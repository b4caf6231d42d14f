"""The 4->3 ones-count LUT (paper Figs 3/4) and the §10 gate-cost models.

Copy of ``repro/core/lut.py`` for the PyTorch port, which imports nothing
of the JAX package (``tests/test_torch_core_moa.py`` holds the two equal).
The tensor functions take and return int32 tensors on any device.

Two deliverables live here:

1. The LUT itself — the I/O map of Fig 3 — as both a table and a tensor
   gather, plus the explicit gate-level netlist of Fig 4 (ones-count logic)
   evaluated bit-by-bit so tests can prove the netlist == the table.

2. The gate-delay / gate-area cost models used in §10 to compare LUT-based
   multi-operand adders with conventional Carry-Look-Ahead (CLA) adders
   (Figs 16-18). The paper gives the anchor constants (LUT: 4-gate delay /
   25-gate area for the 1-bit 4->3 unit; 4-bit CLA: 9-gate delay / 50-gate
   area, citing [2013 Jovanovic]) and states the larger structures are
   "extended" from these units; the extension rules below are reconstructed
   from §5/§7 (radix-4 LUT trees; binary CLA trees) and documented inline.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "LUT4_TABLE",
    "lut4_lookup",
    "lut4_netlist",
    "popcount_tree",
    "LUT_DELAY_GATES",
    "LUT_AREA_GATES",
    "CLA4_DELAY_GATES",
    "CLA4_AREA_GATES",
    "GateCost",
    "lut_parallel_adder_cost",
    "cla_adder_cost",
    "cla_tree_cost",
    "lut_tree_cost",
    "performance_advantage",
]

# ---------------------------------------------------------------------------
# The 4->3 LUT (Fig 3): input = 4 column bits, output = ones count (0..4)
# ---------------------------------------------------------------------------

#: Fig 3 I/O map: index = packed 4 input bits (b3 b2 b1 b0), value = popcount.
LUT4_TABLE: np.ndarray = np.array([bin(i).count("1") for i in range(16)],
                                  dtype=np.int32)


def lut4_lookup(packed: torch.Tensor) -> torch.Tensor:
    """Vectorized Fig-3 LUT: ``packed`` holds 4-bit codes in [0, 16)."""
    table = torch.as_tensor(LUT4_TABLE, device=packed.device)
    return table[packed.long()]


def lut4_netlist(b: torch.Tensor) -> torch.Tensor:
    """Fig 4 one's-count *gate netlist*, evaluated on the last axis of 4 bits.

    Structure (two-input gates, longest path 4 gates):
      half-add pairs:  s0 = b0^b1, c0 = b0&b1 ; s1 = b2^b3, c1 = b2&b3
      merge sums:      z0 = s0^s1, m  = s0&s1
      merge carries:   t  = c0^c1, z2p = c0&c1
      weight-2 column: z1 = t^m,  k  = t&m
      weight-4:        z2 = z2p | k
    Output value = z0 + 2*z1 + 4*z2  == popcount(b).
    """
    b = b.to(torch.int32)
    b0, b1, b2, b3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    s0, c0 = b0 ^ b1, b0 & b1
    s1, c1 = b2 ^ b3, b2 & b3
    z0, m = s0 ^ s1, s0 & s1
    t, z2p = c0 ^ c1, c0 & c1
    z1, kk = t ^ m, t & m
    z2 = z2p | kk
    return z0 + 2 * z1 + 4 * z2


def popcount_tree(bits: torch.Tensor) -> torch.Tensor:
    """Hierarchical LUT popcount over the last axis (any N): groups of 4 go
    through the 4->3 unit, partial counts are added pairwise — the paper's
    'hierarchical implementations with several levels of LUTs' (§3.3)."""
    n = bits.shape[-1]
    pad = (-n) % 4
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))],
                         dim=-1)
    grp = bits.reshape(bits.shape[:-1] + (-1, 4))
    counts = lut4_netlist(grp)          # (..., n/4) partial ones-counts
    return torch.sum(counts, dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# §10 gate-cost anchors
# ---------------------------------------------------------------------------

LUT_DELAY_GATES = 4     # Fig 4 longest path
LUT_AREA_GATES = 25     # §10: "overall area of 25 gates"
CLA4_DELAY_GATES = 9    # §10, 4-bit two-operand CLA [2013 Jovanovic]
CLA4_AREA_GATES = 50


@dataclass(frozen=True)
class GateCost:
    delay_gates: float
    area_gates: float

    def __add__(self, other: "GateCost") -> "GateCost":
        return GateCost(self.delay_gates + other.delay_gates,
                        self.area_gates + other.area_gates)


def lut_parallel_adder_cost(n_operands: int, m_bits: int) -> GateCost:
    """Cost of one combinatorial LUT-based ``n_operands`` x ``m_bits`` adder.

    Reconstruction: the Fig-7 4x4 unit has one level of per-column LUTs and a
    shifted-merge level; its longest path is 4 LUTs (16 gates) with area
    ~ (2*M - 1) LUT units. For N > 4 operands a radix-4 tree of such units is
    used (§7); level l handles words of (m_bits + 2*(l-1)) bits, since each
    4-operand stage widens the word by 2 bits (Theorem: carry <= 3 -> 2 bits).
    """
    if n_operands < 2:
        return GateCost(0.0, 0.0)
    delay = 0.0
    area = 0.0
    remaining = n_operands
    width = m_bits
    while remaining > 1:
        groups = math.ceil(remaining / 4)
        # Longest path in one 4xW unit is 4 LUTs irrespective of W (Fig 7):
        # column LUTs operate in parallel and the shifted merge is a fixed
        # 3-LUT + half-adder chain.
        delay += LUT_DELAY_GATES * 4
        area += groups * (LUT_AREA_GATES * (2 * width - 1) + 5)
        remaining = groups
        width += 2  # each stage adds 2 carry bits (4-operand carry <= 3)
    return GateCost(delay, area)


def cla_adder_cost(m_bits: int) -> GateCost:
    """Two-operand M-bit adder built from cascaded 4-bit CLA blocks:
    delay = 9 + 4*(blocks-1) (carry ripples between blocks), area = 50/block."""
    blocks = math.ceil(m_bits / 4)
    return GateCost(CLA4_DELAY_GATES + 4 * (blocks - 1),
                    CLA4_AREA_GATES * blocks)


def cla_tree_cost(n_operands: int, m_bits: int) -> GateCost:
    """N-operand addition from a binary tree of two-operand CLAs (the §1
    'tree of adders' baseline): ceil(log2 N) levels, N-1 adders, word width
    growing by 1 bit per level (2-operand carry = 1)."""
    if n_operands < 2:
        return GateCost(0.0, 0.0)
    delay = 0.0
    area = 0.0
    remaining = n_operands
    width = m_bits
    while remaining > 1:
        pairs = remaining // 2
        unit = cla_adder_cost(width)
        delay += unit.delay_gates
        area += pairs * unit.area_gates
        remaining = remaining - pairs  # odd operand passes through
        width += 1
    return GateCost(delay, area)


def lut_tree_cost(n_operands: int, m_bits: int) -> GateCost:
    """Alias with the §7 radix-4 reconfiguration framing."""
    return lut_parallel_adder_cost(n_operands, m_bits)


def performance_advantage(n_operands: int, m_bits: int) -> float:
    """Eqn (22): d_g(CLA) / d_g(LUT) — >1 means the LUT adder is faster."""
    cla = cla_tree_cost(n_operands, m_bits)
    lut = lut_tree_cost(n_operands, m_bits)
    if lut.delay_gates == 0:
        return float("inf")
    return cla.delay_gates / lut.delay_gates
