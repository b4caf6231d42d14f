"""The port's bit-serial adder against the JAX package.

``repro_torch.kernels.ops.bitplane_add`` on CPU tensors (the plain column
loop, :func:`~repro_torch.kernels.bitplane_add.bitplane_add_plain`)
against ``bitplane_add_pallas(..., interpret=True)`` at the shapes of
``tests/test_kernels.py:60-82``, exactly, plus the Fig-12 lanes, operands
wider than M, and the width guard.  The CUDA kernel is held against the
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bitplane_add import bitplane_add_pallas
from repro_torch.core import moa
from repro_torch.kernels import bitplane_add as bpa
from repro_torch.kernels import ops, ref

SHAPES = [(4, 4, 64), (4, 16, 256), (16, 16, 128), (3, 8, 33),
          (64, 20, 512)]


def _lanes(n, m_bits, batch):
    rng = np.random.default_rng(n + m_bits)
    return rng.integers(0, 2 ** m_bits, (n, batch)).astype(np.int32)


@pytest.mark.parametrize("n,m_bits,batch", SHAPES)
def test_ops_bitplane_add_cpu_matches_pallas_interpret(n, m_bits, batch):
    x = _lanes(n, m_bits, batch)
    want = bitplane_add_pallas(jnp.asarray(x), m_bits=m_bits, bb=128,
                               interpret=True)
    got = ops.bitplane_add(torch.from_numpy(x), m_bits)
    assert got.dtype == torch.int32 and tuple(got.shape) == (batch,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.bitplane_add_ref(torch.from_numpy(x), m_bits).numpy(),
        np.asarray(jref.bitplane_add_ref(jnp.asarray(x), m_bits)))


@pytest.mark.parametrize("n,m_bits,batch", SHAPES)
def test_plain_equals_core_serial_add(n, m_bits, batch):
    """The plain kernel version and core.moa.serial_add are both
    Algorithm 2; on in-range lanes they give the same sums."""
    x = torch.from_numpy(_lanes(n, m_bits, batch))
    got = bpa.bitplane_add_plain(x, m_bits)
    want, clocks = moa.serial_add(x.t(), m_bits)
    assert torch.equal(got, want) and clocks == m_bits + 1


def test_paper_fig12_lanes():
    x = np.tile(np.array([[0xA], [0xF], [0x1], [0x2]], np.int32), (1, 256))
    got = ops.bitplane_add(torch.from_numpy(x), 4)
    assert bool((got == 0x1C).all())
    want = bitplane_add_pallas(jnp.asarray(x), m_bits=4, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reads_only_the_low_bits_like_pallas():
    """Operands wider than M, negative ones too: both kernels add only the
    low M bits of each."""
    rng = np.random.default_rng(5)
    x = rng.integers(-2 ** 31, 2 ** 31, (7, 100)).astype(np.int32)
    want = bitplane_add_pallas(jnp.asarray(x), m_bits=12, bb=128,
                               interpret=True)
    got = ops.bitplane_add(torch.from_numpy(x), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), (x & 0xFFF).sum(axis=0))


def test_width_guard():
    with pytest.raises(ValueError):
        bitplane_add_pallas(jnp.zeros((8, 4), jnp.int32), m_bits=30,
                            interpret=True)
    with pytest.raises(ValueError, match="int32 capacity"):
        ops.bitplane_add(torch.zeros((8, 4), dtype=torch.int32), 30)
    with pytest.raises(ValueError, match="int32 capacity"):
        bpa.check_width(2 ** 10 + 1, 21)
    bpa.check_width(2 ** 10, 21)           # 2^10 (2^21 - 1) < 2^31


def test_cpu_tensor_takes_plain_path_without_launch():
    x = torch.from_numpy(_lanes(16, 16, 64))
    before = bpa.LAUNCHES
    got = ops.bitplane_add(x, 16)
    assert bpa.LAUNCHES == before
    assert torch.equal(got, bpa.bitplane_add_plain(x, 16))


def test_netlist_op_count():
    """Per group of four, 11 gates and 2K - 1 adder gates; 3K - 2 for the
    column pass: K = 5 counter words at N = 16, K = 2 at N = 3."""
    assert bpa.netlist_ops_per_lane(16) == 4 * (11 + 9) + 13
    assert bpa.netlist_ops_per_lane(3) == 1 * (11 + 3) + 4
    assert bpa.bound_bytes(16, 10) == 4 * 17 * 10
