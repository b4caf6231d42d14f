"""The port's Theorem-planned int8 matmul against the JAX package.

``repro_torch.kernels.ops.quant_matmul`` on CPU tensors (the plain
block-by-block version,
:func:`~repro_torch.kernels.quant_matmul.quant_matmul_plain`) against
``quant_matmul_pallas(..., bm=64, bn=64, interpret=True)`` at the shapes
of ``tests/test_kernels.py:86-116``, exactly, with a binding 18-bit plan,
the all-(-128) K = 8192 worst case, the wrap of two plan blocks, the K
plan itself and the wrapper's choice of product kernel.  The CUDA kernels
are held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.accum import plan_dot_accumulation as jplan
from repro.kernels import ref as jref
from repro.kernels.quant_matmul import quant_matmul_pallas
from repro_torch.core.accum import plan_dot_accumulation
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quant_matmul as qmm

SHAPES = [(8, 128, 128), (32, 384, 256), (130, 257, 65), (256, 1024, 512)]


def _operands(m, k, n):
    rng = np.random.default_rng(m + k + n)
    return (rng.integers(-128, 128, (m, k)).astype(np.int8),
            rng.integers(-128, 128, (k, n)).astype(np.int8))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_ops_quant_matmul_cpu_matches_pallas_interpret(m, k, n):
    x, w = _operands(m, k, n)
    want = quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w), bm=64, bn=64,
                               interpret=True)
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.quant_matmul_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(w))))


def test_binding_plan_matches_pallas_interpret():
    """An emulated 18-bit accumulator: blocks of 8 products, 33 of them
    over K = 257, added in int32 — the same result as the TPU kernel's."""
    x, w = _operands(130, 257, 65)
    assert qmm.k_plan(257, 18).block == 8
    want = quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w), bm=64, bn=64,
                               acc_bits=18, interpret=True)
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                           acc_bits=18)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_worst_case_no_overflow():
    """All-(-128) inputs at K = 8192: every sum is exactly 8192 * 2^14."""
    k = 8192
    x = np.full((4, k), -128, np.int8)
    w = np.full((k, 4), -128, np.int8)
    want = quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                               interpret=True)
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert bool((got == k * 128 * 128).all())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert qmm.k_plan(k).exact and qmm.k_plan(k).num_blocks == 1


def test_two_plan_blocks_wrap_like_the_tpu_kernel():
    """x all -128, w all 127 at K = 262144: two plan blocks, each partial
    -2,130,706,432 fits int32, their sum wraps to 33,554,432.  The plain
    version, the Pallas kernel and numpy's int64 product taken modulo 2^32
    agree: the semantics on which the card kernel's single accumulator
    rests."""
    k = 262144
    plan = qmm.k_plan(k)
    assert (plan.block, plan.num_blocks) == (131072, 2)
    assert -128 * 127 * plan.block == -2130706432 >= -2 ** 31
    x = np.full((4, k), -128, np.int8)
    w = np.full((k, 4), 127, np.int8)
    wrapped = (x.astype(np.int64) @ w.astype(np.int64)) % 2 ** 32
    want = np.where(wrapped >= 2 ** 31, wrapped - 2 ** 32, wrapped)
    assert (want == 33554432).all()
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w))
    pallas = quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                                 interpret=True)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(pallas), want.astype(np.int32))


@pytest.mark.parametrize("k,n,x_ptr,w_ptr,want", [
    (3072, 8192, 0, 256, "wgmma"), (16, 16, 4096, 16, "wgmma"),
    (262144, 16, 32, 48, "wgmma"), (257, 65, 0, 0, "mma_sync"),
    (40, 9, 0, 0, "mma_sync"), (520, 3072, 0, 0, "mma_sync"),
    (272, 200, 0, 0, "mma_sync"), (16, 8, 0, 0, "mma_sync"),
    (3072, 8192, 1, 0, "mma_sync"), (3072, 8192, 0, 8, "mma_sync")])
def test_route_by_shape_and_alignment(k, n, x_ptr, w_ptr, want):
    """The wgmma kernel takes K and N multiples of 16 with 16-byte-aligned
    bases (what TMA can describe); every other call takes the pre-pass and
    the mma.sync kernel."""
    assert qmm.route(k, n, x_ptr, w_ptr) == want


@pytest.mark.parametrize("k", [1, 8, 127, 128, 257, 1024, 8192, 200000])
@pytest.mark.parametrize("acc_bits", [16, 18, 24, 32])
def test_k_plan_equals_jax(k, acc_bits):
    got = qmm.k_plan(k, acc_bits)
    want = jplan(k, lhs_bits=8, rhs_bits=8, acc_bits=acc_bits, align=128)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_plan_is_binding():
    """The Theorem's block bound is exact: with an emulated narrow
    accumulator, max_block terms never overflow but max_block + 1 can."""
    plan = plan_dot_accumulation(1024, acc_bits=18, align=1)
    worst = 2 ** 14                        # (-128) * (-128)
    assert plan.max_block * worst <= 2 ** 17
    assert (plan.max_block + 1) * worst > 2 ** 17


def test_cpu_tensors_take_plain_path_without_launch():
    x, w = (torch.from_numpy(a) for a in _operands(32, 384, 256))
    before = qmm.LAUNCHES
    got = ops.quant_matmul(x, w)
    assert qmm.LAUNCHES == before
    assert torch.equal(got, qmm.quant_matmul_plain(x, w))


def test_shapes_must_agree():
    x = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        ops.quant_matmul(x, x)


def test_bounds():
    m, k, n = 4096, 3072, 8192
    assert qmm.bound_ops(m, k, n) == 2 * m * k * n
    assert qmm.bound_bytes(m, k, n) == m * k + k * n + 4 * m * n
