"""The port's radix-4 page combine against the JAX package.

* ``radix4_tree_sum`` against the JAX ``radix4_tree_sum``: int32 exact,
  fp32 within the kernel tests' ``rtol=2e-6, atol=1e-5`` (XLA may
  re-associate the adds; the tree order is the same).
* ``ops.moa_reduce`` on CPU tensors against ``moa_reduce_pallas(...,
  interpret=True)`` at the shapes and dtypes of ``tests/test_kernels.py``,
  including ``bk=5`` operand blocking and the bf16 small-terms case: int32
  exact, floats within ``rtol=2e-6, atol=1e-5`` (the TPU kernel sums one
  tree per ``bk`` block, the port one tree over all N).

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.moa_reduce import moa_reduce_pallas
from repro.kernels.moa_reduce import radix4_tree_sum as jtree
from repro_torch.dist.plan import make_reduction_plan
from repro_torch.kernels import moa_reduce as tmoa
from repro_torch.kernels import ops, ref

SHAPES = [(2, 8, 128), (4, 64, 128), (7, 33, 257), (16, 128, 384),
          (33, 16, 130)]
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "int32": torch.int32}


def _operands(n, rows, cols, dtype):
    rng = np.random.default_rng(n * rows + cols)
    if dtype == "int32":
        return rng.integers(-1000, 1000, (n, rows, cols)).astype(np.int32)
    return rng.standard_normal((n, rows, cols)).astype(np.float32)


def _pair(x, dtype):
    """The same operands for both packages (bf16 rounded once, in JAX)."""
    jx = jnp.asarray(x, JNP[dtype])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)
                                   if dtype == "bfloat16" else jx)
                          ).to(TORCH[dtype])
    return jx, tx


@pytest.mark.parametrize("n,rows,cols", SHAPES + [(1, 4, 8), (300, 2, 16)])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_radix4_tree_sum_matches_jax(n, rows, cols, dtype):
    jx, tx = _pair(_operands(n, rows, cols, dtype), dtype)
    got = tmoa.radix4_tree_sum(tx).numpy()
    want = np.asarray(jtree(jx))
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-5)


@pytest.mark.parametrize("n,rows,cols", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_ops_moa_reduce_cpu_matches_pallas_interpret(n, rows, cols, dtype):
    jx, tx = _pair(_operands(n, rows, cols, dtype), dtype)
    acc_j = jnp.int32 if dtype == "int32" else jnp.float32
    acc_t = torch.int32 if dtype == "int32" else torch.float32
    want = moa_reduce_pallas(jx, bm=64, bn=128, acc_dtype=acc_j,
                             interpret=True)
    got = ops.moa_reduce(tx, acc_t)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (rows, cols)
    want = np.asarray(want.astype(jnp.float32) if dtype == "bfloat16"
                      else want)
    got = got.float().numpy() if dtype == "bfloat16" else got.numpy()
    if dtype == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-5)
    # the oracle agrees too
    np.testing.assert_allclose(
        ref.moa_reduce_ref(tx, acc_t).float().numpy(),
        np.asarray(jref.moa_reduce_ref(jx, acc_j).astype(jnp.float32)),
        rtol=2e-6, atol=1e-5)


def test_ops_moa_reduce_cpu_matches_pallas_operand_blocking():
    """The TPU kernel at bk=5 chains block trees; the port's one tree over
    all 24 operands agrees within the reference's tolerance."""
    x = np.random.default_rng(0).standard_normal((24, 32, 256)).astype(
        np.float32)
    want = moa_reduce_pallas(jnp.asarray(x), bm=32, bn=128, bk=5,
                             interpret=True)
    got = ops.moa_reduce(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-6, atol=1e-5)


def test_ops_moa_reduce_cpu_bf16_keeps_small_terms():
    n = 256
    x = np.concatenate([np.full((1, 8, 128), 1024.0, np.float32),
                        np.full((n - 1, 8, 128), 0.25, np.float32)])
    want = moa_reduce_pallas(jnp.asarray(x, jnp.bfloat16),
                             acc_dtype=jnp.float32, out_dtype=jnp.float32,
                             interpret=True)
    got = ops.moa_reduce(torch.from_numpy(x).to(torch.bfloat16),
                         torch.float32, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), 1024.0 + 0.25 * (n - 1),
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_plain_is_the_radix4_tree_bit_for_bit():
    """moa_reduce_plain adds in the make_reduction_plan order: check it
    against a scalar transcription of the tree, exactly, in fp32."""
    rng = np.random.default_rng(7)
    for n in (1, 2, 3, 4, 5, 6, 15, 16, 17, 63, 64, 65, 259):
        x = rng.standard_normal((n, 5)).astype(np.float32)
        vals = [x[i] for i in range(n)]
        while len(vals) > 1:
            vals += [np.zeros(5, np.float32)] * (-len(vals) % 4)
            vals = [(vals[i] + vals[i + 1]) + (vals[i + 2] + vals[i + 3])
                    for i in range(0, len(vals), 4)]
        got = tmoa.moa_reduce_plain(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), vals[0])


def test_split_levels_for_every_operand_count():
    """The wrapper's split of the plan's tree across lanes, N = 1..300: no
    split while one level-0 group holds every operand, one level up to
    N = 64, two beyond, never more; every lane's subtree spans at least
    one whole level-0 group of the plan, and a split never shrinks as N
    grows."""
    at = {1: 0, 2: 0, 4: 0, 5: 1, 16: 1, 17: 1, 64: 1, 65: 2, 256: 2,
          257: 2, 300: 2}
    prev = 0
    for n in range(1, 301):
        levels = len(make_reduction_plan(n).levels)
        s = tmoa.split_levels(n)
        assert s == at.get(n, s) and prev <= s <= 2, n
        assert s == 0 or 4 ** (levels - s) >= 4, n
        prev = s


def _kernel_order(x):
    """The CUDA kernel's order of adds, transcribed: lane j of the 4^s
    lanes of a column reduces operands [j 4^D, (j + 1) 4^D) (D = L - s),
    padding every level to a multiple of 4 with zeros, a lone element
    too, for D levels (an empty subtree is +0); then each of s levels
    adds the value of the lane at xor offset 1 and 2, then 4 and 8, as the
    warp shuffles do.  Returns every lane's result."""
    n = x.shape[0]
    s = tmoa.split_levels(n)
    depth = len(make_reduction_plan(n).levels) - s
    zero = np.zeros(x.shape[1:], np.float32)
    lanes = []
    for j in range(4 ** s):
        vals = list(x[j * 4 ** depth:(j + 1) * 4 ** depth])
        if not vals:
            lanes.append(zero)
            continue
        for _ in range(depth):
            vals += [zero] * (-len(vals) % 4)
            vals = [(vals[i] + vals[i + 1]) + (vals[i + 2] + vals[i + 3])
                    for i in range(0, len(vals), 4)]
        lanes.append(vals[0])
    for offset in (1, 2, 4, 8)[:2 * s]:
        lanes = [lanes[j] + lanes[j ^ offset] for j in range(len(lanes))]
    return lanes


def test_aligned_subtree_split_is_the_plan_bit_for_bit():
    """The kernel's split of the tree across lanes adds in the plan's
    order: for N = 1..300 every lane ends with radix4_tree_sum's bits in
    fp32, sign of zero included (columns of -0.0, mixed zeros, and values
    over 20 binades, where a change of order shows)."""
    rng = np.random.default_rng(11)
    for n in range(1, 301):
        x = (rng.standard_normal((n, 6)) *
             np.exp2(rng.integers(-10, 10, (n, 6)))).astype(np.float32)
        x[:, 0] = -0.0
        x[:, 1] = np.where(rng.random(n) < 0.5, -0.0, 0.0)
        x[:n // 2, 2] = -0.0
        want = tmoa.radix4_tree_sum(torch.from_numpy(x)).numpy()
        for got in _kernel_order(x):
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32), err_msg=n)
