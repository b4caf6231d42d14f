"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Tests marked ``cuda`` skip without a CUDA device (a CUDA kernel has no CPU
mode); on the card run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed."""
import pytest
import torch

from repro_torch.kernels import moa_reduce as moa
from repro_torch.kernels import ops

DTYPES = {"float32": (torch.float32, torch.float32),
          "bfloat16": (torch.bfloat16, torch.float32),
          "int32": (torch.int32, torch.int32)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _operands(n, m, dtype, device):
    gen = torch.Generator(device=device).manual_seed(n * 7919 + m)
    in_dt, acc = DTYPES[dtype]
    if in_dt == torch.int32:
        return torch.randint(-1000, 1000, (n, m), generator=gen,
                             device=device, dtype=torch.int32), acc
    return torch.randn((n, m), generator=gen, device=device).to(in_dt), acc


def test_cuda_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        moa.moa_reduce_cuda(torch.zeros(4, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(1, 64), (2, 1024), (5, 3), (7, 8227),
                                 (16, 96), (16, 12288), (16, 6144),
                                 (33, 2080), (16, 786432), (300, 640)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_equals_plain_bit_for_bit(cuda_device, n, m, dtype):
    x, acc = _operands(n, m, dtype, cuda_device)
    before = moa.LAUNCHES
    got = moa.moa_reduce_cuda(x, acc)
    torch.cuda.synchronize()
    assert moa.LAUNCHES == before + 1
    assert torch.equal(got, moa.moa_reduce_plain(x, acc, acc))


@pytest.mark.cuda
def test_kernel_unaligned_view_takes_scalar_path(cuda_device):
    """A view offset by one element cannot take 16-byte loads; the kernel
    must still be exact."""
    base, acc = _operands(16, 4097, "float32", cuda_device)
    x = base.reshape(-1)[1:1 + 16 * 4096].reshape(16, 4096)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert torch.equal(moa.moa_reduce_cuda(x, acc),
                       moa.moa_reduce_plain(x, acc, acc))


@pytest.mark.cuda
def test_ops_dispatches_cuda_tensors_to_the_kernel(cuda_device):
    x, _ = _operands(16, 4 * 24 * 128, "float32", cuda_device)
    x = x.reshape(16, 4, 24 * 128)
    before = moa.LAUNCHES
    got = ops.moa_reduce(x)
    assert moa.LAUNCHES == before + 1
    assert got.shape == (4, 24 * 128)
    assert torch.equal(got, moa.moa_reduce_plain(x))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    with pytest.raises(ValueError, match="operands"):
        moa.moa_reduce_cuda(torch.zeros(moa.MAX_OPERANDS + 1, 4,
                                        device=cuda_device))
    with pytest.raises(ValueError, match="dtypes"):
        moa.moa_reduce_cuda(torch.zeros(4, 4, device=cuda_device,
                                        dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        moa.moa_reduce_cuda(torch.zeros(4, 8, device=cuda_device)[:, ::2])
