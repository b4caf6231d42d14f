"""Kernel layer: hand-written Hopper kernels, their plain PyTorch versions,
and :mod:`~repro_torch.kernels.ops`, which dispatches on the tensor's
device."""
