"""Parameters from the JAX package, as numpy arrays, into the port's dict.

``params_from_numpy(jax.tree.map(np.asarray, params), device, dtype)``
turns a JAX parameter tree into the port's plain dict of tensors with the
same nesting (``blocks`` stacked on a leading layers axis).  Floating
leaves are stored in ``dtype`` once, where the JAX package keeps fp32
params and casts them to the compute dtype at every use
(``repro/models/attention.py:_project_qkv``, ``repro/models/moe.py:dense_ffn``):
the values the math sees are the same.  Integer leaves keep their dtype.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def params_from_numpy(tree: Any, device: Union[str, torch.device],
                      dtype: torch.dtype) -> Any:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (floating leaves cast to ``dtype``)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        # bfloat16 arrives as an ml_dtypes array numpy cannot hand torch
        return torch.from_numpy(arr.astype(np.float32)).to(device=device,
                                                            dtype=dtype)
    return torch.from_numpy(arr.copy()).to(device)
