"""Checkpoints: one ``.npy`` file a leaf and a JSON manifest, atomic
commits, asynchronous saves (counterpart of ``repro/checkpoint/ckpt.py``).

Layout, the JAX package's:
    <dir>/step_<N>/manifest.json      leaf paths and metadata
    <dir>/step_<N>/leaf_<i>.npy       whole leaves
    <dir>/step_<N>/.complete          commit marker

The manifest holds the JAX package's fields, ``step`` and ``leaves[{path,
file, dtype, stored, shape}]``, in JSON where the JAX package writes
msgpack.  Leaves come in the JAX package's flatten order (dict keys
sorted, lists by index), each named by its path in the form of
``jax.tree_util.keystr`` (``['params']['blocks']['attn']['wq']``), with
numpy dtype names; bf16 is stored as fp32 (``"stored":
"float32->bfloat16"``).  So for one train state the two packages write
the same manifest and the same ``.npy`` files.

A save writes into ``step_<N>.tmp``, fsyncs the marker, then renames the
directory, so a crash mid-save never leaves a committed partial step.  The
train step updates the state in place, so :class:`AsyncCheckpointer` copies
every leaf to host memory before ``save`` returns (one flat host buffer,
pinned for CUDA leaves, filled by non-blocking copies and one
synchronise, and reused by a later save once its files are written); only
the file writes go to its worker thread.  On one
device, :func:`restore_checkpoint` takes a ``device`` where the JAX
package takes shardings.
"""
from __future__ import annotations

import concurrent.futures as futures
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "flatten_with_paths", "snapshot"]

_MANIFEST = "manifest.json"
_COMMIT = ".complete"
#: byte alignment of each leaf in a snapshot's flat host buffer
_ALIGN = 64


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in ``jax.tree_util.tree_flatten_with_path``'s
    order, each path in ``keystr`` form."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _map_with_paths(fn: Callable[[str, Any], Any], tree: Any,
                    prefix: str = "") -> Any:
    """``fn(path, leaf)`` over ``tree``, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def snapshot(tree: Any, buf: Optional[torch.Tensor] = None
             ) -> Tuple[List[Tuple[str, torch.Tensor]], torch.Tensor]:
    """``([(path, host copy)], buffer)``: every leaf, copied now into views
    of one flat CPU buffer (pinned when a leaf is on CUDA) by non-blocking
    copies and one synchronise.  Later in-place updates of ``tree`` do not
    reach it.  ``buf``, the buffer of an earlier snapshot that nothing reads
    any more, is refilled when it fits; else a new one is allocated."""
    flat = [(p, t.detach()) for p, t in flatten_with_paths(tree)]
    on_cuda = any(t.is_cuda for _, t in flat)
    nbytes = [t.numel() * t.element_size() for _, t in flat]
    spans = [-(-n // _ALIGN) * _ALIGN for n in nbytes]
    if buf is None or buf.numel() != sum(spans) or \
            (on_cuda and not buf.is_pinned()):
        buf = torch.empty(sum(spans), dtype=torch.uint8, pin_memory=on_cuda)
    out, off = [], 0
    for (path, t), n, span in zip(flat, nbytes, spans):
        host = buf[off:off + n].view(t.dtype).view(t.shape)
        host.copy_(t, non_blocking=on_cuda)
        out.append((path, host))
        off += span
    if on_cuda:
        torch.cuda.synchronize()
    return out, buf


def _write(ckpt_dir: str, step: int,
           flat: List[Tuple[str, torch.Tensor]]) -> str:
    """Write host leaves as committed step ``step``; returns its directory."""
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "leaves": []}
    for i, (path, t) in enumerate(flat):
        fname = f"leaf_{i:05d}.npy"
        # bfloat16 has no numpy dtype: stored as fp32, flagged
        if t.dtype == torch.bfloat16:
            arr, stored = t.float().numpy(), "float32->bfloat16"
        else:
            arr = t.numpy()
            stored = str(arr.dtype)
        np.save(os.path.join(tmp, fname), arr)
        meta["leaves"].append({"path": path, "file": fname,
                               "dtype": _dtype_name(t.dtype),
                               "stored": stored, "shape": list(t.shape)})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous atomic save.  Returns the committed directory."""
    return _write(ckpt_dir, step, snapshot(tree)[0])


def _committed_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                  if n.startswith("step_") and not n.endswith(".tmp")
                  and os.path.exists(os.path.join(ckpt_dir, n, _COMMIT)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *committed* checkpoint step, or None."""
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, target_tree: Any,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Any:
    """A new tree of ``target_tree``'s structure holding step ``step``: each
    leaf in the dtype of the target's leaf, on ``device`` (default: the
    target leaf's device).  Raises on a missing leaf or a shape mismatch."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        meta = json.load(f)
    by_path = {rec["path"]: rec for rec in meta["leaves"]}

    def load(path: str, leaf: torch.Tensor) -> torch.Tensor:
        rec = by_path.get(path)
        if rec is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = np.load(os.path.join(d, rec["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {path}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        return torch.from_numpy(arr).to(
            device=leaf.device if device is None else device,
            dtype=leaf.dtype)

    return _map_with_paths(load, target_tree)


class AsyncCheckpointer:
    """Saves on a worker thread; ``wait()`` joins pending saves (call it
    before exiting or before deleting old steps).  ``save`` returns once
    the state is copied to host memory, so the caller may then update it
    in place.  ``timings`` gets one ``{step, bytes, snapshot_s, write_s}``
    a committed save: the host copy's seconds (in ``save``) and the file
    writes' (on the worker).  A host buffer goes back to a free list once
    its files are written, and the next save refills it: a pinned buffer
    the size of the state is allocated only while every earlier one is
    still being written."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.timings: List[Dict[str, float]] = []
        self._pool = futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[futures.Future] = []
        self._free: List[torch.Tensor] = []     # buffers no write reads
        self._lock = threading.Lock()

    def save(self, step: int, tree: Any) -> futures.Future:
        t0 = time.perf_counter()
        with self._lock:
            buf = self._free.pop() if self._free else None
        flat, buf = snapshot(tree, buf)
        snapshot_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for _, t in flat)

        def job() -> str:
            t1 = time.perf_counter()
            try:
                path = _write(self.ckpt_dir, step, flat)
            finally:
                with self._lock:
                    self._free.append(buf)
            with self._lock:
                self.timings.append({"step": step, "bytes": nbytes,
                                     "snapshot_s": snapshot_s,
                                     "write_s": time.perf_counter() - t1})
            self._gc()
            return path

        fut = self._pool.submit(job)
        with self._lock:
            self._pending.append(fut)
        return fut

    def _gc(self) -> None:
        for s in _committed_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(_step_dir(self.ckpt_dir, s), ignore_errors=True)

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
        self._free.clear()
