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

From a device mesh (:class:`AsyncCheckpointer` given ``mesh`` and
``shardings``, the partition specs of the state's blocks; the manifest
and the commit are the one-device save's) a save writes the same files:
rank 0 creates every
leaf's ``.npy`` at its whole shape in ``step_<N>.tmp`` (headers only; the
data is a sparse file), the ranks meet at a barrier, then each rank writes
the blocks it owns (the first of the ranks that hold a block) into their
rows of the files, and marks the directory; rank 0 writes the manifest,
the commit marker and renames once every rank has marked.  Nothing is
gathered.  :func:`restore_checkpoint` with ``shardings`` (and the target
``mesh``, which may differ from the one that saved: the elastic restore)
maps each file and reads only the rank's block of it.
"""
from __future__ import annotations

import concurrent.futures as futures
import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.common import block_owner, block_slices, pspec_axes
from repro_torch.tree import map_tree

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "flatten_with_paths", "snapshot"]

_MANIFEST = "manifest.json"
_COMMIT = ".complete"
#: seconds rank 0 waits for every rank's blocks of a mesh save
MESH_WRITE_TIMEOUT = 1800.0
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


def _map_with_paths(fn: Callable[..., Any], tree: Any, *rest: Any,
                    prefix: str = "") -> Any:
    """``fn(path, leaf, *rest_leaves)`` over ``tree``, keeping its
    structure (``rest``: trees indexed like ``tree``)."""
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, *(r[k] for r in rest),
                                   prefix=f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, v, *(r[i] for r in rest),
                                          prefix=f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


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


@dataclasses.dataclass(frozen=True)
class _Block:
    """Where a rank's block sits in its leaf's file."""
    shape: Tuple[int, ...]          # the whole leaf's
    index: Tuple[slice, ...]        # the rank's block of it
    owner: bool                     # whether this rank writes it


def _blocks(tree: Any, shardings: Any, mesh) -> Any:
    """A :class:`_Block` a leaf of ``tree`` (the rank's blocks under
    ``shardings`` on ``mesh``)."""
    def one(t, ps):
        shape = tuple(n * mesh.size(pspec_axes(ps, i))
                      for i, n in enumerate(t.shape))
        return _Block(shape, block_slices(shape, ps, mesh),
                      block_owner(ps, mesh))
    return map_tree(one, tree, shardings)


def _stored(dtype: torch.dtype) -> str:
    """The manifest's ``stored`` name for a leaf of ``dtype``: its numpy
    dtype's, or for bf16, which has none, fp32 flagged."""
    if dtype == torch.bfloat16:
        return "float32->bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host leaf as the array its file stores (bf16 as fp32)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _manifest(step: int, flat: List[Tuple[str, torch.Tensor]],
              shapes: List[Tuple[int, ...]]) -> dict:
    """The manifest of step ``step``: a record a leaf of ``flat``, each of
    its whole shape in ``shapes``."""
    return {"step": step, "leaves": [
        {"path": path, "file": f"leaf_{i:05d}.npy",
         "dtype": _dtype_name(t.dtype), "stored": _stored(t.dtype),
         "shape": list(shape)}
        for i, ((path, t), shape) in enumerate(zip(flat, shapes))]}


def _fresh_tmp(ckpt_dir: str, step: int) -> str:
    """An empty ``step_<N>.tmp`` (a leftover of a crashed save removed)."""
    tmp = _step_dir(ckpt_dir, step) + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp


def _commit(ckpt_dir: str, meta: dict) -> str:
    """Write the manifest and the fsynced commit marker into the step's
    ``.tmp`` directory, whose leaf files are written, and rename it to the
    step's; returns the committed directory."""
    final = _step_dir(ckpt_dir, meta["step"])
    tmp = final + ".tmp"
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


def _write(ckpt_dir: str, step: int,
           flat: List[Tuple[str, torch.Tensor]]) -> str:
    """Write host leaves as committed step ``step``; returns its directory."""
    tmp = _fresh_tmp(ckpt_dir, step)
    meta = _manifest(step, flat, [tuple(t.shape) for _, t in flat])
    for rec, (_, t) in zip(meta["leaves"], flat):
        np.save(os.path.join(tmp, rec["file"]), _host_array(t))
    return _commit(ckpt_dir, meta)


def _mesh_prepare(ckpt_dir: str, meta: dict) -> None:
    """Rank 0: a fresh ``step_<N>.tmp`` with every leaf's file at its
    whole shape (header and a sparse body)."""
    tmp = _fresh_tmp(ckpt_dir, meta["step"])
    for rec in meta["leaves"]:
        np.lib.format.open_memmap(
            os.path.join(tmp, rec["file"]), mode="w+",
            dtype=np.dtype(rec["stored"].split("->")[0]),
            shape=tuple(rec["shape"]))


def _mesh_write(ckpt_dir: str, meta: dict, rank: int, world: int,
                owned: List[Tuple[int, Tuple[slice, ...], torch.Tensor]]
                ) -> Optional[str]:
    """Write this rank's owned blocks (host tensors) into their rows of
    the prepared files and mark the directory; rank 0 then waits for every
    rank's mark and commits.  Returns the committed directory on rank 0."""
    step = meta["step"]
    tmp = _step_dir(ckpt_dir, step) + ".tmp"
    for i, index, t in owned:
        mm = np.lib.format.open_memmap(
            os.path.join(tmp, meta["leaves"][i]["file"]), mode="r+")
        mm[index] = _host_array(t)
        mm.flush()
        del mm
    with open(os.path.join(tmp, f".rank_{rank}"), "w") as f:
        f.flush()
        os.fsync(f.fileno())
    if rank != 0:
        return None
    marks = [os.path.join(tmp, f".rank_{r}") for r in range(world)]
    deadline = time.monotonic() + MESH_WRITE_TIMEOUT
    while not all(os.path.exists(m) for m in marks):
        if time.monotonic() > deadline:
            raise TimeoutError(f"step {step}: not every rank wrote its "
                               f"blocks within {MESH_WRITE_TIMEOUT} s")
        time.sleep(0.01)
    for m in marks:
        os.remove(m)
    return _commit(ckpt_dir, meta)


def _mesh_begin(ckpt_dir: str, step: int, tree: Any, shardings: Any, mesh,
                buf: Optional[torch.Tensor] = None):
    """The synchronous half of a mesh save, on every rank at the same
    step: copy the rank's owned blocks to host memory, rank 0 prepares the
    files, barrier.  Returns ``(meta, owned, buf)``."""
    flat = flatten_with_paths(tree)
    blocks = [b for _, b in flatten_with_paths(_blocks(tree, shardings,
                                                       mesh))]
    meta = _manifest(step, flat, [b.shape for b in blocks])
    mine = [i for i, b in enumerate(blocks) if b.owner]
    host, buf = snapshot([flat[i][1] for i in mine], buf)
    owned = [(i, blocks[i].index, t) for i, (_, t) in zip(mine, host)]
    if dist.get_rank() == 0:
        _mesh_prepare(ckpt_dir, meta)
    dist.barrier()
    return meta, owned, buf


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous atomic save.  Returns the committed directory.  From a
    device mesh, save through :class:`AsyncCheckpointer`."""
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
                       device: Optional[Union[str, torch.device]] = None,
                       shardings: Any = None, mesh=None) -> Any:
    """A new tree of ``target_tree``'s structure holding step ``step``: each
    leaf in the dtype of the target's leaf, on ``device`` (default: the
    target leaf's device).  With ``shardings`` (partition specs matching
    the tree) on the device ``mesh``, each leaf is this rank's block of
    the saved leaf, read from the mapped file: the elastic path, the mesh
    may differ from the one the checkpoint was written under.  Raises on
    a missing leaf or a shape mismatch."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        meta = json.load(f)
    by_path = {rec["path"]: rec for rec in meta["leaves"]}

    def load(path: str, leaf: torch.Tensor, ps=None) -> torch.Tensor:
        rec = by_path.get(path)
        if rec is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        file = os.path.join(d, rec["file"])
        if ps is None:
            arr = np.load(file)
        else:
            arr = np.load(file, mmap_mode="r")
            arr = np.array(arr[block_slices(arr.shape, ps, mesh)])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {path}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        return torch.from_numpy(arr).to(
            device=leaf.device if device is None else device,
            dtype=leaf.dtype)

    if shardings is None:
        return _map_with_paths(load, target_tree)
    return _map_with_paths(load, target_tree, shardings)


class AsyncCheckpointer:
    """Saves on a worker thread; ``wait()`` joins pending saves (call it
    before exiting or before deleting old steps).  ``save`` returns once
    the state is copied to host memory, so the caller may then update it
    in place.  ``timings`` gets one ``{step, bytes, snapshot_s, write_s}``
    a committed save: the host copy's seconds (in ``save``) and the file
    writes' (on the worker).  A host buffer goes back to a free list once
    its files are written, and the next save refills it: a pinned buffer
    the size of the state is allocated only while every earlier one is
    still being written.

    From a device ``mesh`` (the saved trees are the rank's blocks under
    ``shardings``) every rank calls ``save`` at the same step: the host
    copy of the rank's owned blocks and rank 0's preparing of the files
    happen in ``save`` (with a barrier), the block writes on the worker,
    and rank 0's worker commits once every rank has written; ``wait`` ends
    with a barrier, so on every rank it returns once the step is
    committed.  ``bytes`` is then the rank's own, and ``snapshot_s``
    includes the preparing and the barrier."""

    def __init__(self, ckpt_dir: str, keep: int = 3, mesh=None,
                 shardings: Any = None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.mesh, self.shardings = mesh, shardings
        self.timings: List[Dict[str, float]] = []
        self._pool = futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[futures.Future] = []
        self._free: List[torch.Tensor] = []     # buffers no write reads
        self._lock = threading.Lock()

    def save(self, step: int, tree: Any) -> futures.Future:
        t0 = time.perf_counter()
        with self._lock:
            buf = self._free.pop() if self._free else None
        if self.mesh is None:
            flat, buf = snapshot(tree, buf)
            host = [t for _, t in flat]
            write = lambda: _write(self.ckpt_dir, step, flat)
            lead = True
        else:
            meta, owned, buf = _mesh_begin(self.ckpt_dir, step, tree,
                                           self.shardings, self.mesh, buf)
            host = [t for *_, t in owned]
            rank, world = dist.get_rank(), dist.get_world_size()
            write = lambda: _mesh_write(self.ckpt_dir, meta, rank, world,
                                        owned)
            lead = rank == 0
        snapshot_s = time.perf_counter() - t0
        nbytes = sum(t.numel() * t.element_size() for t in host)

        def job() -> Optional[str]:
            t1 = time.perf_counter()
            try:
                path = write()
            finally:
                with self._lock:
                    self._free.append(buf)
            with self._lock:
                self.timings.append({"step": step, "bytes": nbytes,
                                     "snapshot_s": snapshot_s,
                                     "write_s": time.perf_counter() - t1})
            if lead:
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
        if self.mesh is not None:
            dist.barrier()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
        self._free.clear()
