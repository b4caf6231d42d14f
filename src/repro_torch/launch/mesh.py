"""Meshes: the dry run's axis-size mappings and the device mesh of ranks.

Counterpart of ``repro/launch/mesh.py`` (and of ``build_mesh`` /
``maybe_init_distributed`` in ``repro/launch/train.py``).

* The dry run's meshes (:func:`make_production_mesh`, :func:`card_mesh`)
  are ordered mappings of axis name to size: all that the sharding
  arithmetic (:func:`repro_torch.models.common.logical_to_pspec`) reads.
* A device mesh (:class:`Mesh`) is one process a rank, joined by
  ``torch.distributed``: PyTorch's ``DeviceMesh`` with named axes, a
  process group an axis (:meth:`Mesh.group`), and the
  :class:`~repro_torch.dist.transport.Transport` that issues and counts
  the collectives.  Code that takes a ``mesh`` runs on every rank with the
  rank's own block of each sharded tensor (what a JAX ``shard_map`` body
  sees).  :func:`make_test_mesh` gives the JAX tests' 8-rank shapes,
  :func:`build_mesh` the train CLI's mesh over the whole world, and
  :func:`maybe_init_distributed` joins the group that ``torchrun`` set up.
* A mesh view (:class:`MeshView`) is one rank of a mesh that has no
  process group: the same surface as :class:`Mesh`, its groups the axis
  names and its transport a
  :class:`~repro_torch.dist.transport.MetaTransport`, so the mesh code
  runs one rank's program on meta tensors and counts what its
  collectives would move (the dry run's collective term).
"""
from __future__ import annotations

import math
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.dist.transport import MetaTransport, Transport

__all__ = ["make_production_mesh", "card_mesh", "mesh_summary", "Mesh",
           "MeshView", "device_mesh", "make_test_mesh", "build_mesh",
           "maybe_init_distributed"]


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips).

    Axes: ("data", "model") / ("pod", "data", "model"). "data" carries
    DP + FSDP; "model" carries TP / EP / SP / kv-seq sharding; "pod" is the
    slow boundary between pods (gradient reduction only).
    """
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def card_mesh() -> Dict[str, int]:
    """One card: every rule falls back to replication."""
    return {"data": 1, "model": 1}


def mesh_summary(mesh: Union[Mapping[str, int], "_Axes"]) -> str:
    shape = mesh.shape if isinstance(mesh, _Axes) else mesh
    return "x".join(f"{k}={v}" for k, v in shape.items())


class _Axes:
    """What :class:`Mesh` and :class:`MeshView` share: ``shape`` (axis
    name -> size, in order) and this rank's coordinates on it."""

    shape: Dict[str, int]

    def index(self, axis: str) -> int:
        raise NotImplementedError

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def flat_index(self, axes: Sequence[str]) -> int:
        """This rank's row-major coordinate over ``axes`` together (where
        its block sits in a split over those axes)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.index(a)
        return i

    def __repr__(self) -> str:
        return f"{type(self).__name__}({mesh_summary(self)}, {self.device})"


class Mesh(_Axes):
    """This rank's view of a device mesh: ``shape`` (axis name -> size, in
    order), its coordinate on each axis (:meth:`index`), an axis's process
    group (:meth:`group`), the ``device`` its tensors live on and the
    ``transport`` its collectives go through, which counts each axis's
    ops under the axis's name."""

    def __init__(self, dmesh, device: torch.device,
                 transport: Optional[Transport] = None):
        self.device_mesh = dmesh
        self.device = device
        self.transport = transport if transport is not None else Transport()
        self.axis_names: Tuple[str, ...] = tuple(dmesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              dmesh.mesh.shape))
        # axes of 2 or more ranks first: a one-rank axis may share their
        # group
        for a in sorted(self.axis_names, key=lambda a: self.shape[a] == 1):
            self.transport.name_group(self.group(a), a)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return self.device_mesh.get_local_rank(axis)


class MeshView(_Axes):
    """One rank of a mesh of ``shape`` (axis name -> size, in order) at
    ``coord`` (one coordinate an axis; default the first rank), with no
    process group: :meth:`group` is the axis's name, and the ``transport``
    (a :class:`~repro_torch.dist.transport.MetaTransport`) counts every
    collective and moves nothing.  The mesh code runs on it as on a
    :class:`Mesh`, on tensors of ``device`` (default ``meta``)."""

    def __init__(self, shape: Mapping[str, int],
                 coord: Optional[Sequence[int]] = None,
                 device: Union[str, torch.device] = "meta"):
        self.shape = {a: int(n) for a, n in shape.items()}
        self.axis_names = tuple(self.shape)
        coord = tuple(coord) if coord is not None else (0,) * len(self.shape)
        if len(coord) != len(self.shape) or not all(
                0 <= c < n for c, n in zip(coord, self.shape.values())):
            raise ValueError(f"coordinate {coord} is not a rank of "
                             f"{mesh_summary(self.shape)}")
        self.coord = dict(zip(self.axis_names, coord))
        self.device = torch.device(device)
        self.transport = MetaTransport(self.shape)

    def group(self, axis: str):
        return axis

    def index(self, axis: str) -> int:
        return self.coord[axis]


def device_mesh(shape: Sequence[int], axis_names: Sequence[str],
                device: Optional[Union[str, torch.device]] = None,
                transport: Optional[Transport] = None,
                ranks: Optional[torch.Tensor] = None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the ranks of the default process
    group (``ranks``, a tensor of that shape, orders them; default
    row-major).  ``device`` is where the ranks' tensors live: ``None`` is
    the card, which raises without one.  Raises ``ValueError`` when the
    mesh's size is not the world size, and ``RuntimeError`` outside a
    process group."""
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs a process group: call "
            "maybe_init_distributed() under torchrun, or "
            "torch.distributed.init_process_group(...) first")
    shape = tuple(int(s) for s in shape)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"a mesh of shape {shape} holds {math.prod(shape)} ranks, but "
            f"the process group has {world}")
    if ranks is None:
        ranks = torch.arange(world).reshape(shape)
    dmesh = DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axis_names))
    return Mesh(dmesh, dev, transport)


def make_test_mesh(devices: Optional[Union[str, torch.device]] = None, *,
                   multi_pod: bool = False) -> Mesh:
    """The 8-rank test meshes: (2, 4) ``("data", "model")``, or with
    ``multi_pod`` (2, 2, 2) ``("pod", "data", "model")``.  ``devices`` is
    where the ranks' tensors live (``None``: the card)."""
    if multi_pod:
        return device_mesh((2, 2, 2), ("pod", "data", "model"), devices)
    return device_mesh((2, 4), ("data", "model"), devices)


def build_mesh(pods: int = 1,
               devices: Optional[Union[str, torch.device]] = None
               ) -> Optional[Mesh]:
    """The train CLI's mesh over every rank: ``None`` for one process;
    else ``model`` the largest of 16, 8, 4, 2 that divides the ranks of a
    pod (1 if none), ``data`` the rest, and with ``pods > 1`` a leading
    ``pod`` axis when the ranks divide into pods (the JAX ``build_mesh``
    picks ``model`` over all the devices first, so it has a pod axis only
    from 32 devices on)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        return None
    with_pods = pods > 1 and world % pods == 0
    per_pod = world // pods if with_pods else world
    model = next((m for m in (16, 8, 4, 2) if per_pod % m == 0), 1)
    if with_pods:
        return device_mesh((pods, per_pod // model, model),
                           ("pod", "data", "model"), devices)
    return device_mesh((per_pod // model, model), ("data", "model"),
                       devices)


def maybe_init_distributed(device: Optional[Union[str, torch.device]] = None
                           ) -> torch.device:
    """Join the process group ``torchrun`` describes (``env://``) and
    return this rank's device; with ``WORLD_SIZE`` unset, only resolve the
    device.  On the card each rank takes ``cuda:LOCAL_RANK`` modulo the
    visible cards and the group is NCCL's; ranks that share a card (more
    ranks on a host, ``LOCAL_WORLD_SIZE``, than it has cards), or CPU
    ranks, join through gloo."""
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE",
                                 os.environ["WORLD_SIZE"]))
    backend = "gloo"
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
        if on_host <= count:
            backend = "nccl"
    dist.init_process_group(backend, init_method="env://")
    return dev
