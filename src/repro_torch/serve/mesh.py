"""Mesh-sharded serving plan: bind an EngineConfig to a list of devices.

The counterpart of ``repro/serve/mesh.py``.  The paged engine keeps one
slot batch, one page table and one page pool; :class:`MeshPlan` is the
layout contract that splits all three into ``shards`` along one
``"slots"`` axis:

* **slots** — the decode batch splits into ``shards`` equal groups of
  ``slots_per_shard`` lanes; slot ``s`` lives on shard
  ``s // slots_per_shard``.  Tokens, positions, sampling lanes and
  page-table rows split the same way, so a decode step is embarrassingly
  parallel: each shard advances only its own lanes.
* **page pool** — the pool's ``phys_page`` axis splits into ``shards``
  contiguous blocks of ``block`` pages; block ``s`` is shard ``s``'s
  state, held on ``devices[s]``.  ``repro_torch.serve.cache.PagePool``
  keeps one free list a block, and the first page of every block is that
  shard's scratch page.  Page ids are global on the host; a dispatch turns
  a table row into shard-local offsets with one ``% block``
  (:meth:`local_pages`), and the unallocated sentinel 0 maps to every
  shard's local scratch page 0.
* **weights** — replicated: one copy on each distinct device.  Shards
  that share a device share its copy.

``devices`` takes the place of the JAX package's ``jax.sharding.Mesh``:
placement is the device of each shard's state, and a dispatch moves no
tensor between shards, so the JAX plan's ``PartitionSpec`` helpers
(``lane_spec``, ``replicated_spec``, ``state_specs``) have no
counterpart.  A list may name one device more than once (two shards on
one card, or on the CPU in tests); the plan never does so on its own.

Per-slot decode math does not depend on the other lanes (each lane
attends only through its own page-table row), so a sharded engine's
greedy tokens equal those of the one-shard engine serving the same
requests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["MeshPlan"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Frozen layout contract for one mesh-sharded engine.

    Built by :meth:`build` from a *resolved*
    :class:`~repro_torch.serve.config.EngineConfig`; the engine keeps it as
    ``mesh_plan`` and every sharded code path (per-shard dispatch, table
    localisation, shard-of queries) goes through it.
    """

    #: shards along the ``slots`` axis
    shards: int
    #: decode lanes per shard (``max_slots // shards``)
    slots_per_shard: int
    #: pool pages per shard block, including the block's scratch page
    block: int
    #: the device of each shard, in shard order
    devices: Tuple[torch.device, ...]

    @classmethod
    def build(cls, config, devices: Optional[Sequence[
            Union[str, torch.device]]] = None) -> "MeshPlan":
        """Bind a resolved ``EngineConfig`` to ``devices``, one a shard
        (default: the first ``mesh_shards`` visible CUDA devices).

        Raises ``ValueError`` for fewer than 2 shards, for a config that
        was not resolved to a paged engine (the pool is what shards), and
        for a ``devices`` list whose length is not ``mesh_shards``;
        ``RuntimeError`` when no list is given and fewer CUDA devices are
        visible than the config shards across."""
        shards = config.mesh_shards
        if shards < 2:
            raise ValueError(
                f"MeshPlan needs mesh_shards >= 2, got {shards} "
                f"(a single-device engine has no mesh to plan)")
        if not config.paged_kv or not config.pool_pages:
            raise ValueError(
                "MeshPlan.build needs a RESOLVED paged config "
                "(config.resolve(model_cfg) with paged_kv on) — the "
                "physical page pool is what shards across the mesh")
        if devices is None:
            visible = torch.cuda.device_count() \
                if torch.cuda.is_available() else 0
            if visible < shards:
                raise RuntimeError(
                    f"mesh_shards={shards} needs {shards} devices but only "
                    f"{visible} CUDA device(s) are visible; pass the "
                    f"shards' devices as devices=[...] (a device may be "
                    f"named more than once, e.g. ['cuda:0'] * {shards} on "
                    f"one card or ['cpu'] * {shards})")
            devs = tuple(torch.device("cuda", i) for i in range(shards))
        else:
            devs = tuple(torch.device(d) for d in devices)
            if len(devs) != shards:
                raise ValueError(
                    f"mesh_shards={shards} needs one device a shard, got "
                    f"{len(devs)} devices")
        return cls(shards=shards,
                   slots_per_shard=config.max_slots // shards,
                   block=config.pool_pages // shards + 1,
                   devices=devs)

    # --------------------------------------------------------- shard maps
    def shard_of_slot(self, slot: int) -> int:
        """The shard holding ``slot``."""
        return int(slot) // self.slots_per_shard

    def shard_of_page(self, page: int) -> int:
        """The shard whose pool block holds global physical ``page``."""
        return int(page) // self.block

    def local_pages(self, table: np.ndarray) -> np.ndarray:
        """Convert a host page table of *global* page ids to the
        shard-local offsets a shard's dispatch indexes with: one
        vectorized ``% block``.

        Sound because the engine's allocator keeps every non-zero entry
        of a slot's row in that slot's own shard block (global id ``shard
        * block + local``), and the unallocated sentinel 0 maps to local
        0, every shard's scratch page, which is where an unallocated or
        idle lane must aim."""
        table = np.asarray(table)
        return table % table.dtype.type(self.block)
