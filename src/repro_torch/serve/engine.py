"""Chunked-prefill, continuous-batching serve engine over a paged KV pool or
contiguous slots.

The counterpart of ``repro/serve/engine.py`` for one device:

* **Chunked prefill** — an admission ingests its context in pieces of at
  most ``prefill_chunk`` tokens, each padded to a power-of-two shape bucket
  (the JAX engine's pieces exactly: chunk shape changes float results, so
  parity needs the same cut).
* **Continuous batching** — the
  :class:`~repro_torch.serve.scheduler.Scheduler` admits requests into a
  fixed-width decode batch; every decode step advances all live slots at
  their own positions, and a finished slot is refilled by the next
  admission while the rest keep decoding.
* **Paged KV** — every slot maps its positions to physical pages of one
  refcounted pool through a page table; pages are allocated as writes reach
  them.  Idle lanes point their whole row at scratch page 0, which is
  re-zeroed after every admission.  Pool exhaustion reclaims retired rows
  and session snapshots least-recently-used first, then defers the
  admission (never drops it).  With ``kv_dtype`` ``"int8"`` or ``"int4"``
  the pool holds per-row codes and fp32 scales
  (:func:`~repro_torch.serve.cache.quant_state_specs`), dequantized on
  every gather and quantized on every write; the page size is audited
  against the int32 carrier at build
  (:func:`~repro_torch.models.quant_kv.assert_kv_accumulator`).
* **Contiguous slots** (``paged_kv=False``, and every state tree that
  cannot be paged) — each request owns one batch index of dense
  ``(layers, slots, max_seq, ...)`` caches: an admission resets its slot
  (:func:`~repro_torch.serve.cache.reset_slot`), and a prefix hit copies
  the whole source slot (:func:`~repro_torch.serve.cache.copy_slot`).  An
  idle lane's discarded decode write lands at the first position the
  prefix trie does not index, so a retired slot's matchable prefix
  survives.  GQA attends over the slot rows read as pages of
  ``page_size`` (the same split-K combine, and kernel, as a paged engine:
  the same tokens) or, with ``page_size`` 0, with one softmax.  Sessions
  keep their history but no page snapshot.
* **Sampling** — per-request :class:`SamplingParams` ride every dispatch
  as per-slot lanes; a request's ``n``-th token draws with
  ``fold_in(PRNGKey(seed), n)`` (:mod:`repro_torch.serve.prng`), so its
  stream is the same across restarts, slots and preemption, and a verify
  row draws at the sequential index it stands for.  A dispatch whose live
  lanes are all greedy takes the argmax alone.
* **Prefix cache** — a :class:`~repro_torch.serve.cache.PrefixTrie` indexes
  the tokens each row's pages hold, retired rows included; an admission
  whose context extends a resident prefix shares its full pages by
  reference, copies at most the partial boundary page (copy-on-write), and
  prefills only the rest.
* **Page dedup** (``page_dedup``) — full pages an admission wrote are
  hashed; a byte-identical resident page, wherever it sits, replaces the
  fresh copy by reference.
* **Sessions** — :meth:`ServeEngine.submit_turn` carries a conversation's
  history; a retiring turn snapshots its page row, so the next turn
  re-admits the history as shared pages after its slot has turned over.
* **SLO admission and overload** — earliest-deadline-first admission under
  an engine-fed cost model, preemption that rescues an at-risk request,
  and (``degrade``) the :class:`~repro_torch.serve.scheduler.DegradeLadder`:
  speculative decode off, then smaller prefill chunks, then shedding of
  hopeless pending requests.
* **Speculative decode** (``spec_k > 0``) — a prompt-lookup drafter
  (:class:`~repro_torch.serve.spec.PromptLookupDrafter`) proposes up to K
  tokens per slot from its own history, ONE ``verify_chunk`` dispatch
  scores all K+1 rows, and the longest matching prefix plus one token is
  emitted (:func:`~repro_torch.serve.spec.accept_tokens`); pages advanced
  past the accepted point are released.  Tokens equal sequential
  decode's, sampled ones too (exact-match acceptance of draws made at the
  sequential indices).
* **Tree speculative decode** (``spec_mode="tree"`` / ``"auto"``) — a
  token tree per slot (n-gram fan-out, or draft heads with
  ``spec_drafter="heads"``) verified in ONE ``verify_tree`` dispatch under
  an ancestor mask; the longest accepted root-to-leaf path is emitted
  (:func:`~repro_torch.serve.spec.accept_path`) and becomes the next
  step's chain part, so drafted rows only ever touch scratch.  ``"auto"``
  picks a chain or a tree shape per slot per step from its accept-rate
  EWMA (the Lemma-3 closed forms; decision trace in ``stats_summary``).
* **Split-K page combine** — GQA's decode, verify and prefill attention
  combine their pages through :func:`repro_torch.kernels.ops.moa_reduce`:
  on the card that is the hand-written Hopper kernel, twice per layer per
  dispatch (none on a contiguous engine with ``page_size`` 0).  MLA
  (``minicpm3-4b``) attends over its latent rows with one softmax and
  launches none.
* **Warm-up** (:meth:`ServeEngine.warmup`) — every dispatch shape once
  before any request, so first-use costs stay out of timed regions and
  SLO clocks.
* **Mesh sharding** (``mesh_shards > 1``, paged engines only) — a
  :class:`~repro_torch.serve.mesh.MeshPlan` splits the slot batch and the
  page pool into shards, each with its own pooled state on its own device
  (``devices=``; shards may share one).  Each shard's lanes decode in a
  dispatch of their own over that shard's block of pages, with the page
  table localised by ``% block``; every shard's launches are queued before
  the host reads a token.  Admission balances the shards' loads, a slot
  allocates only from its shard's block, and no page is shared across
  blocks (prefix hits, session snapshots and dedup stay inside one).  The
  greedy tokens equal those of the one-shard engine.

Dispatch is eager PyTorch (the JAX engine compiles ahead of time); the
state tensors are updated in place, and every dispatch samples on the
device and moves only the token ids to the host.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import moa_reduce as _moa
from repro_torch.models import quant_kv
from repro_torch.models.registry import serve_api
from repro_torch.serve import cache
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.mesh import MeshPlan
from repro_torch.serve.sampling import (GREEDY, SamplingParams,
                                        greedy_tokens, sample_tokens,
                                        sampling_lanes)
from repro_torch.serve.scheduler import DegradeLadder, Request, Scheduler
from repro_torch.serve.sessions import SessionStore
from repro_torch.serve.spec import (DraftHeadDrafter, NGramTreeDrafter,
                                    PromptLookupDrafter, SuffixCache,
                                    TreeDraft,
                                    accept_path, accept_tokens,
                                    expected_tokens_chain,
                                    expected_tokens_tree,
                                    per_candidate_accept, pick_shape)
from repro_torch.tree import map_tree

__all__ = ["ServeEngine", "tree_width"]

#: EWMA weight for the scheduler cost model's newest timing sample.
_COST_EWMA = 0.5

#: EWMA weight of a slot's per-candidate accept rate (slower than the
#: timing EWMA: one rejected tree must not swing the shape decision).
_ACCEPT_EWMA = 0.3

#: Accept rate assumed for a slot with no measurement yet.
_ACCEPT_PRIOR = 0.5

#: Length of the reconfigurator decision trace ``stats_summary`` keeps.
_DECISION_TRACE = 64

#: Auto mode runs a shape once anyway after it lost this many consecutive
#: decisions on a slot, so a stale losing estimate can recover.
_EXPLORE_EVERY = 16

#: Sliding-window length for the latency samples behind the percentiles.
_LATENCY_WINDOW = 4096


def tree_width(spec_k: int, nodes: int, branch: int, mode: str,
               n_heads: int = 0) -> int:
    """Row width of the tree-verify dispatch: the widest chain part plus
    the drafted-node budget.  Drafting depth is capped (``nodes //
    branch`` for the n-gram tree, ``n_heads`` for draft heads), so an
    accepted path, the next step's chain part, is at most ``depth + 1``
    tokens.  Auto mode also fits a chain-``spec_k`` shape (drafts
    ``spec_k`` nodes, accepts up to ``spec_k + 1``)."""
    d = max(1, nodes // max(branch, 1), n_heads)
    if mode == "auto":
        return max(d, spec_k) + 1 + max(nodes, spec_k)
    return d + 1 + nodes


def _buckets(chunk: int, lo: int = 8) -> Tuple[int, ...]:
    """Power-of-two prefill shape buckets up to ``chunk`` (inclusive)."""
    out, b = [], lo
    while b < chunk:
        out.append(b)
        b *= 2
    out.append(chunk)
    return tuple(out)


class ServeEngine:
    """Continuous-batching engine over one dense decoder's KV caches: a
    paged pool, or contiguous slots (``config.paged_kv``, resolved by
    :meth:`EngineConfig.resolve`).

    Args:
      cfg: model config (its ``dtype`` is the compute dtype, and the KV
        dtype of an unquantized pool).
      params: parameter dict in the JAX tree's layout, on ``device`` and in
        ``cfg.dtype`` (from :func:`repro_torch.models.common.init_params`
        or :func:`repro_torch.convert.params_from_numpy`).
      config: the engine knobs (default :class:`EngineConfig`).
      device: where the model runs; ``None`` is the card, and raises when
        there is no CUDA device.  Pass ``"cpu"`` for the plain PyTorch path.
      devices: with ``config.mesh_shards > 1``, the device of each shard
        (:meth:`MeshPlan.build`: by default the first ``mesh_shards`` CUDA
        devices, and a device may be named more than once, e.g.
        ``["cuda:0"] * 2`` on one card); the weights are copied once to
        each distinct device.  Not taken at one shard.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 config: Optional[EngineConfig] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 devices: Optional[Sequence[Union[str, torch.device]]]
                 = None):
        self.api = serve_api(cfg)
        self.device = resolve_device(device)
        ecfg = (config or EngineConfig()).resolve(cfg)
        self.config = ecfg
        self.shards = ecfg.mesh_shards
        if devices is not None and self.shards == 1:
            raise ValueError(
                "devices= names the shards' devices of a mesh engine "
                "(mesh_shards > 1); a one-shard engine takes device=")
        #: the slots mesh (None at one shard)
        self.mesh_plan = (MeshPlan.build(ecfg, devices)
                          if self.shards > 1 else None)
        #: the device of each shard's state and dispatches
        self.devices: Tuple[torch.device, ...] = (
            self.mesh_plan.devices if self.mesh_plan is not None
            else (self.device,))
        # a contiguous engine's GQA decode reads its slot rows as pages of
        # this size (0: one softmax over the whole cache)
        self.cfg = dataclasses.replace(cfg, decode_page_size=ecfg.page_size)
        self.params = params
        self.max_slots = ecfg.max_slots
        self.max_seq = ecfg.max_seq
        self.prefill_chunk = ecfg.prefill_chunk
        self.page_size = ecfg.page_size
        self.min_prefix = ecfg.min_prefix
        self.chunk_buckets = _buckets(ecfg.prefill_chunk)
        self.scheduler = Scheduler.from_config(ecfg)
        self.specs = self.api.decode_state_specs(self.cfg, ecfg.max_slots,
                                                 ecfg.max_seq)
        self.paged = ecfg.paged_kv
        self.kv_dtype = ecfg.kv_dtype
        if self.paged:
            self.max_pages = ecfg.max_seq // ecfg.page_size
            # one scratch page a shard beyond the allocatable pages (the
            # first page of each shard's block)
            num_pages = ecfg.pool_pages + self.shards
            self.pool = cache.PagePool(num_pages, shards=self.shards)
            self.pspecs = cache.paged_state_specs(self.specs, ecfg.page_size,
                                                  num_pages)
            # each shard's state holds its own block of the pool
            block_specs = cache.paged_state_specs(
                self.specs, ecfg.page_size, self.pool.block)
            if self.kv_dtype != "fp32":
                # page_size int{bits} magnitudes must sum exactly inside
                # the int32 carrier (the paper's carry math)
                quant_kv.assert_kv_accumulator(
                    ecfg.page_size, 8 if self.kv_dtype == "int8" else 4)
                self.pspecs = cache.quant_state_specs(self.pspecs,
                                                      self.kv_dtype)
                block_specs = cache.quant_state_specs(block_specs,
                                                      self.kv_dtype)
            #: the pooled state of each shard, on its device
            self.states: List[Dict[str, torch.Tensor]] = [
                cache.state_zeros(block_specs, dev) for dev in self.devices]
            #: bytes of one physical page across every leaf
            self.page_bytes = cache.state_bytes(self.pspecs) // num_pages
            # per-slot page tables of global page ids; 0 = the scratch
            # page (unallocated)
            self.table = np.zeros((ecfg.max_slots, self.max_pages),
                                  np.int64)
        else:
            self.states = [cache.state_zeros(self.specs, self.device)]
        #: the weights on each distinct device (one copy a device)
        self._params_by_device: Dict[torch.device, dict] = {}
        #: bytes one contiguous copy_slot moves (its prefix hit's cost)
        self.slot_bytes = cache.state_bytes(self.specs) // ecfg.max_slots
        # resolve() already gated prefix_cache on supports_prefix
        self.prefix = (cache.PrefixTrie(capacity=ecfg.trie_capacity)
                       if ecfg.prefix_cache else None)
        if self.prefix is not None:
            # the cost model prices a resident prefix at ~0 (a probe: it
            # must not refresh the trie's recency)
            self.scheduler.reuse_probe = self._probe_reuse
        #: content digest -> resident physical pages (page_dedup)
        self.dedup = cache.PageDedupIndex() if ecfg.page_dedup else None
        #: page-content hash, injectable so tests can force collisions (a
        #: digest match is only a candidate, confirmed byte for byte)
        self._digest_fn = (
            lambda b: hashlib.blake2b(b, digest_size=16).digest())
        #: conversation id -> accumulated history + retired page refs
        self.sessions = SessionStore()
        #: overload degrade ladder (None = every knob always as configured)
        self.ladder = DegradeLadder() if ecfg.degrade else None
        # speculative decode (resolve() turned spec_k off and spec_mode to
        # "chain" where the family cannot verify)
        self.spec_k = ecfg.spec_k
        self.spec_mode = ecfg.spec_mode
        self.spec_tree_nodes = ecfg.spec_tree_nodes
        self.spec_branch = ecfg.spec_branch
        self.spec_drafter = ecfg.spec_drafter
        self.drafter = (PromptLookupDrafter(ngram_max=ecfg.spec_ngram)
                        if ecfg.spec_k else None)
        self.tree_drafter = (NGramTreeDrafter(ngram_max=ecfg.spec_ngram)
                             if self.spec_mode != "chain" else None)
        # draft heads need trained weights; without them the n-gram tree
        # drafter serves
        self.head_drafter = None
        if self.spec_mode != "chain" and ecfg.spec_drafter == "heads" \
                and "draft_heads" in params:
            self.head_drafter = DraftHeadDrafter(
                n_heads=int(params["draft_heads"]["w1"].shape[0]))
        #: per-slot incremental suffix-lookup caches (fresh on admission)
        self._suffix_caches: Dict[int, SuffixCache] = {}
        #: per-slot count of emitted tokens not yet written to the pages
        #: (the chain part the next tree step commits; 1 after admission)
        self._spec_unwritten: Dict[int, int] = {}
        #: per-slot (H, A) draft-head candidates at the last accepted row
        self._head_preds: Dict[int, np.ndarray] = {}
        #: per-slot, per-shape ("chain" / "tree") accept-rate EWMAs
        self._slot_accept: Dict[int, Dict[str, float]] = {}
        #: per-slot decisions since each shape last ran (auto mode)
        self._shape_age: Dict[int, Dict[str, int]] = {}
        #: per-slot emitted-tokens-per-step EWMA (the scheduler's rate)
        self._slot_tps: Dict[int, float] = {}
        if self.paged:
            # eviction tie-breaks consult how many pages a victim's
            # release would actually free
            self.scheduler.freed_probe = self._freed_pages
        #: when True, every decode dispatch appends its live-lane fp32
        #: logits (a numpy array) to ``logit_trace``
        self.trace_logits = False
        self.logit_trace: List[np.ndarray] = []
        self._chunk_ewma: Optional[float] = None
        self._step_ewma: Optional[float] = None
        self._tps_ewma: Optional[float] = None
        self.reset_stats()

    def _probe_reuse(self, ctx) -> int:
        """Cost-model probe: resident-prefix length of ``ctx`` if it were
        admitted now (0 below the ``min_prefix`` reuse threshold)."""
        n = self.prefix.longest_match(ctx, touch=False)[0]
        n = min(n, max(0, len(ctx) - 1))
        return n if n >= self.min_prefix else 0

    # -------------------------------------------------- mesh-sharded layout
    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The state tree of a one-shard engine (a mesh engine keeps one a
        shard in :attr:`states`).  Setting it replaces every shard's state
        with the one value (``None`` frees them)."""
        if len(self.states) != 1:
            raise AttributeError(
                f"a {len(self.states)}-shard engine keeps one state a "
                f"shard: read engine.states[shard]")
        return self.states[0]

    @state.setter
    def state(self, value) -> None:
        self.states = [value]

    def _slot_shard(self, slot: int) -> int:
        """The mesh shard owning ``slot`` (always 0 at one shard)."""
        if self.mesh_plan is None:
            return 0
        return self.mesh_plan.shard_of_slot(slot)

    def _shard_lanes(self, shard: int) -> slice:
        """The slot lanes of ``shard``'s dispatches (all slots at one
        shard)."""
        n = self.max_slots // self.shards
        return slice(shard * n, (shard + 1) * n)

    def _local(self, pages: np.ndarray) -> np.ndarray:
        """Global page ids -> offsets into their shard's block (identity at
        one shard, where the block is the whole pool)."""
        if self.mesh_plan is None:
            return pages
        return self.mesh_plan.local_pages(pages)

    def _params_on(self, dev: torch.device) -> dict:
        """The weights on ``dev``: ``params`` itself at one shard; on a
        mesh, one copy a distinct device, made at first use (no copy
        where ``params`` already lives on ``dev``)."""
        if self.mesh_plan is None:
            return self.params
        if dev not in self._params_by_device:
            self._params_by_device[dev] = map_tree(lambda t: t.to(dev),
                                                   self.params)
        return self._params_by_device[dev]

    # ------------------------------------------------------------ stats
    def reset_stats(self) -> None:
        """Zero the engine counters and timers (the scheduler's SLO tallies
        and the cost model describe the live workload and stay)."""
        self.stats: Dict[str, float] = {
            "prefill_s": 0.0, "decode_s": 0.0,
            "prefill_tokens": 0, "decode_tokens": 0,
            "decode_steps": 0, "decode_lane_steps": 0, "occupancy_sum": 0.0,
            "admissions": 0, "evictions": 0, "preemptions": 0,
            "prefix_hits": 0, "prefix_misses": 0,
            "prefix_reused_tokens": 0, "prefix_evictions": 0,
            "prefix_bytes_copied": 0, "pages_shared": 0, "pages_cow": 0,
            "oom_deferred": 0, "hit_admit_s": 0.0, "cold_admit_s": 0.0,
            # speculative decode (all 0 with spec_k == 0): drafted and
            # accepted tokens, lanes that drafted and kept >= 1 draft,
            # pages rolled back, verify dispatches; tree dispatches and
            # the reconfigurator's shape picks (all 0 in chain mode)
            "spec_drafted": 0, "spec_accepted": 0,
            "spec_lanes_drafted": 0, "spec_lanes_hit": 0,
            "spec_pages_rolled_back": 0, "spec_steps": 0,
            "spec_tree_steps": 0, "spec_shape_chain": 0,
            "spec_shape_tree": 0,
            # page-content dedup: admissions that shared >= 1 page by
            # content, pages shared so, digest matches the bytes refuted
            "dedup_hits": 0, "dedup_pages_shared": 0,
            "dedup_hash_collisions": 0,
            # sessions: turns submitted, admissions served from a session
            # snapshot, the tokens those reused, snapshots reclaimed
            "session_turns": 0, "session_hits": 0,
            "session_reused_tokens": 0, "session_snapshot_drops": 0,
            "degrade_steps": 0, "prefill_dispatches": 0,
            # decode and verify dispatches the shards ran (decode_steps
            # at one shard; a shard with no live lane runs none)
            "decode_dispatches": 0,
            "moa_reduce_launches": 0,
        }
        #: decode lane-steps each mesh shard advanced (index = shard)
        self._shard_lane_steps = np.zeros(self.shards, np.int64)
        #: recent reconfigurator decisions (slot, accept estimates, shape)
        self._spec_decisions: Deque[Dict[str, Any]] = deque(
            maxlen=_DECISION_TRACE)
        self._step_times: Deque[float] = deque(maxlen=_LATENCY_WINDOW)
        self._admit_times: Dict[str, Deque[float]] = {
            "hit": deque(maxlen=_LATENCY_WINDOW),
            "cold": deque(maxlen=_LATENCY_WINDOW)}

    def stats_summary(self) -> Dict[str, float]:
        """The counters plus derived values: prefill and decode tok/s
        (token counts over the seconds of those dispatches, each ending in
        a device-to-host read of the sampled tokens), mean occupancy,
        prefix hit rate, *effective* prefill tok/s (reused tokens count as
        served), hit and cold admission means and medians, decode-step
        percentiles, pool usage, trie evictions, SLO and goodput tallies,
        the ladder's level, the dedup and session figures, and the
        speculative accept and draft-hit rates, accept-rate percentiles
        over the slots' EWMAs, the reconfigurator's decision trace, and the
        mesh's shard count, decode lane-steps a shard and their skew."""
        s = dict(self.stats)
        s["prefill_tok_s"] = s["prefill_tokens"] / max(s["prefill_s"], 1e-9)
        s["decode_tok_s"] = s["decode_tokens"] / max(s["decode_s"], 1e-9)
        s["mean_occupancy"] = (s["occupancy_sum"] / s["decode_steps"]
                               if s["decode_steps"] else 0.0)
        lookups = s["prefix_hits"] + s["prefix_misses"]
        s["prefix_hit_rate"] = s["prefix_hits"] / lookups if lookups else 0.0
        s["effective_prefill_tok_s"] = (
            (s["prefill_tokens"] + s["prefix_reused_tokens"])
            / max(s["prefill_s"], 1e-9))
        s["hit_admit_s_mean"] = (s["hit_admit_s"] / s["prefix_hits"]
                                 if s["prefix_hits"] else 0.0)
        s["cold_admit_s_mean"] = (s["cold_admit_s"] / s["prefix_misses"]
                                  if s["prefix_misses"] else 0.0)
        s["hit_admit_s_p50"] = (float(np.median(self._admit_times["hit"]))
                                if self._admit_times["hit"] else 0.0)
        s["cold_admit_s_p50"] = (float(np.median(self._admit_times["cold"]))
                                 if self._admit_times["cold"] else 0.0)
        s["decode_step_p50_s"] = (float(np.percentile(self._step_times, 50))
                                  if self._step_times else 0.0)
        s["decode_step_p99_s"] = (float(np.percentile(self._step_times, 99))
                                  if self._step_times else 0.0)
        s["tokens_per_step"] = (s["decode_tokens"] / s["decode_lane_steps"]
                                if s["decode_lane_steps"] else 0.0)
        s["spec_accept_rate"] = (s["spec_accepted"] / s["spec_drafted"]
                                 if s["spec_drafted"] else 0.0)
        s["spec_draft_hit_rate"] = (
            s["spec_lanes_hit"] / s["spec_lanes_drafted"]
            if s["spec_lanes_drafted"] else 0.0)
        s["spec_k"] = self.spec_k
        s["spec_mode"] = self.spec_mode
        s["spec_tree_nodes"] = self.spec_tree_nodes
        s["spec_branch"] = self.spec_branch
        s["spec_drafter"] = self.spec_drafter
        accepts = sorted(max(d.values()) for d in
                         self._slot_accept.values() if d)
        s["spec_accept_p50"] = (float(np.percentile(accepts, 50))
                                if accepts else 0.0)
        s["spec_accept_p99"] = (float(np.percentile(accepts, 99))
                                if accepts else 0.0)
        s["spec_decision_trace"] = list(self._spec_decisions)
        s["trie_evictions"] = (self.prefix.evictions
                               if self.prefix is not None else 0)
        s["pages_in_use"] = self.pool.used_count if self.paged else 0
        s["pool_pages"] = (self.pool.num_pages - self.pool.shards
                           if self.paged else 0)
        # capacity under the kv_dtype knob: the bytes of one slot's full
        # row of pages (or its contiguous slot), and of the whole state
        s["kv_dtype"] = self.kv_dtype
        s["kv_bytes_per_slot"] = (self.page_bytes * self.max_pages
                                  if self.paged else self.slot_bytes)
        s["pool_bytes"] = cache.state_bytes(
            self.pspecs if self.paged else self.specs)
        s["slo_met"] = self.scheduler.slo_met_count
        s["slo_missed"] = self.scheduler.slo_missed_count
        s["shed_requests"] = self.scheduler.shed_count
        s["goodput_tokens"] = self.scheduler.goodput_tokens
        s["goodput_tok_s"] = self.scheduler.goodput_tokens / max(
            s["prefill_s"] + s["decode_s"], 1e-9)
        s["degrade_level"] = (self.ladder.level
                              if self.ladder is not None else 0)
        s["degrade_transitions"] = (self.ladder.transitions
                                    if self.ladder is not None else 0)
        s["dedup_hit_rate"] = (s["dedup_hits"] / s["admissions"]
                               if s["admissions"] else 0.0)
        s["dedup_pages_per_hit"] = (s["dedup_pages_shared"]
                                    / s["dedup_hits"]
                                    if s["dedup_hits"] else 0.0)
        s["dedup_indexed_pages"] = (len(self.dedup)
                                    if self.dedup is not None else 0)
        s["sessions_live"] = len(self.sessions)
        # mesh shards: decode lanes each advanced, and the spread between
        # the busiest and the idlest over the busiest (0.0 = balanced)
        s["mesh_shards"] = self.shards
        lane_steps = self._shard_lane_steps
        s["shard_lane_steps"] = [int(x) for x in lane_steps]
        peak = int(lane_steps.max())
        s["shard_occupancy_skew"] = (
            float((peak - int(lane_steps.min())) / peak) if peak else 0.0)
        return s

    # ----------------------------------------------------------- submit
    def submit(self, prompt: Sequence[int], max_new: int,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               slo_ms: Optional[float] = None) -> Request:
        """Queue one generation request.

        Args:
          prompt: token ids to condition on.
          max_new: generation budget.
          eos_id: optional stop token.
          sampling: per-request :class:`SamplingParams` (``None`` =
            greedy).
          slo_ms: optional completion-latency SLO in milliseconds.

        Returns:
          The live :class:`Request` handle (its ``generated`` list fills in
          as the engine runs)."""
        return self.scheduler.submit(
            Request(prompt=list(prompt), max_new=max_new, eos_id=eos_id,
                    sampling=sampling, slo_ms=slo_ms))

    # --------------------------------------------------------- sessions
    def submit_turn(self, conv_id, tokens: Sequence[int], max_new: int,
                    eos_id: Optional[int] = None,
                    sampling: Optional[SamplingParams] = None,
                    slo_ms: Optional[float] = None) -> Request:
        """Queue one turn of conversation ``conv_id``: the prompt is the
        conversation's history (every earlier turn's prompt and reply) plus
        the new ``tokens``.  A returning conversation re-admits its history
        as shared pages from the session's snapshot — full pages by
        reference, one boundary page copy-on-write — even after every slot
        has turned over; the reply joins the history when the turn retires.
        The other arguments and the return value are :meth:`submit`'s."""
        sess = self.sessions.ensure(conv_id)
        req = self.submit(list(sess.history) + list(tokens), max_new,
                          eos_id=eos_id, sampling=sampling, slo_ms=slo_ms)
        req._conv_id = conv_id
        self.stats["session_turns"] += 1
        return req

    def end_session(self, conv_id) -> bool:
        """Drop conversation ``conv_id``: release its snapshot's page
        references (if any) and forget its history.  Returns True if the
        session existed."""
        existed = conv_id in self.sessions
        row = self.sessions.pop(conv_id)
        if row is not None:
            self._deref_row_pages(row[row != 0])
        return existed

    def _session_retire(self, req: Request, slot: int) -> None:
        """A session turn just retired out of ``slot``: fold its reply into
        the history and (paged engines) snapshot the slot's page row — one
        pool reference per page — so the history stays resident for the
        next turn.  Replaces (and releases) any previous snapshot."""
        conv = getattr(req, "_conv_id", None)
        if conv is None:
            return
        sess = self.sessions.ensure(conv)
        sess.history = req.context
        sess.turns += 1
        if not self.paged:
            return
        old = self.sessions.take_snapshot(sess)
        if old is not None:
            self._deref_row_pages(old[old != 0])
        # the positions written to the row: req.pos under sequential and
        # chain decode (the last sampled token is never written), fewer
        # under tree decode, where the last step's whole accepted path
        # retires unwritten
        covered = req.pos + 1 - self._spec_unwritten.get(slot, 1)
        npages = -(-covered // self.page_size)
        row = self.table[slot, :npages].copy()
        if covered > 0 and int((row != 0).sum()) == npages:
            self.pool.ref_many(row)
            sess.row = row
            sess.covered = covered

    def evict(self, slot: int) -> Request:
        """Preempt the live request in ``slot`` back to the pending queue
        (its re-admission re-prefills, or prefix-reuses, its context).  A
        paged slot's pages are released at once when nothing can reuse
        them."""
        self.stats["evictions"] += 1
        req = self.scheduler.evict(slot)
        if self.paged and not self._row_reusable(slot):
            self._release_row(slot)
        return req

    def _row_reusable(self, slot: int) -> bool:
        """True while a trie entry still indexes ``slot``'s pages.  Without
        one the row would be invisible to reclaim (which scans trie
        entries), so its pages would strand until the slot is reused."""
        return self.prefix is not None and \
            self.prefix.length(slot) is not None

    # ----------------------------------------------- page-table management
    def _deref_row_pages(self, pages: np.ndarray) -> int:
        """Deref ``pages`` and un-index from the dedup index every page that
        freed (an indexed page must stay resident); returns pages freed."""
        pages = np.asarray(pages)
        freed = self.pool.deref_many(pages)
        if freed and self.dedup is not None:
            for p in np.unique(pages):
                if self.pool.refcount[p] == 0:
                    self.dedup.discard(int(p))
        return freed

    def _freed_pages(self, slot: int) -> int:
        """How many pages releasing ``slot``'s row would free now: a page
        another row, a session snapshot or a dedup sharer still holds
        frees nothing."""
        row = self.table[slot]
        pages = row[row != 0]
        if not pages.size:
            return 0
        uniq, counts = np.unique(pages, return_counts=True)
        return int((self.pool.refcount[uniq] == counts).sum())

    def _release_row(self, slot: int) -> None:
        """Drop ``slot``'s page-table row: deref every mapped page (a page
        shared with another row survives) and drop its trie entry."""
        if self.prefix is not None:
            self.prefix.remove(slot)
        row = self.table[slot]
        self._deref_row_pages(row[row != 0])
        self.table[slot] = 0

    def _release_trie_evicted(self, slots) -> None:
        """Release the rows of capacity-evicted trie ``slots`` that are not
        live (their pages were kept only for reuse)."""
        for s in slots:
            if s not in self.scheduler.active:
                self._release_row(s)

    def _reclaim_pages(self, needed: int, shard: int = 0) -> None:
        """Free pages under pool pressure until ``needed`` are free in
        ``shard``'s block (or nothing reclaimable remains): first retired
        trie entries, least-recently-used first, with entries whose
        release frees no page (every page still shared) last; then session
        snapshots, least-recently-used first (the next turn re-prefills).
        Only victims whose pages live in ``shard``'s block are released:
        another block's pages cannot serve this allocation.  Live slots
        are never touched."""
        if self.prefix is not None:
            victims = [s for s in self.prefix.lru_slots()
                       if s not in self.scheduler.active
                       and self._slot_shard(s) == shard]
            victims.sort(key=lambda s: self._freed_pages(s) == 0)
            for s in victims:
                if self.pool.free_count_in(shard) >= needed:
                    return
                self._release_row(s)
                self.prefix.evictions += 1
        for sess in self.sessions.lru_snapshots():
            if self.pool.free_count_in(shard) >= needed:
                return
            if self.pool.shard_of(int(sess.row[0])) != shard:
                continue
            row = self.sessions.take_snapshot(sess)
            self._deref_row_pages(row[row != 0])
            self.sessions.drops += 1
            self.stats["session_snapshot_drops"] += 1

    def _ensure_pages(self, slot: int, start: int, end: int) -> bool:
        """Allocate physical pages covering positions ``[start, end)`` of
        ``slot``'s row from the slot's own shard block, all or nothing,
        reclaiming under pressure; False when the block is still
        exhausted."""
        first = start // self.page_size
        last = min(-(-end // self.page_size), self.max_pages)
        need = first + np.flatnonzero(self.table[slot, first:last] == 0)
        sh = self._slot_shard(slot)
        if need.size > self.pool.free_count_in(sh):
            self._reclaim_pages(int(need.size), sh)
        if need.size:
            pages = self.pool.alloc_many(int(need.size), sh)
            if pages is None:
                return False
            self.table[slot, need] = pages
        return True

    def _alloc_one(self, shard: int) -> int:
        """One fresh page of ``shard``'s block, reclaiming first when the
        block is empty; -1 when nothing can be freed."""
        if self.pool.free_count_in(shard) < 1:
            self._reclaim_pages(1, shard)
        return self.pool.alloc(shard)

    def _rollback_pages(self, slot: int, length: int) -> None:
        """Rewind ``slot``'s row after a chain step's rejection: release
        every mapped page wholly past the accepted ``length`` (they hold
        only rejected drafts, causally masked).  Sharing stops below the
        write frontier, so each release drops this row's own reference and
        refcounts stay equal to the table."""
        first = -(-length // self.page_size)
        row = self.table[slot]
        stale = first + np.flatnonzero(row[first:] != 0)
        if stale.size:
            self._deref_row_pages(row[stale])
            row[stale] = 0
            self.stats["spec_pages_rolled_back"] += int(stale.size)

    def _bind_pages(self, slot: int, src_row: Optional[np.ndarray],
                    reuse: int, end: int, *, in_place: bool = False
                    ) -> Tuple[bool, Optional[Tuple[int, int]]]:
        """Build ``slot``'s row for an admission that reuses the first
        ``reuse`` tokens held in ``src_row`` (another slot's row or a
        session snapshot), with writable pages through position ``end``:
        full prefix pages are shared by reference, the partial boundary
        page gets a fresh page to copy into, the prefill span is allocated.

        ``in_place`` marks a re-admission into the slot whose own row holds
        the prefix (``src_row`` is ignored).  Prefill is about to overwrite
        every position >= ``reuse``, and a page there with refcount > 1 is
        shared, so it is detached first: the partial boundary page by
        copy-on-write, wholly rewritten pages by a fresh page.

        Returns ``(ok, cow)``: ``cow`` is the ``(src, dst)`` boundary copy
        the caller must make before the first prefill piece (or None);
        ``ok`` is False when the pool is exhausted (the row is released and
        the admission should be deferred)."""
        ps = self.page_size
        sh = self._slot_shard(slot)
        cow = None
        nfull = 0
        if reuse and not in_place:
            self._release_row(slot)
            nfull = reuse // ps
            shared = np.asarray(src_row[:nfull])
            self.pool.ref_many(shared)
            self.table[slot, :nfull] = shared
            if reuse % ps:
                # the source page id is taken BEFORE any reclaim can free
                # src's row; its bytes stay intact until the copy (the
                # first device write of this admission) has read them
                src_b = int(src_row[nfull])
                p = self._alloc_one(sh)
                if p < 0:
                    self._release_row(slot)
                    return False, None
                self.table[slot, nfull] = p
                cow = (src_b, p)
        elif not reuse:
            self._release_row(slot)
        else:
            row = self.table[slot]
            first = reuse // ps
            for j in range(first, self.max_pages):
                p = int(row[j])
                if p == 0:
                    continue
                if self.pool.refcount[p] > 1:
                    fresh = self._alloc_one(sh)
                    if fresh < 0:
                        self._release_row(slot)
                        return False, None
                    if j == first and reuse % ps:
                        # positions [j * ps, reuse) must survive the swap
                        cow = (p, fresh)
                    row[j] = fresh
                    self._deref_row_pages(np.asarray([p]))
                elif self.dedup is not None:
                    # a kept page about to be rewritten: its index entry
                    # must go now
                    self.dedup.discard(p)
        if not self._ensure_pages(slot, reuse, end):
            self._release_row(slot)
            return False, None
        self.stats["pages_shared"] += nfull
        return True, cow

    def _scrub_scratch(self) -> None:
        """Re-zero every shard's scratch page (local page 0): an
        admission's bucket-padding and idle lanes' writes land there, and
        a masked lane reads it as ``0 * v``, which a NaN or inf would
        poison."""
        for state in self.states:
            cache.zero_page(state, self.pspecs, 0)

    # ----------------------------------------------------------- warm-up
    def warmup(self) -> None:
        """Run every dispatch shape once before any request: each prefill
        bucket, the decode step, the chain verify (``spec_k`` in chain
        mode) or the tree verify (tree and auto modes), a greedy and a
        sampled draw, and the admission's page or slot copy.  The first
        use of a kernel (its nvcc build and its load), cuBLAS's handles and
        the allocator's first blocks then never reach a timed region or an
        SLO clock.

        A paged engine runs them on all-scratch page tables, on every
        shard of a mesh, and re-zeroes scratch after.  A contiguous engine
        runs the verifies with ``nspec = 0`` (every write masked) and the
        rest on the first positions of every slot, saved before and put
        back as they were; a leaf with no sequence axis (an SSM layer's
        ``h`` and ``conv``) is saved and put back whole.  The state (a
        paged engine's scratch pages aside) and every counter are left as
        they were."""
        buckets = sorted({min(cb, self.max_seq) for cb in self.chunk_buckets})
        saved = {}
        if not self.paged:
            for name, t in self.state.items():
                axes = self.specs[name].axes
                # a positional leaf: the rows the warm-up can reach; a
                # recurrent one (SSM h / conv): whole, since every
                # dispatch rewrites every slot's
                if "kv_seq" in axes:
                    t = t.narrow(axes.index("kv_seq"), 0, buckets[-1])
                saved[name] = (t, t.clone())
        for shard, dev in enumerate(self.devices):
            self._warm_shard(shard, dev, buckets)
        if self.paged:
            self._scrub_scratch()
        for view, before in saved.values():
            view.copy_(before)
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _warm_shard(self, shard: int, dev: torch.device,
                    buckets: Sequence[int]) -> None:
        """:meth:`warmup`'s dispatches on one shard: its lanes, its state,
        its device."""
        b = self.max_slots // self.shards
        params, state = self._params_on(dev), self.states[shard]

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=dev)

        tables, table1 = {}, {}
        slot_state = state
        if self.paged:
            tables = {"pages": zeros(b, self.max_pages)}
            table1 = {"pages": zeros(1, self.max_pages)}
            if self.prefix is not None:
                cache.copy_page(state, self.pspecs, 0, 0)
        else:
            slot_state = cache.slot_slice(state, self.specs, 0)
            if self.prefix is not None:
                cache.copy_slot(state, self.specs, 0, 0)
        for cb in buckets:
            self.api.prefill_chunk(
                params, slot_state,
                {"tokens": zeros(1, cb), "index": zeros(), "nvalid": cb,
                 **table1}, self.cfg)
        logits, _ = self.api.decode_step(
            params, state,
            {"tokens": zeros(b, 1), "index": zeros(b), **tables}, self.cfg)
        self._draw(logits, None)
        self._draw(logits, sampling_lanes(
            [SamplingParams(temperature=1.0)] * b, [0] * b, dev))
        idle = zeros(b)
        if self.spec_k and self.spec_mode == "chain":
            self.api.verify_chunk(
                params, state,
                {"tokens": zeros(b, self.spec_k + 1), "index": idle,
                 "nspec": idle, **tables}, self.cfg)
        if self.spec_mode != "chain":
            cw = self._tree_width()
            # padding rows parent themselves: never anyone's ancestor
            parents = torch.arange(cw, device=dev).expand(b, cw)
            self.api.verify_tree(
                params, state,
                {"tokens": zeros(b, cw), "index": idle, "parents": parents,
                 "pos_off": zeros(b, cw), "nchain": idle, "nspec": idle,
                 **tables}, self.cfg, head_topk=self.spec_branch)

    # ---------------------------------------------------- content dedup
    def _page_views(self, page: int) -> List[torch.Tensor]:
        """ONE physical page's bytes as ``uint8`` views of every leaf, read
        from its shard's block at its local offset."""
        return cache.page_bytes(self.states[self.pool.shard_of(page)],
                                self.pspecs, page % self.pool.block)

    def _page_bytes_of(self, page: int) -> bytes:
        """The raw bytes of ONE physical page across every leaf, on the
        host (only the page leaves the device) — the unit of content
        identity the digest is taken over."""
        return b"".join(v.cpu().numpy().tobytes()
                        for v in self._page_views(page))

    def _same_bytes(self, a: int, b: int) -> bool:
        """Byte identity of physical pages ``a`` and ``b`` (of one shard),
        compared on the pool's device through integer views."""
        return all(torch.equal(x, y) for x, y in zip(
            self._page_views(a), self._page_views(b)))

    def _dedup_slot(self, slot: int, length: int) -> None:
        """Content-dedup the full pages below ``length`` that this row
        owns alone (decode can never write them).  A digest match is only
        a candidate: the share happens after a byte compare confirms it (a
        collision is counted and degrades to a miss).  On a match the fresh
        page is dropped for a reference to the resident twin; otherwise it
        is indexed for later admissions."""
        row = self.table[slot]
        shared_any = False
        for j in range(length // self.page_size):
            p = int(row[j])
            if p == 0 or self.pool.refcount[p] != 1:
                continue               # already shared: nothing to save
            digest = self._digest_fn(self._page_bytes_of(p))
            match = None
            for c in self.dedup.candidates(digest):
                if c == p:
                    continue
                if self.pool.shard_of(c) != self.pool.shard_of(p):
                    # another block's page cannot sit in this shard's row
                    continue
                if self._same_bytes(c, p):
                    match = c
                    break
                self.stats["dedup_hash_collisions"] += 1
            if match is None:
                self.dedup.insert(p, digest)
            else:
                self.pool.ref(match)
                row[j] = match
                self._deref_row_pages(np.asarray([p]))   # frees the copy
                self.stats["dedup_pages_shared"] += 1
                shared_any = True
        if shared_any:
            self.stats["dedup_hits"] += 1

    # --------------------------------------------------------- sampling
    @staticmethod
    def _lanes(sps: Sequence[SamplingParams], idxs: Sequence[int],
               dev: torch.device) -> Optional[tuple]:
        """The sampling lanes of a dispatch's rows (one
        :class:`SamplingParams` and sample index a row) on ``dev``, or
        None when every row is greedy: the argmax alone then gives the
        same tokens."""
        if all(sp.is_greedy for sp in sps):
            return None
        return sampling_lanes(sps, idxs, dev)

    @staticmethod
    def _draw(logits: torch.Tensor, lanes: Optional[tuple]) -> torch.Tensor:
        """One token a row of ``logits`` (N, V), on the device: the argmax
        without lanes, else :func:`sample_tokens`."""
        if lanes is None:
            return greedy_tokens(logits)
        return sample_tokens(logits, *lanes)

    # ------------------------------------------------------------ admit
    def _effective_chunk(self) -> int:
        """The prefill chunk cap for admissions planned now: the smallest
        shape bucket while the degrade ladder holds ``SMALL_CHUNKS`` or
        above, else ``prefill_chunk``."""
        if self.ladder is not None and \
                self.ladder.level >= DegradeLadder.SMALL_CHUNKS:
            return self.chunk_buckets[0]
        return self.prefill_chunk

    def _feed_cost_model(self, chunk_s: Optional[float] = None,
                         step_s: Optional[float] = None,
                         tokens_per_step: Optional[float] = None) -> None:
        """EWMA the newest measured prefill-chunk and decode-step times,
        and the tokens a decode step emits per live slot (1 sequential,
        more under speculative decode), into the scheduler's cost
        model."""
        if chunk_s is not None:
            self._chunk_ewma = (chunk_s if self._chunk_ewma is None else
                                (1 - _COST_EWMA) * self._chunk_ewma
                                + _COST_EWMA * chunk_s)
        if step_s is not None:
            self._step_ewma = (step_s if self._step_ewma is None else
                               (1 - _COST_EWMA) * self._step_ewma
                               + _COST_EWMA * step_s)
        if tokens_per_step is not None:
            self._tps_ewma = (tokens_per_step if self._tps_ewma is None else
                              (1 - _COST_EWMA) * self._tps_ewma
                              + _COST_EWMA * tokens_per_step)
        self.scheduler.update_cost_model(self._chunk_ewma, self._step_ewma,
                                         self._tps_ewma)

    def _pieces(self, ctx: Sequence[int], start: int = 0,
                chunk: Optional[int] = None) -> List[Tuple[int, int, int]]:
        """The prefill pieces of ``ctx`` from position ``start`` as
        ``(start, nvalid, bucket)``: at most ``chunk`` (default
        ``prefill_chunk``) tokens each, padded to the smallest shape
        bucket, the tail bucket shrunk to the cache room (a padded block
        past ``max_seq`` would clamp onto earlier positions)."""
        chunk = chunk or self.prefill_chunk
        pieces = []
        pos = start
        while pos < len(ctx):
            n = min(chunk, len(ctx) - pos)
            cb = next(b for b in self.chunk_buckets if b >= n)
            pieces.append((pos, n, min(cb, self.max_seq - pos)))
            pos += n
        return pieces

    def _admit(self, slot: int, req: Request) -> List[Request]:
        """Admit ``req`` into ``slot``: prefix-cache lookup, then page
        sharing and the boundary copy-on-write (paged) or a slot copy or
        reset (contiguous), then chunked prefill of the rest of the
        context; samples the first token.  A paged admission that finds
        the pool exhausted even after reclaim is deferred to the head of
        the queue, never dropped."""
        ctx = req.context
        sh = self._slot_shard(slot)
        # ---- prefix-cache lookup, clamped to keep >= 1 token to prefill
        # (its logits sample the first token); on a mesh only rows of the
        # slot's own shard match: a page never crosses a block
        reuse, src, removed = 0, -1, False
        if self.prefix is not None:
            allowed = (None if self.mesh_plan is None
                       else (lambda s: self._slot_shard(s) == sh))
            match_len, match_slot = self.prefix.longest_match(
                ctx, allowed=allowed)
            match_len = min(match_len, len(ctx) - 1)
            if match_len >= self.min_prefix:
                reuse, src = match_len, match_slot
            # the slot's pages are about to be overwritten: its entry must
            # stop matching now
            removed = self.prefix.remove(slot)
        # ---- a returning conversation's snapshot, when it covers more
        sess_row = None
        conv = getattr(req, "_conv_id", None)
        if self.paged and conv is not None:
            sess = self.sessions.get(conv)
            if sess is not None and sess.row is not None:
                s_reuse = min(sess.covered, len(ctx) - 1)
                if self.pool.shard_of(int(sess.row[0])) != sh:
                    # the snapshot's pages live in another shard's block
                    s_reuse = 0
                if s_reuse >= self.min_prefix and s_reuse > reuse:
                    reuse, src = s_reuse, -1
                    sess_row = sess.row
        # ---- the pieces from the reuse point (the ladder caps the chunk)
        pieces = self._pieces(ctx, reuse, self._effective_chunk())
        cow = None
        if self.paged:
            prefill_end = max(start + cb for start, _, cb in pieces)
            in_place = bool(reuse) and sess_row is None and src == slot
            row_src = sess_row if sess_row is not None else (
                self.table[src] if reuse and not in_place else None)
            ok, cow = self._bind_pages(slot, row_src, reuse, prefill_end,
                                       in_place=in_place)
            if not ok:
                if removed and src != slot:    # the entry is gone even on
                    self.stats["prefix_evictions"] += 1   # deferral
                self.stats["oom_deferred"] += 1
                self.scheduler.evict(slot)     # head of queue: deferred
                if not self.scheduler.active and not self.pool.used_count:
                    raise RuntimeError(
                        f"page pool ({self.pool.num_pages - self.pool.shards}"
                        f" pages of {self.page_size} tokens"
                        + (f", {self.pool.shards} shard blocks"
                           if self.pool.shards > 1 else "")
                        + f") cannot hold a single request of "
                        f"{len(ctx)} context tokens")
                return []
        # ---- committed: account the lookup (session reuse is tallied on
        # its own; the trie counters mean "the trie found or missed it")
        if sess_row is not None:
            self.stats["session_hits"] += 1
            self.stats["session_reused_tokens"] += reuse
        if self.prefix is not None:
            if reuse and sess_row is None:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_reused_tokens"] += reuse
            elif not reuse:
                self.stats["prefix_misses"] += 1
            if removed and src != slot:
                self.stats["prefix_evictions"] += 1
        # every piece's inputs go to the device before the timer starts; a
        # prefill runs on the slot's shard alone (its state, its device,
        # its row localised into its block); a contiguous prefill on the
        # slot's own rows (views, so its writes land in the state)
        dev = self.devices[sh]
        extra, state = {}, self.states[sh]
        if self.paged:
            extra = {"pages": torch.as_tensor(
                self._local(self.table[slot])[None], device=dev)}
        else:
            state = cache.slot_slice(state, self.specs, slot)
        batches = []
        for start, nvalid, cb in pieces:
            toks = np.zeros((1, cb), np.int64)
            toks[0, :nvalid] = ctx[start:start + nvalid]
            batches.append({"tokens": torch.as_tensor(toks, device=dev),
                            "index": torch.tensor(start, device=dev),
                            "nvalid": nvalid, **extra})
        # the first token continues the request's sample stream (a
        # re-admission draws at the index its tokens so far reach)
        lanes = self._lanes([req.sampling or GREEDY], [len(req.generated)],
                            dev)
        params = self._params_on(dev)
        launches0 = _moa.LAUNCHES
        t0 = time.perf_counter()
        if cow is not None:
            # copy-on-write: ONE boundary page, before any prefill write,
            # inside the shard's block
            cache.copy_page(self.states[sh], self.pspecs,
                            *(int(p) for p in self._local(np.asarray(cow))))
            self.stats["prefix_bytes_copied"] += self.page_bytes
            self.stats["pages_cow"] += 1
        elif not self.paged and reuse and src != slot:
            # the whole source slot, positions past the prefix included
            # (masked, and overwritten by the prefill in order)
            cache.copy_slot(self.state, self.specs, src, slot)
            self.stats["prefix_bytes_copied"] += self.slot_bytes
        elif not self.paged and not reuse:
            cache.reset_slot(self.state, self.specs, slot)
        # (contiguous reuse in the slot itself: the rows are there already)
        for batch in batches:
            logits, _ = self.api.prefill_chunk(params, state, batch,
                                               self.cfg)
        first = int(self._draw(logits, lanes)[0])
        dt = time.perf_counter() - t0
        self.stats["moa_reduce_launches"] += _moa.LAUNCHES - launches0
        self.stats["prefill_s"] += dt
        self.stats["prefill_tokens"] += len(ctx) - reuse
        self.stats["prefill_dispatches"] += len(pieces)
        self.stats["admissions"] += 1
        if self.prefix is not None:
            self.stats["hit_admit_s" if reuse else "cold_admit_s"] += dt
            self._admit_times["hit" if reuse else "cold"].append(dt)
        if self.paged:
            self._scrub_scratch()
        if not reuse:
            # only a cold admission prices a whole prefill chunk
            self._feed_cost_model(chunk_s=dt / max(1, len(pieces)))
        self.scheduler.on_prefill(req, first)
        if self.drafter is not None:
            # fresh speculative state for the slot's new occupant: one
            # unwritten token (the first sample), a cold suffix cache, no
            # accept or head history
            self._spec_unwritten[slot] = 1
            self._suffix_caches[slot] = self.drafter.make_cache()
            self._head_preds.pop(slot, None)
            self._slot_accept.pop(slot, None)
            self._shape_age.pop(slot, None)
            self._slot_tps.pop(slot, None)
        if self.prefix is not None:
            # the pages now hold exactly ctx (the first sampled token is
            # written by the next decode step)
            evicted = self.prefix.insert(slot, ctx)
            if self.paged:
                self._release_trie_evicted(evicted)
        if self.dedup is not None:
            self._dedup_slot(slot, len(ctx))
        if req.slot is None:                   # retired on its first token
            self._session_retire(req, slot)
            if self.paged and not self._row_reusable(slot):
                self._release_row(slot)
            return [req]
        return []

    # ------------------------------------------------------------- step
    def _decode_once(self) -> List[Request]:
        """One batched decode step over every live slot (idle lanes run
        with token 0, their outputs discarded: paged, at position 0 on an
        all-scratch row; contiguous, in their own slot at the first
        position the prefix trie does not index)."""
        if self.paged:
            # each live slot's write page; a slot that cannot get one even
            # after reclaim is evicted back to the queue (deferred, not
            # dropped)
            for slot, req in list(self.scheduler.active.items()):
                if not self._ensure_pages(slot, req.pos, req.pos + 1):
                    self.evict(slot)
                    self.stats["oom_deferred"] += 1
            if not self.scheduler.active:
                return []
        tokens = np.zeros((self.max_slots, 1), np.int64)
        positions = np.zeros((self.max_slots,), np.int64)
        sps = [GREEDY] * self.max_slots
        sidx = [0] * self.max_slots
        live = list(self.scheduler.active)
        for slot in live:
            req = self.scheduler.active[slot]
            tokens[slot, 0] = req.generated[-1]
            positions[slot] = req.pos
            sps[slot] = req.sampling or GREEDY
            sidx[slot] = len(req.generated)
        if not self.paged and self.prefix is not None:
            # an idle lane's discarded write lands in its own slot: aim it
            # at the first position the trie does not index, so a retired
            # slot's matchable prefix survives until the slot is reused
            for slot in range(self.max_slots):
                if slot in self.scheduler.active:
                    continue
                n = self.prefix.length(slot)
                if n is None:
                    continue
                if n >= self.max_seq:          # a full row: nowhere safe
                    self.prefix.remove(slot)
                    self.stats["prefix_evictions"] += 1
                else:
                    positions[slot] = n
        occ = self.scheduler.occupancy
        nxt, _, dt = self._dispatch(
            lambda params, state, batch: self.api.decode_step(
                params, state, batch, self.cfg),
            live, tokens, positions, sps, sidx)
        self.stats["decode_s"] += dt
        self.stats["decode_tokens"] += len(live)
        self.stats["decode_steps"] += 1
        self.stats["decode_lane_steps"] += len(live)
        self.stats["occupancy_sum"] += occ
        self._step_times.append(dt)
        self._feed_cost_model(step_s=dt, tokens_per_step=1.0)
        if self.prefix is not None:
            # this step wrote each live slot's fed token into its pages
            for slot in live:
                self.prefix.extend(slot, int(tokens[slot, 0]))
        reqs = {s: self.scheduler.active[s] for s in live}
        done = self.scheduler.on_decode({s: int(nxt[s, 0]) for s in live})
        for slot in live:
            if slot not in self.scheduler.active:
                # a retiring session turn snapshots its row before any
                # release can free it; a row nothing can reuse goes now
                self._session_retire(reqs[slot], slot)
                if self.paged and not self._row_reusable(slot):
                    self._release_row(slot)
        return done

    # ----------------------------------------------- speculative decode
    def _truncate_emitted(self, req: Request, emitted: List[int]
                          ) -> List[int]:
        """Clip a slot's emitted tokens at its retire point: sequential
        decode never samples past ``eos_id`` or the ``max_new`` budget."""
        out: List[int] = []
        room = req.remaining
        for t in emitted:
            if room <= 0:
                break
            out.append(t)
            room -= 1
            if req.eos_id is not None and t == req.eos_id:
                break
        return out

    def _update_slot_accept(self, slot: int, shape: str, successes: int,
                            trials: int, mean_branch: float) -> None:
        """Fold one step's acceptance into ``slot``'s per-candidate accept
        EWMA for ``shape`` (``mean_branch`` > 1 turns a tree step's
        per-level rate back into a per-candidate one).  The first
        observation blends with the prior too: a rate of 0 would never be
        picked again, so it could never heal."""
        if trials <= 0:
            return
        p = per_candidate_accept(successes, trials, mean_branch)
        per = self._slot_accept.setdefault(slot, {})
        prev = per.get(shape, _ACCEPT_PRIOR)
        per[shape] = (1 - _ACCEPT_EWMA) * prev + _ACCEPT_EWMA * p

    def _feed_slot_rate(self, slot: int, rate: float) -> None:
        """EWMA ``slot``'s expected emitted tokens per step (the Lemma-3
        closed form at its own accept estimate) into the scheduler's
        per-slot rate."""
        prev = self._slot_tps.get(slot)
        r = (rate if prev is None
             else (1 - _COST_EWMA) * prev + _COST_EWMA * rate)
        self._slot_tps[slot] = r
        self.scheduler.slot_tokens_per_step[slot] = max(1.0, r)

    def _batch(self, shard: int, tokens: np.ndarray, positions: np.ndarray,
               **rows: np.ndarray) -> Dict[str, torch.Tensor]:
        """A decode or verify dispatch's inputs for ``shard``'s lanes, on
        its device: the fed ``tokens``, each slot's ``index``, the per-row
        ``rows`` (``nspec``, a tree's ``parents`` ...) and, on a paged
        engine, the page table localised into the shard's block: live
        slots' rows, idle lanes all scratch."""
        lanes, dev = self._shard_lanes(shard), self.devices[shard]
        batch = {"tokens": torch.as_tensor(tokens[lanes], device=dev),
                 "index": torch.as_tensor(positions[lanes], device=dev)}
        batch.update((k, torch.as_tensor(v[lanes], device=dev))
                     for k, v in rows.items())
        if self.paged:
            disp = np.zeros((lanes.stop - lanes.start, self.max_pages),
                            np.int64)
            for slot in self.scheduler.active:
                if lanes.start <= slot < lanes.stop:
                    disp[slot - lanes.start] = self.table[slot]
            batch["pages"] = torch.as_tensor(self._local(disp), device=dev)
        return batch

    def _dispatch(self, call, live: List[int], tokens: np.ndarray,
                  positions: np.ndarray, sps: Sequence[SamplingParams],
                  sidx: Sequence[int], **rows: np.ndarray
                  ) -> Tuple[np.ndarray, List[Tuple[slice, tuple]], float]:
        """One decode or verify dispatch on every shard that holds a live
        lane (all slots at one shard), timed.

        ``tokens`` is the (B, W) fed block, ``sps`` / ``sidx`` one sampling
        lane a row (slot-major, B * W), ``rows`` the per-slot extras;
        ``call(params, state, batch)`` runs the model entry point and
        returns its outputs, logits first and the state last.  Each
        shard's inputs reach its device before the timer starts, and every
        shard's launches are queued before the host reads any token, so
        shards on distinct devices overlap.  With ``trace_logits`` the
        live lanes' logits join ``logit_trace`` in ``live`` order.

        Returns (the (B, W) drawn tokens on the host, idle lanes 0; each
        dispatched shard's lanes and outputs; seconds)."""
        w = tokens.shape[1]
        shards = sorted({self._slot_shard(s) for s in live})
        plans = []
        for sh in shards:
            lanes, dev = self._shard_lanes(sh), self.devices[sh]
            r = slice(lanes.start * w, lanes.stop * w)
            plans.append((sh, lanes, self._params_on(dev),
                          self._batch(sh, tokens, positions, **rows),
                          self._lanes(sps[r], sidx[r], dev)))
        launches0 = _moa.LAUNCHES
        t0 = time.perf_counter()
        outs, drawn = [], []
        for sh, lanes, params, batch, lanes_s in plans:
            out = call(params, self.states[sh], batch)
            self.states[sh] = out[-1]
            n = lanes.stop - lanes.start
            drawn.append(self._draw(out[0].reshape(n * w, -1), lanes_s))
            outs.append((lanes, out))
        nxt = np.zeros(tokens.shape, np.int64)
        for (lanes, _), d in zip(outs, drawn):
            nxt[lanes] = d.reshape(-1, w).cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["moa_reduce_launches"] += _moa.LAUNCHES - launches0
        self.stats["decode_dispatches"] += len(plans)
        for slot in live:
            self._shard_lane_steps[self._slot_shard(slot)] += 1
        if self.trace_logits:
            rows_of = {}
            for lanes, out in outs:
                mine = [s for s in live if lanes.start <= s < lanes.stop]
                got = out[0][[s - lanes.start for s in mine]].cpu().numpy()
                rows_of.update(zip(mine, got))
            self.logit_trace.append(np.stack([rows_of[s] for s in live]))
        return nxt, outs, dt

    def _spec_decode_once(self) -> List[Request]:
        """One chain speculative step over every live slot: draft up to
        ``spec_k`` tokens per slot by prompt lookup over its history (its
        incremental suffix cache), verify all K+1 rows in ONE
        ``verify_chunk`` dispatch, emit each slot's longest matching draft
        prefix plus one token, then release the pages past the accepted
        point.  Idle lanes run with ``nspec == 0``: every write masked."""
        k = self.spec_k
        drafts: Dict[int, List[int]] = {}
        for slot, req in self.scheduler.active.items():
            # a draft past the cache or the budget could never be emitted
            kd = min(k, self.max_seq - req.pos - 1, req.remaining - 1)
            sc = self._suffix_caches.get(slot)
            if kd <= 0:
                drafts[slot] = []
            elif sc is not None:
                drafts[slot] = self.drafter.propose_cached(
                    sc, req.context, kd)
            else:
                drafts[slot] = self.drafter.propose(req.context, kd)
        for slot, req in list(self.scheduler.active.items()):
            end = req.pos + 1 + len(drafts[slot])
            if self.paged and not self._ensure_pages(slot, req.pos, end):
                # not even the draft-free step fits: defer, not drop
                drafts[slot] = []
                if not self._ensure_pages(slot, req.pos, req.pos + 1):
                    self.evict(slot)
                    self.stats["oom_deferred"] += 1
        if not self.scheduler.active:
            return []
        b = self.max_slots
        tokens = np.zeros((b, k + 1), np.int64)
        positions = np.zeros((b,), np.int64)
        nspec = np.zeros((b,), np.int64)     # idle lanes: writes masked
        # row j of a slot draws at sample index len(generated) + j: the
        # draw sequential decode makes there
        sps = [GREEDY] * (b * (k + 1))
        sidx = [0] * (b * (k + 1))
        for slot, req in self.scheduler.active.items():
            d = drafts[slot]
            tokens[slot, 0] = req.generated[-1]
            tokens[slot, 1:1 + len(d)] = d
            positions[slot] = req.pos
            nspec[slot] = 1 + len(d)
            for j in range(k + 1):
                sps[slot * (k + 1) + j] = req.sampling or GREEDY
                sidx[slot * (k + 1) + j] = len(req.generated) + j
        occ = self.scheduler.occupancy
        live = list(self.scheduler.active)
        nxt, _, dt = self._dispatch(
            lambda params, state, batch: self.api.verify_chunk(
                params, state, batch, self.cfg),
            live, tokens, positions, sps, sidx, nspec=nspec)

        emitted: Dict[int, List[int]] = {}
        n_emitted = 0
        for slot in live:
            req = self.scheduler.active[slot]
            d = drafts[slot]
            toks, accepted = accept_tokens(nxt[slot], d)
            toks = self._truncate_emitted(req, toks)
            emitted[slot] = toks
            n_emitted += len(toks)
            self.stats["spec_drafted"] += len(d)
            self.stats["spec_accepted"] += accepted
            if d:
                self.stats["spec_lanes_drafted"] += 1
                if accepted:
                    self.stats["spec_lanes_hit"] += 1
                # candidates tested: the accepted prefix and the first
                # mismatch, if the walk stopped inside the draft
                self._update_slot_accept(
                    slot, "chain", accepted,
                    accepted + (1 if accepted < len(d) else 0), 1.0)
            p = self._slot_accept.get(slot, {}).get("chain")
            if p is not None:
                self._feed_slot_rate(slot, expected_tokens_chain(p, k))
        self.stats["decode_s"] += dt
        self.stats["decode_tokens"] += n_emitted
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        self.stats["decode_lane_steps"] += len(live)
        self.stats["occupancy_sum"] += occ
        self._step_times.append(dt)
        self._feed_cost_model(step_s=dt,
                              tokens_per_step=n_emitted / len(live))
        if self.prefix is not None:
            # the step wrote each slot's fed-and-kept tokens: the last
            # sampled token and its accepted draft prefix
            for slot in live:
                for t in ([int(tokens[slot, 0])]
                          + drafts[slot][:len(emitted[slot]) - 1]):
                    self.prefix.extend(slot, t)
        new_len = {slot: int(positions[slot]) + len(emitted[slot])
                   for slot in live}
        reqs = {s: self.scheduler.active[s] for s in live}
        done = self.scheduler.on_decode_tokens(emitted)
        for slot in live:
            if self.paged:
                # rewind: rejected-draft pages past the accepted frontier
                # (dense rows past it are masked until overwritten)
                self._rollback_pages(slot, new_len[slot])
            if slot not in self.scheduler.active:
                # snapshot after the rollback: the row maps exactly the
                # accepted positions
                self._session_retire(reqs[slot], slot)
                if self.paged and not self._row_reusable(slot):
                    self._release_row(slot)
        return done

    def _tree_width(self) -> int:
        """Row width of this engine's tree-verify dispatch
        (:func:`tree_width`)."""
        return tree_width(self.spec_k, self.spec_tree_nodes,
                          self.spec_branch, self.spec_mode,
                          self.head_drafter.n_heads
                          if self.head_drafter is not None else 0)

    def _tree_decode_once(self, draft: bool = True) -> List[Request]:
        """One tree speculative step over every live slot.

        A slot's fed block is its chain part (the ``_spec_unwritten``
        tokens the previous step accepted but did not write, committed at
        ``[index, index + u)``), then its drafted tree, whose rows reach
        only the attended view and scratch: a rejected branch needs no
        rollback.  The longest accepted root-to-leaf path is emitted and
        becomes the next step's chain part.  ``draft=False`` (the ladder's
        ``SPEC_OFF``) runs the dispatch with no drafted node, which still
        writes the chain part.  In ``"auto"`` mode each slot's accept
        EWMAs price the Lemma-3 closed forms and pick a chain-``spec_k``
        or a tree shape per step; both run in the same dispatch."""
        branch = self.spec_branch
        heads = self.head_drafter
        cw = self._tree_width()
        trees: Dict[int, Optional[TreeDraft]] = {}
        shapes: Dict[int, str] = {}
        u_map: Dict[int, int] = {}
        # the chain part is emitted already and cannot shrink: a slot that
        # cannot page it is evicted (deferred); drafted rows need no pages
        for slot, req in list(self.scheduler.active.items()):
            u = self._spec_unwritten.get(slot, 1)
            index = req.pos + 1 - u
            if self.paged and not self._ensure_pages(slot, index, index + u):
                self.evict(slot)
                self._spec_unwritten.pop(slot, None)
                self.stats["oom_deferred"] += 1
        if not self.scheduler.active:
            return []

        # ---- drafting and the per-slot shape decision
        for slot, req in self.scheduler.active.items():
            u = self._spec_unwritten.get(slot, 1)
            u_map[slot] = u
            index = req.pos + 1 - u
            room = self.max_seq - index - u    # cache rows left for drafts
            max_depth = min(req.remaining - 1, room)
            nodes = min(self.spec_tree_nodes, room, cw - u)
            tree: Optional[TreeDraft] = None
            if draft and nodes > 0 and max_depth > 0:
                acc = self._slot_accept.get(slot, {})
                p_chain = acc.get("chain", _ACCEPT_PRIOR)
                p_tree = acc.get("tree", _ACCEPT_PRIOR)
                shape = "tree"
                kd = min(self.spec_k, room, max_depth, cw - u)
                if self.spec_mode == "auto":
                    # one dispatch either way: the decision is on expected
                    # emitted tokens alone, each shape at its own estimate
                    shape = pick_shape(p_chain, p_tree, kd, nodes, branch)
                    other = "tree" if shape == "chain" else "chain"
                    age = self._shape_age.setdefault(
                        slot, {"chain": 0, "tree": 0})
                    explore = age[other] >= _EXPLORE_EVERY
                    if explore:
                        shape = other
                    age[shape] = 0
                    age["tree" if shape == "chain" else "chain"] += 1
                    self.stats[f"spec_shape_{shape}"] += 1
                    rec = {"slot": slot, "accept_chain": round(p_chain, 4),
                           "accept_tree": round(p_tree, 4), "shape": shape}
                    if explore:
                        rec["explore"] = True
                    self._spec_decisions.append(rec)
                sc = self._suffix_caches.get(slot)
                if shape == "chain":
                    d = (self.drafter.propose_cached(sc, req.context, kd)
                         if sc is not None
                         else self.drafter.propose(req.context, kd))
                    tree = TreeDraft.chain(tuple(d)) if d else None
                elif heads is not None and slot in self._head_preds:
                    tree = heads.propose_tree(self._head_preds[slot],
                                              nodes, branch, max_depth)
                elif sc is not None:
                    # depth capped at nodes // branch, so the budget buys
                    # hedges instead of one rank-0 spine
                    tree = self.tree_drafter.propose_tree(
                        sc, req.context, nodes, branch,
                        min(max_depth, max(1, nodes // branch)))
                if tree is not None and tree.n == 0:
                    tree = None
                shapes[slot] = shape
            trees[slot] = tree

        # ---- the (B, C) block
        b = self.max_slots
        tokens = np.zeros((b, cw), np.int64)
        # padding rows parent themselves: never an ancestor of a valid row
        parents = np.broadcast_to(np.arange(cw, dtype=np.int64),
                                  (b, cw)).copy()
        pos_off = np.zeros((b, cw), np.int64)
        positions = np.zeros((b,), np.int64)
        nchain = np.zeros((b,), np.int64)    # idle lanes: writes masked
        nspec = np.zeros((b,), np.int64)
        for slot, req in self.scheduler.active.items():
            u = u_map[slot]
            ctx = req.context
            tokens[slot, :u] = ctx[len(ctx) - u:]
            parents[slot, 0] = -1
            parents[slot, 1:u] = np.arange(u - 1)
            pos_off[slot, :u] = np.arange(u)
            tree = trees[slot]
            n = tree.n if tree is not None else 0
            if n:
                tokens[slot, u:u + n] = tree.tokens
                parents[slot, u:u + n] = [u - 1 if p < 0 else u + p
                                          for p in tree.parents]
                pos_off[slot, u:u + n] = [u - 1 + d for d in tree.depths]
            positions[slot] = req.pos + 1 - u
            nchain[slot] = u
            nspec[slot] = u + n
        # row j draws at len(generated) + pos_off[j] - (u - 1): the anchor
        # (the last chain row) at the next sequential index, a depth-d node
        # at d past it, so an accepted path's draws are the sequential
        # ones; chain rows before the anchor redraw emitted indices
        # (clamped at 0) and are discarded
        sps = [GREEDY] * (b * cw)
        sidx = [0] * (b * cw)
        for slot, req in self.scheduler.active.items():
            base = len(req.generated) - (u_map[slot] - 1)
            for j in range(cw):
                sps[slot * cw + j] = req.sampling or GREEDY
                sidx[slot * cw + j] = max(base + int(pos_off[slot, j]), 0)
        occ = self.scheduler.occupancy
        live = list(self.scheduler.active)
        nxt, outs, dt = self._dispatch(
            lambda params, state, batch: self.api.verify_tree(
                params, state, batch, self.cfg, head_topk=branch),
            live, tokens, positions, sps, sidx, parents=parents,
            pos_off=pos_off, nchain=nchain, nspec=nspec)
        head_np = None
        if heads is not None:
            # each shard's head candidates back in slot order
            for lanes, (_, head_top, _) in outs:
                top = head_top.cpu().numpy()
                if head_np is None:
                    head_np = np.zeros((b,) + top.shape[1:], top.dtype)
                head_np[lanes] = top

        # ---- the longest accepted root-to-leaf path per slot
        emitted: Dict[int, List[int]] = {}
        n_emitted = 0
        for slot in live:
            req = self.scheduler.active[slot]
            u = u_map[slot]
            tree = trees[slot]
            if tree is not None:
                sampled = [int(nxt[slot, u - 1])] + [
                    int(nxt[slot, u + i]) for i in range(tree.n)]
                toks, path = accept_path(sampled, tree)
            else:
                toks, path = [int(nxt[slot, u - 1])], []
            toks = self._truncate_emitted(req, toks)
            emitted[slot] = toks
            n_emitted += len(toks)
            n = tree.n if tree is not None else 0
            self.stats["spec_drafted"] += n
            self.stats["spec_accepted"] += len(path)
            if n:
                self.stats["spec_lanes_drafted"] += 1
                if path:
                    self.stats["spec_lanes_hit"] += 1
                # per accepted level the walk tested |children| candidates,
                # plus the last level it failed at, if that had any
                kids: Dict[int, int] = {}
                for par in tree.parents:
                    kids[par] = kids.get(par, 0) + 1
                levels = []
                cur = -1
                for node in path:
                    levels.append(kids.get(cur, 0))
                    cur = node
                fail = 1 if kids.get(cur, 0) else 0
                if fail:
                    levels.append(kids[cur])
                if levels:
                    self._update_slot_accept(
                        slot, shapes.get(slot, "tree"), len(path),
                        len(path) + fail, sum(levels) / len(levels))
            acc = self._slot_accept.get(slot, {})
            rates = []
            if "tree" in acc:
                rates.append(expected_tokens_tree(
                    acc["tree"], self.spec_tree_nodes, branch))
            if "chain" in acc and self.spec_mode == "auto":
                rates.append(expected_tokens_chain(acc["chain"],
                                                   self.spec_k))
            if rates:
                # auto mode runs the better-priced shape next step
                self._feed_slot_rate(slot, max(rates))
            if head_np is not None:
                # head candidates at the last accepted row seed the next
                # step's tree
                r_star = (u - 1 if len(toks) <= 1
                          else u + path[len(toks) - 2])
                self._head_preds[slot] = head_np[slot, r_star]

        self.stats["decode_s"] += dt
        self.stats["decode_tokens"] += n_emitted
        self.stats["decode_steps"] += 1
        self.stats["spec_steps"] += 1
        self.stats["spec_tree_steps"] += 1
        self.stats["decode_lane_steps"] += len(live)
        self.stats["occupancy_sum"] += occ
        self._step_times.append(dt)
        self._feed_cost_model(step_s=dt,
                              tokens_per_step=n_emitted / len(live))
        if self.prefix is not None:
            # this step wrote each live slot's chain part
            for slot in live:
                for t in tokens[slot, :u_map[slot]]:
                    self.prefix.extend(slot, int(t))
        reqs = {s: self.scheduler.active[s] for s in live}
        done = self.scheduler.on_decode_tokens(emitted)
        for slot in live:
            # the accepted path is the next step's chain part
            self._spec_unwritten[slot] = max(1, len(emitted[slot]))
            if slot not in self.scheduler.active:
                self._session_retire(reqs[slot], slot)
                self._head_preds.pop(slot, None)
                if self.paged and not self._row_reusable(slot):
                    self._release_row(slot)
        return done

    def step(self) -> List[Request]:
        """One engine iteration: the degrade ladder's observation (when
        ``degrade`` is on; at ``SHED`` hopeless pending requests are
        retired with a reason), the preemption check, admissions into free
        slots (chunked prefill each), then one batched decode step shared
        by all live slots: speculative when ``spec_k`` is set and the
        ladder is below ``SPEC_OFF``, sequential otherwise (tree and auto
        modes verify with no drafted node instead, which still writes each
        slot's unwritten chain part).  Returns the requests that finished
        during this iteration, shed ones included."""
        finished: List[Request] = []
        if self.ladder is not None:
            level = self.ladder.observe(self.scheduler.slo_pressure())
            if level:
                self.stats["degrade_steps"] += 1
            if level >= DegradeLadder.SHED:
                finished += self.scheduler.shed_hopeless()
        victim = self.scheduler.maybe_preempt()
        if victim is not None:
            self.evict(victim)
            self.stats["preemptions"] += 1
        for slot, req in self.scheduler.admissions():
            finished += self._admit(slot, req)
        if self.scheduler.active:
            spec_on = self.spec_k and not (
                self.ladder is not None
                and self.ladder.level >= DegradeLadder.SPEC_OFF)
            if self.spec_mode != "chain":
                finished += self._tree_decode_once(draft=bool(spec_on))
            elif spec_on:
                finished += self._spec_decode_once()
            else:
                finished += self._decode_once()
        return finished

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drain all submitted work; returns finished requests in
        completion order. ``max_steps`` bounds engine iterations."""
        finished: List[Request] = []
        steps = 0
        while self.scheduler.has_work:
            if max_steps is not None and steps >= max_steps:
                break
            finished += self.step()
            steps += 1
        return finished
