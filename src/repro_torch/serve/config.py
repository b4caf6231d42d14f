"""Typed serve-engine configuration (counterpart of ``repro/serve/config.py``).

:class:`EngineConfig` holds every knob of the serve engine, field for field
the JAX config's, with its defaults, its docs (field metadata) and its
validation messages, so one value describes an engine in either package:

* :meth:`EngineConfig.validate` — the model-independent constraints,
  pure host-side Python;
* :meth:`EngineConfig.resolve` — the model-dependent resolution: the auto
  page size, paged allocation (``paged_kv``: on where the state tree is
  pageable, else contiguous slots), the family gates of speculative decode
  and the prefix cache, the quantization and dedup fallbacks of a
  contiguous engine, and the default pool size;
* :meth:`EngineConfig.replace` / :meth:`EngineConfig.to_dict` — sweep
  points and their record;
* :func:`add_cli_args` / :func:`config_from_args` — the one argparse
  binding of every serve CLI;
* :func:`knob_table_md` — the knob table, generated from the field docs.

``mesh_shards`` above 1 shards a paged engine's slot batch and page pool
(:class:`~repro_torch.serve.mesh.MeshPlan`); a contiguous engine is
refused at resolution, as in the JAX config.
"""
from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import Optional, Tuple

from repro_torch.models.quant_kv import KV_DTYPES

__all__ = ["EngineConfig", "KV_DTYPES", "SPEC_MODES", "SPEC_DRAFTERS",
           "auto_page_size", "knob_table_md", "add_cli_args",
           "config_from_args"]

#: speculative topologies: a linear K-token draft, a token tree verified
#: under an ancestor mask, or a per-slot per-step choice between the two
SPEC_MODES: Tuple[str, ...] = ("chain", "tree", "auto")

#: tree drafters: suffix-lookup n-gram fan-out, or trained draft heads
SPEC_DRAFTERS: Tuple[str, ...] = ("ngram", "heads")


def auto_page_size(max_seq: int) -> int:
    """Largest power-of-two page in [16, 128] that divides ``max_seq`` and
    leaves at least two pages (a 1-page split-K combine is a no-op)."""
    for p in (128, 64, 32, 16):
        if max_seq % p == 0 and max_seq // p >= 2:
            return p
    return 0


def _knob(default, doc: str):
    """Dataclass field carrying its knob-table ``doc`` line (and CLI help)
    as metadata; ``default`` is the engine default."""
    return field(default=default, metadata={"doc": doc})


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The serve engine's complete knob space as one typed, frozen value,
    field for field the JAX package's ``EngineConfig``.

    Field defaults are the engine defaults; ``None`` means *auto* for
    ``page_size`` / ``paged_kv`` / ``pool_pages`` (resolved against a
    model config by :meth:`resolve`) and *unbounded* for
    ``trie_capacity``.  Each field's ``doc`` metadata is its row of
    :func:`knob_table_md`.
    """

    max_slots: int = _knob(
        4, "decode batch width (concurrent requests)")
    max_seq: int = _knob(
        128, "per-slot cache capacity (context + generated tokens)")
    prefill_chunk: int = _knob(
        32, "max tokens per prefill dispatch (shape buckets are powers "
           "of two up to it)")
    page_size: Optional[int] = _knob(
        None, "KV page for the split-K decode combine and the paged "
              "allocator (`None` auto, `0` dense; must divide `max_seq`)")
    prefix_cache: bool = _knob(
        True, "enable prefix reuse (auto-off for non-positional state)")
    min_prefix: int = _knob(
        8, "smallest resident-prefix match worth reusing")
    paged_kv: Optional[bool] = _knob(
        None, "paged allocation (`None` auto, `False` contiguous "
              "copy_slot)")
    pool_pages: Optional[int] = _knob(
        None, "physical page-pool size (`None` = one full row per slot; "
              "smaller overcommits)")
    trie_capacity: Optional[int] = _knob(
        None, "LRU bound on prefix-trie entries (`None` = unbounded)")
    spec_k: int = _knob(
        0, "speculative draft budget per slot per step (`0` = "
           "sequential; auto-off for SSM/hybrid)")
    spec_ngram: int = _knob(
        3, "longest history n-gram the prompt-lookup drafter anchors on")
    spec_mode: str = _knob(
        "chain", "speculative topology: `\"chain\"` linear K-token draft, "
                 "`\"tree\"` branching token-tree verify under an ancestor "
                 "mask, `\"auto\"` per-slot per-step Lemma-3 choice from "
                 "the measured accept rate (tree/auto need `verify_tree`; "
                 "auto-off to chain for SSM/hybrid)")
    spec_tree_nodes: int = _knob(
        12, "drafted-node budget per slot per tree step (the flattened "
            "tree's size; chain steps still use `spec_k`)")
    spec_branch: int = _knob(
        3, "max children per tree node the drafter fans out (`1` degrades "
           "the tree to a chain topology)")
    spec_drafter: str = _knob(
        "ngram", "tree drafter: `\"ngram\"` suffix-lookup fan-out (no "
                 "weights) or `\"heads\"` medusa-style trained draft heads "
                 "(needs `draft_heads` params; falls back to ngram "
                 "without them)")
    kv_dtype: str = _knob(
        "fp32", "KV page element type: `\"fp32\"` (default), `\"int8\"` "
                "or `\"int4\"` quantized pages (paged engines only; "
                "auto-falls back to fp32 for SSM/hybrid, errors with "
                "explicit `paged_kv=False`)")
    page_dedup: bool = _knob(
        False, "content-hash full pages at admission and share "
               "byte-identical ones by reference, wherever they sit in "
               "either sequence (paged engines only; auto-off otherwise, "
               "errors with explicit `paged_kv=False`)")
    degrade: bool = _knob(
        False, "enable the overload degrade ladder: under measured SLO "
               "pressure step down spec_k -> smaller prefill chunks -> "
               "shed hopeless pending requests, recovering with "
               "hysteresis")
    mesh_shards: int = _knob(
        1, "device-mesh shards along the `slots` axis: slot batch, page "
           "pool, page tables and sampling lanes split across this many "
           "devices with shard-local decode (`1` = single-device; must "
           "divide `max_slots` and `pool_pages`; paged engines only)")

    # ------------------------------------------------------------ checks
    def validate(self) -> "EngineConfig":
        """Check every model-independent constraint; returns ``self`` so
        calls chain.  Raises ``ValueError`` with the same messages the
        engine constructor historically raised (tests pin them):
        slot/capacity/chunk lower bounds, ``spec_k >= 0``, ``kv_dtype``
        membership in :data:`KV_DTYPES`, quantization's conflict with an
        explicit ``paged_kv=False``, ``mesh_shards`` divisibility of
        ``max_slots`` / ``pool_pages``, and explicit-``page_size``
        divisibility of ``max_seq``."""
        if self.max_slots < 1:
            raise ValueError("need at least one slot")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.spec_ngram < 1:
            raise ValueError(
                f"spec_ngram must be >= 1, got {self.spec_ngram}")
        if self.spec_mode not in SPEC_MODES:
            raise ValueError(f"spec_mode must be one of {SPEC_MODES},"
                             f" got {self.spec_mode!r}")
        if self.spec_tree_nodes < 1:
            raise ValueError(
                f"spec_tree_nodes must be >= 1, got {self.spec_tree_nodes}")
        if self.spec_branch < 1:
            raise ValueError(
                f"spec_branch must be >= 1, got {self.spec_branch}")
        if self.spec_drafter not in SPEC_DRAFTERS:
            raise ValueError(f"spec_drafter must be one of {SPEC_DRAFTERS},"
                             f" got {self.spec_drafter!r}")
        if self.pool_pages is not None and self.pool_pages < 1:
            raise ValueError(
                f"pool_pages must be >= 1, got {self.pool_pages}")
        if self.trie_capacity is not None and self.trie_capacity < 1:
            raise ValueError(
                f"trie_capacity must be >= 1, got {self.trie_capacity}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES},"
                             f" got {self.kv_dtype!r}")
        if self.kv_dtype != "fp32" and self.paged_kv is False:
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} quantizes pooled KV pages, "
                f"which requires the paged engine — incompatible with "
                f"paged_kv=False")
        if self.page_dedup and self.paged_kv is False:
            raise ValueError(
                "page_dedup=True shares physical pages by content hash, "
                "which requires the paged engine — incompatible with "
                "paged_kv=False")
        if self.mesh_shards < 1:
            raise ValueError(
                f"mesh_shards must be >= 1, got {self.mesh_shards}")
        if self.max_slots % self.mesh_shards:
            raise ValueError(
                f"mesh_shards={self.mesh_shards} must divide "
                f"max_slots={self.max_slots} (every shard holds the same "
                f"number of slot lanes; pick a slot count divisible by the "
                f"shard count)")
        if self.pool_pages is not None and \
                self.pool_pages % self.mesh_shards:
            raise ValueError(
                f"mesh_shards={self.mesh_shards} must divide "
                f"pool_pages={self.pool_pages} (the physical page pool "
                f"splits into equal per-shard blocks with process-local "
                f"free lists)")
        if self.page_size and self.max_seq % self.page_size:
            raise ValueError(
                f"page_size={self.page_size} must divide "
                f"max_seq={self.max_seq} (the cache is allocated in whole "
                f"pages; pick a page size that divides the capacity, or "
                f"pass page_size=None to let auto_page_size choose one)")
        return self

    def resolve(self, model_cfg) -> "EngineConfig":
        """Resolve every auto knob against ``model_cfg`` and return a new,
        fully-concrete config (no ``None``-as-auto fields left).

        Runs :meth:`validate` first, then applies the JAX config's gates
        in its order:

        * ``page_size`` ``None`` -> :func:`auto_page_size` (0 when no page
          fits: contiguous slots with one softmax);
        * ``spec_k`` off when the family has no ``verify_chunk`` or no
          position-wise rewindable state, and ``spec_mode`` back to
          ``"chain"`` without ``spec_k`` or ``verify_tree``;
        * ``paged_kv`` ``None`` -> on iff the state tree is pageable at the
          resolved page size; an explicit ``True`` raises when
          ``page_size`` resolved to 0 or the family is not pageable;
        * ``mesh_shards > 1`` raises on a contiguous engine (the page pool
          is what shards), so the SSM and hybrid families serve on one;
        * ``kv_dtype`` falls back to ``"fp32"`` and ``page_dedup`` to off
          on a contiguous engine (both are paged-only);
        * ``pool_pages`` ``None`` -> one full page row per slot (paged);
        * ``prefix_cache`` off for families without positional state.

        Imports the model registry lazily, so building and validating a
        config stays pure host-side Python."""
        self.validate()
        from repro_torch.models.registry import get_api
        from repro_torch.serve import cache
        api = get_api(model_cfg)
        page_size = self.page_size
        if page_size is None:
            page_size = auto_page_size(self.max_seq)
        specs = api.decode_state_specs(
            dataclasses.replace(model_cfg, decode_page_size=page_size),
            self.max_slots, self.max_seq)
        spec_k = self.spec_k
        # speculative decode needs (a) a verify_chunk entry point and (b)
        # a position-wise rewindable state tree: rolling back a rejected
        # draft is just "stop counting those positions" for attention
        # families, but impossible for O(1) SSM/hybrid state — auto-off,
        # exactly like the paged_kv gate.
        if spec_k and (api.verify_chunk is None
                       or not cache.supports_prefix(specs)):
            spec_k = 0
        # tree/auto topologies additionally need the tree-verify entry
        # point; families without it (and engines with spec off entirely)
        # fall back to the chain topology the rest of the engine treats as
        # the degenerate single-path tree.
        spec_mode = self.spec_mode
        if spec_mode != "chain" and (
                spec_k == 0 or api.verify_tree is None
                or not cache.supports_prefix(specs)):
            spec_mode = "chain"
        paged = self.paged_kv
        if paged is None:
            paged = cache.pageable(specs, page_size)
        elif paged:
            if not page_size:
                raise ValueError(
                    f"paged_kv=True needs page_size > 0, but it resolved "
                    f"to 0 (auto_page_size found no power-of-two page in "
                    f"[16, 128] dividing max_seq={self.max_seq} into >= 2 "
                    f"pages); pass an explicit page_size")
            if not cache.pageable(specs, page_size):
                raise ValueError(
                    f"paged_kv=True: {model_cfg.arch_id}'s decode state "
                    f"is not pageable at page_size={page_size} (every "
                    f"leaf needs an adjacent (batch, kv_seq) axis pair — "
                    f"SSM/hybrid families are not)")
        paged = bool(paged)
        if self.mesh_shards > 1 and not paged:
            raise ValueError(
                f"mesh_shards={self.mesh_shards} shards the slot batch and "
                f"the physical page pool across devices, which requires "
                f"the paged engine — {model_cfg.arch_id}'s decode state "
                f"resolved to paged_kv=False (contiguous allocation); "
                f"serve this family single-device (mesh_shards=1)")
        kv_dtype = self.kv_dtype
        if kv_dtype != "fp32" and not paged:
            # same silent auto-gate as paged_kv: SSM/hybrid state (or a
            # page_size that resolved to 0) has no pages to quantize (an
            # explicit paged_kv=False was already rejected by validate)
            kv_dtype = "fp32"
        pool_pages = self.pool_pages
        if paged and pool_pages is None:
            pool_pages = self.max_slots * (self.max_seq // page_size)
        prefix_cache = bool(self.prefix_cache
                            and cache.supports_prefix(specs))
        # content dedup shares whole physical pages; without a page pool
        # there is nothing to share (an explicit paged_kv=False was
        # already rejected by validate, like kv_dtype)
        page_dedup = bool(self.page_dedup and paged)
        return dataclasses.replace(
            self, page_size=page_size, paged_kv=paged, spec_k=spec_k,
            spec_mode=spec_mode, kv_dtype=kv_dtype, pool_pages=pool_pages,
            prefix_cache=prefix_cache, page_dedup=page_dedup)

    def replace(self, **overrides) -> "EngineConfig":
        """New config with the ``overrides`` keyword fields swapped in —
        the sweep-point constructor (``cfg.replace(spec_k=4)``)."""
        return dataclasses.replace(self, **overrides)

    def to_dict(self) -> dict:
        """Plain-dict view of the knobs (JSON-serializable; the record of
        one sweep point)."""
        return dataclasses.asdict(self)


def knob_table_md() -> str:
    """Markdown knob table (``| knob | where | meaning |``) generated from
    the :class:`EngineConfig` field metadata: string for string the JAX
    package's ``knob_table_md()``, so the two knob sets cannot drift
    apart."""
    rows = ["| knob | where | meaning |", "|---|---|---|"]
    for f in dataclasses.fields(EngineConfig):
        rows.append(f"| `{f.name}` | `EngineConfig` | {f.metadata['doc']} |")
    return "\n".join(rows) + "\n"


def add_cli_args(parser, spec_k_default: int = 4) -> None:
    """Register every :class:`EngineConfig` knob on an argparse ``parser``
    (one shared binding for every serve CLI; each option's ``dest`` is the
    field name, so :func:`config_from_args` can round-trip them).

    ``spec_k_default`` sets the CLI default draft budget — the serving
    CLIs default speculative decode ON (4) while the dataclass defaults
    it off, preserving each layer's historical behavior.  ``--max-seq``
    keeps the CLI convention ``0 = derive from the submitted requests``
    (see ``serve_batch``)."""
    parser.add_argument("--slots", dest="max_slots", type=int, default=4,
                        help="decode batch width (concurrent requests)")
    parser.add_argument("--max-seq", dest="max_seq", type=int, default=0,
                        help="per-slot cache capacity (0 = derive from "
                             "the submitted requests, padded to 16)")
    parser.add_argument("--prefill-chunk", dest="prefill_chunk", type=int,
                        default=32,
                        help="max tokens per prefill dispatch")
    parser.add_argument("--page", dest="page_size", type=int, default=None,
                        help="KV page size for the split-K decode combine "
                             "(default auto; 0 = dense)")
    parser.add_argument("--no-prefix-cache", dest="prefix_cache",
                        action="store_false", default=True,
                        help="disable prefix-cache reuse across requests")
    parser.add_argument("--min-prefix", dest="min_prefix", type=int,
                        default=8,
                        help="smallest resident-prefix match worth reusing")
    parser.add_argument("--no-paged-kv", dest="paged_kv",
                        action="store_const", const=False, default=None,
                        help="force contiguous slot allocation (default: "
                             "paged page-table allocation when supported)")
    parser.add_argument("--pool-pages", dest="pool_pages", type=int,
                        default=None,
                        help="physical page-pool size for paged allocation "
                             "(default: one full row per slot)")
    parser.add_argument("--trie-capacity", dest="trie_capacity", type=int,
                        default=None,
                        help="LRU bound on prefix-trie entries "
                             "(default: unbounded)")
    parser.add_argument("--spec-k", dest="spec_k", type=int,
                        default=spec_k_default,
                        help="speculative-decode draft budget per slot per "
                             "step (prompt-lookup drafting + one K+1-wide "
                             "verify dispatch; auto-off for SSM/hybrid)")
    parser.add_argument("--no-spec", dest="no_spec", action="store_true",
                        help="disable speculative decode (sequential "
                             "one-token decode steps)")
    parser.add_argument("--spec-ngram", dest="spec_ngram", type=int,
                        default=3,
                        help="longest history n-gram the drafter anchors on")
    parser.add_argument("--spec-mode", dest="spec_mode", default="chain",
                        choices=SPEC_MODES,
                        help="speculative topology: linear chain draft, "
                             "token-tree verify under an ancestor mask, or "
                             "auto per-slot Lemma-3 choice from the "
                             "measured accept rate (tree/auto auto-off to "
                             "chain for SSM/hybrid)")
    parser.add_argument("--spec-tree-nodes", dest="spec_tree_nodes",
                        type=int, default=12,
                        help="drafted-node budget per slot per tree step")
    parser.add_argument("--spec-branch", dest="spec_branch", type=int,
                        default=3,
                        help="max children per tree node the drafter "
                             "fans out")
    parser.add_argument("--spec-drafter", dest="spec_drafter",
                        default="ngram", choices=SPEC_DRAFTERS,
                        help="tree drafter: suffix-lookup n-gram fan-out "
                             "or medusa-style trained draft heads")
    parser.add_argument("--kv-dtype", dest="kv_dtype", default="fp32",
                        choices=KV_DTYPES,
                        help="KV page element type: quantized int8/int4 "
                             "pages shrink the pool (per-row codes + fp32 "
                             "scales, dequantized on gather; paged "
                             "engines only)")
    parser.add_argument("--page-dedup", dest="page_dedup",
                        action="store_true", default=False,
                        help="content-hash full pages at admission and "
                             "share byte-identical ones by reference "
                             "(interior-span reuse the prefix trie cannot "
                             "see; paged engines only)")
    parser.add_argument("--degrade", dest="degrade",
                        action="store_true", default=False,
                        help="enable the overload degrade ladder (spec off "
                             "-> smaller prefill chunks -> shed hopeless "
                             "pending requests, hysteretic recovery)")
    parser.add_argument("--mesh-shards", dest="mesh_shards", type=int,
                        default=1,
                        help="shard the slot batch + page pool across this "
                             "many devices with shard-local decode (must "
                             "divide --slots; paged engines only; by "
                             "default the first that many CUDA devices, "
                             "or name them with the serve CLI's "
                             "--mesh-devices, where a device may repeat)")


def config_from_args(args) -> EngineConfig:
    """Build an :class:`EngineConfig` from a namespace parsed by an
    :func:`add_cli_args` parser.  Every field whose ``dest`` is present is
    copied over; ``--no-spec`` zeroes ``spec_k``; ``--max-seq 0`` (the
    derive-from-requests CLI convention) keeps the dataclass default —
    callers that derive pass their workload capacity to ``serve_batch``
    separately."""
    kw = {}
    for f in dataclasses.fields(EngineConfig):
        if hasattr(args, f.name):
            kw[f.name] = getattr(args, f.name)
    if getattr(args, "no_spec", False):
        kw["spec_k"] = 0
    if not kw.get("max_seq"):
        kw.pop("max_seq", None)
    return EngineConfig(**kw)
