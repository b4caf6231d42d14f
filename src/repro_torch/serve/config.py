"""Typed serve-engine configuration (counterpart of ``repro/serve/config.py``).

The port's :class:`EngineConfig` holds the knobs of the features the port
serves — batching, paging, quantized KV pages, the prefix cache, page
dedup, the degrade ladder and chain and tree speculative decode — with
the JAX config's defaults and validation messages; the JAX config's other
knobs (contiguous slots, mesh shards) arrive with their features
(``ROADMAP.md``, queue 1).  The engine always runs the paged allocator, so
``page_size`` must resolve to a page.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.quant_kv import KV_DTYPES

__all__ = ["EngineConfig", "SPEC_MODES", "SPEC_DRAFTERS", "KV_DTYPES",
           "auto_page_size", "add_spec_args", "spec_knobs",
           "add_kv_dtype_arg"]

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


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The port's serve-engine knobs; defaults are the JAX engine's.

    Args:
      max_slots: decode batch width (concurrent requests).
      max_seq: per-slot cache capacity (context + generated tokens).
      prefill_chunk: max tokens per prefill dispatch (shape buckets are
        powers of two up to it).
      page_size: KV page of the split-K combine and the allocator
        (``None`` = :func:`auto_page_size`; must divide ``max_seq``).
      prefix_cache: enable prefix reuse (auto-off for non-positional
        state).
      min_prefix: smallest resident-prefix match worth reusing.
      pool_pages: allocatable pages in the physical pool (``None`` = one
        full row per slot; smaller overcommits and defers admissions when
        the pool runs dry).
      trie_capacity: LRU bound on prefix-trie entries (``None`` =
        unbounded).
      page_dedup: content-hash full pages at admission and share
        byte-identical ones by reference, wherever they sit in either
        sequence.
      degrade: enable the overload degrade ladder: under measured SLO
        pressure suspend speculative decode, then step down to smaller
        prefill chunks, then shed hopeless pending requests, recovering
        with hysteresis.
      spec_k: speculative draft budget per slot per step (``0`` =
        sequential; off for a family without ``verify_chunk``).
      spec_ngram: longest history n-gram the prompt-lookup drafter anchors
        on.
      spec_mode: speculative topology, one of :data:`SPEC_MODES`: a linear
        K-token draft, a token tree verified under an ancestor mask, or a
        per-slot per-step Lemma-3 choice from the measured accept rate
        (tree and auto fall back to chain without ``verify_tree``).
      spec_tree_nodes: drafted-node budget per slot per tree step.
      spec_branch: most children per tree node the drafter fans out.
      spec_drafter: tree drafter, one of :data:`SPEC_DRAFTERS`: n-gram
        fan-out, or trained draft heads (``params["draft_heads"]``; the
        n-gram drafter without them).
      kv_dtype: KV page element type, one of :data:`KV_DTYPES`: ``"fp32"``
        (the unquantized pool, in the model's dtype), or ``"int8"`` /
        ``"int4"`` per-row codes with fp32 scales.
    """

    max_slots: int = 4
    max_seq: int = 128
    prefill_chunk: int = 32
    page_size: Optional[int] = None
    prefix_cache: bool = True
    min_prefix: int = 8
    pool_pages: Optional[int] = None
    trie_capacity: Optional[int] = None
    page_dedup: bool = False
    degrade: bool = False
    spec_k: int = 0
    spec_ngram: int = 3
    spec_mode: str = "chain"
    spec_tree_nodes: int = 12
    spec_branch: int = 3
    spec_drafter: str = "ngram"
    kv_dtype: str = "fp32"

    def validate(self) -> "EngineConfig":
        """Check the model-independent constraints; returns ``self``."""
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
        if self.kv_dtype != "fp32" and self.page_size == 0:
            # page_size 0 asks for contiguous slots, the JAX engine's
            # paged_kv=False
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} quantizes pooled KV pages, "
                f"which requires the paged engine — incompatible with "
                f"paged_kv=False")
        if self.page_size is not None and self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1 (the port serves paged KV only; "
                f"contiguous slots are still to port, see ROADMAP.md "
                f"queue 1), got {self.page_size}")
        if self.page_size and self.max_seq % self.page_size:
            raise ValueError(
                f"page_size={self.page_size} must divide "
                f"max_seq={self.max_seq}")
        return self

    def resolve(self, model_cfg) -> "EngineConfig":
        """Validate, then resolve the auto knobs against ``model_cfg``: the
        page size, the pool size, ``prefix_cache``, which is off for a
        family whose decode state is not positional, ``spec_k``, which is
        off for a family without ``verify_chunk`` or positional state, and
        ``spec_mode``, which falls back to ``"chain"`` when ``spec_k`` is 0
        or the family has no ``verify_tree``.  Raises when no page size
        fits ``max_seq``.  Imports the model registry lazily, so
        building and validating a config stays pure host-side Python."""
        self.validate()
        from repro_torch.models.registry import get_api
        from repro_torch.serve import cache
        page_size = self.page_size
        if page_size is None:
            page_size = auto_page_size(self.max_seq)
            if not page_size:
                raise ValueError(
                    f"auto_page_size found no power-of-two page in "
                    f"[16, 128] dividing max_seq={self.max_seq} into >= 2 "
                    f"pages; pass an explicit page_size")
        pool_pages = self.pool_pages
        if pool_pages is None:
            pool_pages = self.max_slots * (self.max_seq // page_size)
        api = get_api(model_cfg)
        specs = api.decode_state_specs(model_cfg, self.max_slots,
                                       self.max_seq)
        positional = cache.supports_prefix(specs)
        prefix_cache = bool(self.prefix_cache and positional)
        # a rejected draft is rolled back by no longer counting its
        # positions, which needs position-wise state
        spec_k = self.spec_k
        if spec_k and (api.verify_chunk is None or not positional):
            spec_k = 0
        spec_mode = self.spec_mode
        if spec_mode != "chain" and (spec_k == 0 or api.verify_tree is None
                                     or not positional):
            spec_mode = "chain"
        return dataclasses.replace(self, page_size=page_size,
                                   pool_pages=pool_pages,
                                   prefix_cache=prefix_cache, spec_k=spec_k,
                                   spec_mode=spec_mode)


def add_spec_args(parser, spec_k_default: int = 4) -> None:
    """Register the speculative-decode knobs on an argparse ``parser``
    with the JAX serve CLI's flags and defaults (``spec_k_default``: the
    serving CLI drafts by default, the dataclass does not);
    :func:`spec_knobs` reads them back."""
    parser.add_argument("--spec-k", dest="spec_k", type=int,
                        default=spec_k_default,
                        help="speculative-decode draft budget per slot per "
                             "step (prompt-lookup drafting + one K+1-wide "
                             "verify dispatch)")
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
                             "measured accept rate")
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


def add_kv_dtype_arg(parser) -> None:
    """Register ``--kv-dtype`` on an argparse ``parser`` with the JAX serve
    CLI's choices and default."""
    parser.add_argument("--kv-dtype", dest="kv_dtype", default="fp32",
                        choices=KV_DTYPES,
                        help="KV page element type: quantized int8/int4 "
                             "pages shrink the pool (per-row codes + fp32 "
                             "scales, dequantized on gather)")


def spec_knobs(args) -> dict:
    """The :class:`EngineConfig` speculative knobs of a namespace parsed
    by an :func:`add_spec_args` parser (``--no-spec`` zeroes ``spec_k``)."""
    return dict(spec_k=0 if args.no_spec else args.spec_k,
                spec_ngram=args.spec_ngram, spec_mode=args.spec_mode,
                spec_tree_nodes=args.spec_tree_nodes,
                spec_branch=args.spec_branch,
                spec_drafter=args.spec_drafter)
