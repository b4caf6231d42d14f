"""Unified LM: parameter layout, the training forward and loss, decode.

The counterpart of ``repro/models/lm.py``: the decoders, GQA
(``llama3.2-3b``), MLA (``minicpm3-4b``, :mod:`repro_torch.models.mla`),
and either with the routed MoE FFN in every block (``phi3.5-moe``,
``llama4-scout``, :mod:`repro_torch.models.moe`); the encoder-only audio
model and the VLM backbone.
Parameters are a plain dict of tensors in the JAX tree's layout, with
``blocks`` stacked on a leading layers axis (or, as the train step passes
them, a list of per-layer dicts of views: see
:func:`repro_torch.train.state.split_layers`; on a device mesh each a
:class:`~repro_torch.models.common.ShardedLayer` of the rank's blocks,
gathered where the layer runs); the block stack runs as a Python loop
over layers (``lax.scan`` in JAX).  For decode, the state
leaves are a contiguous engine's dense ``(layers, batch, max_seq, ...)``
slot rows (:func:`decode_state_specs`), or physical page pools ``(layers,
num_pages, page_size, Hkv, hd)`` for GQA, ``(layers, num_pages, page_size, kv_lora_rank)`` and ``(...,
qk_rope_dim)`` latent pools for MLA (see
:func:`repro_torch.serve.cache.paged_state_specs`), or int8/int4 code
pools with fp32 per-row scales beside them
(:func:`repro_torch.serve.cache.quant_state_specs`), updated in place.
Speculative decode scores a drafted chain (:func:`verify_chunk`) or token
tree (:func:`verify_tree`) in one dispatch; medusa-style draft heads
(:func:`draft_head_specs`, :func:`fit_draft_heads`) propose the tree's
nodes from the hidden states that dispatch already computed.

The modality frontends are stubs, as in the JAX package: a ``vision_stub``
model (``internvl2-26b``) projects precomputed patch embeddings through
``frontend_proj`` and prepends them to the token embeddings, and takes its
loss on the text positions only; an ``audio_stub`` encoder
(``hubert-xlarge``, non-causal, train-only) projects precomputed frames
and has no token embedding.  The SSM and hybrid families run through
:mod:`repro_torch.models.hybrid`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, mla, moe, paging
from repro_torch.dist import transport as tx
from repro_torch.models.common import (LOGIT_AXES, ParamSpec,
                                       cross_entropy_loss, model_split_dim,
                                       rms_norm, token_nll,
                                       topk_low_index_first,
                                       vocab_parallel_cross_entropy, whole,
                                       whole_sequence)
from repro_torch.tree import index_tree, map_tree

__all__ = ["param_specs", "block_specs", "stack_specs", "forward",
           "train_loss", "embed_inputs", "vocab_parallel_embed",
           "logits_split", "head_logits", "lm_loss",
           "decode_state_specs",
           "decode_step", "prefill_chunk", "verify_chunk",
           "draft_head_specs", "verify_tree", "hidden_states",
           "fit_draft_heads"]


def stack_specs(per_layer: Any, n: int) -> Any:
    """Add a leading (n, ...) 'layers' axis to every spec in a tree."""
    return map_tree(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                            dtype=s.dtype, init=s.init, scale=s.scale),
        per_layer)


def block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """One decoder block: pre-norm attention + pre-norm FFN."""
    d = cfg.d_model
    return {
        "attn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "ffn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "attn": (mla.mla_param_specs(cfg) if cfg.attn_kind == "mla"
                 else attention.gqa_param_specs(cfg)),
        "ffn": (moe.moe_param_specs(cfg) if cfg.n_experts
                else moe.dense_ffn_specs(cfg)),
    }


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The whole model's parameter declaration, in the JAX tree's layout."""
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), scale=0.02),
        "blocks": stack_specs(block_specs(cfg), cfg.n_layers),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, cfg.vocab), ("embed", "vocab")),
    }
    if cfg.frontend:
        specs["frontend_proj"] = ParamSpec((cfg.frontend_dim, d),
                                           (None, "embed"))
    return specs


def decode_state_specs(cfg: ModelConfig, batch: int, max_seq: int
                       ) -> Dict[str, ParamSpec]:
    """Contiguous KV-cache layout; the serve tier rewrites its adjacent
    ``(batch, kv_seq)`` axis pair into a page pool.  MLA caches the latent
    ``ckv`` rows and the shared rope key ``kr``; GQA caches ``k`` and
    ``v``."""
    l, hd = cfg.n_layers, cfg.hd
    if cfg.attn_kind == "mla":
        return {
            name: ParamSpec((l, batch, max_seq, width),
                            ("layers", "batch", "kv_seq", None),
                            dtype=cfg.dtype, init="zeros")
            for name, width in (("ckv", cfg.kv_lora_rank),
                                ("kr", cfg.qk_rope_dim))
        }
    return {
        name: ParamSpec((l, batch, max_seq, cfg.n_kv_heads, hd),
                        ("layers", "batch", "kv_seq", None, None),
                        dtype=cfg.dtype, init="zeros")
        for name in ("k", "v")
    }


def _layer(blocks: Any, i: int) -> dict:
    """Layer ``i``'s params from the stacked dict or the per-layer list."""
    return blocks[i] if isinstance(blocks, list) else index_tree(blocks, i)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block_train(x: torch.Tensor, bp: dict, cfg: ModelConfig, mesh=None,
                 sp: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block: (x, the layer's router aux loss; 0 for a dense FFN).
    ``bp`` may be a :class:`~repro_torch.models.common.ShardedLayer`,
    gathered here.  With ``sp`` ``x`` is this rank's stretch of the
    sequence-parallel stream, and so is the result: attention gathers the
    sequence (:func:`~repro_torch.models.attention.gqa_train`), the norms
    and the FFN run on the stretch, and the layer's weight gradients are
    summed over ``model`` (:func:`~repro_torch.models.common.whole`)."""
    bp = whole(bp, mesh if sp else None)
    h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        attend = lambda h: mla.mla_train(h, bp["attn"], cfg)
        x = x + (whole_sequence(attend, h, mesh) if sp else attend(h))
    else:
        x = x + attention.gqa_train(h, bp["attn"], cfg, mesh=mesh, sp=sp)
    h = rms_norm(x, bp["ffn_norm"], cfg.norm_eps)
    if cfg.n_experts:
        h, aux = moe.moe_ffn(h, bp["ffn"], cfg, mesh, sp)
    else:
        h = moe.dense_ffn(h, bp["ffn"], cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, aux


def vocab_parallel_embed(tokens: torch.Tensor, table: torch.Tensor, mesh,
                         vocab: int, enabled: bool = True, sp: bool = False
                         ) -> torch.Tensor:
    """Rows ``tokens`` of the (vocab, D) embedding ``table`` (Megatron's
    VocabParallelEmbedding, the counterpart of
    ``repro/models/lm.py:vocab_parallel_embed``).

    On a ``mesh`` whose ``model`` axis has ``tp`` > 1 ranks dividing
    ``vocab``, ``table`` is this rank's block of ``vocab / tp`` rows: each
    rank takes the tokens that fall in its rows, zeros the others, and the
    ranks' results are summed over ``model``
    (:func:`~repro_torch.dist.transport.reduce_from`: every rank's
    gradient of its block is then its block of the whole gradient).
    Without one (``enabled`` off, ``tp`` 1, ``vocab % tp``), or given the
    whole table, a plain take.

    With ``sp`` (the sequence-parallel layout; ``tokens`` (B, S) with
    ``tp`` dividing S) this returns the rank's stretch (B, S / tp, D): the
    sum is a reduce-scatter along the sequence
    (:func:`~repro_torch.dist.transport.reduce_scatter`), and a plain take
    keeps its stretch (:func:`~repro_torch.dist.transport.split_to`)."""
    tp = mesh.shape.get("model", 1) if mesh is not None else 1
    if not enabled or tp == 1 or vocab % tp or table.shape[0] == vocab:
        x = table[tokens.long()]
        return tx.split_to(x, mesh, "model", 1) if sp and tp > 1 else x
    v_local = vocab // tp
    lo = mesh.index("model") * v_local
    tok = tokens.long()
    in_range = (tok >= lo) & (tok < lo + v_local)
    x = table[torch.clamp(tok - lo, 0, v_local - 1)]
    x = x * in_range[..., None].to(x.dtype)
    if sp:
        return tx.reduce_scatter(x, mesh, "model", 1)
    return tx.reduce_from(x, mesh, "model")


def embed_inputs(params: dict, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, mesh=None, sp: bool = False
                 ) -> torch.Tensor:
    """(B, S, D) inputs of the block stack in the compute dtype: the token
    embedding (:func:`vocab_parallel_embed` on a ``mesh``), after the
    projected ``vision_embeds`` (B, n_frontend_tokens, frontend_dim) of a
    vision stub; for an audio stub, the projected ``frames`` (B, S,
    frontend_dim) alone.  With ``sp`` this rank's stretch (B, S / tp, D)
    of them."""
    parts = []
    if cfg.frontend == "vision_stub" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(cfg.dtype)
        parts.append(ve @ params["frontend_proj"].to(cfg.dtype))
    if cfg.frontend == "audio_stub":
        frames = batch["frames"].to(cfg.dtype)
        x = frames @ params["frontend_proj"].to(cfg.dtype)
        return tx.split_to(x, mesh, "model", 1) if sp else x
    tok = vocab_parallel_embed(batch["tokens"], params["embed"], mesh,
                               cfg.vocab, cfg.use_tp_shardmap,
                               sp and not parts).to(cfg.dtype)
    if not parts:
        return tok
    x = torch.cat(parts + [tok], dim=1)
    return tx.split_to(x, mesh, "model", 1) if sp else x


def _seq_len(batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> int:
    """The length of the block stack's sequence: the frames of an audio
    stub, the tokens after a vision stub's patches, else the tokens."""
    if cfg.frontend == "audio_stub":
        return batch["frames"].shape[1]
    s = batch["tokens"].shape[1]
    if cfg.frontend == "vision_stub" and "vision_embeds" in batch:
        s += batch["vision_embeds"].shape[1]
    return s


def logits_split(batch: Dict[str, torch.Tensor], cfg: ModelConfig, mesh
                 ) -> Optional[int]:
    """The dim of the logits (B, S, V) that ``model`` splits, as the JAX
    package's constraints lay them out (:data:`~repro_torch.models.common.
    LOGIT_AXES`): 1 where it divides the sequence (then the residual
    stream is sequence-parallel too, each rank its stretch of S / tp),
    else 2 where it divides the vocab (the stream whole on every rank, the
    logits each rank's V / tp columns), else ``None``."""
    if mesh is None:
        return None
    rows = mesh.size([a for a in mesh.axis_names if a != "model"])
    return model_split_dim(LOGIT_AXES, (rows, _seq_len(batch, cfg),
                                        cfg.vocab), mesh)


def head_logits(x: torch.Tensor, params: dict, cfg: ModelConfig, mesh=None,
                split: Optional[int] = None) -> torch.Tensor:
    """The logits of the block stack's output ``x`` under ``split``
    (:func:`logits_split`): for 1, ``x`` is the rank's stretch and so are
    the logits (B, S / tp, V), ``final_norm`` and the whole ``lm_head``
    summing their gradients over ``model``; for 2 with ``lm_head`` given
    as the rank's (D, V / tp) columns, the rank's columns of the logits
    of the whole ``x`` (B, S, V / tp); else the whole logits."""
    head, norm = params["lm_head"], params["final_norm"]
    if split == 1:
        norm, head = (tx.copy_to(t, mesh, "model") for t in (norm, head))
    x = rms_norm(x, norm, cfg.norm_eps)
    if split == 2 and head.shape[1] != cfg.vocab:
        # the normed rows feed this rank's columns alone: their cotangents
        # are summed over model
        x = tx.copy_to(x, mesh, "model")
    return x @ head.to(x.dtype)


def _text_labels(batch: Dict[str, torch.Tensor], s_total: int, lo: int,
                 n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The labels and weights (B, n) of stream positions ``[lo, lo + n)``
    of ``s_total``: the labels are those of the last ``labels.shape[1]``
    (text) positions; a position before them weighs 0, one in them its
    ``loss_mask`` entry (1 without one)."""
    labels, mask = batch["labels"], batch.get("loss_mask")
    j = torch.arange(lo, lo + n, device=device) - (s_total - labels.shape[1])
    jc = j.clamp_min(0)
    w = (j >= 0).float()[None, :].expand(labels.shape[0], n)
    if mask is not None:
        w = w * mask[:, jc].float()
    return labels[:, jc], w


def lm_loss(x: torch.Tensor, params: dict, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, mesh=None, split: Optional[int] = None
            ) -> torch.Tensor:
    """Mean next-token NLL of ``batch["labels"]`` from the block stack's
    output ``x`` under ``split`` (:func:`logits_split`); with stub tokens
    prepended, over the last ``labels.shape[1]`` (text) positions only,
    weighted by ``loss_mask`` when given.  For 1 each rank sums its
    stretch's weighted NLL and weights, both summed over ``model``; for 2
    (``lm_head`` as the rank's columns)
    :func:`~repro_torch.models.common.vocab_parallel_cross_entropy`.  The
    loss is the same on every rank."""
    logits = head_logits(x, params, cfg, mesh, split)
    labels = batch["labels"]
    if split == 1:
        tp, r = mesh.shape["model"], mesh.index("model")
        n = logits.shape[1]
        lab, w = _text_labels(batch, n * tp, r * n, n, logits.device)
        total = tx.reduce_from(torch.sum(token_nll(logits, lab) * w), mesh,
                               "model")
        if "loss_mask" not in batch:
            return total / labels.numel()
        den = mesh.transport.all_reduce(torch.sum(w), mesh.group("model"))
        return total / torch.clamp_min(den, 1.0)
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    if split == 2 and logits.shape[-1] != cfg.vocab:
        return vocab_parallel_cross_entropy(logits, labels,
                                            batch.get("loss_mask"), mesh)
    return cross_entropy_loss(logits, labels, batch.get("loss_mask"))


def gather_logits(logits: torch.Tensor, cfg: ModelConfig, mesh,
                  split: Optional[int]) -> torch.Tensor:
    """The whole logits from :func:`head_logits`' layout (the rank's
    stretch, or its vocab columns), gathered over ``model``."""
    if split == 1 or (split == 2 and logits.shape[-1] != cfg.vocab):
        return tx.gather_from(logits, mesh, "model", split)
    return logits


def _stack(params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
           mesh, sp: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block stack's output (the rank's stretch with ``sp``) and the
    router losses summed over layers."""
    x = embed_inputs(params, batch, cfg, mesh, sp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        if remat:
            x, aux_l = checkpoint(_block_train, x, bp, cfg, mesh, sp,
                                  use_reentrant=False)
        else:
            x, aux_l = _block_train(x, bp, cfg, mesh, sp)
        aux = aux + aux_l
    return x, aux


def forward(params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) in the compute dtype, aux_loss): the
    router losses summed over layers in layer order (0 for dense FFNs).

    On a device ``mesh`` (:class:`repro_torch.launch.mesh.Mesh`) ``batch``
    holds this rank's rows.  The params a layer computes with are whole:
    given whole, or as the train step gives them, each layer a
    :class:`~repro_torch.models.common.ShardedLayer` of the rank's blocks
    gathered inside the layer's checkpoint region, and ``embed`` the
    rank's block of vocab rows (:func:`vocab_parallel_embed`).  GQA splits
    its heads over ``model`` and the MoE FFN its experts
    (:func:`~repro_torch.models.attention.gqa_train`,
    :func:`~repro_torch.models.moe.moe_ffn`).  Where ``model`` (2 or more
    ranks) divides the sequence, the residual stream between half-blocks
    is each rank's stretch of it (sequence parallelism, :func:`logits_split`
    1), else whole on every rank.  The logits returned are those of the
    rank's rows, whole (gathered over ``model``); the ranks' gradients
    meaned over the data axes (as the train step means them) are those of
    the mean loss over all the rows.

    With ``cfg.remat`` and grad enabled, each layer runs under
    ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint`` with
    ``nothing_saveable``): only its input is kept, and the backward runs
    the layer's forward again."""
    split = logits_split(batch, cfg, mesh)
    x, aux = _stack(params, batch, cfg, mesh, split == 1)
    logits = head_logits(x, params, cfg, mesh, split)
    return gather_logits(logits, cfg, mesh, split), aux


def train_loss(params: dict, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """Mean next-token NLL of ``batch["labels"]`` (+ the aux loss); with
    stub tokens prepended, over the last ``labels.shape[1]`` (text)
    positions only.  ``mesh`` as in :func:`forward`; the logits stay in
    their layout (:func:`lm_loss`): each rank's stretch of the sequence,
    or its columns of the vocab."""
    split = logits_split(batch, cfg, mesh)
    x, aux = _stack(params, batch, cfg, mesh, split == 1)
    return lm_loss(x, params, batch, cfg, mesh, split) + aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode_blocks(params: dict, state: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   mesh=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the block stack over C new tokens against the KV caches.

    batch: {"tokens": (B, C) int64, "index": 0-d chunk start (or lockstep
    position) or (B,) per-slot lengths, optionally "pages": (B, n_pages)
    int64 page table}, and for speculative verification "nspec" (B,):
    valid rows per slot (rows at or past it write nothing, or only
    scratch).  Tree verification (:func:`verify_tree`) also passes
    "parents" (B, C), "pos_off" (B, C) and "nchain" (B,): every layer then
    ropes at ``index + pos_off`` and attends under the ancestor mask.

    With "pages" the state leaves are physical page pools: every layer
    attends over its gathered pages and scatters its new rows into its
    pool, in place (GQA's ``k`` / ``v`` through
    :func:`repro_torch.models.attention.gqa_decode_pages`, MLA's latent
    ``ckv`` / ``kr`` through
    :func:`repro_torch.models.mla.mla_decode_pages`); a tree commits only
    its chain rows.  A quantized state (``"<leaf>_scale"`` beside each
    leaf, :func:`repro_torch.serve.cache.quant_state_specs`) passes each
    layer its ``(codes, scales)`` pairs, and is paged-only.

    Without "pages" the leaves are dense ``(layers, B, Smax, ...)`` slot
    rows, written in place: GQA takes split-K over the rows read as pages
    (:func:`~repro_torch.models.attention.gqa_decode_paged`) when
    ``cfg.decode_page_size`` is set and divides ``Smax``, else one softmax
    (:func:`~repro_torch.models.attention.gqa_decode`); MLA takes
    :func:`repro_torch.models.mla.mla_decode`.  Returns the final hidden
    states (B, C, D) and the state (the same dict).

    On a device ``mesh`` with a ``model`` axis of 2 or more ranks, decode
    takes split-K under the JAX package's condition (dense slots, no
    ``nspec``, a 0-d index, :func:`~repro_torch.models.attention.
    splitk_ok`): the state holds this rank's block, its batch rows over
    the data axes and its stretch of ``Smax`` over ``model``
    (:func:`~repro_torch.models.attention.gqa_decode_splitk`, for MLA's
    latent rows :func:`~repro_torch.models.mla.mla_decode_splitk`).
    Anything else on such a mesh (a paged, quantized or speculative state,
    a per-slot index) raises: its cache would have to be whole on every
    rank.  A mesh of data axes alone runs the rank's rows as above.  On a
    mesh the params may be laid out as the sharded train step holds them
    (:func:`repro_torch.train.state.mesh_params`): ``embed`` the rank's
    vocab rows (:func:`vocab_parallel_embed`), each layer a
    :class:`~repro_torch.models.common.ShardedLayer` gathered where it
    runs, the rest whole."""
    mla_kind = cfg.attn_kind == "mla"
    names = ("ckv", "kr") if mla_kind else ("k", "v")
    quant = names[0] + "_scale" in state
    pages = batch.get("pages")
    if quant and pages is None:
        raise ValueError("quantized KV state requires a page table "
                         "(kv_dtype != 'fp32' is paged-only)")
    cur = batch["index"]
    nspec = batch.get("nspec")
    tree = None
    if "parents" in batch:
        tree = (batch["parents"], batch["pos_off"], batch["nchain"])
    blocks = params["blocks"]
    x = vocab_parallel_embed(batch["tokens"], params["embed"], mesh,
                             cfg.vocab, cfg.use_tp_shardmap).to(cfg.dtype)
    b, c = batch["tokens"].shape
    splitk = _splitk(cfg, mesh, quant or pages is not None
                     or nspec is not None or tree is not None, cur, b,
                     state[names[0]].shape[2])
    scatter = ()
    if pages is not None:
        page = state[names[0]].shape[2]
        smax = pages.shape[1] * page
        decode = mla.mla_decode_pages if mla_kind \
            else attention.gqa_decode_pages
        extra = (pages,)
        # where every layer scatters its new rows into its pools
        scatter = (paging.scatter_plan(
            pages, attention.decode_positions(cur, c), page, b,
            nspec if tree is None else tree[2]),)
    else:
        smax = state[names[0]].shape[2]
        page = cfg.decode_page_size
        extra = ()
        if splitk:
            decode = _splitk_layer
            extra = (mesh,)
        elif mla_kind:
            decode = mla.mla_decode
        elif page > 0 and smax % page == 0:
            decode = attention.gqa_decode_paged
            extra = (page,)
        else:
            decode = attention.gqa_decode
    # the mask and the row-masked write's indices are the same for every
    # layer: built once (the tree mask's pointer walk is C - 1 hops)
    valid = attention.attend_mask(cur, c, smax, nspec, tree)
    plan = (None if nspec is None else attention.masked_write_plan(
        attention.decode_positions(cur, c), nspec, smax, b))
    for i in range(cfg.n_layers):
        bp = whole(_layer(blocks, i))
        h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        caches = [(state[n][i], state[n + "_scale"][i]) if quant
                  else state[n][i] for n in names]
        h, _, _ = decode(h, bp["attn"], cfg, *caches, cur, *extra, nspec,
                         tree, valid, plan, *scatter)
        x = x + h
        h = rms_norm(x, bp["ffn_norm"], cfg.norm_eps)
        if cfg.n_experts:
            h, _ = moe.moe_ffn(h, bp["ffn"], cfg, mesh)
        else:
            h = moe.dense_ffn(h, bp["ffn"], cfg)
        x = x + h
    return x, state


def _splitk(cfg: ModelConfig, mesh, other_path: bool, cur: torch.Tensor,
            b: int, smax: int) -> bool:
    """Whether decode on ``mesh`` takes split-K, from this rank's ``b``
    rows and ``smax`` cache positions; raises where a ``model`` axis would
    need a path that is not split-K (``other_path``: a quantized, paged
    or speculative state), or a per-slot index."""
    if mesh is None or mesh.shape.get("model", 1) <= 1:
        return False
    tp = mesh.shape["model"]
    dp = mesh.size([a for a in mesh.axis_names if a != "model"])
    if (other_path or cur.dim() != 0
            or not attention.splitk_ok(cfg, mesh, b * dp, smax * tp)):
        raise ValueError(
            f"decode on a mesh with model={tp} runs split-K only: a dense "
            f"GQA or MLA state split over model, not paged or quantized, "
            f"no nspec or tree, a 0-d index (got a {cur.dim()}-d index)")
    return True


def _splitk_layer(h, p, cfg, ck, cv, cur, mesh, *_):
    """:func:`~repro_torch.models.attention.gqa_decode_splitk` or, for
    MLA, :func:`~repro_torch.models.mla.mla_decode_splitk`, in the
    argument order of the other decode paths."""
    fn = (mla.mla_decode_splitk if cfg.attn_kind == "mla"
          else attention.gqa_decode_splitk)
    return fn(h, p, cfg, ck, cv, cur, mesh)


def decode_step(params: dict, state: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                mesh=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token for every slot. batch: {"tokens": (B, 1), "index":
    (B,) per-slot lengths or a 0-d lockstep position, optionally "pages":
    (B, n_pages)}.  Returns (logits (B, V) float32, state).  ``mesh``: see
    :func:`_decode_blocks` (split-K decode on a ``model`` axis)."""
    x, state = _decode_blocks(params, state, batch, cfg, mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(x.dtype))[:, -1]
    return logits.float(), state


def prefill_chunk(params: dict, state: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  mesh=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Ingest a prompt chunk in one dispatch. batch: {"tokens": (B, C),
    "index": 0-d chunk start, "nvalid": count of real tokens in the chunk
    (trailing bucket padding only writes masked-off positions), optionally
    "pages": (B, n_pages)}.  Returns (logits (B, V) float32 at row
    ``nvalid - 1``, state).  ``mesh``: see :func:`_decode_blocks` (on a
    ``model`` axis the chunk takes split-K, each rank writing the rows of
    its stretch of the cache)."""
    x, state = _decode_blocks(params, state, batch, cfg, mesh)
    c = x.shape[1]
    last = min(max(int(batch.get("nvalid", c)) - 1, 0), c - 1)
    x_last = rms_norm(x[:, last:last + 1], params["final_norm"],
                      cfg.norm_eps)
    logits = (x_last @ params["lm_head"].to(x_last.dtype))[:, 0]
    return logits.float(), state


def verify_chunk(params: dict, state: Dict[str, torch.Tensor],
                 batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 mesh=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Score a (B, K+1) speculative block in one dispatch: each slot feeds
    its last sampled token and up to K drafted tokens, and the logits come
    back at every fed row.

    batch: {"tokens": (B, K+1), "index": (B,) per-slot cache lengths,
    "nspec": (B,) valid fed rows per slot (1 = no drafts, 0 = idle lane),
    optionally "pages": (B, n_pages)}.  Rows at or past ``nspec`` write
    nothing (dense rows) or only scratch (pages); the engine rolls back
    pages past what it accepts.  Returns (logits (B, K+1, V) float32,
    state): ``logits[:, j]`` is the next-token distribution after fed
    token ``j``.  ``mesh``: see :func:`_decode_blocks` (a ``model`` axis
    of 2 or more ranks raises: no split-K for ``nspec``)."""
    x, state = _decode_blocks(params, state, batch, cfg, mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    return logits.float(), state


def draft_head_specs(cfg: ModelConfig, n_heads: int,
                     head_dim: int = 64) -> Dict[str, ParamSpec]:
    """Medusa-style draft heads: ``n_heads`` small residual MLPs over the
    final hidden state, sharing ``lm_head``; head ``h`` predicts the token
    ``h + 2`` after the row it reads.  They run inside :func:`verify_tree`
    on hidden states that dispatch already has; the engine reads them from
    ``params["draft_heads"]``."""
    d = cfg.d_model
    return {
        "w1": ParamSpec((n_heads, d, head_dim), (None, "embed", None)),
        "w2": ParamSpec((n_heads, head_dim, d), (None, None, "embed")),
    }


def _draft_head_top(params: dict, x: torch.Tensor, head_topk: int
                    ) -> torch.Tensor:
    """Top-``head_topk`` candidates of every draft head at every fed row:
    ``x`` is the final-normed hidden state (B, C, D); head ``h`` scores
    ``lm_head(x + silu(x @ w1[h]) @ w2[h])``.  Returns (B, C, H, A) int64,
    ranked by logit (ties: lower token id first)."""
    hp = params["draft_heads"]
    w1 = hp["w1"].to(x.dtype)
    w2 = hp["w2"].to(x.dtype)
    t = F.silu(torch.einsum("bcd,hde->bhce", x, w1))
    xh = x[:, None] + torch.einsum("bhce,hed->bhcd", t, w2)     # (B,H,C,D)
    head_logits = xh @ params["lm_head"].to(x.dtype)            # (B,H,C,V)
    top = topk_low_index_first(head_logits, head_topk)
    return top.transpose(1, 2)                                  # (B,C,H,A)


def verify_tree(params: dict, state: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                mesh=None, *, head_topk: int = 4
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Dict[str, torch.Tensor]]:
    """Score a (B, C) speculative token tree in one dispatch.

    Each slot feeds ``nchain`` chain rows (tokens the previous step
    accepted but did not write, committed at ``index + j``) and then its
    drafted tree rows, whose topology travels per row, so one dispatch
    verifies another tree shape per slot per step.

    batch: {"tokens": (B, C), "index": (B,) committed lengths, "parents":
    (B, C) parent row per row (-1: the committed cache only; chain row
    ``j`` has parent ``j - 1``; padding rows point at themselves),
    "pos_off": (B, C) token-position offsets (chain row ``j``: ``j``; a
    node: ``nchain - 1 + depth``), "nchain": (B,), "nspec": (B,) valid rows
    (0 = idle lane), optionally "pages": (B, n_pages)}.  Through a page
    table drafted rows reach only the attended view and scratch; in dense
    rows they land past the committed length, masked until overwritten.
    Either way a rejected branch needs no rollback.

    Returns ``(logits (B, C, V) float32, head_top, state)``; ``head_top``
    is (B, C, H, ``head_topk``) draft-head candidates when
    ``params["draft_heads"]`` exists (:func:`draft_head_specs`), else
    None.  ``mesh``: as :func:`verify_chunk`."""
    x, state = _decode_blocks(params, state, batch, cfg, mesh)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    head_top = (_draft_head_top(params, x, head_topk)
                if "draft_heads" in params else None)
    return logits.float(), head_top, state


def hidden_states(params: dict, cfg: ModelConfig, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """Teacher-forced final-normed hidden states of whole sequences:
    ``tokens`` (B, L) -> (B, L, D) float32, the ``x`` that
    :func:`verify_tree` hands the draft heads (full causal attention over a
    fresh dense cache of ``L`` positions)."""
    b, l = tokens.shape
    state = map_tree(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=tokens.device),
        decode_state_specs(cfg, b, l))
    batch = {"tokens": tokens, "index": torch.tensor(0, device=tokens.device)}
    x, _ = _decode_blocks(params, state, batch, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x.float()


def draft_head_loss(w: Dict[str, torch.Tensor], x_all: torch.Tensor,
                    y_all: torch.Tensor, m_all: torch.Tensor,
                    lm_head: torch.Tensor) -> torch.Tensor:
    """The distillation loss of :func:`fit_draft_heads`: the masked mean
    NLL of head ``h``'s target ``y_all[h]`` over the rows ``x_all`` (N, D),
    with ``lm_head`` (D, V) frozen; ``y_all``, ``m_all`` (H, N)."""
    t = F.silu(torch.einsum("nd,hde->hne", x_all, w["w1"]))
    xh = x_all[None] + torch.einsum("hne,hed->hnd", t, w["w2"])
    logp = torch.log_softmax(xh @ lm_head, dim=-1)             # (H, N, V)
    nll = -torch.gather(logp, -1, y_all[..., None])[..., 0]
    return (nll * m_all).sum() / torch.clamp(m_all.sum(), min=1.0)


def adam_update(w: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
                opt: Dict[str, Dict[str, torch.Tensor]], i: int, lr: float
                ) -> None:
    """One bias-corrected Adam step of :func:`fit_draft_heads`, in place
    (``i`` counts from 0; the corrections are computed in fp32, as the
    JAX step computes them from its fp32 step counter)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    t = torch.tensor(float(i + 1), dtype=torch.float32)
    c1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
    c2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
    for k in w:
        mu, nu = opt["mu"][k], opt["nu"][k]
        mu.mul_(b1).add_(g[k], alpha=1 - b1)
        nu.mul_(b2).add_(g[k] * g[k], alpha=1 - b2)
        w[k].sub_(lr * (mu / c1.item())
                  / (torch.sqrt(nu / c2.item()) + eps))


def fit_draft_heads(cfg: ModelConfig, params: dict, streams: Any, *,
                    n_heads: int = 4, head_dim: int = 64, steps: int = 300,
                    lr: float = 1e-2, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """Train medusa-style draft heads (:func:`draft_head_specs`) by
    distillation on the model's own trajectories: head ``h`` learns
    ``token[t + h + 2]`` from the hidden state at ``t``, ``lm_head`` frozen
    and shared.  ``w2`` starts at zero, so each head begins as the plain
    next-token head; ``w1`` is drawn from a ``torch.Generator`` seeded
    with ``seed`` on the params' device (the JAX package draws it with
    threefry, so the two fits start from other weights).  Full-batch Adam
    for ``steps`` steps.

    Args:
      streams: token sequences, each longer than ``n_heads + 2`` (e.g.
        finished requests' histories).
    Returns:
      {"w1", "w2"} float32 tensors for ``params["draft_heads"]``."""
    seqs = [list(s) for s in streams if len(s) > n_heads + 2]
    if not seqs:
        raise ValueError("fit_draft_heads needs a non-empty stream set")
    dev = params["lm_head"].device
    xs, ys, ms = [], [], []
    with torch.no_grad():
        for s in seqs:
            t = torch.tensor(s, dtype=torch.int64, device=dev)
            xs.append(hidden_states(params, cfg, t[None])[0])   # (L, D)
            tgt = torch.zeros((n_heads, len(s)), dtype=torch.int64,
                              device=dev)
            mask = torch.zeros((n_heads, len(s)), device=dev)
            for h in range(n_heads):
                n_valid = max(len(s) - h - 2, 0)
                tgt[h, :n_valid] = t[h + 2:]
                mask[h, :n_valid] = 1.0
            ys.append(tgt)
            ms.append(mask)
    x_all = torch.cat(xs, 0)
    y_all = torch.cat(ys, 1)
    m_all = torch.cat(ms, 1)
    lm_head = params["lm_head"].float()
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = {"w1": torch.randn((n_heads, cfg.d_model, head_dim), generator=gen,
                           device=dev) * 0.02,
         "w2": torch.zeros((n_heads, head_dim, cfg.d_model), device=dev)}
    opt = {"mu": {k: torch.zeros_like(v) for k, v in w.items()},
           "nu": {k: torch.zeros_like(v) for k, v in w.items()}}
    for i in range(steps):
        wg = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        loss = draft_head_loss(wg, x_all, y_all, m_all, lm_head)
        g = dict(zip(wg, torch.autograd.grad(loss, list(wg.values()))))
        with torch.no_grad():
            adam_update(w, g, opt, i, lr)
    return w
