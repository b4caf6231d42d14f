"""Serving CLI and static-batch API of the port: chunked prefill, continuous
batching, paged or contiguous KV, quantized pages, prefix cache, page dedup,
SLO admission, the degrade ladder, sampling and speculative decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --requests 8 --slots 4 --prompt-len 512 --gen 32 --slo-ms 2000 \
        --kv-dtype int8 --temperature 0.8 --top-k 40

Requests flow through :func:`serve_batch` into
:class:`repro_torch.serve.ServeEngine` on the card (``--device cpu`` runs
the plain PyTorch path instead; ``--reduced`` swaps in the tiny same-family
config).  Weights are random, drawn from ``--seed``; prompts have
staggered lengths around ``--prompt-len``, so finished slots are refilled
mid-flight.  Every request samples with ``--temperature`` / ``--top-k`` /
``--top-p`` and the seed ``--seed``, one shared
:class:`~repro_torch.serve.SamplingParams` as in the JAX CLI
(``--temperature 0``, the default, is greedy).  Every engine knob is an
:class:`~repro_torch.serve.EngineConfig` field bound by
:func:`~repro_torch.serve.add_cli_args`, as in the JAX CLI: decoding is
speculative by default (``--spec-k`` prompt-lookup drafts verified in one
K+1-wide dispatch; ``--no-spec`` decodes one token a step; ``--spec-mode
tree`` / ``auto`` verify token trees), ``--kv-dtype`` picks the page
element type and ``--no-paged-kv`` serves contiguous slots.
``--mesh-shards N`` splits a paged engine's slot batch and page pool into N
shards, each decoding its own lanes over its own block of pages on its own
device: by default the first N CUDA devices, or the comma-separated
``--mesh-devices`` list, where a device may repeat (two shards on one card:
``--mesh-shards 2 --mesh-devices cuda:0,cuda:0``).
``--per-token`` instead runs :func:`generate`, the one-dispatch-per-token
loop kept as the measurement baseline.  ``--burst-smoke`` instead replays
a seeded bursty open-loop trace (:func:`repro_torch.tune.bursty_trace`,
``--requests`` arrivals, SLO ``--slo-ms`` or 900 ms) through
:func:`repro_torch.tune.replay_open_loop` on a virtual clock, with the
degrade ladder on and ``max_seq`` ``--max-seq`` or 128:

    PYTHONPATH=src python -m repro_torch.launch.serve --burst-smoke \
        --requests 24

The flags are the JAX CLI's (``repro/launch/serve.py``).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.models.common import init_params
from repro_torch.models.registry import serve_api
from repro_torch.serve import (EngineConfig, SamplingParams, ServeEngine,
                               add_cli_args, config_from_args, prng,
                               state_zeros)
from repro_torch.tree import leaves
from repro_torch.tune.workloads import bursty_trace, replay_open_loop

__all__ = ["main", "generate", "serve_batch", "batch_config"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts: np.ndarray, gen: int,
             greedy: bool = True, seed: int = 0,
             device: Optional[Union[str, torch.device]] = None):
    """The per-token serve loop (the measurement baseline).

    prompts: (B, P) int token ids.  Returns ((B, P + gen) int64 ids, stats).
    One ``decode_step`` dispatch per token for every position, prefill
    included, with a 0-d index (every row in lockstep) over dense zero
    state of ``P + gen`` positions: the dispatch-bound shape the engine
    replaces.  GQA attends split-K over pages of ``cfg.decode_page_size``
    when it divides ``P + gen`` (the page combine is the ``moa_reduce``
    kernel on the card), else with one softmax.  ``greedy=False`` draws
    each token with ``jax.random.categorical`` of the key ``seed`` split
    once a step, as the JAX package's ``generate`` does (the port's
    threefry, :mod:`repro_torch.serve.prng`).  ``device``: ``None`` is the
    card (raises without one); ``params`` must live there."""
    dev = resolve_device(device)
    api = serve_api(cfg)
    b, p = prompts.shape
    max_seq = p + gen
    state = state_zeros(api.decode_state_specs(cfg, b, max_seq), dev)
    toks = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                           device=dev)

    def step(tok, i):
        return api.decode_step(params, state,
                               {"tokens": tok, "index": torch.tensor(
                                   i, device=dev)}, cfg)[0]

    # warm up outside the timed region (first kernel use, cuBLAS handles),
    # then zero the state again: a recurrent family's step advances its
    # whole state, not only position 0
    step(toks[:, :1], 0)
    for t in leaves(state):
        t.zero_()
    _sync(dev)
    out = [toks]
    key = prng.prng_key(torch.tensor(seed, device=dev))
    t_prefill = t_decode = 0.0
    cur = None
    for i in range(max_seq - 1):
        tok_i = toks[:, i:i + 1] if i < p else cur
        t0 = time.perf_counter()
        logits = step(tok_i, i)
        _sync(dev)
        dt = time.perf_counter() - t0
        if i < p - 1:
            t_prefill += dt
            continue
        t_decode += dt
        if greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            # jax.random.split(key): the cipher of counters (0, 0), (0, 1)
            key, sub = prng.fold_in(key, 0), prng.fold_in(key, 1)
            noise = prng.gumbel(sub, logits.numel()).reshape(logits.shape)
            nxt = torch.argmax(noise + logits, dim=-1)
        cur = nxt[:, None]
        out.append(cur)
    ids = torch.cat(out, dim=1).cpu().numpy()
    return ids, {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "prefill_tok_s": b * (p - 1) / max(t_prefill, 1e-9),
        "decode_tok_s": b * gen / max(t_decode, 1e-9)}


def batch_config(prompts, gens, *, config=None, slots=None, max_seq=None,
                 **knobs) -> EngineConfig:
    """Resolve the :func:`serve_batch` knob surface into ONE
    :class:`~repro_torch.serve.EngineConfig` (planning only: no engine is
    built).

    Args:
      prompts: list of 1-D int token lists (sizes the derived capacity).
      gens: per-request generation lengths (int or list).
      config: a ready-made config; mutually exclusive with ``knobs``.
      slots: alias for ``max_slots``; overrides the config when given.
      max_seq: per-slot cache capacity.  ``0`` derives it from the longest
        request (padded to 16); ``None`` (default) derives too unless an
        explicit ``config`` was given (whose ``max_seq`` then stands); any
        other value is used as is.
      knobs: any other :class:`~repro_torch.serve.EngineConfig` field by
        name.

    Returns:
      The populated (unresolved) config the engine will run."""
    if config is not None and knobs:
        raise TypeError(
            f"pass engine knobs via config= OR as keywords, not both "
            f"(got config= plus {sorted(knobs)})")
    ecfg = config if config is not None else EngineConfig(**knobs)
    if slots is not None:
        ecfg = ecfg.replace(max_slots=slots)
    if max_seq:
        ecfg = ecfg.replace(max_seq=max_seq)
    elif max_seq == 0 or config is None:
        if isinstance(gens, int):
            gens = [gens] * len(prompts)
        need = max(len(p) + g for p, g in zip(prompts, gens))
        ecfg = ecfg.replace(max_seq=max(16, -(-need // 16) * 16))
    return ecfg


def serve_batch(cfg, params, prompts, gens, *, config=None, slots=None,
                max_seq=None, sampling=None, slo_ms=None,
                device: Optional[Union[str, torch.device]] = None,
                devices: Optional[Sequence[Union[str, torch.device]]] = None,
                **knobs):
    """Run a list of requests through one engine; returns (outputs, stats).

    Args:
      cfg, params: the model config and parameters (on ``device``).
      prompts: list of 1-D int token lists.
      gens: per-request generation lengths (int or list).
      config, slots, max_seq, knobs: the engine knobs, as
        :func:`batch_config` takes them.
      sampling: per-request :class:`SamplingParams`, one shared instance,
        or None for greedy decoding everywhere.
      slo_ms: per-request completion-latency SLO in ms (scalar or list;
        None = no SLO).
      device: ``None`` is the card (raises without one); ``"cpu"`` the
        plain PyTorch path.
      devices: each shard's device when the knobs shard the engine
        (``mesh_shards > 1``; :class:`~repro_torch.serve.mesh.MeshPlan`).

    Returns:
      (outputs, stats): per-request generated-token lists in submission
      order, and the engine's
      :meth:`~repro_torch.serve.ServeEngine.stats_summary`.  The engine is
      warmed up (:meth:`~repro_torch.serve.ServeEngine.warmup`) before the
      first submission, so no request's SLO clock pays for it."""
    n = len(prompts)
    if isinstance(gens, int):
        gens = [gens] * n
    if sampling is None or isinstance(sampling, SamplingParams):
        sampling = [sampling] * n
    if slo_ms is None or isinstance(slo_ms, (int, float)):
        slo_ms = [slo_ms] * n
    ecfg = batch_config(prompts, gens, config=config, slots=slots,
                        max_seq=max_seq, **knobs)
    eng = ServeEngine(cfg, params, config=ecfg, device=device,
                      devices=devices)
    eng.warmup()
    reqs = [eng.submit(list(p), g, sampling=sp, slo_ms=sl)
            for p, g, sp, sl in zip(prompts, gens, sampling, slo_ms)]
    eng.run()
    return [r.generated for r in reqs], eng.stats_summary()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (fp32)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="mean prompt length (lengths are staggered)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--per-token", action="store_true",
                    help="run the per-token baseline loop (generate) "
                         "instead")
    ap.add_argument("--burst-smoke", action="store_true",
                    help="replay a seeded bursty open-loop trace on the "
                         "virtual clock instead (exercises SLO pressure, "
                         "the degrade ladder and shedding end to end)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus truncation (1.0 = disabled)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request completion-latency SLO in ms "
                         "(enables deadline-aware admission)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    ap.add_argument("--mesh-devices", default=None,
                    help="comma-separated device of each --mesh-shards "
                         "shard, a device may repeat (default: the first "
                         "--mesh-shards CUDA devices)")
    # every engine knob: --slots, --max-seq, --prefill-chunk, --page,
    # --no-prefix-cache, --min-prefix, --no-paged-kv, --pool-pages,
    # --trie-capacity, --spec-k / --no-spec and the spec flags,
    # --kv-dtype, --page-dedup, --degrade, --mesh-shards
    add_cli_args(ap)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    try:
        api = serve_api(cfg)
    except ValueError as e:         # encoder-only: no decode step
        raise SystemExit(str(e)) from None
    device = resolve_device(args.device)
    devices = (args.mesh_devices.split(",") if args.mesh_devices
               else None)
    if args.reduced:
        cfg = cfg.reduced(dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(api.param_specs(cfg), gen, device, cfg.dtype)
    rng = np.random.default_rng(args.seed)

    if args.burst_smoke:
        # open-loop burst replay: arrivals do not wait for completions,
        # time is virtual (deterministic given --seed), tokens are real.
        # Degrade + SLOs are forced on: the smoke drives the ladder
        # through shed and back.
        ecfg = config_from_args(args).replace(
            max_seq=(args.max_seq or 128), degrade=True)
        trace = bursty_trace(args.requests, rate=2.0, burst_rate=30.0,
                             mean_prompt=float(args.prompt_len),
                             mean_gen=float(args.gen),
                             max_prompt=ecfg.max_seq // 2,
                             max_gen=ecfg.max_seq // 4, vocab=cfg.vocab,
                             slo_ms=args.slo_ms or 900.0, seed=args.seed)
        eng = ServeEngine(cfg, params, config=ecfg, device=device,
                          devices=devices)
        res = replay_open_loop(eng, trace)
        st = res["stats"]
        print(f"[burst] arch={cfg.arch_id} device={device} "
              f"arrivals={len(trace)} slots={ecfg.max_slots} virtual "
              f"{res['elapsed_s']:.2f}s in {res['steps']} engine steps")
        print(f"goodput {res['goodput_tok_s']:.1f} tok/s (virtual)  "
              f"SLO {res['slo_met']} met / {res['slo_missed']} missed  "
              f"shed {res['shed']}  degrade transitions "
              f"{st['degrade_transitions']:.0f} "
              f"(final level {st['degrade_level']:.0f})")
        shed = [r for r in res["finished"] if r.shed_reason is not None]
        if shed:
            print(f"first shed reason: {shed[0].shed_reason!r}")
        return 0

    if args.per_token:
        prompts = rng.integers(0, cfg.vocab,
                               (args.max_slots, args.prompt_len))
        ids, st = generate(cfg, params, prompts, args.gen,
                           greedy=args.temperature == 0.0, seed=args.seed,
                           device=device)
        print(f"[per-token] arch={cfg.arch_id} device={device} "
              f"batch={args.max_slots} prompt={args.prompt_len} "
              f"gen={args.gen}")
        print(f"prefill {st['prefill_s']:.3f}s ({st['prefill_tok_s']:.1f} "
              f"tok/s)  decode {st['decode_s']:.3f}s "
              f"({st['decode_tok_s']:.1f} tok/s)")
        print(f"first request ids: {ids[0, :args.prompt_len].tolist()} -> "
              f"{ids[0, args.prompt_len:].tolist()}")
        return 0

    lens = [max(1, args.prompt_len + int(d))
            for d in rng.integers(-args.prompt_len // 2,
                                  args.prompt_len // 2 + 1, args.requests)]
    prompts = [rng.integers(0, cfg.vocab, (n,)).tolist() for n in lens]
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed)
    ecfg = batch_config(prompts, args.gen, config=config_from_args(args),
                        max_seq=args.max_seq)
    resolved = ecfg.resolve(cfg)
    outs, st = serve_batch(cfg, params, prompts, args.gen, config=ecfg,
                           sampling=sampling, slo_ms=args.slo_ms,
                           device=device, devices=devices)
    print(f"[engine] arch={cfg.arch_id} device={device} "
          f"requests={args.requests} slots={resolved.max_slots} "
          f"gen={args.gen} prompt_lens={lens} page={resolved.page_size} "
          f"paged_kv={resolved.paged_kv}")
    print(f"kv pool: kv_dtype={st['kv_dtype']} "
          f"{st['kv_bytes_per_slot']} bytes a slot, {st['pool_bytes']} "
          f"bytes in all; sampling={sampling}")
    print(f"prefill {st['prefill_s']:.3f}s ({st['prefill_tok_s']:.1f} tok/s, "
          f"{st['prefill_dispatches']} dispatches)  decode "
          f"{st['decode_s']:.3f}s ({st['decode_tok_s']:.1f} tok/s, "
          f"{st['decode_steps']} steps)  moa_reduce launches "
          f"{st['moa_reduce_launches']}")
    print(f"prefix cache: {st['prefix_hits']} hits / {st['prefix_misses']} "
          f"misses ({st['prefix_reused_tokens']} tokens reused, "
          f"{st['pages_shared']} pages shared by reference, "
          f"{st['prefix_bytes_copied']} bytes copied); dedup "
          f"{st['dedup_pages_shared']} pages shared")
    if st["spec_k"]:
        print(f"speculative decode (k={st['spec_k']}): "
              f"{st['tokens_per_step']:.2f} tokens/step, "
              f"accept rate {st['spec_accept_rate']:.0%}, "
              f"draft hit rate {st['spec_draft_hit_rate']:.0%}, "
              f"decode step p50 {st['decode_step_p50_s'] * 1e3:.2f}ms / "
              f"p99 {st['decode_step_p99_s'] * 1e3:.2f}ms")
    if st["spec_mode"] != "chain":
        print(f"tree speculation (mode={st['spec_mode']}, "
              f"nodes={st['spec_tree_nodes']}, "
              f"branch={st['spec_branch']}, "
              f"drafter={st['spec_drafter']}): "
              f"{st['spec_tree_steps']} tree steps, "
              f"accept p50 {st['spec_accept_p50']:.2f} / "
              f"p99 {st['spec_accept_p99']:.2f}, "
              f"shape picks chain={st['spec_shape_chain']} "
              f"tree={st['spec_shape_tree']}")
    if st["mesh_shards"] > 1:
        print(f"mesh: {st['mesh_shards']} shards, lane steps "
              f"{st['shard_lane_steps']}, occupancy skew "
              f"{st['shard_occupancy_skew']:.2f}")
    if args.slo_ms is not None:
        print(f"SLO {args.slo_ms:.0f}ms: {st['slo_met']} met / "
              f"{st['slo_missed']} missed  (preemptions "
              f"{st['preemptions']}, shed {st['shed_requests']})")
    print(f"first request: {prompts[0]} -> {outs[0]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
