"""Serving CLI of the port: chunked prefill, continuous batching, quantized
KV pages, prefix cache, page dedup, SLO admission, the degrade ladder,
sampling and speculative decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --requests 8 --slots 4 --prompt-len 512 --gen 32 --slo-ms 2000 \
        --kv-dtype int8 --temperature 0.8 --top-k 40

Requests flow through :class:`repro_torch.serve.ServeEngine` on the card
(``--device cpu`` runs the plain PyTorch path instead; ``--reduced`` swaps
in the tiny same-family config).  Weights are random, drawn from
``--seed``; prompts have staggered lengths around ``--prompt-len``, so
finished slots are refilled mid-flight.  Every request samples with
``--temperature`` / ``--top-k`` / ``--top-p`` and the seed ``--seed``, one
shared :class:`~repro_torch.serve.SamplingParams` as in the JAX CLI
(``--temperature 0``, the default, is greedy), over a KV pool of
``--kv-dtype`` pages.  As in the JAX CLI, decoding is
speculative by default: ``--spec-k`` prompt-lookup drafts verified
in one K+1-wide dispatch (``--no-spec`` decodes one token a step);
``--spec-mode tree`` drafts a token tree per slot (n-gram fan-out, or
``--spec-drafter heads`` when the params carry draft heads), verified in
one ancestor-masked dispatch, and ``--spec-mode auto`` picks chain or tree
per slot per step.  The flags are the JAX CLI's (``repro/launch/serve.py``)
for what the port has.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.models.common import init_params
from repro_torch.models.registry import get_api
from repro_torch.serve import EngineConfig, SamplingParams, ServeEngine
from repro_torch.serve.config import (add_kv_dtype_arg, add_spec_args,
                                      spec_knobs)

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (fp32)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch width (concurrent requests)")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="mean prompt length (lengths are staggered)")
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=0,
                    help="per-slot cache capacity (0 = derive from the "
                         "requests, padded to 16)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="max tokens per prefill dispatch")
    ap.add_argument("--page", type=int, default=None,
                    help="KV page size (default auto)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false", default=True,
                    help="disable prefix-cache reuse across requests")
    ap.add_argument("--min-prefix", type=int, default=8,
                    help="smallest resident-prefix match worth reusing")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical page-pool size (default: one full row "
                         "per slot)")
    ap.add_argument("--trie-capacity", type=int, default=None,
                    help="LRU bound on prefix-trie entries (default: "
                         "unbounded)")
    ap.add_argument("--page-dedup", action="store_true",
                    help="content-hash full pages at admission and share "
                         "byte-identical ones by reference")
    ap.add_argument("--degrade", action="store_true",
                    help="enable the overload degrade ladder (smaller "
                         "prefill chunks -> shed hopeless pending requests, "
                         "hysteretic recovery)")
    add_spec_args(ap, spec_k_default=4)
    add_kv_dtype_arg(ap)
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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype=torch.float32)
    api = get_api(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(api.param_specs(cfg), gen, device, cfg.dtype)
    rng = np.random.default_rng(args.seed)
    lens = [max(1, args.prompt_len + int(d))
            for d in rng.integers(-args.prompt_len // 2,
                                  args.prompt_len // 2 + 1, args.requests)]
    prompts = [rng.integers(0, cfg.vocab, (n,)).tolist() for n in lens]
    max_seq = args.max_seq or max(16, -(-(max(lens) + args.gen) // 16) * 16)
    ecfg = EngineConfig(max_slots=args.slots, max_seq=max_seq,
                        prefill_chunk=args.prefill_chunk,
                        page_size=args.page, prefix_cache=args.prefix_cache,
                        min_prefix=args.min_prefix,
                        pool_pages=args.pool_pages,
                        trie_capacity=args.trie_capacity,
                        page_dedup=args.page_dedup, degrade=args.degrade,
                        kv_dtype=args.kv_dtype, **spec_knobs(args))
    eng = ServeEngine(cfg, params, config=ecfg, device=device)
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              seed=args.seed)
    reqs = [eng.submit(p, args.gen, slo_ms=args.slo_ms, sampling=sampling)
            for p in prompts]
    eng.run()
    st = eng.stats_summary()
    print(f"[engine] arch={cfg.arch_id} device={device} "
          f"requests={args.requests} slots={args.slots} gen={args.gen} "
          f"prompt_lens={lens} page={eng.page_size}")
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
    if args.slo_ms is not None:
        print(f"SLO {args.slo_ms:.0f}ms: {st['slo_met']} met / "
              f"{st['slo_missed']} missed  (preemptions "
              f"{st['preemptions']}, shed {st['shed_requests']})")
    print(f"first request: {prompts[0]} -> {reqs[0].generated}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
