"""Serving CLI of the port: chunked prefill and continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --requests 8 --slots 4 --prompt-len 512 --gen 32

Requests flow through :class:`repro_torch.serve.ServeEngine` on the card
(``--device cpu`` runs the plain PyTorch path instead; ``--reduced`` swaps
in the tiny same-family config).  Weights are random, drawn from
``--seed``; prompts have staggered lengths around ``--prompt-len``, so
finished slots are refilled mid-flight.  Decoding is greedy.  The flags are
the JAX CLI's (``repro/launch/serve.py``) for what the port has.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.models.common import init_params
from repro_torch.models.registry import get_api
from repro_torch.serve import EngineConfig, ServeEngine

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
                        page_size=args.page)
    eng = ServeEngine(cfg, params, config=ecfg, device=device)
    reqs = [eng.submit(p, args.gen) for p in prompts]
    eng.run()
    st = eng.stats_summary()
    print(f"[engine] arch={cfg.arch_id} device={device} "
          f"requests={args.requests} slots={args.slots} gen={args.gen} "
          f"prompt_lens={lens} page={eng.page_size}")
    print(f"prefill {st['prefill_s']:.3f}s ({st['prefill_tok_s']:.1f} tok/s, "
          f"{st['prefill_dispatches']} dispatches)  decode "
          f"{st['decode_s']:.3f}s ({st['decode_tok_s']:.1f} tok/s, "
          f"{st['decode_steps']} steps)  moa_reduce launches "
          f"{st['moa_reduce_launches']}")
    print(f"first request: {prompts[0]} -> {reqs[0].generated}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
