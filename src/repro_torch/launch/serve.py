"""Serving launcher: the paged engine of the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --requests 8 --max-tokens 12 \
      --offload-mode zero_copy     # or: copy

``--arch`` takes any of ``repro_torch.configs.ARCH_IDS`` (llama3.2-1b,
gemma2-2b, llama3.2-3b, qwen2-7b, olmoe-1b-7b, kimi-k2-1t-a32b,
llama-3.2-vision-90b, rwkv6-3b, seamless-m4t-medium,
jamba-1.5-large-398b). gemma2-2b serves copy mode only while
``--max-len`` fits its sliding window (8 tokens at ``--smoke``), as the
reference. kimi-k2-1t-a32b, llama-3.2-vision-90b and jamba-1.5-large-398b
take ``--smoke`` only (see ``SMOKE_ONLY``). seamless-m4t-medium serves with
zero encoder input of the engine's default 16 frames. Like the
reference's CLI this one passes the engine no ``src_len``, so
llama-3.2-vision-90b does not serve even with ``--smoke``: its 8 smoke
image tokens are not the default 16, and the engine raises ValueError, where
the reference's prefill fails. The recurrent archs (rwkv6-3b, jamba) prefill at exact
lengths, and their chunked scans take only the prompt lengths the
reference's chunking takes: under 64 tokens, or any length ``T`` that
``T // 32`` divides, for rwkv6; under 512, or any ``T`` that ``T // 256``
divides, for jamba's mamba layers.

Runs on a CUDA device unless ``--device cpu`` is given. Same flags and
output as ``repro.launch.serve``: ``zero_copy`` shows ``staging_copies: 0``,
``copy`` (the staging baseline) one staging copy per request.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.core.serving.engine import ServingEngine
from repro_torch.models import init_params
from repro_torch.models.params import resolve_device


# Archs that serve at smoke size only, and why.
SMOKE_ONLY = {"kimi-k2-1t-a32b": "its 61 layers are about 2 TB of bf16 "
                                 "weights, past an 80 GB card",
              "jamba-1.5-large-398b": "398 B parameters are about 0.8 TB of "
                                      "bf16 weights, and one period of 8 "
                                      "layers alone is 84 GiB, past an 80 GB "
                                      "card",
              "llama-3.2-vision-90b": "its 100 layers are about 175 GB of "
                                      "bf16 weights, past an 80 GB card"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--offload-mode", default="zero_copy",
                    choices=["zero_copy", "copy"])
    ap.add_argument("--translation-stats", action="store_true",
                    help="run decode-step page gathers through the IOMMU "
                         "for live IOTLB hit/miss stats (host-side sweep: "
                         "adds per-step overhead, off by default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.arch in SMOKE_ONLY and not args.smoke:
        ap.error(f"--arch {args.arch} needs --smoke: "
                 f"{SMOKE_ONLY[args.arch]}")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=device)
    eng = ServingEngine(cfg, params, n_slots=args.slots, max_len=args.max_len,
                        page_size=args.page_size,
                        offload_mode=args.offload_mode,
                        translation_stats=args.translation_stats,
                        device=device)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    rids = [eng.submit(rng.integers(0, cfg.vocab_size,
                                    size=args.prompt_len).tolist(),
                       max_tokens=args.max_tokens)
            for _ in range(args.requests)]
    done = eng.run()
    wall = time.time() - t0
    for rid in rids:
        r = done[rid]
        ttft = (r.first_token_at - r.submitted_at) * 1e3
        print(f"req {rid}: ttft={ttft:.0f}ms tokens={r.out_tokens[:8]}...")
    s = eng.stats()
    toks = s["tokens"]
    print(f"\n{toks} tokens in {wall:.2f}s ({toks/wall:.1f} tok/s) "
          f"mode={args.offload_mode} device={args.device}")
    print(json.dumps({k: v for k, v in s.items()
                      if k in ("prefills", "decode_steps", "staging_copies",
                               "sva", "tlb", "iommu", "svasan")}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
