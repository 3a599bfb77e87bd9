"""Serving launcher: the zero-copy paged engine of the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --requests 8 --max-tokens 12

Runs on a CUDA device unless ``--device cpu`` is given. Same flags and
output as ``repro.launch.serve``; ``--offload-mode copy`` is not ported and
raises.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.serving.engine import ServingEngine
from repro_torch.models import init_params
from repro_torch.models.params import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
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
