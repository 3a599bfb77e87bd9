"""Paged serving demo of the PyTorch port (the twin of
``examples/serve_paged.py``): the smoke-reduced qwen2-7b (or ``--arch``,
any arch of the registry at smoke size) served with zero-copy admission,
copy-on-write prefix sharing, SVA/TLB statistics and the adaptive
translation front-end.

Most requests open with the same system prompt, so admission maps the
already-resident prefix pages (refcount++) and prefills only each prompt's
suffix; an exact-duplicate prompt also shares the partial tail page and
CoW-duplicates it on its first divergent token.

  PYTHONPATH=src python -m repro_torch.launch.serve_paged --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_paged --device cpu \\
      --tlb-prefetch stream --tlb-autotune 4
  PYTHONPATH=src python -m repro_torch.launch.serve_paged --device cpu \\
      --scheduler continuous        # or: --disagg share | copy
  PYTHONPATH=src python -m repro_torch.launch.serve_paged --device cpu \\
      --arch olmoe-1b-7b            # or: kimi-k2-1t-a32b, rwkv6-3b,
                                    # jamba-1.5-large-398b,
                                    # seamless-m4t-medium (fixed only)

``--scheduler continuous`` serves the same requests as two bursty arrival
waves over an oversubscribed page pool (``--pool-pages``, 16 by default):
lazy admission, chunked prefill inside mixed decode steps, preemption of
the newest sequence under pool pressure and its resume from warm prefix
pages. ``--disagg share`` (or ``copy``) splits that demo across a 2-slot
prefill worker and a 2-slot decode worker joined by IOMMU-priced KV
transfers (page re-attachment under the decode ASID, or a device-side page
copy). Runs on a CUDA device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.core.serving.disagg import DisaggEngine
from repro_torch.core.serving.engine import ServingEngine
from repro_torch.core.sva.iommu import IOMMU, Sv39Walk, TLBConfig
from repro_torch.models import init_params
from repro_torch.models.params import resolve_device


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tlb-prefetch", default="none",
                    choices=("none", "next_page", "stream"),
                    help="IOTLB prefetch policy on the decode gather stream")
    ap.add_argument("--tlb-prefetch-degree", type=int, default=2,
                    help="prefetch fills issued per trigger")
    ap.add_argument("--tlb-prefetch-distance", type=int, default=4,
                    help="stream run-ahead distance in pages")
    ap.add_argument("--tlb-autotune", type=int, default=0, metavar="STEPS",
                    help="auto-tune the serving TLB geometry online over "
                         "windows of this many decode steps (0 = off)")
    ap.add_argument("--tlb-ranges", type=int, default=0, metavar="N",
                    help="range-coalesced IOTLB entries of up to N pages "
                         "(0 = per-page)")
    ap.add_argument("--scheduler", default="fixed",
                    choices=("fixed", "continuous"))
    ap.add_argument("--disagg", default="off",
                    choices=("off", "copy", "share"),
                    help="a 2-slot prefill worker + a 2-slot decode worker "
                         "(implies the continuous two-wave demo)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="physical KV page pool (0 = n_slots * pages; the "
                         "continuous demo defaults to 16 pages)")
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCH_IDS,
                    help="the arch served, reduced to smoke size")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def _prompts(vocab: int):
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, size=16).tolist()    # shared prefix
    prompts = [system + rng.integers(0, vocab,
                                     size=rng.integers(2, 8)).tolist()
               for _ in range(7)]
    prompts.append(list(prompts[1]))                     # exact duplicate
    prompts += [rng.integers(0, vocab, size=12).tolist()
                for _ in range(2)]                       # unrelated
    return prompts


def main(argv=None) -> int:
    args = _args(argv)
    device = resolve_device(args.device)
    cfg = reduce_for_smoke(get_config(args.arch))
    cfg = dataclasses.replace(
        cfg,
        serve_tlb_prefetch_policy=args.tlb_prefetch,
        serve_tlb_prefetch_degree=args.tlb_prefetch_degree,
        serve_tlb_prefetch_distance=args.tlb_prefetch_distance,
        serve_tlb_autotune=args.tlb_autotune,
        serve_tlb_ranges=args.tlb_ranges,
        # a small TLB when auto-tuning, so the ladder has room to move
        serve_tlb_entries=64 if args.tlb_autotune else cfg.serve_tlb_entries)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    bursty = args.scheduler == "continuous" or args.disagg != "off"
    pool_pages = args.pool_pages or (16 if bursty else 0)
    if args.disagg != "off":
        # The transfer fabric prices each hand-off as the paper's 4-entry
        # IOTLB over a no-LLC Sv39 walk (remote DMA by virtual address).
        eng = DisaggEngine(cfg, params, n_prefill_slots=2, n_decode_slots=2,
                           max_len=128, page_size=8, disagg_mode=args.disagg,
                           xfer_iommu=IOMMU(walk_model=Sv39Walk(llc=False),
                                            tlb=TLBConfig(4, "lru")),
                           pool_pages=pool_pages or None,
                           translation_stats=True, device=device)
    else:
        eng = ServingEngine(cfg, params, n_slots=4, max_len=128, page_size=8,
                            scheduler=args.scheduler,
                            pool_pages=pool_pages or None,
                            translation_stats=True, device=device)
    prompts = _prompts(cfg.vocab_size)
    if bursty:
        print(f"two bursty arrival waves of {len(prompts)} requests over an "
              f"oversubscribed {eng.mgr.pool.n_pages}-page pool "
              f"(disagg={args.disagg})...")
        finished = {}
        # Decode growth (a page per 8 tokens a sequence) oversubscribes the
        # pool, so generations run longer than in the fixed demo.
        rids = [eng.submit(p, max_tokens=24) for p in prompts[:6]]
        for _ in range(3):                     # the second burst lands mid-serve
            eng.step(finished)
        rids += [eng.submit(p, max_tokens=24) for p in prompts[6:]]
        done = {**finished, **eng.run()}
    else:
        print(f"submitting {len(prompts)} requests into 4 slots (8 share a "
              "system prompt, 2 are exact duplicates)...")
        rids = [eng.submit(p, max_tokens=10) for p in prompts]
        done = eng.run()
    for rid in rids[:4]:
        r = done[rid]
        print(f"  req {rid}: ttft "
              f"{(r.first_token_at - r.submitted_at) * 1e3:6.0f}ms "
              f"-> {r.out_tokens}")
    s = eng.stats()
    print(f"\n{s['tokens']} tokens, {s['decode_steps']} decode steps, "
          f"{s['prefills']} prefills on {args.device}")
    print(f"SVA: {s['sva']}")
    print(f"TLB: {s['tlb']}")
    print(f"IOMMU: {s['iommu']}")
    if bursty:
        sc = s["sched"]
        steps = [done[r].first_token_step - done[r].submitted_step
                 for r in rids]
        print(f"scheduler: preemptions={sc['preemptions']} "
              f"resumes={sc['resumes']}; steps-to-first-token "
              f"mean={np.mean(steps):.1f} max={max(steps)}")
    if args.disagg != "off":
        t = s["transfer"]
        print(f"transfers: {t['transfers']} ({args.disagg}): pages shared="
              f"{t['pages_shared']} copied={t['pages_copied']}, payload "
              f"{t['payload_bytes']}B + table {t['table_bytes']}B, "
              f"remote-DMA PTW {t['ptw_cycles']:.0f} cycles")
    # an arch with per-slot state (rings, recurrent layers) shares no prefix
    print(f"prefix cache: {s.get('prefix', 'off')}")
    print(f"prefill tokens saved: {s['prefill_tokens_saved']} "
          f"(shared admissions: {s['shared_admissions']}); "
          f"CoW page copies: {s['cow_page_copies']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
