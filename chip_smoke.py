"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. card + kernel build: nvidia-smi name/power limit, nvcc build time of
     every ``src/repro_torch/kernels/csrc/*.cu``.
  2. kernels vs their plain PyTorch versions at the serving path's shapes
     (Hq=32, Hkv=8, D=64, page 16), fp32 and bf16, plus small mask cases;
     CUDA-event times of kernel, plain version and the library yardstick,
     and each kernel's bound.
  3. full-width llama3.2-1b (bf16, random seeded weights) served by the
     zero-copy paged engine: prefix sharing, CoW, launch counters.
  4. the smoke-reduced llama3.2-1b (fp32) served on cuda and on cpu over the
     same seeded workload: greedy tokens must be identical.
With ``--profile``, phase 3 is served a second time under torch.profiler.
Then one JSON line of per-kernel numbers, and the contract line
``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # fp32 outside the tensor cores
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Decode/prefill shapes of the full-width serve below.
HQ, HKV, D, PAGE = 32, 8, 64, 16
DEC_B, DEC_P = 8, 64
FLASH_B, FLASH_S = 4, 512


def emit(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ------------------------------------------------------------------ phase 1

def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from repro_torch.kernels.build import SOURCES, build
    t0 = time.perf_counter()
    logs = build(SOURCES, ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit("phase1 card+build", card=card, sources=list(SOURCES),
         build_s=round(seconds, 3), ptxas=ptxas)
    return {"card": card}


# ------------------------------------------------------------------ phase 2

def _decode_inputs(dtype, rng):
    """B=8 rows over one pool of B*P pages: lengths 0, 1, a partial page, a
    full table; shared pages; NULL entries; an inactive all-NULL row."""
    total = DEC_B * DEC_P
    null = total
    perm = rng.permutation(total)
    table = np.full((DEC_B, DEC_P), null, np.int32)
    lengths = np.array([0, 1, 23, DEC_P * PAGE, 500, 1, 700, 333], np.int32)
    nxt = 0

    def fresh(n):
        nonlocal nxt
        out = perm[nxt:nxt + n]
        nxt += n
        return out

    for b, ln in enumerate(lengths):
        if b == 5:
            continue                       # inactive slot: all NULL, len 1
        n = -(-int(ln) // PAGE)
        table[b, :n] = fresh(n)
    table[4, :20] = table[3, :20]          # shares the full row's prefix
    table[6, :31] = table[3, :31]          # shares a partial page too
    table[7, :5] = table[4, :5]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    q = mk(DEC_B, HQ, D)
    kp = mk(total, PAGE, HKV, D)
    vp = mk(total, PAGE, HKV, D)
    return (q, kp, vp, torch.from_numpy(table).cuda(),
            torch.from_numpy(lengths).cuda())


def _decode_bound(q, kp, table, lengths) -> tuple:
    """Bytes the decode must move (each valid K/V token once, even when two
    rows share its page; q in, out once) and its flops, for this data."""
    total, page, hkv, d = kp.shape
    tbl = table.cpu().numpy()
    lens = lengths.cpu().numpy()
    tokens = set()
    flops = 0
    for b in range(tbl.shape[0]):
        n = min(int(lens[b]), tbl.shape[1] * page)
        flops += 4 * q.shape[1] * n * d
        for pos in range(n):
            e = int(tbl[b, pos // page])
            if e < total:
                tokens.add((e, pos % page))
    it = kp.element_size()
    nbytes = (2 * len(tokens) * hkv * d * it + 2 * q.numel() * it
              + table.numel() * 4 + lengths.numel() * 4)
    return nbytes, flops


def _bound(nbytes, flops, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_flops(B, Sq, Skv, Hq, D, causal, window, q_offset):
    qp = np.arange(Sq)[:, None] + q_offset
    kp = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    return 4 * B * Hq * D * int(mask.sum())


def phase_kernels() -> dict:
    from repro_torch.kernels import flash_attention_fwd, paged_attention_global
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ref import (
        gather_global_pages, paged_attention_global_ref)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32 here
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    res = {}
    # ---- paged decode
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, tbl, lens = _decode_inputs(dtype, rng)
        for cap in (None, 30.0):
            out = paged_attention_global(q, kp, vp, tbl, lens, softcap=cap)
            ref = paged_attention_global_ref(q, kp, vp, tbl, lens, softcap=cap)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            assert torch.isfinite(out).all(), "decode kernel: non-finite"
            assert (out[0] == 0).all(), "decode kernel: length-0 row != 0"
            assert (out[5] == 0).all(), "decode kernel: all-NULL row != 0"
            assert err <= TOL[dtype], f"decode {dtype} cap={cap}: err {err}"
            emit("phase2 decode", dtype=str(dtype), softcap=cap,
                 max_abs_err=err, tol=TOL[dtype])
        ms = cuda_ms(lambda: paged_attention_global(q, kp, vp, tbl, lens))
        plain = cuda_ms(lambda: paged_attention_global_ref(q, kp, vp, tbl, lens),
                        iters=5)
        # Yardstick: SDPA over K/V already gathered dense (the gather, which
        # is the paged part, is outside the timed call).
        k = gather_global_pages(kp, tbl).reshape(DEC_B, -1, HKV, D)
        v = gather_global_pages(vp, tbl).reshape(DEC_B, -1, HKV, D)
        G = HQ // HKV
        kd = k.repeat_interleave(G, 2).transpose(1, 2).contiguous()
        vd = v.repeat_interleave(G, 2).transpose(1, 2).contiguous()
        pos = torch.arange(kd.shape[2], device="cuda")
        mask = (pos[None] < lens[:, None])[:, None, None, :]
        qd = q[:, :, None, :]
        sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        nbytes, flops = _decode_bound(q, kp, tbl, lens)
        bound, by = _bound(nbytes, flops, dtype)
        emit("phase2 decode timing", dtype=str(dtype), ms=ms, plain_ms=plain,
             sdpa_gathered_ms=sdpa, bound_ms=bound, bound_by=by,
             bytes=nbytes, flops=flops)
        res[("decode", dtype)] = dict(err=err, ms=ms, plain_ms=plain,
                                      sdpa=sdpa, bound=bound, by=by)
    # ---- flash prefill: main shape, then small mask cases
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = [(FLASH_B, FLASH_S, FLASH_S, HQ, HKV, D, True, None, None, 0),
             (2, 100, 100, 8, 2, 64, True, None, 30.0, 0),
             (2, 128, 128, 8, 2, 64, True, 48, None, 0),
             (2, 100, 164, 8, 2, 64, True, None, None, 64),
             (2, 96, 96, 4, 4, 64, False, None, None, 0),
             (2, 80, 80, 4, 2, 16, True, 24, 20.0, 0),
             (1, 70, 90, 4, 1, 32, True, None, None, 20)]
    for dtype in (torch.float32, torch.bfloat16):
        for (B, Sq, Skv, Hq, Hkv, Dh, causal, window, cap, qoff) in cases:
            mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
            q, k, v = mk(B, Sq, Hq, Dh), mk(B, Skv, Hkv, Dh), mk(B, Skv, Hkv, Dh)
            kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
            out = flash_attention_fwd(q, k, v, **kw)
            ref = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            assert torch.isfinite(out).all(), "flash kernel: non-finite"
            assert err <= TOL[dtype], f"flash {dtype} {kw} S={Sq}: err {err}"
            emit("phase2 flash", dtype=str(dtype), B=B, Sq=Sq, Skv=Skv, Hq=Hq,
                 Hkv=Hkv, D=Dh, max_abs_err=err, tol=TOL[dtype], **kw)
            if (B, Sq) != (FLASH_B, FLASH_S):
                continue
            ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, **kw))
            plain = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw), iters=5)
            G = Hq // Hkv
            qt = q.transpose(1, 2).contiguous()
            kt = k.repeat_interleave(G, 2).transpose(1, 2).contiguous()
            vt = v.repeat_interleave(G, 2).transpose(1, 2).contiguous()
            sdpa = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            flops = _flash_flops(B, Sq, Skv, Hq, Dh, causal, window, qoff)
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            bound, by = _bound(nbytes, flops, dtype)
            emit("phase2 flash timing", dtype=str(dtype), ms=ms, plain_ms=plain,
                 library_ms=sdpa, bound_ms=bound, bound_by=by, flops=flops,
                 bytes=nbytes)
            res[("flash", dtype)] = dict(err=err, ms=ms, plain_ms=plain,
                                         sdpa=sdpa, bound=bound, by=by)
    return res


# ------------------------------------------------------------------ phase 3

def requests(vocab: int, rng, n: int = 8, system_len: int = 256,
             lo: int = 100, hi: int = 500):
    """n prompts of lo..hi tokens: half start with one shared system prompt
    of ``system_len`` tokens, and the second repeats the first exactly (it
    is admitted beside it, maps all its pages, and its first decode append
    lands in a shared page: a CoW copy)."""
    system = rng.integers(0, vocab, size=system_len).tolist()
    prompts = []
    for i in range(n - 1):
        if i % 2 == 0:
            # odd suffix: the prompt ends inside a page, so the repeat's
            # first append lands in a page the two share
            suffix = int(rng.integers(lo // 5, hi - system_len)) | 1
            prompts.append(system + rng.integers(0, vocab, size=suffix).tolist())
        else:
            prompts.append(rng.integers(0, vocab,
                                        size=int(rng.integers(lo, hi))).tolist())
    return prompts[:1] + [list(prompts[0])] + prompts[1:]


def serve(cfg, params, device, prompts, max_tokens, n_slots, max_len, page):
    """Serve ``prompts`` on a fresh zero-copy engine; returns (outputs,
    engine, finished, wall seconds)."""
    from repro_torch.core.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                        page_size=page, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_tokens=max_tokens) for p in prompts]
    done = eng.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [done[r].out_tokens for r in rids], eng, done, wall


def check_serve(cfg, eng, outs, prompts, max_tokens) -> dict:
    """What a served run must show on any device; returns its stats."""
    s = eng.stats()
    assert s["staging_copies"] == 0, "zero-copy serve made a staging copy"
    assert all(len(o) == max_tokens for o in outs), "short generation"
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert len({tuple(o) for o in outs}) > 1, "every request decoded alike"
    assert s["shared_admissions"] > 0 and s["prefill_tokens_saved"] > 0
    assert s["cow_page_copies"] > 0, "no CoW page copy was exercised"
    for kv in eng.cache:
        assert torch.isfinite(kv.k_pool).all() and torch.isfinite(kv.v_pool).all()
    return s


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_slots, max_len, new_tokens = 8, 1024, 32
    prompts = requests(cfg.vocab_size, np.random.default_rng(SEED))
    reset_launch_counts()
    outs, eng, done, wall = serve(cfg, params, "cuda", prompts, new_tokens,
                                  n_slots, max_len, PAGE)
    launches = launch_counts()
    s = check_serve(cfg, eng, outs, prompts, new_tokens)
    steps = s["decode_steps"]
    assert launches["paged_attention_global"] == cfg.n_layers * steps, launches
    assert launches["flash_attention_fwd"] >= cfg.n_layers, launches
    ttft = [(r.first_token_at - r.submitted_at) * 1e3 for r in done.values()]
    pool_bytes = sum(kv.k_pool.numel() * kv.k_pool.element_size() * 2
                     for kv in eng.cache)
    emit("phase3 serve", arch=cfg.name, dtype=cfg.activation_dtype,
         n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
         requests=len(prompts), prompt_lens=[len(p) for p in prompts],
         new_tokens=new_tokens, slots=n_slots, max_len=max_len, page=PAGE,
         kv_pool_mib=pool_bytes / 2**20,
         weights_gib=sum(t.numel() * t.element_size()
                         for t in _leaves(params)) / 2**30,
         init_s=init_s, wall_s=wall, tokens=s["tokens"],
         tokens_per_s=s["tokens"] / wall,
         ttft_ms_median=statistics.median(ttft), ttft_ms_max=max(ttft),
         prefill_s=s["prefill_s"], decode_s=s["decode_s"],
         decode_steps=steps, prefills=s["prefills"],
         staging_copies=s["staging_copies"],
         prefill_tokens_saved=s["prefill_tokens_saved"],
         shared_admissions=s["shared_admissions"],
         cow_page_copies=s["cow_page_copies"],
         table_uploads_full=s["table_uploads_full"],
         table_uploads_delta=s["table_uploads_delta"],
         table_upload_bytes=s["table_upload_bytes"], launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return launches, (cfg, params, prompts, new_tokens, n_slots, max_len)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _device_us(ev) -> float:
    return float(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)))


def phase_profile(cfg, params, prompts, new_tokens, n_slots, max_len) -> None:
    """The phase-3 serve again, under torch.profiler: device busy time
    (the sum over device-side events only, kernels and copies, so no time
    is counted twice under the host op that launched it) against wall
    time, and the top device kernels and host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, eng, _, wall = serve(cfg, params, "cuda", prompts, new_tokens,
                                n_slots, max_len, PAGE)
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_ms = sum(_device_us(e) for e in dev) / 1e3
    top = lambda evs, key: [(e.key[:60], e.count, round(key(e) / 1e3, 3))
                            for e in sorted(evs, key=key, reverse=True)[:12]]
    s = eng.stats()
    emit("phase3b profile", wall_s=wall, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / (wall * 1e3),
         device_launches=sum(e.count for e in dev),
         prefill_s=s["prefill_s"], decode_s=s["decode_s"],
         decode_steps=s["decode_steps"],
         top_device_ms=top(dev, _device_us),
         top_host_self_ms=top(host, lambda e: float(e.self_cpu_time_total)))


# ------------------------------------------------------------------ phase 4

def phase_cross_check(device: str = "cuda") -> None:
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    cfg = reduce_for_smoke(get_config("llama3.2-1b"))
    params_cpu = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    params_dev = {k: _to(v, device) for k, v in params_cpu.items()}
    prompts = requests(cfg.vocab_size, np.random.default_rng(SEED), n=6,
                       system_len=20, lo=8, hi=40)
    kw = dict(max_tokens=8, n_slots=4, max_len=64, page=8)
    reset_launch_counts()
    dev_outs, dev_eng, _, _ = serve(cfg, params_dev, device, prompts, **kw)
    launches = launch_counts()
    cpu_outs, cpu_eng, _, _ = serve(cfg, params_cpu, "cpu", prompts, **kw)
    s = check_serve(cfg, dev_eng, dev_outs, prompts, kw["max_tokens"])
    check_serve(cfg, cpu_eng, cpu_outs, prompts, kw["max_tokens"])
    if device == "cuda":
        assert all(n > 0 for n in launches.values()), launches
    same = dev_outs == cpu_outs
    emit("phase4 cuda-vs-cpu", arch=cfg.name, dtype=cfg.activation_dtype,
         device=device, requests=len(prompts), identical_tokens=same,
         launches=launches, shared_admissions=s["shared_admissions"],
         cow_page_copies=s["cow_page_copies"])
    assert same, f"greedy tokens differ: {device} {dev_outs} vs cpu {cpu_outs}"


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also serve the phase-3 requests under "
                         "torch.profiler and print where the time goes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    phase_card()
    res = phase_kernels()
    launches, served = phase_serve()
    if args.profile:
        phase_profile(*served)
    phase_cross_check()
    dec, fl = res[("decode", torch.bfloat16)], res[("flash", torch.bfloat16)]
    kernels = [
        {"name": "paged_attention_global", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention/kernel.py:150",
         "launches": launches["paged_attention_global"],
         "max_abs_err": dec["err"],
         "max_abs_err_fp32": res[("decode", torch.float32)]["err"],
         "ms": dec["ms"], "plain_ms": dec["plain_ms"],
         "bound_ms": dec["bound"], "bound_by": dec["by"],
         "library_ms": None, "sdpa_gathered_ms": dec["sdpa"]},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:67",
         "launches": launches["flash_attention_fwd"],
         "max_abs_err": fl["err"],
         "max_abs_err_fp32": res[("flash", torch.float32)]["err"],
         "ms": fl["ms"], "plain_ms": fl["plain_ms"],
         "bound_ms": fl["bound"], "bound_by": fl["by"],
         "library_ms": fl["sdpa"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
