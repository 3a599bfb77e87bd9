"""Training launcher of the PyTorch port: synthetic data -> train_step loop
with checkpointing, failure injection, straggler detection, and restart
from the last checkpoint (port of ``repro/launch/train.py``, one device).

Examples:
  # reduced llama on the CPU, 30 steps, a checkpoint every 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --device cpu --steps 30 --batch 4 --seq 128 --ckpt-dir /tmp/ck

  # inject a failure at step 7 and watch the restart path
  ... --steps 12 --ckpt-every 5 --inject-failure-at 7

Runs on a CUDA device unless ``--device cpu`` is given. Same flags and
output lines as the reference's; ``--mesh`` is refused, since training
on a mesh is not ported yet. Checkpoints are written in the
reference's layout (blocks stacked, ``models.params.stack_blocks``), so the
two launchers restore each other's. The recurrent archs take only the
``--seq`` lengths their chunked scans reshape (rwkv6: under 64 or a
multiple of ``seq // 32``; mamba: under 512 or a multiple of
``seq // 256``), as the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.checkpoint.ckpt import latest_step, restore, save
from repro_torch.configs import ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.params import (resolve_device, stack_blocks,
                                       torch_dtype, unstack_blocks)
from repro_torch.optim import OptState, init_opt_state
from repro_torch.runtime.ft import (FailureInjector, StragglerDetector,
                                    run_with_restarts)


def build(args):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if args.layers:
        cfg = dataclasses.replace(
            cfg, n_layers=cfg.first_k_dense + args.layers * len(cfg.block_pattern))
    if args.d_model:
        head = max(args.d_model // max(cfg.n_heads, 1), 8)
        # scale_embeddings: from-scratch stability, as the reference's
        cfg = dataclasses.replace(cfg, d_model=args.d_model, d_head=head,
                                  d_ff=4 * args.d_model,
                                  vocab_size=min(cfg.vocab_size, 32768),
                                  scale_embeddings=True)
    return cfg


def ckpt_state(params, opt: OptState) -> dict:
    """{"params", "opt"} in the reference's layout (the blocks stacked)."""
    moment = lambda t: None if t is None else stack_blocks(t)
    return {"params": stack_blocks(params),
            "opt": opt._replace(master=moment(opt.master), mu=moment(opt.mu),
                                nu=moment(opt.nu), ef=moment(opt.ef))}


def from_ckpt_state(state: dict):
    """(params, opt) in the port's layout from :func:`ckpt_state`'s."""
    opt = state["opt"]
    moment = lambda t: None if t is None else unstack_blocks(t)
    return unstack_blocks(state["params"]), opt._replace(
        master=moment(opt.master), mu=moment(opt.mu), nu=moment(opt.nu),
        ef=moment(opt.ef))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0, dest="d_model")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--mesh", default="", help="e.g. 4,1 -> data=4,model=1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error("--mesh is not ported yet: training on a mesh (ROADMAP "
                 "queue 1, item 2b) brings it, and this launcher runs on "
                 "one device")

    cfg = build(args)
    device = resolve_device(args.device)
    tc = TrainConfig(lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     grad_compression=args.grad_compression,
                     microbatches=args.microbatches)
    with_ef = tc.grad_compression == "int8_ef"

    injector = FailureInjector(
        fail_at_steps=(args.inject_failure_at,) if args.inject_failure_at >= 0
        else ())
    straggler = StragglerDetector()
    executor = ThreadPoolExecutor(max_workers=1)
    step_fn = make_train_step(cfg, tc)
    act = torch_dtype(cfg.activation_dtype)

    def train_loop(resume) -> int:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, gen, device)
        opt = init_opt_state(params, with_ef=with_ef)
        start = 0
        if resume is not None and args.ckpt_dir:
            step = latest_step(args.ckpt_dir)
            if step is not None:
                params, opt = from_ckpt_state(restore(
                    args.ckpt_dir, step, ckpt_state(params, opt)))
                start = step
                print(f"[train] restored step {step}", flush=True)
        data = make_pipeline(cfg.vocab_size, args.batch, args.seq, args.seed)
        pending = None
        t_all = time.time()
        try:
            for step in range(start, args.steps):
                injector.check(step)
                toks, labels = next(data)
                batch = {"tokens": torch.from_numpy(toks).to(device, torch.long),
                         "labels": torch.from_numpy(labels).to(device,
                                                               torch.long)}
                if cfg.is_encdec:
                    batch["enc_x"] = torch.zeros(
                        (args.batch, 32, cfg.d_model), dtype=act, device=device)
                elif cfg.n_image_tokens:
                    batch["img_x"] = torch.zeros(
                        (args.batch, cfg.n_image_tokens, cfg.d_model),
                        dtype=act, device=device)
                t0 = time.time()
                params, opt, metrics = step_fn(params, opt, batch)
                loss = float(metrics["loss"])
                dt = time.time() - t0
                slow = straggler.record(step, dt)
                if step % args.log_every == 0:
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms"
                          + ("  [straggler]" if slow else ""), flush=True)
                if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                    if pending is not None:
                        pending.result()
                    pending = save(args.ckpt_dir, step + 1,
                                   ckpt_state(params, opt), executor=executor)
        finally:
            # Commit any in-flight checkpoint even when a failure is raised
            # mid-loop, or the restart would begin from an older one.
            if pending is not None:
                pending.result()
        data.close()
        print(f"[train] done {args.steps - start} steps in "
              f"{time.time()-t_all:.1f}s; stragglers={len(straggler.events)}",
              flush=True)
        return args.steps

    try:
        run_with_restarts(train_loop, max_restarts=3)
    finally:
        executor.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
