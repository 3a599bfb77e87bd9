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
output lines as the reference's. ``--mesh d,m`` trains on a ("data",
"model") mesh of d x m ranks, one process a rank (every arch; a model
axis that does not split its widths is refused with an argparse error
naming them): the launcher starts the ranks itself, or,
under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set),
joins the group its environment names. Ranks talk over gloo with
``--device cpu``, over NCCL with one rank a card where there are d x m
cards, else over gloo with every rank on ``cuda:0``. Rank 0 prints the
lines; an injected failure restarts every rank from the last checkpoint,
each restoring its blocks. Checkpoints are written in the reference's
layout (blocks stacked, ``models.params.stack_blocks``), so the two
launchers restore each other's, on any mesh shape. The recurrent archs take only the
``--seq`` lengths their chunked scans reshape (rwkv6: under 64 or a
multiple of ``seq // 32``; mamba: under 512 or a multiple of
``seq // 256``), as the reference's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.checkpoint.ckpt import latest_step, restore, save
from repro_torch.configs import ARCH_IDS, get_config, reduce_for_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import MeshInfo, NO_MESH, init_params
from repro_torch.models.model import mesh_train_refusal
from repro_torch.models.params import (model_specs, resolve_device,
                                       shardings, stack_blocks, stack_specs,
                                       torch_dtype, unstack_blocks)
from repro_torch.optim import OptState, init_opt_state, opt_state_specs
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


def ckpt_shardings(cfg, mi: MeshInfo, with_ef: bool) -> dict:
    """The Shardings of :func:`ckpt_state`'s tree on ``mi``'s mesh."""
    specs = stack_specs(model_specs(cfg))
    return {"params": shardings(specs, mi),
            "opt": shardings(opt_state_specs(specs, with_ef), mi)}


def parse_mesh(text: str):
    d, m = (int(x) for x in text.split(","))
    if d < 1 or m < 1:
        raise ValueError(text)
    return d, m


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
    cfg = build(args)
    if not args.mesh:
        train(args, cfg, resolve_device(args.device))
        return 0
    try:
        d, m = parse_mesh(args.mesh)
    except ValueError:
        ap.error(f"--mesh takes d,m (two positive integers), not "
                 f"{args.mesh!r}")
    why = mesh_train_refusal(cfg, m)
    if why:
        ap.error(f"--mesh {args.mesh}: {why}")
    if args.device == "cuda":
        resolve_device("cuda")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:   # torchrun
        if int(os.environ["WORLD_SIZE"]) != d * m:
            ap.error(f"--mesh {args.mesh} needs {d * m} ranks; the group "
                     f"has {os.environ['WORLD_SIZE']}")
        mesh_rank(int(os.environ["RANK"]), args, cfg, "env://")
        return 0
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    mp.spawn(mesh_rank, args=(args, cfg, f"tcp://localhost:{port}"),
             nprocs=d * m, join=True)
    return 0


def mesh_rank(rank: int, args, cfg, init_method: str) -> None:
    """One rank of ``--mesh``: join the group, build the mesh, train.
    Only rank 0 prints."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    d, m = parse_mesh(args.mesh)
    world = d * m
    if args.device == "cpu":
        device, backend = torch.device("cpu"), "gloo"
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    elif torch.cuda.device_count() >= world:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device, backend = torch.device("cuda", local), "nccl"
    else:
        device, backend = torch.device("cuda", 0), "gloo"
    init_distributed(rank, world, init_method, device=device,
                     backend=backend)
    try:
        mi = MeshInfo(make_mesh((d, m), ("data", "model"),
                                device=device.type))
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink if rank else sys.stdout):
            train(args, cfg, device, mi)
    finally:
        dist.destroy_process_group()


def train(args, cfg, device: torch.device, mi: MeshInfo = NO_MESH) -> None:
    """The training loop with checkpoints and restarts, on one device or as
    one rank of ``mi``'s mesh (its blocks of the parameters and the
    optimizer state; every rank draws the same global batches)."""
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
    step_fn = make_train_step(cfg, tc, mi)
    act = torch_dtype(cfg.activation_dtype)
    placed = ckpt_shardings(cfg, mi, with_ef) if mi.active else None

    def train_loop(resume) -> int:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, gen, device, mi=mi)
        opt = init_opt_state(params, with_ef=with_ef)
        start = 0
        if resume is not None and args.ckpt_dir:
            step = latest_step(args.ckpt_dir)
            if step is not None:
                params, opt = from_ckpt_state(restore(
                    args.ckpt_dir, step, ckpt_state(params, opt),
                    shardings=placed))
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
                                   ckpt_state(params, opt), executor=executor,
                                   shardings=placed, mi=mi)
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


if __name__ == "__main__":
    raise SystemExit(main())
