"""The port's training on a mesh against the JAX package's: four ranks
over ``torch.distributed`` (gloo, on the CPU) against the reference on
four host devices (``--xla_force_host_platform_device_count=4``, the
recipe of ``tests/test_multidevice.py``), which holds its sharded train
step on a (2, 2) mesh against one device (``:75-103``).

One JAX subprocess writes every reference array, one ``mp.spawn`` of four
ranks every port array, from the same numpy-seeded inputs and the same
weights (JAX ``init_params`` -> numpy, ``from_jax_params`` on the port's
side, each rank its blocks); this process compares them. They run side
by side. The cases:

  (a) every leaf's resolved spec, for every arch's smoke and full specs,
      against the reference's ``resolve_spec`` (a stand-in mesh of axis
      names and shape) on (2, 2), (4, 1), (1, 4), (16, 16) and the
      multi-pod (2, 16, 16) and (2, 2, 2); each rank's local shapes;
  (b) ``compressed_psum`` under ``shard_map`` on four ranks against the
      reference's on four devices, bit for bit;
  (c) one train step of smoke llama3.2-1b on (2, 2), (4, 1) and (1, 4),
      of smoke qwen2-7b (random QKV biases) on (2, 2), of llama with
      int8_ef and two microbatches on (2, 2), of smoke gemma2-2b (tied,
      softcapped, scaled embedding) on (1, 4) and of llama with a vocab of
      514 (which does not split over 4: the table stays whole, as the
      reference's ``resolve_spec`` leaves it) on (1, 4), against the
      reference's one-device step, and (llama, qwen2) its (2, 2) mesh
      step; replicas bit for bit; on every case with a model axis over 1,
      no embedding leaf gathered over ``model`` (a spy on
      ``dist.all_gather``, which sees the table gathered whole over every
      axis, as the step did before the vocab-parallel path);
  (d) a save on (2, 2), the restore on (4, 1) and on one device, one more
      step each, against two uninterrupted steps; and the JAX launcher's
      checkpoint restored on (2, 2), each rank's blocks against the
      reference's own shards of it on a (2, 2) mesh, bit for bit;
  (e) the cross-attention configs' ``make_train_step`` builds on a mesh
      (their steps are held in ``test_torch_mesh_cross.py``, the MoE and
      recurrent configs' in ``test_torch_mesh_moe.py`` and
      ``test_torch_mesh_recurrent.py``);
  (f) the vocab-parallel embedding and cross-entropy
      (``layers.vocab_parallel_embed``, ``vocab_parallel_xent``) on (1, 4)
      and (2, 2), tied and untied, with and without softcap 30, labels
      and tokens at every block edge, against the reference's
      ``chunked_xent`` of its ``embed`` on the whole leaves (loss 1e-6
      relative, every gradient 1e-5 of its leaf's largest); the planted
      fault, each rank clamping the label into its own block instead of
      masking it, misses by far.
"""
import contextlib
import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import reduce_for_smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 240        # each side takes ~30 s
LR = 1e-3
B, S = 4, 32
# a model -> (arch, its smoke config's fields changed)
MODELS = {"llama3.2-1b-v514": ("llama3.2-1b", {"vocab_size": 514})}
# (c): case -> (model, mesh shape, TrainConfig fields)
STEP_CASES = {"llama_2x2": ("llama3.2-1b", (2, 2), {}),
              "llama_4x1": ("llama3.2-1b", (4, 1), {}),
              "llama_1x4": ("llama3.2-1b", (1, 4), {}),
              "qwen2_2x2": ("qwen2-7b", (2, 2), {}),
              "llama_2x2_int8_mb2": ("llama3.2-1b", (2, 2),
                                     {"grad_compression": "int8_ef",
                                      "microbatches": 2}),
              "gemma2_1x4": ("gemma2-2b", (1, 4), {}),
              "llama_v514_1x4": ("llama3.2-1b-v514", (1, 4), {})}
MESH_CASES = ("llama_2x2", "qwen2_2x2")     # the reference's (2, 2) step too
ARCHS = ("llama3.2-1b", "qwen2-7b", "gemma2-2b", "llama3.2-1b-v514")
SPEC_MESHES = ((("data", "model"), (2, 2)), (("data", "model"), (4, 1)),
               (("data", "model"), (1, 4)), (("data", "model"), (16, 16)),
               (("pod", "data", "model"), (2, 16, 16)),
               (("pod", "data", "model"), (2, 2, 2)))
# (e): the cross-attention archs, whose steps test_torch_mesh_cross.py
# holds against the reference's
CROSS = ("seamless-m4t-medium", "llama-3.2-vision-90b")
LAUNCHER_ARGS = ["--arch", "llama3.2-1b", "--smoke", "--steps", "3",
                 "--batch", "4", "--seq", "32", "--ckpt-every", "3",
                 "--log-every", "100"]


def _cfg(jax_side: bool, model="llama3.2-1b"):
    """The smoke config of ``model`` (an arch, or a name of ``MODELS``)."""
    import dataclasses
    arch, fields = MODELS.get(model, (model, {}))
    if jax_side:
        from repro.configs import get_config
        from repro.configs import reduce_for_smoke as j_reduce
        return dataclasses.replace(j_reduce(get_config(arch)), **fields)
    return dataclasses.replace(reduce_for_smoke(tconfigs.get_config(arch)),
                               **fields)


def _kw(case: str) -> dict:
    return dict(lr=LR, warmup_steps=1, total_steps=10, **STEP_CASES[case][2])


def batch(cfg, i: int) -> dict:
    """Batch ``i``: tokens and labels (B, S), int32, from a seed."""
    r = np.random.default_rng(40 + i)
    return {k: r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def with_biases(arch: str, tree):
    """A numpy parameter tree (the reference's layout) with random QKV
    biases where the arch has them (qwen2: zero at init)."""
    r = np.random.default_rng(7)
    for name, leaf in tree["blocks"]["0"]["attn"].items():
        if name in ("bq", "bk", "bv"):
            tree["blocks"]["0"]["attn"][name] = (
                0.3 * r.standard_normal(leaf.shape)).astype(np.float32)
    return tree


# (f): the vocab-parallel loss's cases, and its inputs' sizes
VOCAB_CASES = [(shape, tied, softcap) for shape in ((1, 4), (2, 2))
               for tied in (True, False) for softcap in (None, 30.0)]
VOCAB, D_VOCAB = 512, 64


def vocab_inputs() -> dict:
    """The whole table (V, d) and head (d, V), x0 (B, S, d) added to the
    embedding, and tokens and labels (B, S) with every vocab block's edges
    on meshes of 2 and 4 model ranks among them; entries of about unit
    size, so a softcap of 30 bends the logits."""
    r = np.random.default_rng(23)
    out = {"table": r.standard_normal((VOCAB, D_VOCAB)),
           "head": r.standard_normal((D_VOCAB, VOCAB)) / 4,
           "x0": r.standard_normal((B, S, D_VOCAB))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    edges = sorted({e for m in (2, 4) for b in range(m)
                    for e in (b * VOCAB // m, (b + 1) * VOCAB // m - 1)})
    for i, k in enumerate(("tokens", "labels")):
        t = r.integers(0, VOCAB, (B, S))
        t[i, :len(edges)] = edges
        t[2 + i, -len(edges):] = edges[::-1]
        out[k] = t.astype(np.int32)
    return out


def psum_input() -> np.ndarray:
    return np.random.default_rng(5).standard_normal((4, 256)).astype(
        np.float32)


def _np_opt(o) -> dict:
    return {f: getattr(o, f) for f in ("master", "mu", "nu", "ef", "count")}


# ---------------------------------------------------------------- the reference

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{src!r}, {tests!r}]
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.checkpoint.ckpt import restore
from repro.configs import TrainConfig
from repro.launch import train as jtrain
from repro.launch.mesh import make_host_mesh, make_mesh, mesh_context
from repro.launch.steps import make_train_step
from repro.models import MeshInfo, NO_MESH, init_params, model_specs
from repro.models.dist import shard_map
from repro.models.params import shardings
from repro.optim import init_opt_state, opt_state_specs
from repro.optim.compression import compressed_psum
import test_torch_mesh_train as T

out = {{}}
host = lambda t: jax.tree.map(np.asarray, t)
mesh4 = make_mesh((4,), ("data",))
with mesh_context(mesh4):
    out["psum"] = np.asarray(jax.jit(shard_map(
        lambda x: compressed_psum(x, "data"), mesh=mesh4, in_specs=P("data"),
        out_specs=P("data")))(jnp.asarray(T.psum_input())))

from repro.models import layers as jl
v = {{k: jnp.asarray(a) for k, a in T.vocab_inputs().items()}}
for tied in (True, False):
    for softcap in (None, 30.0):
        def f(table, head, x0):
            p = {{"table": table}} if tied else {{"table": table, "head": head}}
            x = jl.embed(p, v["tokens"]) + x0
            return jl.chunked_xent(p, x, v["labels"], softcap)
        loss, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
            v["table"], v["head"], v["x0"])
        out[("vocab", tied, softcap)] = host(dict(
            loss=loss, table=grads[0], head=grads[1], x0=grads[2]))

mesh22 = make_host_mesh(data=2, model=2)
params = {{a: T.with_biases(a, host(init_params(T._cfg(True, a),
                                              jax.random.key(0))))
          for a in T.ARCHS}}
out["params"] = params
steps = {{}}          # (model, TrainConfig fields) -> the one-device step
for case, (arch, shape, extra) in T.STEP_CASES.items():
    cfg, tc = T._cfg(True, arch), TrainConfig(**T._kw(case))
    ef = tc.grad_compression == "int8_ef"
    p = jax.tree.map(jnp.asarray, params[arch])
    b = {{k: jnp.asarray(v) for k, v in T.batch(cfg, 0).items()}}
    step = jax.jit(make_train_step(cfg, tc, NO_MESH))
    key = (arch, tuple(sorted(extra.items())))
    if key not in steps:
        p1, o1, m1 = step(p, init_opt_state(p, with_ef=ef), b)
        steps[key] = (p1, o1, host(dict(params=p1, opt=T._np_opt(o1),
                                        metrics=m1)))
    p1, o1, out[case] = steps[key]
    if case == "llama_2x2":          # (d): two uninterrupted steps
        b2 = {{k: jnp.asarray(v) for k, v in T.batch(cfg, 1).items()}}
        p2, o2, m2 = step(p1, o1, b2)
        out["two_steps"] = host(dict(params=p2, opt=T._np_opt(o2),
                                     metrics=m2))
    if case in T.MESH_CASES:
        with mesh_context(mesh22):
            pm, om, mm = jax.jit(make_train_step(cfg, tc, MeshInfo(mesh22)))(
                p, init_opt_state(p), b)
        out[case + "_mesh"] = host(dict(params=pm, opt=T._np_opt(om),
                                        metrics=mm))

# (d): the launcher's checkpoint, and the reference's own (2, 2) shards of it
ck = {ck!r}
jtrain.main(T.LAUNCHER_ARGS + ["--ckpt-dir", ck])
open({marker!r}, "w").close()
cfg = T._cfg(True)
specs = model_specs(cfg)
sh = {{"params": shardings(specs, mesh22),
       "opt": shardings(opt_state_specs(specs), mesh22)}}
p0 = init_params(cfg, jax.random.key(0))
state = restore(ck, 3, {{"params": p0, "opt": init_opt_state(p0)}},
                shardings=sh)
coords = {{d.id: tuple(int(i) for i in np.argwhere(mesh22.devices == d)[0])
          for d in mesh22.devices.flat}}
shards = {{}}
for i, leaf in enumerate(jax.tree.leaves(state)):
    for s in leaf.addressable_shards:
        shards[(i,) + coords[s.device.id]] = np.asarray(s.data)
out["launcher_shards"] = shards
with open({out_pkl!r}, "wb") as f:
    pickle.dump(out, f)
print("reference OK")
"""


# ---------------------------------------------------------------- the port

def _blocks(tree) -> list:
    from repro_torch.tree import leaves
    return [t.detach().numpy().copy() for t in leaves(tree)]


def _dump(params, opt, m) -> dict:
    out = {k: _blocks(getattr(opt, k)) for k in ("master", "mu", "nu")}
    out["ef"] = _blocks(opt.ef) if opt.ef is not None else None
    out["params"] = _blocks(params)
    out["metrics"] = {k: float(v) for k, v in m.items()}
    return out


@contextlib.contextmanager
def _gathers():
    """Records the axis and the result's shape of every ``dist.all_gather``
    (the collective of ``gather_param``, ``gather_from`` and
    ``gather_whole``) while it is entered."""
    from repro_torch.models import dist
    calls, gather = [], dist.all_gather

    def spy(t, dim, mi, axis):
        out = gather(t, dim, mi, axis)
        calls.append((axis, tuple(out.shape)))
        return out

    with mock.patch.object(dist, "all_gather", spy):
        yield calls


def _vocab_over_model(calls: list, vocab: int) -> list:
    """The gathers over ``model`` whose result has a vocab-sized
    dimension: an embedding leaf gathered whole over the axis."""
    return [c for c in calls if c[0] == "model" and vocab in c[1]]


def _clamped_gold(logits, labels, v0):
    """The planted fault of (f): the label clamped into this rank's block,
    where it should be masked (every rank adds a wrong logit)."""
    n = logits.shape[-1]
    return torch.gather(logits, -1,
                        (labels - v0).clamp(0, n - 1)[..., None])[..., 0]


def _vocab_case(mi, tied: bool, softcap, fault: bool = False) -> dict:
    """(f) on one rank: the vocab-parallel embedding of the tokens plus x0
    and the loss, placed and gathered as ``forward_train`` does (the
    table's and head's vocab over ``model``, d over ``data``, gathered
    over ``data`` at use; the rank's rows of x0 and the batch); the loss
    and the rank's blocks of the gradients."""
    from repro_torch.models import layers
    from repro_torch.models.dist import gather_param, reduce_from
    from repro_torch.models.model import batch_sharding
    from repro_torch.models.params import sharding_of, split_axes
    v = {k: torch.from_numpy(a) for k, a in vocab_inputs().items()}
    specs = {"table": ("tp", "fsdp"), "head": ("fsdp", "tp")}
    names = ("table",) if tied else ("table", "head")
    sh = {k: sharding_of(specs[k], v[k].shape, mi) for k in names}
    rows = batch_sharding((B, S), mi)
    grad_axes = tuple(a for a in split_axes(rows.spec[0]) if mi.size(a) > 1)
    blocks = {k: sh[k].cut(v[k]).clone().requires_grad_() for k in names}
    x0 = rows.cut(v["x0"]).clone().requires_grad_()
    tokens, labels = (rows.cut(v[k]).long() for k in ("tokens", "labels"))
    emb = {k: gather_param(blocks[k], sh[k], mi, ("data",), grad_axes)
           for k in names}
    with (mock.patch.object(layers, "_vocab_gold", _clamped_gold) if fault
          else contextlib.nullcontext()):
        x = layers.vocab_parallel_embed(emb, tokens, mi) + x0
        loss = reduce_from(layers.vocab_parallel_xent(
            emb, x, labels, softcap, mi, count=B * S), mi, grad_axes)
        loss.backward()         # recomputes each chunk: the fault too
    out = {k: blocks[k].grad.numpy().copy() for k in names}
    out.update(loss=loss.item(), x0=x0.grad.numpy().copy())
    return out


def _rank(rank: int, port: int, tmp: str, jparams) -> None:
    """One rank: every port case, results to files."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import (ckpt_shardings, ckpt_state,
                                          from_ckpt_state)
    from repro_torch.models import MeshInfo, from_jax_params
    from repro_torch.models.dist import axis_rank, shard_map
    from repro_torch.models.params import model_specs, shardings
    from repro_torch.optim import init_opt_state
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.tree import leaves
    init_distributed(rank, WORLD, f"tcp://localhost:{port}", device="cpu")
    meshes = {shape: MeshInfo(make_mesh(shape, ("data", "model"),
                                        device="cpu"))
              for shape in ((2, 2), (4, 1), (1, 4))}
    out = {"coords": {str(s): [axis_rank(mi, a) for a in ("data", "model")]
                      for s, mi in meshes.items()}}
    t = lambda b: {k: torch.from_numpy(v).long() for k, v in b.items()}

    mi41 = meshes[(4, 1)]
    out["psum"] = shard_map(lambda x: compressed_psum(x, mi41, "data"), mi41,
                            ("data",), ("data",))(
        torch.from_numpy(psum_input())).numpy()

    for shape, tied, softcap in VOCAB_CASES:        # (f)
        for fault in (False, True):
            out[("vocab", shape, tied, softcap, fault)] = _vocab_case(
                meshes[shape], tied, softcap, fault)

    for case, (arch, shape, _) in STEP_CASES.items():
        mi, cfg, tc = meshes[shape], _cfg(False, arch), TrainConfig(**_kw(case))
        params = from_jax_params(cfg, jparams[arch], device="cpu", mi=mi)
        opt = init_opt_state(params,
                             with_ef=tc.grad_compression == "int8_ef")
        sh = shardings(model_specs(cfg), mi)
        out[case + "_local_shapes"] = [
            [list(x.shape) for x in leaves(tree)]
            for tree in (params, opt.master, opt.mu, opt.nu)]
        step = make_train_step(cfg, tc, mi)
        with _gathers() as calls:
            params, opt, m = step(params, opt, t(batch(cfg, 0)))
        out[case + "_vocab_gathers"] = _vocab_over_model(calls,
                                                         cfg.vocab_size)
        out[case] = _dump(params, opt, m)
        out[case + "_replicas"] = _replicas(
            (params, opt.master, opt.mu, opt.nu), sh, mi)
        if case == "llama_2x2":      # (d): save on (2, 2), restore on (4, 1)
            ck = os.path.join(tmp, "ck")
            held = ckpt_state(params, opt)
            out["saved_2x2"] = _blocks(held)
            save(ck, 1, held, shardings=ckpt_shardings(cfg, mi, False), mi=mi)
            p4 = from_jax_params(cfg, jparams[arch], device="cpu", mi=mi41)
            state = restore(ck, 1, ckpt_state(p4, init_opt_state(p4)),
                            shardings=ckpt_shardings(cfg, mi41, False))
            out["restored_4x1"] = _blocks(state)
            p4, o4 = from_ckpt_state(state)
            p4, o4, m4 = make_train_step(cfg, tc, mi41)(p4, o4,
                                                        t(batch(cfg, 1)))
            out["elastic_4x1"] = _dump(p4, o4, m4)

    # (d): the JAX launcher's checkpoint on (2, 2), once it is written
    cfg, mi = _cfg(False), meshes[(2, 2)]
    t0 = time.monotonic()
    while not os.path.exists(os.path.join(tmp, "launcher_done")):
        if time.monotonic() - t0 > DEADLINE_S:
            raise TimeoutError("the reference's launcher wrote nothing")
        time.sleep(0.2)
    p = from_jax_params(cfg, jparams["llama3.2-1b"], device="cpu", mi=mi)
    got = restore(os.path.join(tmp, "jck"), 3,
                  ckpt_state(p, init_opt_state(p)),
                  shardings=ckpt_shardings(cfg, mi, False))
    out["launcher_blocks"] = _blocks(got)

    out["builds"] = {arch: callable(make_train_step(_cfg(False, arch),
                                                    TrainConfig(), mi))
                     for arch in CROSS}

    # (c): the spy's witness, the table gathered over every axis on (1, 4)
    # (the whole-table gather of the step before the vocab-parallel path)
    from repro_torch.models.dist import gather_param
    cfg, mi = _cfg(False), meshes[(1, 4)]
    p = from_jax_params(cfg, jparams["llama3.2-1b"], device="cpu", mi=mi)
    with _gathers() as calls:
        gather_param(p["embed"]["table"],
                     shardings(model_specs(cfg), mi)["embed"]["table"], mi,
                     mi.axis_names, ())
    out["witness_vocab_gathers"] = _vocab_over_model(calls, cfg.vocab_size)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _replicas(trees, shards, mi) -> bool:
    """Every block that more than one rank holds, equal bit for bit on
    each of them."""
    from repro_torch.models.dist import all_gather
    from repro_torch.tree import leaves
    ok = True
    for tree in trees:
        for x, sh in zip(leaves(tree), leaves(shards)):
            for a in mi.axis_names:
                if a in sh.split or mi.size(a) == 1:
                    continue
                parts = all_gather(x.reshape(1, -1), 0, mi, a)
                ok &= all(torch.equal(q, parts[0]) for q in parts)
    return bool(ok)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, each rank's, the one-device restore's
    step). The JAX subprocess and the four ranks run at once."""
    import jax
    import torch.multiprocessing as mp
    from repro.models import init_params as j_init_params
    tmp = tmp_path_factory.mktemp("mesh_train")
    code = JAX_SCRIPT.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"),
                             out_pkl=str(tmp / "ref.pkl"),
                             ck=str(tmp / "jck"),
                             marker=str(tmp / "launcher_done"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    jparams = {a: with_biases(a, jax.tree.map(
        np.asarray, j_init_params(_cfg(True, a), jax.random.key(0))))
        for a in ARCHS}
    try:
        ctx = mp.spawn(_rank, args=(_free_port(), str(tmp), jparams),
                       nprocs=WORLD, join=False)
        t0 = time.monotonic()
        while not ctx.join(timeout=2):      # a rank's failure raises here
            if time.monotonic() - t0 > DEADLINE_S:
                for proc in ctx.processes:
                    proc.kill()
                pytest.fail(f"the four ranks ran past {DEADLINE_S} s")
        stdout, stderr = ref_proc.communicate(timeout=DEADLINE_S)
    finally:
        ref_proc.kill()
    assert ref_proc.returncode == 0, f"{stdout}\n{stderr[-4000:]}"
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(ref=ref, ranks=ranks, tmp=tmp, jparams=jparams)


# ---------------------------------------------------------------- helpers

def _port_layout(tree) -> list:
    """The leaves of a reference tree (numpy) in the port's layout and
    leaf order."""
    from repro_torch.models.params import unstack_blocks
    from repro_torch.tree import leaves
    return [np.asarray(x) for x in leaves(unstack_blocks(tree))]


def _placed(specs, shape, coords):
    """The Shardings of a spec tree at one rank of a ("data", "model")
    mesh of ``shape``, the rank at ``coords``."""
    from repro_torch.models.params import Sharding, _map, resolve_spec
    sizes = dict(zip(("data", "model"), shape))
    return _map(lambda s: Sharding(resolve_spec(s.pspec, s.shape, sizes),
                                   tuple(sizes.items()),
                                   tuple(zip(("data", "model"), coords))),
                specs)


def _ref_blocks(case_ref: dict, cfg, shape, coords) -> dict:
    """The reference's step (whole arrays) cut to one rank's blocks, in
    the port's layout."""
    from repro_torch.models.params import model_specs
    from repro_torch.tree import leaves
    shs = leaves(_placed(model_specs(cfg), shape, coords))
    opt = case_ref["opt"]
    whole = {k: _port_layout(opt[k]) for k in ("master", "mu", "nu")}
    whole["ef"] = _port_layout(opt["ef"]) if opt["ef"] is not None else None
    whole["params"] = _port_layout(case_ref["params"])
    out = {k: None if v is None else [sh.cut(x) for x, sh in zip(v, shs)]
           for k, v in whole.items()}
    # each whole leaf's largest |value|: the limits scale by the leaf's
    out["leaf_max"] = {k: None if v is None else
                       [float(np.abs(x).max()) for x in v]
                       for k, v in whole.items()}
    out["metrics"] = {k: float(v) for k, v in case_ref["metrics"].items()}
    return out


GRAD_AGREE = 1e-5      # the gradients' agreement, of a leaf's largest


def _step_sensitivity(mu, nu, count: int, top_mu: float,
                      top_nu: float) -> np.ndarray:
    """How far the AdamW step u = (mu/c1) / (sqrt(nu/c2) + eps) of each
    entry can move when every gradient it was built from moves by
    ``GRAD_AGREE`` of the leaf's largest: mu by up to (1 + b1)(1 - b1) of
    that, nu by up to 2 (1 + b2)(1 - b2) |g| of it (|g| <= sqrt(nu / (1 -
    b2))); the largest change of u over the four corners. Near eps (|g|
    ~ 1e-8) the step is steep in g, where the step is a sign, flat."""
    b1, b2, eps = 0.9, 0.95, 1e-8
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    mu, nu = mu.astype(np.float64), nu.astype(np.float64)
    g_top = max(top_mu / (1 - b1), np.sqrt(top_nu / (1 - b2)))
    d = GRAD_AGREE * g_top
    dm = (1 + b1) * (1 - b1) * d
    dv = 2 * (1 + b2) * (1 - b2) * (np.sqrt(nu / (1 - b2)) + d) * d
    u = lambda m, v: (m / c1) / (np.sqrt(np.maximum(v, 0) / c2) + eps)
    base = u(mu, nu)
    return np.max([np.abs(u(mu + sm * dm, nu + sv * dv) - base)
                   for sm in (-1, 1) for sv in (-1, 1)], axis=0)


def _hold(ours: dict, ref: dict, kw: dict, earlier=None) -> None:
    """``ours`` against ``ref`` (one rank's blocks) after one step, or
    after two where ``earlier`` is the reference after the first (cut
    alike): loss and gradient norm 1e-5 relative; params and master
    within 1e-6 relative + lr (1e-4 + the AdamW step's sensitivity to the
    gradients' agreement, ``_step_sensitivity``, summed over the steps)
    on every entry, and 2 lr + 1e-6
    where an int8 gradient lies within 1.5 quanta of zero (a near-tie of
    the rounding may flip it to zero); mu within 1e-4 of its leaf's
    largest, nu 2e-4; with int8_ef the error-feedback buffers within one
    quantum (a near-tie may flip one value, the squared norm by up to 255
    q^2 a leaf)."""
    b1, b2 = 0.9, 0.95
    int8 = ref["ef"] is not None
    top = ref["leaf_max"]
    gn = ref["metrics"]["grad_norm"]
    # with int8_ef, a leaf's quantum: its largest dequantized gradient is
    # 127 quanta, and after one step mu = (1 - b1) x that gradient times
    # the clip's factor; ``quanta`` in the gradient's units (ef's),
    # ``clipped`` in the moments'
    clip = min(1.0, 1.0 / gn)
    quanta = ([m / ((1 - b1) * 127 * clip) for m in top["mu"]] if int8
              else None)
    flips = sum(255 * q * q for q in quanta) / (2 * gn) if int8 else 0.0
    for k in ("loss", "grad_norm"):
        assert abs(ours["metrics"][k] - ref["metrics"][k]) <= 1e-5 * abs(
            ref["metrics"][k]) + (flips if k == "grad_norm" else 0.0), k
    lr = kw["lr"]
    tight = 0
    names = ["params", "master", "mu", "nu"] + (["ef"] if int8 else [])
    if not int8:
        assert ours["ef"] is None
    for name in names:
        for i, (a, b) in enumerate(zip(ours[name], ref[name])):
            assert a.shape == b.shape, (name, i)
            q = quanta[i] * 1.01 if int8 else 0.0
            qc = q * clip
            if name in ("params", "master"):
                steps = [(ref, 2 if earlier else 1)] + (
                    [(earlier, 1)] if earlier else [])
                tol = 1e-6 * np.abs(b) + lr * (1e-4 + sum(
                    _step_sensitivity(r_["mu"][i], r_["nu"][i], n,
                                      r_["leaf_max"]["mu"][i],
                                      r_["leaf_max"]["nu"][i])
                    for r_, n in steps))
                if int8:
                    near = np.abs(ref["mu"][i]) / (1 - b1) <= 1.5 * qc
                    tol = np.where(near, 2 * lr + 1e-6, tol)
                tight += int((tol < 1e-2 * lr).sum())
                assert np.all(np.abs(a - b) <= tol), (name, i, a.shape)
                continue
            scale = top[name][i]
            tol = {"mu": 1e-4 * scale + (1 - b1) * qc,
                   "nu": 2e-4 * scale + (1 - b2) * qc * (254 * qc + qc),
                   "ef": q + 1e-4 * 127 * q}[name] + 1e-12
            assert float(np.abs(a - b).max()) <= tol, (name, i, a.shape)
    # the limit is tight (under 1% of a step) on most entries
    n = sum(x.size for x in ours["params"]) * 2
    assert tight > 0.5 * n, (tight, n)


def _coords(runs, rank: int, shape) -> tuple:
    return tuple(runs["ranks"][rank]["coords"][str(shape)])


# ---------------------------------------------------------------- (a)

class _StandIn:
    """What the reference's ``resolve_spec`` reads of a mesh."""

    def __init__(self, axes, shape):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _spec_pairs(port, ref, path=()):
    """(port spec, reference spec, stacked) for every leaf: a port block's
    leaf against the reference's stacked leaf."""
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, sorted(set(port) ^ set(ref)))
        for k in port:
            yield from _spec_pairs(port[k], ref[k], path + (k,))
    elif isinstance(port, list):
        for blk in port:
            for p, r, _ in _spec_pairs(blk, ref, path):
                yield p, r, True
    else:
        yield port, ref, False


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_resolved_specs_match_reference(arch, smoke):
    from repro.configs import get_config
    from repro.configs import reduce_for_smoke as j_reduce
    from repro.models import model_specs as j_model_specs
    from repro.models.params import resolve_spec as j_resolve
    from repro_torch.models.params import model_specs, resolve_spec
    cfg, jcfg = tconfigs.get_config(arch), get_config(arch)
    if smoke:
        cfg, jcfg = reduce_for_smoke(cfg), j_reduce(jcfg)
    n = 0
    for p, r, stacked in _spec_pairs(model_specs(cfg), j_model_specs(jcfg)):
        assert tuple(p.shape) == tuple(r.shape[1:] if stacked else r.shape)
        for axes, shape in SPEC_MESHES:
            want = tuple(j_resolve(r.pspec, r.shape, _StandIn(axes, shape)))
            if stacked:
                assert want[0] is None
                want = want[1:]
            assert resolve_spec(p.pspec, p.shape,
                                dict(zip(axes, shape))) == want, (p, r)
            n += 1
    assert n > 20


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_each_rank_holds_its_blocks(runs, case):
    """Every parameter and optimizer leaf of every rank has the local
    shape the reference's resolved spec gives: each dimension over the
    product of its axes' sizes."""
    from repro.models.params import resolve_spec as j_resolve
    from repro_torch.models.params import model_specs
    from repro_torch.tree import leaves
    arch, shape, _ = STEP_CASES[case]
    sizes = dict(zip(("data", "model"), shape))
    want = []
    for spec in leaves(model_specs(_cfg(False, arch))):
        res = j_resolve(spec.pspec, spec.shape,
                        _StandIn(("data", "model"), shape))
        ax = lambda e: () if e is None else (e if isinstance(e, tuple)
                                             else (e,))
        want.append([n // int(np.prod([sizes[a] for a in ax(e)]))
                     for n, e in zip(spec.shape, res)])
    split = sum(w != list(s.shape) for w, s in
                zip(want, leaves(model_specs(_cfg(False, arch)))))
    assert split > 0 or shape == (1, 1)
    for r in runs["ranks"]:
        for tree in r[case + "_local_shapes"]:
            assert tree == want


# ---------------------------------------------------------------- (b)

def test_compressed_psum_matches_reference(runs):
    ref = runs["ref"]["psum"]
    exact = psum_input().sum(0, keepdims=True)
    assert np.abs(ref - exact).max() / np.abs(exact).max() < 0.05
    for r in runs["ranks"]:
        assert r["psum"].shape == ref.shape
        np.testing.assert_array_equal(r["psum"], ref)


# ---------------------------------------------------------------- (c)

@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_step_matches_one_device_reference(runs, case):
    arch, shape, _ = STEP_CASES[case]
    cfg = _cfg(False, arch)
    for rank, r in enumerate(runs["ranks"]):
        ref = _ref_blocks(runs["ref"][case], cfg, shape,
                          _coords(runs, rank, shape))
        _hold(r[case], ref, _kw(case))


@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_step_matches_reference_mesh_step(runs, case):
    arch, shape, _ = STEP_CASES[case]
    cfg = _cfg(False, arch)
    for rank, r in enumerate(runs["ranks"]):
        ref = _ref_blocks(runs["ref"][case + "_mesh"], cfg, shape,
                          _coords(runs, rank, shape))
        _hold(r[case], ref, _kw(case))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_replicas_bit_equal(runs, case):
    """The blocks several ranks hold (norm weights; on (1, 4) the KV
    projections, whose 2 heads do not split over 4) stay equal bit for
    bit, and every rank reports the same loss."""
    for r in runs["ranks"]:
        assert r[case + "_replicas"] is True
        assert r[case]["metrics"] == runs["ranks"][0][case]["metrics"]


# ---------------------------------------------------------------- (d)

def test_checkpoint_saved_on_2x2_restores_bit_for_bit_on_4x1(runs):
    """The (2, 2) step's state saved (rank 0 writes whole leaves) and
    restored on (4, 1): each rank's (2, 2) blocks, and its (4, 1) blocks
    after the restore, equal bit for bit their blocks of the files."""
    from repro_torch.models.params import model_specs, stack_specs
    from repro_torch.optim import opt_state_specs
    from repro_torch.tree import leaves
    specs = stack_specs(model_specs(_cfg(False)))
    tree = {"params": specs, "opt": opt_state_specs(specs)}
    d = runs["tmp"] / "ck" / "step_1"
    n = json.loads((d / "manifest.json").read_text())["n_leaves"]
    files = [np.load(d / f"leaf_{i}.npy") for i in range(n)]
    assert n == len(leaves(tree)) == len(runs["ranks"][0]["saved_2x2"])
    for shape, key in (((2, 2), "saved_2x2"), ((4, 1), "restored_4x1")):
        for rank, r in enumerate(runs["ranks"]):
            placed = leaves(_placed(tree, shape, _coords(runs, rank, shape)))
            for i, (x, f, sh) in enumerate(zip(r[key], files, placed)):
                want = sh.cut(f)
                assert x.shape == want.shape, (key, i)
                assert np.array_equal(x.view(np.int32), want.view(np.int32)
                                      ), (key, i)


@pytest.mark.parametrize("where", ["4x1", "one_device"])
def test_elastic_restore_then_step_matches_uninterrupted(runs, where):
    """Saved on (2, 2) after one step, restored on (4, 1) or on one
    device, one more step: the reference's two uninterrupted steps."""
    cfg = _cfg(False)
    two = runs["ref"]["two_steps"]
    kw = _kw("llama_2x2")
    first = runs["ref"]["llama_2x2"]       # the same first step
    if where == "4x1":
        for rank, r in enumerate(runs["ranks"]):
            c = _coords(runs, rank, (4, 1))
            _hold(r["elastic_4x1"], _ref_blocks(two, cfg, (4, 1), c), kw,
                  _ref_blocks(first, cfg, (4, 1), c))
        return
    from repro_torch.checkpoint.ckpt import restore
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import ckpt_state, from_ckpt_state
    from repro_torch.models import from_jax_params
    from repro_torch.optim import init_opt_state
    p = from_jax_params(cfg, runs["jparams"]["llama3.2-1b"], device="cpu")
    p, o = from_ckpt_state(restore(str(runs["tmp"] / "ck"), 1,
                                   ckpt_state(p, init_opt_state(p))))
    p, o, m = make_train_step(cfg, TrainConfig(**kw))(
        p, o, {k: torch.from_numpy(v).long()
               for k, v in batch(cfg, 1).items()})
    _hold(_dump(p, o, m), _ref_blocks(two, cfg, (1, 1), (0, 0)), kw,
          _ref_blocks(first, cfg, (1, 1), (0, 0)))


def test_jax_launcher_checkpoint_restores_on_2x2(runs):
    """The JAX launcher's checkpoint (3 steps, smoke llama) restored by the
    port on (2, 2): each rank's block of every leaf equals, bit for bit,
    the reference's own shard on the device at the rank's coordinates
    (its restore with shardings on a (2, 2) mesh)."""
    shards = runs["ref"]["launcher_shards"]
    n = max(k[0] for k in shards) + 1
    for rank, r in enumerate(runs["ranks"]):
        got = r["launcher_blocks"]
        assert len(got) == n
        c = _coords(runs, rank, (2, 2))
        for i, x in enumerate(got):
            want = shards[(i,) + c]
            assert x.shape == want.shape, i
            assert np.array_equal(x.view(np.int32) if x.dtype.itemsize == 4
                                  else x, want.view(np.int32)
                                  if want.dtype.itemsize == 4 else want), i


# ---------------------------------------------------------------- (e)

@pytest.mark.parametrize("arch", CROSS)
def test_unported_kinds_refuse_on_a_mesh(runs, arch):
    """The cross-attention kinds, the last without a tensor-parallel form
    until ROADMAP item 2c(ii)(b), no longer refuse: each arch's
    ``make_train_step`` builds on the (2, 2) mesh on every rank."""
    for r in runs["ranks"]:
        assert r["builds"][arch] is True


@pytest.mark.parametrize("case", [c for c, (_, shape, _) in STEP_CASES.items()
                                  if shape[1] > 1])
def test_no_embed_leaf_gathered_over_model(runs, case):
    """On every mesh case with a model axis over 1, no rank gathers the
    table or the head over ``model`` in its step: where the vocab splits
    each rank keeps its block, where it does not (vocab 514 on (1, 4)) the
    leaves are whole over ``model`` already."""
    for r in runs["ranks"]:
        assert r[case + "_vocab_gathers"] == []


def test_gather_spy_sees_the_whole_table(runs):
    """The spy's witness: the table gathered over every axis on (1, 4), as
    the step did before the vocab-parallel path, shows as the (512, 64)
    table gathered whole over ``model``."""
    for r in runs["ranks"]:
        assert ("model", (512, 64)) in r["witness_vocab_gathers"]


# ---------------------------------------------------------------- (f)

def _vocab_ref(runs, shape, tied, softcap, rank) -> dict:
    """The reference's loss and gradients, cut to ``rank``'s blocks on
    ``shape`` (the table's vocab over model and d over data, the head's
    transposed, x0's rows over data)."""
    from repro_torch.models.params import Sharding, resolve_spec
    ref = runs["ref"][("vocab", tied, softcap)]
    sizes = dict(zip(("data", "model"), shape))
    place = lambda spec, shp: Sharding(
        resolve_spec(spec, shp, sizes), tuple(sizes.items()),
        tuple(zip(("data", "model"), _coords(runs, rank, shape))))
    out = {"loss": float(ref["loss"])}
    for k, spec in (("table", ("tp", "fsdp")), ("head", ("fsdp", "tp")),
                    ("x0", ("batch", None, None))):
        out[k] = place(spec, ref[k].shape).cut(ref[k])
        out[k + "_max"] = float(np.abs(ref[k]).max())
    return out


@pytest.mark.parametrize("shape,tied,softcap", VOCAB_CASES)
def test_vocab_parallel_xent_matches_reference(runs, shape, tied, softcap):
    """Loss within 1e-6 relative, and each rank's blocks of the table's,
    the head's and x0's gradients within 1e-5 of the leaf's largest."""
    for rank, r in enumerate(runs["ranks"]):
        ours = r[("vocab", shape, tied, softcap, False)]
        ref = _vocab_ref(runs, shape, tied, softcap, rank)
        assert abs(ours["loss"] - ref["loss"]) <= 1e-6 * abs(ref["loss"])
        for k in ("table", "x0") + (() if tied else ("head",)):
            assert ours[k].shape == ref[k].shape, k
            err = float(np.abs(ours[k] - ref[k]).max())
            assert err <= GRAD_AGREE * ref[k + "_max"], (k, err)


@pytest.mark.parametrize("shape,tied,softcap", VOCAB_CASES)
def test_vocab_label_clamp_fault_misses(runs, shape, tied, softcap):
    """The planted fault, each rank clamping the label into its block
    instead of masking it, misses the loss by over 100 times its limit
    and the gradient of the leaf the logits come from (the table, tied,
    or the head) by over a tenth of its largest entry."""
    for rank, r in enumerate(runs["ranks"]):
        bad = r[("vocab", shape, tied, softcap, True)]
        ref = _vocab_ref(runs, shape, tied, softcap, rank)
        assert abs(bad["loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"])
        grad = "table" if tied else "head"
        assert float(np.abs(bad[grad] - ref[grad]).max()) > \
            0.1 * ref[grad + "_max"]
