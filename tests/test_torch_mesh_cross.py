"""The port's cross-attention training on a mesh against the JAX package's:
four ranks over ``torch.distributed`` (gloo, on the CPU) against the
reference on four host devices, the recipe and helpers of
``test_torch_mesh_train.py`` and ``test_torch_mesh_recurrent.py``.

The reference draws every cross gate at 0, where tanh(0) = 0 leaves every
other cross leaf without a gradient and hides a wrong tensor-parallel
form, so every gate is set to 0.5 in both trees first. Batches come from
a numpy seed: tokens and labels (4, 16), and random ``enc_x`` (4, 8, d)
for seamless or ``img_x`` (4, n_image_tokens, d) for vision. JAX
subprocesses write every reference array, one ``mp.spawn`` of four ranks
every port array; this process compares them. The cases:

  (a) one train step of smoke seamless-m4t-medium (2 encoder layers, 1
      ``cross_mlp``) and smoke llama-vision (4 ``attn_mlp``, 1
      ``xattn_mlp``) on (2, 2), (1, 4) and (4, 1), each against the
      reference's step on the same mesh; each rank's local shapes;
      replicas bit for bit;
  (b) the tensor-parallel forms of vision's ``xattn_mlp`` layer,
      seamless's ``cross_mlp`` layer and its encoder block: the output and
      the gradients of x, the cross source and every leaf of the rank's
      blocks, against the whole layer on the rank's rows, with the gate at
      0 (the gate's own gradient is then the only cross gradient) and at
      0.5; the source without its ``copy_to`` and the gate's gradient
      summed over ``model`` must miss;
  (c) a seamless save on (2, 2) restored on (1, 4), bit for bit.
"""
import contextlib
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_moe import _hold_moe  # noqa: E402
from test_torch_mesh_recurrent import get_params, put_params  # noqa: E402,F401
from test_torch_mesh_train import (GRAD_AGREE, _blocks, _dump,  # noqa: E402
                                   _free_port, _placed, _port_layout,
                                   _ref_blocks, _replicas, _step_sensitivity)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import reduce_for_smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 240
LR = 1e-3
SEAMLESS, VISION = "seamless-m4t-medium", "llama-3.2-vision-90b"
ARCHS = (SEAMLESS, VISION)
GATE = 0.5
B, S, ENC_LEN = 4, 16, 8
# (a): case -> (arch, mesh shape)
STEP_CASES = {f"{a}_{d}x{m}": (arch, (d, m))
              for a, arch in (("seamless", SEAMLESS), ("vision", VISION))
              for d, m in ((2, 2), (1, 4), (4, 1))}
# the reference's steps in parallel processes, each group with whether it
# draws its arch's init (~8 s) or reads another group's: a step takes ~9 s
# more to compile and run
REF_GROUPS = ((("seamless_2x2", "seamless_1x4"), True),
              (("vision_2x2", "vision_1x4"), True),
              (("seamless_4x1", "vision_4x1"), False))
SAVE_CASE = "seamless_2x2"
# (b): layer -> (arch, its leaves' path under the unstacked tree, kind)
LAYERS = {"xattn_mlp": (VISION, ("blocks", 0, "4"), "xattn_mlp"),
          "cross_mlp": (SEAMLESS, ("blocks", 0, "0"), "cross_mlp"),
          "encoder": (SEAMLESS, ("encoder", "blocks", 0, "0"), "attn_mlp")}
LAYER_CASES = [(n, s, g) for n in LAYERS for s in ((2, 2), (1, 4))
               for g in ((0.0, GATE) if n != "encoder" else (None,))]
LAYER_B, LAYER_T = 4, 16
# fp32: the same sums in other orders (cross_mlp's leaves read up to
# 1.2e-5 of their largest on (1, 4))
LAYER_REL = 1e-4
FAULT_REL = 0.1         # a planted fault's gradient, at least


def _cfg(jax_side: bool, arch: str):
    if jax_side:
        from repro.configs import get_config
        from repro.configs import reduce_for_smoke as j_reduce
        return j_reduce(get_config(arch))
    return reduce_for_smoke(tconfigs.get_config(arch))


def _kw() -> dict:
    return dict(lr=LR, warmup_steps=1, total_steps=10)


def gated(tree, gate: float = GATE):
    """A numpy parameter tree (the reference's layout) with every cross
    gate set to ``gate``."""
    for layer in tree["blocks"].values():
        if "xattn" in layer:
            g = layer["xattn"]["gate"]
            layer["xattn"]["gate"] = np.full(g.shape, gate, np.float32)
    return tree


def batch(cfg, i: int) -> dict:
    """Batch ``i``: tokens and labels (B, S) int32, and the cross source:
    ``enc_x`` (B, ENC_LEN, d) or ``img_x`` (B, n_image_tokens, d)."""
    r = np.random.default_rng(60 + i)
    out = {k: r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    key, n = (("img_x", cfg.n_image_tokens) if cfg.n_image_tokens
              else ("enc_x", ENC_LEN))
    out[key] = r.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return out


def layer_inputs(cfg) -> tuple:
    """The layer case's x (LAYER_B, LAYER_T, d), cross source (LAYER_B,
    ENC_LEN or n_image_tokens, d) and the output's weights."""
    r = np.random.default_rng(17)
    n = cfg.n_image_tokens or ENC_LEN
    return tuple(r.standard_normal(shape).astype(np.float32) for shape in (
        (LAYER_B, LAYER_T, cfg.d_model), (LAYER_B, n, cfg.d_model),
        (LAYER_B, LAYER_T, cfg.d_model)))


# ---------------------------------------------------------------- the reference

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{src!r}, {tests!r}]
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import TrainConfig
from repro.launch.mesh import make_host_mesh, mesh_context
from repro.launch.steps import make_train_step
from repro.models import MeshInfo, init_params
from repro.optim import init_opt_state
import test_torch_mesh_cross as T
from test_torch_mesh_train import _np_opt

host = lambda t: jax.tree.map(np.asarray, t)
out = {{}}
for case, (arch, shape) in {cases!r}.items():
    cfg, tc = T._cfg(True, arch), TrainConfig(**T._kw())
    if {init!r}:
        tree = T.gated(host(init_params(cfg, jax.random.key(0))))
        T.put_params({tmp!r}, arch, tree)   # the ranks' weights
    else:
        tree = T.get_params({tmp!r}, arch)
    p = jax.tree.map(jnp.asarray, tree)
    b = {{k: jnp.asarray(v) for k, v in T.batch(cfg, 0).items()}}
    mesh = make_host_mesh(data=shape[0], model=shape[1])
    with mesh_context(mesh):
        p1, o1, m1 = jax.jit(make_train_step(cfg, tc, MeshInfo(mesh)))(
            p, init_opt_state(p), b)
    out[case] = host(dict(params=p1, opt=_np_opt(o1), metrics=m1))
with open({out_pkl!r}, "wb") as f:
    pickle.dump(out, f)
print("reference OK")
"""


# ---------------------------------------------------------------- the port

@contextlib.contextmanager
def source_without_copy():
    """A planted fault: the cross source enters without ``copy_to``, so
    each model rank keeps the part of its gradient its own heads give."""
    from repro_torch.models import blocks
    from repro_torch.models.dist import copy_to

    def partial(p, x, src, ctx):
        return blocks._tp_kv_heads(p, ctx), copy_to(x, ctx.mi, "model"), src
    with mock.patch.object(blocks, "_tp_cross_inputs", partial):
        yield


@contextlib.contextmanager
def gate_summed():
    """A planted fault: the gate through ``copy_to`` after the sum over
    ``model``, so its gradient, already whole on every rank, is counted
    ``model`` times."""
    from repro_torch.models import attention as attn
    from repro_torch.models import blocks
    from repro_torch.models.dist import copy_to, reduce_from

    def summed(p, o, ctx):
        y = reduce_from(attn.out_proj(p, o, gated=False), ctx.mi, "model")
        return attn.gate(dict(p, gate=copy_to(p["gate"], ctx.mi, "model")),
                         y)
    with mock.patch.object(blocks, "_tp_gated_out", summed):
        yield


FAULTS = {"source_without_copy": source_without_copy,
          "gate_summed": gate_summed}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _layer_case(name: str, mi, jtree, gate) -> dict:
    """(b) on one rank: block 0's layer (or the encoder's first block)
    whole on the rank's rows (its leaves' gradients summed over the data
    ranks and cut to the rank's blocks), its tensor-parallel form on the
    rank's blocks, and for a cross layer each planted fault's. Each run
    gives [y, every leaf's gradient..., x's, the source's]."""
    from repro_torch.models.blocks import FwdCtx, apply_layer
    from repro_torch.models.dist import NO_MESH, all_reduce
    from repro_torch.models.model import _use_params, batch_sharding
    from repro_torch.models.params import (model_specs, shardings,
                                           unstack_blocks)
    from repro_torch.tree import flatten, tree_map, unflatten
    arch, path, kind = LAYERS[name]
    cfg = _cfg(False, arch)
    cross = name != "encoder"
    x, src, w = layer_inputs(cfg)
    rows = batch_sharding(x.shape, mi)
    axes = tuple(a for a in rows.axes(0) if mi.size(a) > 1)
    x, src, w = (torch.from_numpy(rows.cut(a).copy()) for a in (x, src, w))
    whole = dict(_at(unstack_blocks(jtree), path))
    if cross:
        whole["xattn"] = dict(whole["xattn"],
                              gate=np.full((), gate, np.float32))
    sh = _at(shardings(model_specs(cfg), mi), path)

    def run(p, tp):
        flat, tdef = flatten(p)
        live = [t.detach().requires_grad_(True) for t in flat]
        xs = [x.clone().requires_grad_(True),
              src.clone().requires_grad_(True)]
        ctx = FwdCtx(cfg=cfg, mode="prefill", causal=cross,
                     cross_x=xs[1] if cross else None,
                     mi=mi if tp else NO_MESH, tp=tp,
                     grad_axes=axes if tp else ())
        pl = unflatten(tdef, live)
        if tp:
            pl = _use_params(pl, sh, ctx)
        y, _ = apply_layer(kind, pl, xs[0], ctx, None)
        used = xs if cross else xs[:1]
        grads = torch.autograd.grad((y * w).sum(), live + used,
                                    allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(live + used, grads)]
        n = len(live)
        if not tp:          # the whole layer: the other rows' part too
            g_leaves = [all_reduce(g, mi, axes) for g in grads[:n]]
            g_tree = tree_map(lambda g, s_: s_.cut(g).contiguous(),
                              unflatten(tdef, g_leaves), sh)
            grads = flatten(g_tree)[0] + grads[n:]
        return [y.detach().numpy()] + [g.numpy() for g in grads]

    p_whole = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                       whole)
    p_local = tree_map(lambda t, s_: s_.cut(t).contiguous(), p_whole, sh)
    out = dict(whole=run(p_whole, False), tp=run(p_local, True),
               leaves=len(flatten(p_whole)[0]))
    if cross:
        for fault, patch in FAULTS.items():
            with patch():
                out[fault] = run(p_local, True)
    return out


def _rank(rank: int, port: int, tmp: str) -> None:
    """One rank: every port case, results to files."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import ckpt_shardings, ckpt_state
    from repro_torch.models import MeshInfo, from_jax_params
    from repro_torch.models.dist import axis_rank
    from repro_torch.models.params import model_specs, shardings
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import leaves
    init_distributed(rank, WORLD, f"tcp://localhost:{port}", device="cpu")
    meshes = {shape: MeshInfo(make_mesh(shape, ("data", "model"),
                                        device="cpu"))
              for shape in ((2, 2), (4, 1), (1, 4))}
    out = {"coords": {str(s): [axis_rank(mi, a) for a in ("data", "model")]
                      for s, mi in meshes.items()}}
    jparams = {a: get_params(tmp, a) for a in ARCHS}

    def tensors(b):
        return {k: torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v) for k, v in b.items()}

    for case, (arch, shape) in STEP_CASES.items():
        mi, cfg, tc = meshes[shape], _cfg(False, arch), TrainConfig(**_kw())
        params = from_jax_params(cfg, jparams[arch], device="cpu", mi=mi)
        opt = init_opt_state(params)
        sh = shardings(model_specs(cfg), mi)
        out[case + "_local_shapes"] = [list(x.shape) for x in leaves(params)]
        params, opt, m = make_train_step(cfg, tc, mi)(params, opt,
                                                       tensors(batch(cfg, 0)))
        out[case] = _dump(params, opt, m)
        out[case + "_replicas"] = _replicas(
            (params, opt.master, opt.mu, opt.nu), sh, mi)
        if case == SAVE_CASE:       # (c): save on (2, 2), restore on (1, 4)
            ck = os.path.join(tmp, "ck")
            held = ckpt_state(params, opt)
            out["saved_2x2"] = _blocks(held)
            save(ck, 1, held, shardings=ckpt_shardings(cfg, mi, False), mi=mi)
            mi14 = meshes[(1, 4)]
            p4 = from_jax_params(cfg, jparams[arch], device="cpu", mi=mi14)
            state = restore(ck, 1, ckpt_state(p4, init_opt_state(p4)),
                            shardings=ckpt_shardings(cfg, mi14, False))
            out["restored_1x4"] = _blocks(state)

    for name, shape, gate in LAYER_CASES:
        out[f"layer_{name}_{shape}_{gate}"] = _layer_case(
            name, meshes[shape], jparams[LAYERS[name][0]], gate)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, each rank's). The JAX subprocesses (one a
    group of ``REF_GROUPS``; the first two write the reference's gated
    init for the third and the ranks) and the four ranks run at once."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh_cross")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = []
    for i, (group, init) in enumerate(REF_GROUPS):
        code = JAX_SCRIPT.format(
            src=str(ROOT / "src"), tests=str(ROOT / "tests"),
            cases={c: STEP_CASES[c] for c in group}, init=init,
            tmp=str(tmp), out_pkl=str(tmp / f"ref{i}.pkl"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        ctx = mp.spawn(_rank, args=(_free_port(), str(tmp)), nprocs=WORLD,
                       join=False)
        t0 = time.monotonic()
        while not ctx.join(timeout=2):      # a rank's failure raises here
            if time.monotonic() - t0 > DEADLINE_S:
                for proc in ctx.processes:
                    proc.kill()
                pytest.fail(f"the four ranks ran past {DEADLINE_S} s")
        ref = {}
        for i, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=DEADLINE_S)
            assert proc.returncode == 0, f"{stdout}\n{stderr[-4000:]}"
            with open(tmp / f"ref{i}.pkl", "rb") as f:
                ref.update(pickle.load(f))
    finally:
        for proc in procs:
            proc.kill()
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(ref=ref, ranks=ranks, tmp=tmp)


def _coords(runs, rank: int, shape) -> tuple:
    return tuple(runs["ranks"][rank]["coords"][str(shape)])


# ---------------------------------------------------------------- (a)

def _reference_spread(runs, arch: str) -> dict:
    """Twice the largest difference between the reference's own steps of
    ``arch`` on its three meshes: in the gradient norm, and a leaf at a
    time in mu and nu. Smoke vision's gradients are ill-conditioned in
    fp32 (its gradients sit up to ~6e-4 of a leaf's largest from fp64's
    on one device), and the reference's meshes differ by ~1.3e-4 of its
    gradient norm and ~1.5e-3 of a leaf's largest mu."""
    cases = [c for c, (a, _) in STEP_CASES.items() if a == arch]
    refs = [runs["ref"][c] for c in cases]
    gn = [float(r_["metrics"]["grad_norm"]) for r_ in refs]
    out = {"grad_norm": 2 * (max(gn) - min(gn))}
    for name in ("mu", "nu"):
        steps = [_port_layout(r_["opt"][name]) for r_ in refs]
        out[name] = [2 * max(float(np.abs(a[i] - b[i]).max())
                             for j, a in enumerate(steps)
                             for b in steps[j + 1:])
                     for i in range(len(steps[0]))]
    return out


def _hold_spread(ours: dict, ref: dict, floor: dict) -> None:
    """One step against the reference's within ``_hold``'s limits, each
    raised to the reference's own spread where that is larger: the
    gradient norm and a moment at least ``floor``'s (``_hold_moe``);
    params and master within 1e-6 relative + lr (1e-4 + the AdamW step's
    sensitivity, ``_step_sensitivity``, to a gradient off by the larger of
    GRAD_AGREE of the leaf's largest and the floor's mu over (1 - b1)).
    A first AdamW step moves each entry by about lr times its gradient's
    sign, so an entry whose gradient lies within the spread of zero may
    move either way."""
    gn = ref["metrics"]["grad_norm"]
    assert abs(ours["metrics"]["grad_norm"] - gn) <= max(1e-5 * abs(gn),
                                                         floor["grad_norm"])
    for name in ("params", "master"):
        for i, (a, b) in enumerate(zip(ours[name], ref[name])):
            assert a.shape == b.shape, (name, i)
            top_mu = max(ref["leaf_max"]["mu"][i],
                         floor["mu"][i] / GRAD_AGREE)
            tol = 1e-6 * np.abs(b) + LR * (1e-4 + _step_sensitivity(
                ref["mu"][i], ref["nu"][i], 1, top_mu,
                ref["leaf_max"]["nu"][i]))
            assert np.all(np.abs(a - b) <= tol), (name, i, a.shape)
    _hold_moe(dict(ours, params=ref["params"], master=ref["master"],
                   metrics=dict(ours["metrics"], grad_norm=gn)), ref, _kw(),
              floor)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_cross_step_matches_reference_mesh_step(runs, case):
    """Each rank's blocks after one step against the reference's step on
    the same mesh, within ``_hold``'s limits or the reference's own spread
    across its meshes where larger (``_reference_spread``,
    ``_hold_spread``)."""
    arch, shape = STEP_CASES[case]
    cfg = _cfg(False, arch)
    floor = _reference_spread(runs, arch)
    for rank, r in enumerate(runs["ranks"]):
        _hold_spread(r[case], _ref_blocks(runs["ref"][case], cfg, shape,
                                          _coords(runs, rank, shape)), floor)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_cross_replicas_bit_equal(runs, case):
    """The blocks several ranks hold (the norms, the gates; on (1, 4)
    vision's KV projections, 2 heads over 4) stay equal bit for bit, and
    every rank reports the same loss."""
    for r in runs["ranks"]:
        assert r[case + "_replicas"] is True
        assert r[case]["metrics"] == runs["ranks"][0][case]["metrics"]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_cross_ranks_hold_their_blocks(runs, case):
    """Every leaf has the local shape its resolved spec gives: the cross
    ``wq`` and ``wo`` hold H / model heads, the encoder's MLP d_ff /
    model hidden units, the gate is whole."""
    from repro_torch.models.params import model_specs
    from repro_torch.tree import leaves
    arch, shape = STEP_CASES[case]
    cfg = _cfg(False, arch)
    specs = model_specs(cfg)
    flat = leaves(specs)
    for rank, r in enumerate(runs["ranks"]):
        placed = leaves(_placed(specs, shape, _coords(runs, rank, shape)))
        want = [list(sh.local_shape(s.shape)) for sh, s in zip(placed, flat)]
        assert r[case + "_local_shapes"] == want
    layer = specs["blocks"][0][str(len(cfg.block_pattern) - 1)]["xattn"]
    m = shape[1]
    for name, dim in (("wq", 1), ("wo", 0)):
        i = next(i for i, s in enumerate(flat) if s is layer[name])
        assert want[i][dim] == cfg.n_heads // m
    i = next(i for i, s in enumerate(flat) if s is layer["gate"])
    assert want[i] == []
    if arch == SEAMLESS:
        mlp = specs["encoder"]["blocks"][0]["0"]["mlp"]
        i = next(i for i, s in enumerate(flat) if s is mlp["w1"])
        assert want[i][1] == cfg.d_ff // m


# ---------------------------------------------------------------- (b)

def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize(
    "name,shape,gate", LAYER_CASES,
    ids=[f"{n}-{s[0]}x{s[1]}" + ("" if g is None else f"-gate{g}")
         for n, s, g in LAYER_CASES])
def test_cross_layer_tp_form_matches_whole_layer(runs, name, shape, gate):
    """The output and the gradients of x, the cross source and every leaf
    of the rank's blocks, the tensor-parallel form against the whole layer
    on the rank's rows. At gate 0 every cross gradient but the gate's is
    zero on both sides. A cross layer's planted faults miss: the source
    without ``copy_to`` its gradient, the gate summed over ``model`` its
    own, each by at least FAULT_REL."""
    for r in runs["ranks"]:
        got = r[f"layer_{name}_{shape}_{gate}"]
        assert len(got["tp"]) == len(got["whole"])
        live = 0
        for i, (a, c) in enumerate(zip(got["tp"], got["whole"])):
            assert a.shape == c.shape, i
            if np.abs(c).max() == 0:
                assert gate == 0.0 and np.abs(a).max() == 0, i
                continue
            live += 1
            assert _rel(a, c) <= LAYER_REL, (i, _rel(a, c))
        if gate is None or gate:
            assert live == len(got["whole"]), live
        if gate is None:
            continue
        n = got["leaves"]
        src = n + 2             # [y, leaves..., x, source]
        gate_i = 1 + next(i for i, a in enumerate(got["whole"][1:n + 1])
                          if a.shape == ())
        assert np.abs(got["whole"][gate_i]).max() > 0
        assert _rel(got["gate_summed"][gate_i],
                    got["whole"][gate_i]) >= FAULT_REL
        if gate:
            assert _rel(got["source_without_copy"][src],
                        got["whole"][src]) >= FAULT_REL


# ---------------------------------------------------------------- (c)

def test_seamless_checkpoint_saved_on_2x2_restores_bit_for_bit_on_1x4(runs):
    """The (2, 2) step's state saved (rank 0 writes whole leaves) and
    restored on (1, 4): each rank's (2, 2) blocks, and its (1, 4) blocks
    after the restore, equal bit for bit their blocks of the files, the
    encoder's included."""
    from repro_torch.models.params import model_specs, stack_specs
    from repro_torch.optim import opt_state_specs
    from repro_torch.tree import leaves
    specs = stack_specs(model_specs(_cfg(False, SEAMLESS)))
    assert "encoder" in specs
    tree = {"params": specs, "opt": opt_state_specs(specs)}
    d = runs["tmp"] / "ck" / "step_1"
    n = json.loads((d / "manifest.json").read_text())["n_leaves"]
    files = [np.load(d / f"leaf_{i}.npy") for i in range(n)]
    assert n == len(leaves(tree)) == len(runs["ranks"][0]["saved_2x2"])
    for shape, key in (((2, 2), "saved_2x2"), ((1, 4), "restored_1x4")):
        for rank, r in enumerate(runs["ranks"]):
            placed = leaves(_placed(tree, shape, _coords(runs, rank, shape)))
            for i, (x, f, sh) in enumerate(zip(r[key], files, placed)):
                want = sh.cut(f)
                assert x.shape == want.shape, (key, i)
                assert np.array_equal(x.view(np.int32), want.view(np.int32)
                                      ), (key, i)
