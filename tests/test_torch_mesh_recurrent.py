"""The port's recurrent training on a mesh against the JAX package's: four
ranks over ``torch.distributed`` (gloo, on the CPU) against the reference
on four host devices, the recipe and helpers of ``test_torch_mesh_train.py``
and ``test_torch_mesh_moe.py``.

The yardstick is the reference's step on the SAME mesh shape (for jamba,
whose MoE layers route in ``G = gcd(T, 4)`` token groups on any mesh of
four and in one group without a mesh, the one-device step is not one).
JAX subprocesses write every reference array, one ``mp.spawn`` of four
ranks every port array, from the same numpy-seeded batches and the same
weights; this process compares them. The cases:

  (a) one train step of smoke rwkv6-3b on (2, 2), (1, 4) and (4, 1), and
      of smoke jamba on its first five layers (mamba, mamba_moe, mamba,
      mamba_moe, attn: every kind) on (2, 2) and (1, 4), each against the
      reference's step on the same mesh; each rank's local shapes;
      replicas bit for bit;
  (b) the tensor-parallel forms of rwkv6's time mix and channel mix and
      of the mamba mixer, forward and the gradient of x and of every leaf
      of the rank's blocks, against the whole mixer on the rank's rows
      (leaves the init draws at zero made random, so every gradient is
      live); and the mamba mixer with in_proj's contiguous block taken as
      (xi, z), which must miss;
  (c) a jamba save on (2, 2) restored on (1, 4), bit for bit;
  (d) ``mesh_train_refusal``: the recurrent and the cross-attention
      archs train on every mesh of four, widths that do not split refuse.
"""
import contextlib
import dataclasses
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
from test_torch_mesh_train import (_blocks, _dump, _free_port,  # noqa: E402
                                   _hold, _placed, _port_layout, _ref_blocks,
                                   _replicas, batch)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import reduce_for_smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 240
LR = 1e-3
RWKV, JAMBA = "rwkv6-3b", "jamba-1.5-large-398b"
ARCHS = (RWKV, JAMBA)
JAMBA_CUT = 5           # mamba, mamba_moe, mamba, mamba_moe, attn
# (a): case -> (arch, mesh shape)
STEP_CASES = {"rwkv_2x2": (RWKV, (2, 2)), "rwkv_1x4": (RWKV, (1, 4)),
              "rwkv_4x1": (RWKV, (4, 1)), "jamba_2x2": (JAMBA, (2, 2)),
              "jamba_1x4": (JAMBA, (1, 4))}
# the port's step without tensor parallelism (experts and widths whole),
# whose distance from the reference's step floors jamba's moment limits
# (``_jamba_floor``): a tensor-parallel step may be FLOOR_FACTOR times as
# far. Its mamba leaves read ~1e-4 of their largest moment without tensor
# parallelism; a gradient summed once too often or not at all moves them
# by their own size
FLOOR_CASE = ("jamba_4x1", JAMBA, (4, 1))
FLOOR_FACTOR = 4
# the reference's steps in parallel processes, the longest alone (its
# jamba steps take ~15-22 s each to compile and run, rwkv's ~5 s)
REF_GROUPS = (("rwkv_2x2", "rwkv_1x4", "rwkv_4x1"), ("jamba_2x2",),
              ("jamba_1x4",))
# (b): mixer -> (arch, the layer's leaves under block 0, layer 0)
MIXERS = {"time_mix": (RWKV, "tm"), "channel_mix": (RWKV, "cm"),
          "mamba": (JAMBA, "mamba")}
LAYER_CASES = [(m, s) for m in MIXERS for s in ((2, 2), (1, 4))]
LAYER_B, LAYER_T = 4, 64        # two of rwkv's chunks of 32
# fp32: the same sums in other orders; the time mix's w_lora_a gradient,
# through the decay's exp(-exp(.)) and two chunks of the scan, reads up to
# 1.2e-5 of its largest on (1, 4), the other leaves under 1e-5
LAYER_REL = 1e-4
FAULT_REL = 0.1         # the planted fault's output, at least


def _cfg(jax_side: bool, arch: str):
    if jax_side:
        from repro.configs import get_config
        from repro.configs import reduce_for_smoke as j_reduce
        cfg = j_reduce(get_config(arch))
    else:
        cfg = reduce_for_smoke(tconfigs.get_config(arch))
    if arch == JAMBA:
        cfg = dataclasses.replace(cfg, n_layers=JAMBA_CUT,
                                  block_pattern=cfg.block_pattern[:JAMBA_CUT])
    return cfg


def _kw() -> dict:
    return dict(lr=LR, warmup_steps=1, total_steps=10)


def live_leaves(arch: str, tree):
    """A numpy parameter tree with the leaves the init draws at zero
    (rwkv's ``w_lora_b``, mamba's ``conv_b``) made random, so the layer
    case's gradients reach every leaf."""
    r = np.random.default_rng(9)
    for layer in tree["blocks"].values():
        for sub in layer.values():
            for name in ("w_lora_b", "conv_b"):
                if isinstance(sub, dict) and name in sub:
                    sub[name] = (0.3 * r.standard_normal(
                        sub[name].shape)).astype(np.float32)
    return tree


def put_params(tmp: str, arch: str, tree) -> None:
    """The reference's init of ``arch`` (numpy) for the ranks, written
    once whole (a rename), by whichever JAX process gets there first."""
    path = os.path.join(tmp, f"params_{arch}.pkl")
    if not os.path.exists(path):
        part = f"{path}.{os.getpid()}"
        with open(part, "wb") as f:
            pickle.dump(tree, f)
        os.replace(part, path)


def get_params(tmp: str, arch: str):
    """``put_params``'s tree, once it is there."""
    path = os.path.join(tmp, f"params_{arch}.pkl")
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > DEADLINE_S:
            raise TimeoutError(f"the reference wrote no {arch} weights")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def layer_x(cfg) -> tuple:
    """The layer case's x and x_prev (B, T, d) and the output's weights."""
    r = np.random.default_rng(13)
    return tuple(r.standard_normal((LAYER_B, LAYER_T, cfg.d_model))
                 .astype(np.float32) for _ in range(3))


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
import test_torch_mesh_recurrent as T
from test_torch_mesh_train import _np_opt

host = lambda t: jax.tree.map(np.asarray, t)
out = {{}}
for case, (arch, shape) in {cases!r}.items():
    cfg, tc = T._cfg(True, arch), TrainConfig(**T._kw())
    p = init_params(cfg, jax.random.key(0))
    T.put_params({tmp!r}, arch, host(p))     # the ranks' weights
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
def contiguous_in_proj():
    """The planted fault: in_proj's contiguous column block taken as (xi,
    z), as the one-device split does with the whole matrix."""
    from repro_torch.models import mamba
    from repro_torch.models.dist import copy_to

    def contiguous(p, x, mi):
        return torch.chunk(copy_to(x, mi, "model") @ p["in_proj"], 2, dim=-1)
    with mock.patch.object(mamba, "_tp_in_proj", contiguous):
        yield


def _mixer(name: str, cfg, p, xs, mi, tp: bool):
    from repro_torch.models import mamba, rwkv6
    split = mi.size("model") if tp else 1
    B = xs[0].shape[0]
    if name == "time_mix":
        st = rwkv6.zero_state(cfg, B, xs[0].dtype, "cpu", split).wkv
        return rwkv6.rwkv_time_mix(p, xs[0], xs[1], cfg, st, mi=mi, tp=tp)[0]
    if name == "channel_mix":
        return rwkv6.rwkv_channel_mix(p, xs[0], xs[1], mi=mi, tp=tp)
    st = mamba.zero_state(cfg, B, xs[0].dtype, "cpu", split)
    return mamba.mamba_mix(p, xs[0], cfg, st, mi=mi, tp=tp)[0]


def _layer_case(name: str, mi, jtree) -> dict:
    """(b) on one rank: the mixer of block 0's layer 0 whole on the rank's
    rows (no tensor parallelism; its gradient summed over the data ranks
    and cut to the rank's blocks), its tensor-parallel form on the rank's
    blocks, and for mamba the planted fault's output."""
    from repro_torch.models.blocks import FwdCtx
    from repro_torch.models.dist import all_reduce
    from repro_torch.models.model import _use_params, batch_sharding
    from repro_torch.models.params import (model_specs, shardings,
                                           unstack_blocks)
    from repro_torch.tree import flatten, tree_map, unflatten
    arch, key = MIXERS[name]
    cfg = _cfg(False, arch)
    x, x_prev, w = layer_x(cfg)
    rows = batch_sharding(x.shape, mi)
    axes = tuple(a for a in rows.axes(0) if mi.size(a) > 1)
    x, x_prev, w = (torch.from_numpy(rows.cut(a).copy())
                    for a in (x, x_prev, w))
    whole = unstack_blocks(jtree)["blocks"][0]["0"][key]
    sh = shardings(model_specs(cfg), mi)["blocks"][0]["0"][key]

    def run(p, tp):
        flat, tdef = flatten(p)
        live = [t.detach().requires_grad_(True) for t in flat]
        xs = [x.clone().requires_grad_(True),
              x_prev.clone().requires_grad_(True)]
        pl = unflatten(tdef, live)
        if tp:
            ctx = FwdCtx(cfg=cfg, mode="prefill", mi=mi, tp=True,
                         grad_axes=axes)
            pl = _use_params(pl, sh, ctx)
        y = _mixer(name, cfg, pl, xs, mi, tp)
        used = xs if name != "mamba" else xs[:1]
        grads = list(torch.autograd.grad((y * w).sum(), live + used))
        n = len(live)
        if not tp:          # the whole mixer: the other rows' part too
            g_leaves = [all_reduce(g, mi, axes) for g in grads[:n]]
            g_tree = tree_map(lambda g, s_: s_.cut(g).contiguous(),
                              unflatten(tdef, g_leaves), sh)
            grads = flatten(g_tree)[0] + grads[n:]
        return [y.detach().numpy()] + [g.numpy() for g in grads]

    p_whole = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                       whole)
    p_local = tree_map(lambda t, s_: s_.cut(t).contiguous(), p_whole, sh)
    out = dict(whole=run(p_whole, False), tp=run(p_local, True))
    if name == "mamba":
        with contiguous_in_proj():
            out["fault"] = run(p_local, True)[0]
    return out


def _rank(rank: int, port: int, tmp: str) -> None:
    """One rank: every port case, results to files."""
    import copy
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
    t = lambda b: {k: torch.from_numpy(v).long() for k, v in b.items()}
    jparams = {a: get_params(tmp, a) for a in ARCHS}
    jlive = {a: live_leaves(a, copy.deepcopy(jparams[a])) for a in ARCHS}

    cases = dict(STEP_CASES, **{FLOOR_CASE[0]: FLOOR_CASE[1:]})
    for case, (arch, shape) in cases.items():
        mi, cfg, tc = meshes[shape], _cfg(False, arch), TrainConfig(**_kw())
        params = from_jax_params(cfg, jparams[arch], device="cpu", mi=mi)
        opt = init_opt_state(params)
        sh = shardings(model_specs(cfg), mi)
        out[case + "_local_shapes"] = [list(x.shape) for x in leaves(params)]
        params, opt, m = make_train_step(cfg, tc, mi)(params, opt,
                                                       t(batch(cfg, 0)))
        out[case] = _dump(params, opt, m)
        out[case + "_replicas"] = _replicas(
            (params, opt.master, opt.mu, opt.nu), sh, mi)
        if case == "jamba_2x2":      # (c): save on (2, 2), restore on (1, 4)
            ck = os.path.join(tmp, "ck")
            held = ckpt_state(params, opt)
            out["saved_2x2"] = _blocks(held)
            save(ck, 1, held, shardings=ckpt_shardings(cfg, mi, False), mi=mi)
            mi14 = meshes[(1, 4)]
            p4 = from_jax_params(cfg, jparams[arch], device="cpu", mi=mi14)
            state = restore(ck, 1, ckpt_state(p4, init_opt_state(p4)),
                            shardings=ckpt_shardings(cfg, mi14, False))
            out["restored_1x4"] = _blocks(state)

    for name, shape in LAYER_CASES:
        out[f"layer_{name}_{shape}"] = _layer_case(
            name, meshes[shape], jlive[MIXERS[name][0]])
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, each rank's). The JAX subprocesses (one a
    group of ``REF_GROUPS``, which also write the reference's init for
    the ranks) and the four ranks run at once."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh_recurrent")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = []
    for i, group in enumerate(REF_GROUPS):
        code = JAX_SCRIPT.format(
            src=str(ROOT / "src"), tests=str(ROOT / "tests"),
            cases={c: STEP_CASES[c] for c in group}, tmp=str(tmp),
            out_pkl=str(tmp / f"ref{i}.pkl"))
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

def _jamba_floor(runs) -> dict:
    """The floor of jamba's limits on mu, nu (a leaf) and the gradient
    norm: FLOOR_FACTOR times the larger of the reference's own spread (its
    (2, 2) step against its (1, 4) step) and the port's distance from the
    reference without tensor parallelism (the port's (4, 1) step,
    ``FLOOR_CASE``, against the reference's (2, 2) step; every mesh of four
    routes in the same token groups), over every rank's blocks. The mamba
    layers' fp32 scan sums in another order than XLA's associative scan,
    and their gradients carry it to ~1e-4 of a leaf's largest moment
    (A_log, dt_proj, conv_w) and ~2e-5 of the gradient norm, where the
    reference's two meshes differ by ~2e-5 and ~2e-7."""
    case, _, shape = FLOOR_CASE
    cfg = _cfg(False, JAMBA)
    refs = [runs["ref"][c] for c in ("jamba_2x2", "jamba_1x4")]
    gn = [float(r_["metrics"]["grad_norm"]) for r_ in refs]
    out = {"grad_norm": max(
        abs(gn[0] - gn[1]),
        abs(runs["ranks"][0][case]["metrics"]["grad_norm"] - gn[0]))}
    for name in ("mu", "nu"):
        a, b = (_port_layout(r_["opt"][name]) for r_ in refs)
        out[name] = [float(np.abs(x - y).max()) for x, y in zip(a, b)]
    for rank, r in enumerate(runs["ranks"]):
        ref = _ref_blocks(refs[0], cfg, shape, _coords(runs, rank, shape))
        for name in ("mu", "nu"):
            out[name] = [max(f, float(np.abs(x - y).max())) for f, x, y in
                         zip(out[name], r[case][name], ref[name])]
    return dict(grad_norm=FLOOR_FACTOR * out["grad_norm"],
                **{k: [FLOOR_FACTOR * f for f in out[k]]
                   for k in ("mu", "nu")})


def _hold_jamba(ours: dict, ref: dict, floor: dict) -> None:
    """``_hold_moe`` with the gradient norm held here, within the larger of
    ``_hold``'s limit (1e-5 of it) and ``floor``'s."""
    gn = ref["metrics"]["grad_norm"]
    assert abs(ours["metrics"]["grad_norm"] - gn) <= max(
        1e-5 * abs(gn), floor["grad_norm"])
    _hold_moe(dict(ours, metrics=dict(ours["metrics"], grad_norm=gn)), ref,
              _kw(), floor)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_recurrent_step_matches_reference_mesh_step(runs, case):
    """Each rank's blocks after one step against the reference's step on
    the same mesh, within ``_hold``'s limits (jamba's moments and gradient
    norm: at least ``_jamba_floor``, ``_hold_jamba``)."""
    arch, shape = STEP_CASES[case]
    cfg = _cfg(False, arch)
    floor = _jamba_floor(runs) if arch == JAMBA else None
    for rank, r in enumerate(runs["ranks"]):
        ref = _ref_blocks(runs["ref"][case], cfg, shape,
                          _coords(runs, rank, shape))
        if floor is None:
            _hold(r[case], ref, _kw())
        else:
            _hold_jamba(r[case], ref, floor)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_recurrent_replicas_bit_equal(runs, case):
    """The blocks several ranks hold (the norms, rwkv's mu, w0, the decay's
    low-rank pair, ln_w and channel-mix mu, jamba's x_proj, the router; on
    (1, 4) jamba's KV projections) stay equal bit for bit, and every rank
    reports the same loss."""
    for r in runs["ranks"]:
        assert r[case + "_replicas"] is True
        assert r[case]["metrics"] == runs["ranks"][0][case]["metrics"]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_recurrent_ranks_hold_their_blocks(runs, case):
    """Every leaf has the local shape its resolved spec gives: rwkv's ``u``
    holds H / model heads, mamba's ``conv_w`` d_in / model channels and
    its ``in_proj`` 2 d_in / model columns."""
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
    layer = specs["blocks"][0]["0"]
    m = shape[1]
    if arch == RWKV:
        i = next(i for i, s in enumerate(flat) if s is layer["tm"]["u"])
        assert want[i][0] == cfg.n_heads // m
    else:
        d_in = cfg.ssm.expand * cfg.d_model
        for name, dim, n in (("conv_w", 1, d_in), ("in_proj", 1, 2 * d_in)):
            i = next(i for i, s in enumerate(flat)
                     if s is layer["mamba"][name])
            assert want[i][dim] == n // m


# ---------------------------------------------------------------- (b)

def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name,shape", LAYER_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}" for n, s in LAYER_CASES])
def test_recurrent_mixer_tp_form_matches_whole_mixer(runs, name, shape):
    """The output and the gradient of x (and x_prev) and of every leaf of
    the rank's blocks, the tensor-parallel form against the whole mixer on
    the rank's rows; mamba's planted fault (in_proj's contiguous block as
    (xi, z)) misses by at least FAULT_REL."""
    for r in runs["ranks"]:
        got = r[f"layer_{name}_{shape}"]
        assert len(got["tp"]) == len(got["whole"])
        for i, (a, c) in enumerate(zip(got["tp"], got["whole"])):
            assert a.shape == c.shape, i
            assert _rel(a, c) <= LAYER_REL, (i, _rel(a, c))
            assert np.abs(c).max() > 0, i
        if name == "mamba":
            assert _rel(got["fault"], got["whole"][0]) >= FAULT_REL


# ---------------------------------------------------------------- (c)

def test_jamba_checkpoint_saved_on_2x2_restores_bit_for_bit_on_1x4(runs):
    """The (2, 2) step's state saved (rank 0 writes whole leaves) and
    restored on (1, 4): each rank's (2, 2) blocks, and its (1, 4) blocks
    after the restore, equal bit for bit their blocks of the files."""
    from repro_torch.models.params import model_specs, stack_specs
    from repro_torch.optim import opt_state_specs
    from repro_torch.tree import leaves
    specs = stack_specs(model_specs(_cfg(False, JAMBA)))
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


# ---------------------------------------------------------------- (d)

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_archs_train_on_every_mesh_of_four(arch, smoke):
    from repro_torch.models.model import mesh_train_refusal
    cfg = tconfigs.get_config(arch)
    if smoke:
        cfg = reduce_for_smoke(cfg)
    for model in (1, 2, 4):
        assert mesh_train_refusal(cfg, model) is None, model


# (arch, the change, the model axis, the width the refusal names)
WIDTH_CASES = [(RWKV, dict(n_heads=3, d_head=16, d_model=48), 2, "heads"),
               (RWKV, dict(d_ff=130), 4, "d_ff"),
               (JAMBA, dict(d_ff=130), 4, "d_ff"),
               (JAMBA, dict(d_model=65), 4, "d_in"),
               (JAMBA, dict(moe_experts=6), 4, "experts")]


@pytest.mark.parametrize("arch,change,model,named", WIDTH_CASES,
                         ids=[f"{a}-{n}" for a, _, _, n in WIDTH_CASES])
def test_width_that_does_not_split_refuses(arch, change, model, named):
    from repro_torch.models.model import mesh_train_refusal
    cfg = reduce_for_smoke(tconfigs.get_config(arch))
    change = dict(change)
    if "moe_experts" in change:
        change["moe"] = dataclasses.replace(cfg.moe,
                                            n_experts=change.pop("moe_experts"))
    cfg = dataclasses.replace(cfg, **change)
    why = mesh_train_refusal(cfg, model)
    assert why is not None and named in why, why
    assert f"model axis of {model}" in why, why


@pytest.mark.parametrize("arch,kind", [("seamless-m4t-medium", "cross_mlp"),
                                       ("llama-3.2-vision-90b", "xattn_mlp")])
def test_cross_attention_still_refuses(arch, kind):
    """The cross-attention archs, smoke and full, train on every mesh of
    four (their kinds have tensor-parallel forms since ROADMAP item
    2c(ii)(b)), and still refuse a width that does not split: their heads
    on a model axis of 3."""
    from repro_torch.models.model import mesh_train_refusal
    for smoke in (True, False):
        cfg = tconfigs.get_config(arch)
        if smoke:
            cfg = reduce_for_smoke(cfg)
        assert kind in cfg.layer_kinds()
        for model in (1, 2, 4):
            assert mesh_train_refusal(cfg, model) is None, (smoke, model)
        why = mesh_train_refusal(cfg, 3)
        assert why is not None and f"heads {cfg.n_heads}" in why, why
        assert "model axis of 3" in why, why
