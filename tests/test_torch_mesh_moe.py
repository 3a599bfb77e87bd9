"""The port's MoE training on a mesh against the JAX package's: four ranks
over ``torch.distributed`` (gloo, on the CPU) against the reference on four
host devices, the recipe and helpers of ``test_torch_mesh_train.py``.

The yardstick is the reference's step on the SAME mesh shape: the
reference routes tokens in ``G = gcd(T, 4)`` groups on any mesh of four
and in one group without a mesh, so its mesh step differs from its
one-device step (by ~2e-4 in the loss at smoke size). One JAX subprocess
writes every reference array, one ``mp.spawn`` of four ranks every port
array, from the same numpy-seeded batches and the same weights; this
process compares them. The cases:

  (a) one train step of smoke olmoe-1b-7b on (2, 2), (1, 4) and (4, 1),
      of smoke kimi-k2-1t-a32b (a dense first layer, a shared expert) on
      (2, 2) and (1, 4), and of olmoe on (2, 2) with two microbatches,
      each against the reference's step on the same mesh; each rank's
      local shapes (an expert leaf holds E / model experts); replicas bit
      for bit; the step's collectives are all_gather, reduce_scatter and
      all_reduce alone;
  (b) the MoE layer's tensor-parallel form (``blocks._apply_moe``: copy_to
      on the input and the router, one reduce_from) with ``moe_ffn`` and
      with ``moe_ffn_ref`` on each rank's experts, forward and every
      leaf's gradient, against each other and against the whole layer on
      the rank's rows;
  (c) a save on (2, 2) restored on (1, 4), bit for bit.
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

from test_torch_mesh_train import (_blocks, _dump, _free_port,  # noqa: E402
                                   _hold, _placed, _ref_blocks, _replicas,
                                   batch)

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import reduce_for_smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 240
LR = 1e-3
OLMOE, KIMI = "olmoe-1b-7b", "kimi-k2-1t-a32b"
ARCHS = (OLMOE, KIMI)
# (a): case -> (arch, mesh shape, TrainConfig fields)
STEP_CASES = {"olmoe_2x2": (OLMOE, (2, 2), {}),
              "olmoe_1x4": (OLMOE, (1, 4), {}),
              "olmoe_4x1": (OLMOE, (4, 1), {}),
              "kimi_2x2": (KIMI, (2, 2), {}),
              "kimi_1x4": (KIMI, (1, 4), {}),
              "olmoe_2x2_mb2": (OLMOE, (2, 2), {"microbatches": 2})}
# (b): the layer's meshes (a model axis larger than 1)
LAYER_CASES = [(a, s) for a in ARCHS for s in ((2, 2), (1, 4))]
LAYER_REL = 1e-5        # fp32: the same sums in other orders
ALLOWED = {"all_gather", "reduce_scatter", "all_reduce"}
OTHER = ("all_to_all", "all_to_all_single", "broadcast", "send", "recv",
         "isend", "irecv", "scatter", "gather", "all_gather_into_tensor",
         "reduce_scatter_tensor", "reduce", "all_gather_object",
         "broadcast_object_list")


def _cfg(jax_side: bool, arch: str):
    if jax_side:
        from repro.configs import get_config
        from repro.configs import reduce_for_smoke as j_reduce
        return j_reduce(get_config(arch))
    return reduce_for_smoke(tconfigs.get_config(arch))


def _kw(case: str) -> dict:
    return dict(lr=LR, warmup_steps=1, total_steps=10, **STEP_CASES[case][2])


def layer_x(cfg, arch: str) -> tuple:
    """The layer case's input (B, S, d) at 4x the embedding's scale, so
    the routing is uneven and capacity drops pairs, and its output's
    weights."""
    r = np.random.default_rng(11 + ARCHS.index(arch))
    x = r.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    w = r.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    return 4 * x, w


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
import test_torch_mesh_moe as T
from test_torch_mesh_train import _np_opt

host = lambda t: jax.tree.map(np.asarray, t)
out = {{}}
for case, (arch, shape, extra) in T.STEP_CASES.items():
    cfg, tc = T._cfg(True, arch), TrainConfig(**T._kw(case))
    p = init_params(cfg, jax.random.key(0))
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

def _collective_recorder(used: set):
    """Patches of torch.distributed's collectives that record each name
    used (the allowed ones pass through)."""
    import torch.distributed as dist
    patches = []
    for name in sorted(ALLOWED) + list(OTHER):
        real = getattr(dist, name, None)
        if real is None:
            continue

        def rec(*a, _n=name, _f=real, **k):
            used.add(_n)
            return _f(*a, **k)
        patches.append(mock.patch.object(dist, name, rec))
    return patches


def _layer_case(cfg, arch, mi, jtree) -> dict:
    """(b) on one rank: the MoE layer of block 0 whole on the rank's rows
    (no tensor parallelism; its gradient summed over the data ranks and
    cut to the rank's blocks), and its tensor-parallel form on the rank's
    blocks with each version of the FFN."""
    from repro_torch.models import blocks
    from repro_torch.models.blocks import FwdCtx, _apply_moe
    from repro_torch.models.dist import all_reduce
    from repro_torch.models.model import batch_sharding, _use_params
    from repro_torch.models.moe import moe_ffn_ref
    from repro_torch.models.params import (model_specs, shardings,
                                           unstack_blocks)
    from repro_torch.tree import flatten, tree_map, unflatten
    x, w = layer_x(cfg, arch)
    rows = batch_sharding(x.shape, mi)
    axes = tuple(a for a in rows.axes(0) if mi.size(a) > 1)
    x, w = (torch.from_numpy(rows.cut(a).copy()) for a in (x, w))
    whole = unstack_blocks(jtree)["blocks"][0]["0"]["moe"]
    sh = shardings(model_specs(cfg), mi)["blocks"][0]["0"]["moe"]

    def run(p, tp, ref=False):
        flat, tdef = flatten(p)
        live = [t.detach().requires_grad_(True) for t in flat]
        xl = x.clone().requires_grad_(True)
        ctx = FwdCtx(cfg=cfg, mode="prefill", mi=mi, tp=tp, grad_axes=axes)
        pl = unflatten(tdef, live)
        with mock.patch.object(blocks, "moe_ffn", moe_ffn_ref) if ref \
                else contextlib.nullcontext():
            if tp:
                y = _apply_moe(_use_params(pl, sh, ctx), xl, ctx)
            else:
                y = _apply_moe(pl, xl, ctx)
        grads = torch.autograd.grad((y * w).sum(), live + [xl])
        if not tp:          # the whole layer: the other rows' part too
            grads = [all_reduce(g, mi, axes) for g in grads[:-1]] \
                + [grads[-1]]
            g_tree = tree_map(lambda g, s_: s_.cut(g).contiguous(),
                              unflatten(tdef, grads[:-1]), sh)
            grads = flatten(g_tree)[0] + [grads[-1]]
        return [y.detach().numpy()] + [g.numpy() for g in grads]

    p_whole = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                       whole)
    p_local = tree_map(lambda t, s_: s_.cut(t).contiguous(), p_whole, sh)
    return dict(whole=run(p_whole, False), main=run(p_local, True),
                ref=run(p_local, True, ref=True),
                w_gate=list(p_local["w_gate"].shape))


def _rank(rank: int, port: int, tmp: str, jparams) -> None:
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
                      for s, mi in meshes.items()}, "used": set()}
    t = lambda b: {k: torch.from_numpy(v).long() for k, v in b.items()}

    for case, (arch, shape, _) in STEP_CASES.items():
        mi, cfg, tc = meshes[shape], _cfg(False, arch), TrainConfig(**_kw(case))
        params = from_jax_params(cfg, jparams[arch], device="cpu", mi=mi)
        opt = init_opt_state(params)
        sh = shardings(model_specs(cfg), mi)
        out[case + "_local_shapes"] = [list(x.shape) for x in leaves(params)]
        step = make_train_step(cfg, tc, mi)
        patches = _collective_recorder(out["used"])
        for p_ in patches:
            p_.start()
        try:
            params, opt, m = step(params, opt, t(batch(cfg, 0)))
        finally:
            for p_ in patches:
                p_.stop()
        out[case] = _dump(params, opt, m)
        out[case + "_replicas"] = _replicas(
            (params, opt.master, opt.mu, opt.nu), sh, mi)
        if case == "olmoe_2x2":      # (c): save on (2, 2), restore on (1, 4)
            ck = os.path.join(tmp, "ck")
            held = ckpt_state(params, opt)
            out["saved_2x2"] = _blocks(held)
            save(ck, 1, held, shardings=ckpt_shardings(cfg, mi, False), mi=mi)
            mi14 = meshes[(1, 4)]
            p4 = from_jax_params(cfg, jparams[arch], device="cpu", mi=mi14)
            state = restore(ck, 1, ckpt_state(p4, init_opt_state(p4)),
                            shardings=ckpt_shardings(cfg, mi14, False))
            out["restored_1x4"] = _blocks(state)

    for arch, shape in LAYER_CASES:
        out[f"layer_{arch}_{shape}"] = _layer_case(
            _cfg(False, arch), arch, meshes[shape], jparams[arch])
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, each rank's). The JAX subprocess and the
    four ranks run at once."""
    import jax
    import torch.multiprocessing as mp
    from repro.models import init_params as j_init_params
    tmp = tmp_path_factory.mktemp("mesh_moe")
    code = JAX_SCRIPT.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"),
                             out_pkl=str(tmp / "ref.pkl"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    jparams = {a: jax.tree.map(np.asarray, j_init_params(
        _cfg(True, a), jax.random.key(0))) for a in ARCHS}
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
    return dict(ref=ref, ranks=ranks, tmp=tmp)


def _coords(runs, rank: int, shape) -> tuple:
    return tuple(runs["ranks"][rank]["coords"][str(shape)])


# ---------------------------------------------------------------- (a)

def _reference_spread(runs, arch: str) -> dict:
    """Twice the largest difference, a leaf, between the reference's own
    one-microbatch steps of ``arch`` on its meshes, in mu and nu. Every
    mesh of four routes in the same four token groups, so the steps differ
    by rounding alone; at smoke size kimi's embedding table shows ~1e-4 of
    its largest moment between the reference's (2, 2) and (1, 4) steps,
    where the port's two steps differ by ~7e-6."""
    from test_torch_mesh_train import _port_layout
    cases = [c for c, (a, _, kw) in STEP_CASES.items() if a == arch and not kw]
    out = {}
    for name in ("mu", "nu"):
        steps = [_port_layout(runs["ref"][c]["opt"][name]) for c in cases]
        out[name] = [2 * max(float(np.abs(a[i] - b[i]).max())
                             for j, a in enumerate(steps)
                             for b in steps[j + 1:])
                     for i in range(len(steps[0]))]
    return out


def _hold_moe(ours: dict, ref: dict, kw: dict, floor: dict) -> None:
    """``_hold`` with a moment's limit raised to at least ``floor``'s entry
    for its leaf: mu and nu are held here, within the larger of
    ``_hold``'s limit (1e-4 and 2e-4 of the leaf's largest) and the floor;
    ``_hold`` holds the rest (fp32 steps, no int8 buffers)."""
    assert ref["ef"] is None and ours["ef"] is None
    for name, rel in (("mu", 1e-4), ("nu", 2e-4)):
        for i, (a, b) in enumerate(zip(ours[name], ref[name])):
            assert a.shape == b.shape, (name, i)
            tol = max(rel * ref["leaf_max"][name][i] + 1e-12,
                      floor[name][i])
            assert float(np.abs(a - b).max()) <= tol, (name, i, a.shape)
    _hold(dict(ours, mu=ref["mu"], nu=ref["nu"]), ref, kw)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_moe_step_matches_reference_mesh_step(runs, case):
    """Each rank's blocks after one step against the reference's step on
    the same mesh, within ``_hold``'s limits; a moment's limit is at least
    the reference's own spread across its meshes (``_reference_spread``,
    ``_hold_moe``)."""
    arch, shape, _ = STEP_CASES[case]
    cfg = _cfg(False, arch)
    floor = _reference_spread(runs, arch)
    for rank, r in enumerate(runs["ranks"]):
        ref = _ref_blocks(runs["ref"][case], cfg, shape,
                          _coords(runs, rank, shape))
        _hold_moe(r[case], ref, _kw(case), floor)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_moe_replicas_bit_equal(runs, case):
    """The blocks several ranks hold (the router, the norms, kimi's first
    layer's norms and its KV projections on (1, 4)) stay equal bit for bit,
    and every rank reports the same loss."""
    for r in runs["ranks"]:
        assert r[case + "_replicas"] is True
        assert r[case]["metrics"] == runs["ranks"][0][case]["metrics"]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mesh_moe_ranks_hold_their_blocks(runs, case):
    """Every leaf has the local shape its resolved spec gives; an expert
    leaf holds n_experts / model experts (on (1, 4) smoke olmoe's w_gate
    is (1, 64, 32))."""
    from repro_torch.models.params import model_specs
    from repro_torch.tree import leaves
    arch, shape, _ = STEP_CASES[case]
    cfg = _cfg(False, arch)
    specs = model_specs(cfg)
    for rank, r in enumerate(runs["ranks"]):
        placed = leaves(_placed(specs, shape, _coords(runs, rank, shape)))
        want = [list(sh.local_shape(s.shape))
                for sh, s in zip(placed, leaves(specs))]
        assert r[case + "_local_shapes"] == want
        gate = specs["blocks"][0]["0"]["moe"]["w_gate"]
        i = next(i for i, s in enumerate(leaves(specs)) if s is gate)
        E = cfg.moe.n_experts
        assert r[case + "_local_shapes"][i][0] == E // shape[1]
    if case == "olmoe_1x4":
        assert runs["ranks"][0][case + "_local_shapes"][i] == [1, 64, 32]


def test_mesh_moe_uses_no_other_collective(runs):
    for r in runs["ranks"]:
        assert r["used"] and r["used"] <= ALLOWED, r["used"]


# ---------------------------------------------------------------- (b)

def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch,shape", LAYER_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in LAYER_CASES])
def test_moe_layer_tp_form_matches_whole_layer(runs, arch, shape):
    """The output and the gradient of x and of every leaf of the rank's
    blocks (router, experts, shared expert), ``moe_ffn`` and
    ``moe_ffn_ref`` in the tensor-parallel form, against each other and
    against the whole layer on the rank's rows."""
    E = _cfg(False, arch).moe.n_experts
    for r in runs["ranks"]:
        got = r[f"layer_{arch}_{shape}"]
        assert got["w_gate"][0] == E // shape[1]
        assert len(got["main"]) == len(got["ref"]) == len(got["whole"])
        for i, (a, b, c) in enumerate(zip(got["main"], got["ref"],
                                          got["whole"])):
            assert a.shape == b.shape == c.shape, i
            assert _rel(a, b) <= LAYER_REL, (i, _rel(a, b))
            assert _rel(a, c) <= LAYER_REL, (i, _rel(a, c))
            assert np.abs(c).max() > 0, i


# ---------------------------------------------------------------- (c)

def test_olmoe_checkpoint_saved_on_2x2_restores_bit_for_bit_on_1x4(runs):
    """The (2, 2) step's state saved (rank 0 writes whole leaves) and
    restored on (1, 4): each rank's (2, 2) blocks, and its (1, 4) blocks
    (16 experts a rank at full width, 1 at smoke) after the restore, equal
    bit for bit their blocks of the files."""
    from repro_torch.models.params import model_specs, stack_specs
    from repro_torch.optim import opt_state_specs
    from repro_torch.tree import leaves
    specs = stack_specs(model_specs(_cfg(False, OLMOE)))
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
