"""The port's serving path on a mesh against the JAX package's: four ranks
over ``torch.distributed`` (gloo, on the CPU) against the reference on four
host devices (``--xla_force_host_platform_device_count=4``, the recipe of
``tests/test_multidevice.py``).

One JAX subprocess writes every reference array, one ``mp.spawn`` of four
ranks every port array, both from the same numpy-seeded inputs and
weights (the weights: JAX ``init_params`` -> numpy, and
``from_jax_params`` on the port's side); this process compares them.
They run side by side. The cases:

  (a) ``MeshInfo``'s values on a (4, 1) ("data", "model") mesh;
  (b) ``sp_paged_decode`` in fp32, outputs to 1e-5 and pools to 1e-6: a
      length in the last shard, one inside shard 0 only (three empty
      partials), one past capacity (the rolling wrap), softcap on, G = 1
      and G = 4 (the rest G = 2);
  (c) the same in bf16, to ``SP_BF16_TOL`` (below);
  (d) ``forward_decode`` of smoke llama3.2-1b under the sequence-parallel
      layout at max_len 262144, two steps across a shard boundary: logits
      and each rank's pool slice;
  (e) ``moe_ffn`` (both versions) at T where ``_n_groups`` is 4 and 2;
  (d') the layout's prefill write on each rank against the one-device
      per-slot write (held against the reference by
      ``tests/test_torch_model.py``) sliced to the rank's pages: prompts
      that span ranks, a right-padded row, one past capacity, random
      permutation tables;
  (f) a copy-mode serve of one slot at 262144 on the four ranks: tokens
      bit for bit across ranks and equal to the one-device port engine at
      262128, just under the layout's threshold;
  (g) the refusals: zero-copy with the layout on both sides; the layout
      without a mesh (the port refuses at construction; the reference
      fails at its first decode).
"""
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import reduce_for_smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 300        # each side takes ~30 s
TOL = dict(atol=1e-4, rtol=1e-4)
# (Hq, Hkv, length, softcap) over 8 pages of 4 tokens, D 16: 2 pages and 8
# tokens a shard. In bf16 (8 significant bits, a rounding off by at most
# 2^-8 of its value) the two sides round at different places: the
# reference rounds P to V's dtype before P.V (repro/models/attention.py:598)
# where the port keeps the kernel's precision (both merge fp32 partials);
# both round the output. Three roundings of values within max|v|: the
# outputs may differ by 3 x 2^-8 x max|v|.
SP_BF16_TOL = 3 * 2.0 ** -8
SP_P, SP_T, SP_D = 8, 4, 16
SP_CASES = {"last_shard": (4, 2, SP_P * SP_T - 3, None),
            "shard0_only": (4, 2, 5, None),
            "past_capacity": (4, 2, SP_P * SP_T + 9, None),
            "softcap": (4, 2, SP_P * SP_T - 3, 30.0),
            "g1": (2, 2, 19, None),
            "g4": (8, 2, 19, None)}
DTYPES = ("float32", "bfloat16")
# (d): one layer, 16384 pages of 16 a sequence, 4096 a rank; the first
# decode appends the last token of shard 2, the second the first of 3.
SP_LEN, PAGE = 262144, 16
DEC_START = 3 * SP_LEN // 4 - 1
DEC_TOKENS = (7, 311)
# (e): B x S with _n_groups = gcd(T, 4): 4 and 2; capacity factor 0.5, so
# the groups' capacities decide which choices drop.
MOE_SHAPES = ((2, 6), (1, 6))
MOE_CF = 0.5
# (d'): (S, per-row lengths or None) over 8 pages of 4 tokens, B 2.
WRITE_CASES = ((21, None), (37, None), (21, (13, 21)), (3, None))
# (f): prompts of one slot served one after the other.
SERVE_PROMPTS = ((5, 9, 17, 33, 2), tuple(range(40, 52)), (300, 301, 7))
SERVE_NEW = 4


def _cfg(jax_side: bool, arch="llama3.2-1b"):
    if jax_side:
        from repro.configs import get_config
        from repro.configs import reduce_for_smoke as j_reduce
        return j_reduce(get_config(arch))
    return reduce_for_smoke(tconfigs.get_config(arch))


def sp_inputs(case: str):
    """q (1, 1, Hq, D), k_new, v_new (1, 1, Hkv, D), pools (1, 8, 4, Hkv,
    D) fp32, the identity table (1, 8) and the length, from a seed."""
    hq, hkv, length, _ = SP_CASES[case]
    r = np.random.default_rng(sorted(SP_CASES).index(case))
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    pool = (1, SP_P, SP_T, hkv, SP_D)
    return (f(1, 1, hq, SP_D), f(1, 1, hkv, SP_D), f(1, 1, hkv, SP_D),
            f(*pool), f(*pool), np.arange(SP_P, dtype=np.int32)[None],
            length)


def decode_pools(cfg):
    """(d)'s K and V pools of the one layer, (1, 16384, 16, Hkv, Dh)."""
    r = np.random.default_rng(11)
    shape = (1, SP_LEN // PAGE, PAGE, cfg.n_kv_heads, cfg.d_head)
    return (r.standard_normal(shape, dtype=np.float32),
            r.standard_normal(shape, dtype=np.float32))


def moe_x(shape):
    return np.random.default_rng(sum(shape)).standard_normal(
        (*shape, 64)).astype(np.float32)


def _moe_cfg(cfg):
    import dataclasses
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CF))


# ---------------------------------------------------------------- the reference

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{src!r}, {tests!r}]
import json
import jax, jax.numpy as jnp, numpy as np
from repro.core.serving.engine import ServingEngine
from repro.launch.mesh import make_mesh, mesh_context
from repro.models import MeshInfo, NO_MESH, init_cache, init_params
from repro.models import forward_decode
from repro.models.attention import PagedKV, sp_paged_decode
from repro.models.moe import moe_ffn, moe_specs
from repro.models.params import materialize
import test_torch_mesh as T

out, info = {{}}, {{}}
mesh = make_mesh((4, 1), ("data", "model"))
mi = MeshInfo(mesh)
info["meshinfo"] = dict(active=mi.active, multi_pod=mi.multi_pod,
                        axis_names=list(mi.axis_names),
                        size_data=mi.size("data"), size_model=mi.size("model"),
                        batch_axes=list(mi.batch_axes),
                        all_axes=list(mi.all_axes))
info["no_mesh"] = dict(active=NO_MESH.active, axis_names=list(NO_MESH.axis_names),
                       size_data=NO_MESH.size("data"),
                       all_axes=list(NO_MESH.all_axes))
with mesh_context(mesh):
    for case, (hq, hkv, length, cap) in T.SP_CASES.items():
        q, kn, vn, kp, vp, tbl, ln = T.sp_inputs(case)
        for dt in T.DTYPES:
            c = lambda a: jnp.asarray(a).astype(dt)
            kv = PagedKV(c(kp), c(vp), jnp.asarray(tbl), jnp.int32(ln))
            o, kv2 = jax.jit(lambda q, kn, vn, kv: sp_paged_decode(
                q, kn, vn, kv, mesh, softcap=cap))(c(q), c(kn), c(vn), kv)
            out[f"sp_{{case}}_{{dt}}_out"] = np.asarray(o.astype(jnp.float32))
            out[f"sp_{{case}}_{{dt}}_k"] = np.asarray(kv2.k_pool.astype(jnp.float32))
            out[f"sp_{{case}}_{{dt}}_v"] = np.asarray(kv2.v_pool.astype(jnp.float32))

    cfg = T._cfg(True)
    params = init_params(cfg, jax.random.key(0))
    info["params_fingerprint"] = float(sum(
        np.abs(np.asarray(a, np.float64)).sum() for a in jax.tree.leaves(params)))
    cache = init_cache(cfg, 1, T.SP_LEN, T.PAGE)
    kp, vp = T.decode_pools(cfg)
    kv = cache["blocks"]["0"]["kv"]
    kv = kv._replace(k_pool=jnp.asarray(kp)[None], v_pool=jnp.asarray(vp)[None],
                     length=jnp.full_like(kv.length, T.DEC_START))
    cache = {{**cache, "blocks": {{**cache["blocks"], "0": {{"kv": kv}}}}}}
    step = jax.jit(lambda p, t, pos, c: forward_decode(cfg, p, t, pos, c, mi))
    for i, tok in enumerate(T.DEC_TOKENS):
        logits, cache = step(params, jnp.full((1, 1), tok, jnp.int32),
                             jnp.int32(T.DEC_START + i), cache)
        out[f"dec_logits_{{i}}"] = np.asarray(logits)
    kv = cache["blocks"]["0"]["kv"]
    out["dec_k"], out["dec_v"] = np.asarray(kv.k_pool[0]), np.asarray(kv.v_pool[0])

    mcfg = T._moe_cfg(T._cfg(True, "olmoe-1b-7b"))
    p = materialize(moe_specs(mcfg), jax.random.key(0))
    info["moe_fingerprint"] = float(sum(
        np.abs(np.asarray(a, np.float64)).sum() for a in jax.tree.leaves(p)))
    for shape in T.MOE_SHAPES:
        x = jnp.asarray(T.moe_x(shape))
        key = "x".join(map(str, shape))
        out[f"moe_{{key}}"] = np.asarray(jax.jit(
            lambda x: moe_ffn(p, x, mcfg, mi))(x))
        out[f"moe_{{key}}_one_group"] = np.asarray(moe_ffn(p, x, mcfg, NO_MESH))

refusals = {{}}
try:
    ServingEngine(cfg, params, 1, T.SP_LEN, page_size=T.PAGE,
                  offload_mode="zero_copy")
except NotImplementedError as e:
    refusals["zero_copy"] = str(e)
eng = ServingEngine(cfg, params, 1, T.SP_LEN, page_size=T.PAGE,
                    offload_mode="copy")
eng.submit([5, 6, 7], 3)
try:
    eng.run()
except Exception as e:
    refusals["no_mesh"] = [type(e).__name__, str(e)]
info["refusals"] = refusals
np.savez({out_npz!r}, **out)
with open({out_json!r}, "w") as f:
    json.dump(info, f)
print("reference OK")
"""


# ---------------------------------------------------------------- the port

def _rank(rank: int, port: int, tmp: str, tparams, mparams) -> None:
    """One rank: every port case on the (4, 1) mesh, results to files."""
    torch.set_num_threads(1)
    from repro_torch.core.serving.engine import ServingEngine
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models import (MeshInfo, NO_MESH, forward_decode,
                                    init_cache)
    from repro_torch.models.attention import PagedKV, sp_paged_decode
    from repro_torch.models.moe import moe_ffn, moe_ffn_ref
    init_distributed(rank, WORLD, f"tcp://localhost:{port}", device="cpu")
    mesh = make_host_mesh(device="cpu")
    mi = MeshInfo(mesh)
    out, info = {}, {}
    info["meshinfo"] = dict(active=mi.active, multi_pod=mi.multi_pod,
                            axis_names=list(mi.axis_names),
                            size_data=mi.size("data"),
                            size_model=mi.size("model"),
                            batch_axes=list(mi.batch_axes),
                            all_axes=list(mi.all_axes))
    info["no_mesh"] = dict(active=NO_MESH.active,
                           axis_names=list(NO_MESH.axis_names),
                           size_data=NO_MESH.size("data"),
                           all_axes=list(NO_MESH.all_axes))
    t = torch.from_numpy
    lp = SP_P // WORLD
    mine = slice(rank * lp, (rank + 1) * lp)
    for case, (hq, hkv, length, cap) in SP_CASES.items():
        q, kn, vn, kp, vp, tbl, ln = sp_inputs(case)
        for dt in DTYPES:
            c = lambda a: t(np.ascontiguousarray(a)).to(getattr(torch, dt))
            kv = PagedKV(c(kp[:, mine]), c(vp[:, mine]), t(tbl),
                         torch.tensor([ln], dtype=torch.int32))
            o, kv2 = sp_paged_decode(c(q), c(kn), c(vn), kv, mesh,
                                     softcap=cap)
            assert int(kv2.length[0]) == ln + 1
            out[f"sp_{case}_{dt}_out"] = o.float().numpy()
            out[f"sp_{case}_{dt}_k"] = kv2.k_pool.float().numpy()
            out[f"sp_{case}_{dt}_v"] = kv2.v_pool.float().numpy()

    cfg = _cfg(False)
    cache = init_cache(cfg, 1, SP_LEN, PAGE, device="cpu", mi=mi)
    kp, vp = decode_pools(cfg)
    n = cache[0].k_pool.shape[1]
    cache[0].k_pool.copy_(t(kp[:, rank * n:(rank + 1) * n]))
    cache[0].v_pool.copy_(t(vp[:, rank * n:(rank + 1) * n]))
    info["local_pages"] = n
    info["table_shape"] = list(cache[0].block_table.shape)
    cache[0] = cache[0]._replace(length=torch.tensor([DEC_START],
                                                     dtype=torch.int32))
    with torch.no_grad():
        for i, tok in enumerate(DEC_TOKENS):
            logits, cache = forward_decode(
                cfg, tparams, torch.full((1, 1), tok),
                torch.tensor(DEC_START + i), cache, mi)
            out[f"dec_logits_{i}"] = logits.numpy()
    out["dec_k"], out["dec_v"] = cache[0].k_pool.numpy(), \
        cache[0].v_pool.numpy()

    from repro_torch.models.blocks import (FwdCtx, _prefill_write_slots,
                                           _prefill_write_sp)
    info["prefill_write"] = []
    for i, (S, lens) in enumerate(WRITE_CASES):
        r = np.random.default_rng(100 + i)
        k, v = (t(r.standard_normal((2, S, 2, SP_D)).astype(np.float32))
                for _ in range(2))
        tbl = t(np.stack([r.permutation(SP_P) for _ in range(2)])
                .astype(np.int32))
        sl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
        full = (2, SP_P, SP_T, 2, SP_D)
        z = torch.zeros(2, dtype=torch.int32)
        one = _prefill_write_slots(
            PagedKV(torch.zeros(full), torch.zeros(full), tbl, z), k, v,
            FwdCtx(cfg=cfg, mode="prefill", seq_lengths=sl), S)
        loc = (2, lp, SP_T, 2, SP_D)
        mine_ = _prefill_write_sp(
            PagedKV(torch.zeros(loc), torch.zeros(loc), tbl, z), k, v,
            FwdCtx(cfg=cfg, mode="prefill", seq_lengths=sl, mi=mi, sp=True),
            S)
        info["prefill_write"].append(
            [torch.equal(mine_.k_pool, one.k_pool[:, mine]),
             torch.equal(mine_.v_pool, one.v_pool[:, mine]),
             torch.equal(mine_.length, one.length),
             bool(mine_.k_pool.abs().sum() > 0)])

    mcfg = _moe_cfg(_cfg(False, "olmoe-1b-7b"))
    for shape in MOE_SHAPES:
        x = t(moe_x(shape))
        key = "x".join(map(str, shape))
        out[f"moe_{key}"] = moe_ffn(mparams, x, mcfg, mi).numpy()
        out[f"moe_{key}_ref"] = moe_ffn_ref(mparams, x, mcfg, mi).numpy()

    eng = ServingEngine(cfg, tparams, 1, SP_LEN, page_size=PAGE, mi=mi,
                        offload_mode="copy", device="cpu")
    for prompt in SERVE_PROMPTS:
        eng.submit(list(prompt), SERVE_NEW)
    done = eng.run()
    info["serve_tokens"] = [done[r].out_tokens for r in sorted(done)]
    st = eng.stats()
    info["serve_stats"] = {k: v for k, v in st.items()
                           if k not in ("prefill_s", "decode_s", "admit_s")}
    info["serve_stats"]["sva"] = {k: v for k, v in st["sva"].items()
                                  if k != "host_seconds"}
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(info, f, default=str)
    import torch.distributed as dist
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference arrays, reference info, [each rank's arrays], [each
    rank's info], the one-device port engine's tokens and stats, the port
    parameters). The JAX subprocess and the four ranks run at once."""
    import jax
    import torch.multiprocessing as mp
    from repro.models import init_params as j_init_params
    from repro.models.moe import moe_specs as j_moe_specs
    from repro.models.params import materialize
    from repro_torch.core.serving.engine import ServingEngine
    from repro_torch.models import from_jax_params
    tmp = tmp_path_factory.mktemp("mesh")
    code = JAX_SCRIPT.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"),
                             out_npz=str(tmp / "ref.npz"),
                             out_json=str(tmp / "ref.json"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    jp = j_init_params(_cfg(True), jax.random.key(0))
    fingerprint = float(sum(np.abs(np.asarray(a, np.float64)).sum()
                            for a in jax.tree.leaves(jp)))
    tcfg = _cfg(False)
    tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    mp_j = materialize(j_moe_specs(_moe_cfg(_cfg(True, "olmoe-1b-7b"))),
                       jax.random.key(0))
    moe_fingerprint = float(sum(np.abs(np.asarray(a, np.float64)).sum()
                                for a in jax.tree.leaves(mp_j)))
    mparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), mp_j)
    try:
        ctx = mp.spawn(_rank, args=(_free_port(), str(tmp), tp, mparams),
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
    # the one-device port engine, one slot just under the layout's threshold
    eng = ServingEngine(tcfg, tp, 1, SP_LEN - PAGE, page_size=PAGE,
                        offload_mode="copy", device="cpu")
    for prompt in SERVE_PROMPTS:
        eng.submit(list(prompt), SERVE_NEW)
    done = eng.run()
    single = [done[r].out_tokens for r in sorted(done)]
    ref = dict(np.load(tmp / "ref.npz"))
    ref_info = json.loads((tmp / "ref.json").read_text())
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    infos = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return dict(ref=ref, ref_info=ref_info, ranks=ranks, infos=infos,
                single=single, fingerprint=fingerprint,
                moe_fingerprint=moe_fingerprint, tcfg=tcfg, tp=tp)


# ---------------------------------------------------------------- (a)

def test_meshinfo_matches_reference(runs):
    for info in runs["infos"]:
        assert info["meshinfo"] == runs["ref_info"]["meshinfo"]
        assert info["no_mesh"] == runs["ref_info"]["no_mesh"]
    assert runs["ref_info"]["meshinfo"]["size_data"] == WORLD


def test_same_weights_on_both_sides(runs):
    assert runs["ref_info"]["params_fingerprint"] == runs["fingerprint"]
    assert runs["ref_info"]["moe_fingerprint"] == runs["moe_fingerprint"]


# ---------------------------------------------------------------- (b), (c)

def _sp_arrays(runs, case, dt):
    key = f"sp_{case}_{dt}"
    ref = runs["ref"]
    outs = [r[f"{key}_out"] for r in runs["ranks"]]
    pools = [np.concatenate([r[f"{key}_{kv}"] for r in runs["ranks"]],
                            axis=1) for kv in "kv"]
    return (ref[f"{key}_out"], outs, (ref[f"{key}_k"], ref[f"{key}_v"]),
            pools)


@pytest.mark.parametrize("case", sorted(SP_CASES))
def test_sp_decode_fp32_matches_reference(runs, case):
    ref_out, outs, ref_pools, pools = _sp_arrays(runs, case, "float32")
    for o in outs:                  # every rank holds the merged output
        np.testing.assert_array_equal(o, outs[0])
    np.testing.assert_allclose(outs[0], ref_out, atol=1e-5, rtol=0)
    for got, want in zip(pools, ref_pools):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", sorted(SP_CASES))
def test_sp_decode_bf16_matches_reference(runs, case):
    ref_out, outs, ref_pools, pools = _sp_arrays(runs, case, "bfloat16")
    vmax = np.abs(sp_inputs(case)[4]).max()
    for o in outs:
        np.testing.assert_array_equal(o, outs[0])
    np.testing.assert_allclose(outs[0], ref_out, rtol=0,
                               atol=SP_BF16_TOL * vmax)
    for got, want in zip(pools, ref_pools):      # the append is a copy
        np.testing.assert_array_equal(got, want)


def test_sp_cases_cover_the_shards():
    """Which shard owns each case's new token, and how many shards hold
    tokens: the cases reach the last shard, shard 0 alone (three empty
    partials) and the rolling wrap."""
    lt = SP_P * SP_T // WORLD
    owner = {c: (ln % (WORLD * lt)) // lt for c, (_, _, ln, _) in
             SP_CASES.items()}
    holding = {c: min(WORLD, math.ceil((ln + 1) / lt)) for c, (_, _, ln, _)
               in SP_CASES.items()}
    assert owner["last_shard"] == WORLD - 1 and holding["last_shard"] == 4
    assert owner["shard0_only"] == 0 and holding["shard0_only"] == 1
    assert SP_CASES["past_capacity"][2] >= WORLD * lt
    assert {SP_CASES[c][0] // SP_CASES[c][1] for c in SP_CASES} == {1, 2, 4}


# ---------------------------------------------------------------- (d)

def test_sp_forward_decode_matches_reference(runs):
    ref = runs["ref"]
    n = runs["infos"][0]["local_pages"]
    assert n * WORLD == SP_LEN // PAGE
    assert runs["infos"][0]["table_shape"] == [1, SP_LEN // PAGE]
    for i in range(len(DEC_TOKENS)):
        for r in runs["ranks"]:
            np.testing.assert_array_equal(r[f"dec_logits_{i}"],
                                          runs["ranks"][0][f"dec_logits_{i}"])
        np.testing.assert_allclose(runs["ranks"][0][f"dec_logits_{i}"],
                                   ref[f"dec_logits_{i}"], **TOL)
    for rank, r in enumerate(runs["ranks"]):
        for kv in "kv":
            np.testing.assert_allclose(r[f"dec_{kv}"],
                                       ref[f"dec_{kv}"][:, rank * n:
                                                        (rank + 1) * n],
                                       **TOL)


def test_sp_forward_decode_appends_on_the_owner_shards(runs):
    """The two steps append on shards 2 and 3; every other position of
    every rank's pool is the seeded pool, bit for bit."""
    cfg = _cfg(False)
    kp, _ = decode_pools(cfg)
    n = runs["infos"][0]["local_pages"]
    touched = [(DEC_START + i) // PAGE for i in range(len(DEC_TOKENS))]
    assert [p // n for p in touched] == [2, 3]
    for rank, r in enumerate(runs["ranks"]):
        got, want = r["dec_k"], kp[:, rank * n:(rank + 1) * n].copy()
        for i, p in enumerate(touched):
            if p // n == rank:
                s = (DEC_START + i) % PAGE
                assert not np.array_equal(got[0, p % n, s], want[0, p % n, s])
                want[0, p % n, s] = got[0, p % n, s]
        np.testing.assert_array_equal(got, want)


def test_sp_prefill_write_is_the_ranks_share_of_the_one_device_write(runs):
    for info in runs["infos"]:
        assert [w[:3] for w in info["prefill_write"]] == \
            [[True] * 3] * len(WRITE_CASES)
    # the 21- and 37-token prompts reach three and four ranks; 3 tokens one
    held = [[info["prefill_write"][i][3] for info in runs["infos"]]
            for i in range(len(WRITE_CASES))]
    assert sum(held[0]) >= 3 and all(held[1]) and sum(held[3]) <= 2


# ---------------------------------------------------------------- (e)

@pytest.mark.parametrize("shape", MOE_SHAPES)
def test_moe_groups_on_a_mesh_match_reference(runs, shape):
    from repro_torch.models.dist import NO_MESH
    from repro_torch.models.moe import _n_groups
    key = "x".join(map(str, shape))
    ref = runs["ref"][f"moe_{key}"]
    assert _n_groups(shape[0] * shape[1], NO_MESH) == 1
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[f"moe_{key}"], ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r[f"moe_{key}_ref"], ref, atol=1e-5,
                                   rtol=1e-5)
    # the groups decide the drops: one group gives another result
    assert np.abs(ref - runs["ref"][f"moe_{key}_one_group"]).max() > 1e-3


# ---------------------------------------------------------------- (f)

def test_sp_serve_tokens_equal_across_ranks_and_one_device(runs):
    infos = runs["infos"]
    for info in infos[1:]:
        assert info["serve_tokens"] == infos[0]["serve_tokens"]
        assert info["serve_stats"] == infos[0]["serve_stats"]
    assert [len(t) for t in infos[0]["serve_tokens"]] == \
        [SERVE_NEW] * len(SERVE_PROMPTS)
    assert infos[0]["serve_tokens"] == runs["single"]
    assert infos[0]["serve_stats"]["staging_copies"] == len(SERVE_PROMPTS)


# ---------------------------------------------------------------- (g)

def test_zero_copy_refuses_the_sp_layout_on_both_sides(runs):
    from repro_torch.core.serving.engine import ServingEngine
    assert "SP cache layout" in runs["ref_info"]["refusals"]["zero_copy"]
    with pytest.raises(NotImplementedError, match="SP cache layout"):
        ServingEngine(runs["tcfg"], runs["tp"], 1, SP_LEN, page_size=PAGE,
                      offload_mode="zero_copy", device="cpu")


def test_sp_layout_without_a_mesh_fails_on_both_sides(runs):
    """The reference builds the engine and fails at its first decode (its
    ``sp_paged_decode`` reads the shape of a mesh that is None); the port
    refuses at construction, and its decode refuses a layout without a
    mesh."""
    from repro_torch.core.serving.engine import ServingEngine
    from repro_torch.models import forward_decode, init_cache
    name, msg = runs["ref_info"]["refusals"]["no_mesh"]
    assert name == "AttributeError" and "shape" in msg
    with pytest.raises(ValueError, match="mesh"):
        ServingEngine(runs["tcfg"], runs["tp"], 1, SP_LEN, page_size=PAGE,
                      offload_mode="copy", device="cpu")
    cache = init_cache(runs["tcfg"], 1, SP_LEN, PAGE, device="cpu")
    assert cache[0].k_pool.shape[1] == SP_LEN // PAGE     # the whole pool
    with pytest.raises(ValueError, match="needs a mesh"):
        forward_decode(runs["tcfg"], runs["tp"], torch.zeros(1, 1).long(),
                       torch.tensor(3), cache)
