"""The port's serve steps on a mesh (``launch/steps.py``'s
``make_prefill_step`` and ``make_decode_step`` with placed weights and
cache) against the reference's steps jitted on four host devices
(``--xla_force_host_platform_device_count=4``) with its shardings: the
parameters by ``model_specs``, the batch and the token as
``input_specs`` gives them, the cache by ``cache_specs`` (at page 8 and
24 tokens, not the dry run's page 64 and ``seq_len``, so that decode
steps cross a page's partial tail).

One JAX subprocess writes the reference's arrays, one ``mp.spawn`` of
four gloo ranks the port's, from the same numpy-seeded tokens and the
same weights (JAX ``init_params`` -> numpy, ``from_jax_params`` on the
port's side, each rank its blocks); they run side by side and this
process compares them. The cases:

  * smoke llama3.2-1b on (2, 2) and (1, 4): 2 KV heads, so each page's
    tokens split over ``model`` (4 and 2 of 8 a rank);
  * smoke gemma2-2b on (1, 4): its sliding-window ring of 8 tokens past
    its capacity, softcaps 50 and 30;
  * a narrow dense config with 16 KV heads on (2, 2): the KV heads over
    ``model``;

each a prefill of 13 tokens, then four decode steps at 13-16 (across the
partial tail of the second page): each rank's rows' logits within 1e-5
(of the largest) of the reference's, its greedy tokens (``sample=True``)
the reference logits' argmax, its cache blocks after the prefill and
after the last step within 1e-5 of its block of the reference's cache
(the lengths: one a row here, one scalar there), its rows' logits bit for
bit on every model rank, and its blocks' shapes and bytes those
``input_specs``' stand-ins give. Then the refusals: an MoE arch on a
mesh, and the sequence-parallel layout with placed weights.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 240
B, S, MAX_LEN, PAGE, STEPS = 4, 13, 24, 8, 4
TOL = 1e-5
# model -> (arch, its smoke config's fields changed)
MODELS = {"llama3.2-1b": ("llama3.2-1b", {}),
          "gemma2-2b": ("gemma2-2b", {}),
          "heads16": ("llama3.2-1b", {"n_heads": 16, "n_kv_heads": 16})}
CASES = {"llama_2x2": ("llama3.2-1b", (2, 2)),
         "llama_1x4": ("llama3.2-1b", (1, 4)),
         "gemma2_1x4": ("gemma2-2b", (1, 4)),
         "heads16_2x2": ("heads16", (2, 2))}


def _cfg(jax_side: bool, model: str):
    arch, fields = MODELS[model]
    if jax_side:
        from repro.configs import get_config
        from repro.configs import reduce_for_smoke as j_reduce
        return dataclasses.replace(j_reduce(get_config(arch)), **fields)
    return dataclasses.replace(
        tconfigs.reduce_for_smoke(tconfigs.get_config(arch)), **fields)


def inputs(cfg) -> tuple:
    """The prompt tokens (B, S) and each decode step's token (B, 1)."""
    r = np.random.default_rng(17)
    return (r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            [r.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
             for _ in range(STEPS)])


# ---------------------------------------------------------------- the reference

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{src!r}, {tests!r}]
import pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ShapeConfig
from repro.launch.input_specs import batch_specs, decode_specs
from repro.launch.mesh import make_host_mesh, mesh_context
from repro.launch.steps import make_step
from repro.models import MeshInfo, cache_specs, init_cache, init_params
from repro.models import model_specs
from repro.models.params import shardings
import test_torch_mesh_serve as T
import test_torch_steps as TS

host = lambda t: jax.tree.map(np.asarray, t)
out = {{}}
for case, (model, (d, m)) in T.CASES.items():
    cfg = T._cfg(True, model)
    mesh = make_host_mesh(data=d, model=m)
    mi = MeshInfo(mesh)
    pre = ShapeConfig("p", T.S, T.B, "prefill")
    dec = ShapeConfig("d", T.MAX_LEN, T.B, "decode")
    psh = shardings(model_specs(cfg), mesh)
    csh = shardings(cache_specs(cfg, T.B, T.MAX_LEN, T.PAGE), mesh)
    bsh = {{k: v.sharding for k, v in batch_specs(cfg, pre, mesh).items()}}
    ds = decode_specs(cfg, dec, mesh)
    tokens, news = T.inputs(cfg)
    with mesh_context(mesh):
        pfn = jax.jit(make_step(cfg, pre, mi)[0],
                      in_shardings=(psh, bsh, csh))
        dfn = jax.jit(make_step(cfg, dec, mi)[0],
                      in_shardings=(psh, ds["token"].sharding,
                                    ds["pos"].sharding, csh))
        p = jax.device_put(init_params(cfg, jax.random.key(0)), psh)
        c = jax.device_put(init_cache(cfg, T.B, T.MAX_LEN, T.PAGE), csh)
        lg, c = pfn(p, {{"tokens": jnp.asarray(tokens)}}, c)
        res = dict(logits=[np.asarray(lg)], prefill_cache=TS.ref_entries(
            cfg, host(c)))
        for i, new in enumerate(news):
            # back to cache_specs' placement (the step's output may differ)
            c = jax.device_put(c, csh)
            lg, c = dfn(p, jnp.asarray(new), jnp.int32(T.S + i), c)
            res["logits"].append(np.asarray(lg))
        res["cache"] = TS.ref_entries(cfg, host(c))
    out[case] = res
with open({out_pkl!r}, "wb") as f:
    pickle.dump(out, f)
print("reference OK")
"""


# ---------------------------------------------------------------- the port

def _numpy(e) -> dict:
    return {f: getattr(e, f).numpy().copy() for f in e._fields}


def _rank(rank: int, port: int, tmp: str, jparams) -> None:
    """One rank: every case, results to files."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.input_specs import prefill_cache_specs
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import MeshInfo, from_jax_params, init_cache
    from repro_torch.models.dist import axis_rank
    from repro_torch.models.params import abstract, model_specs
    from repro_torch.tree import leaves
    init_distributed(rank, WORLD, f"tcp://localhost:{port}", device="cpu")
    out = {}
    for case, (model, shape) in CASES.items():
        mi = MeshInfo(make_mesh(shape, ("data", "model"), device="cpu"))
        cfg = _cfg(False, model)
        params = from_jax_params(cfg, jparams[model], device="cpu", mi=mi)
        cache = init_cache(cfg, B, MAX_LEN, PAGE, device="cpu", mi=mi,
                           placed=True)
        held = leaves(params) + leaves(cache)
        want = (leaves(abstract(model_specs(cfg), mi, cfg=cfg))
                + leaves(prefill_cache_specs(
                    cfg, tconfigs.ShapeConfig("c", MAX_LEN, B, "prefill"),
                    mi, PAGE)[0]))
        res = dict(coords=[axis_rank(mi, a) for a in ("data", "model")],
                   shapes=[list(t.shape) for t in held],
                   want_shapes=[list(t.shape) for t in want],
                   nbytes=sum(t.untyped_storage().nbytes() for t in held),
                   want_nbytes=sum(t.numel() * t.element_size()
                                   for t in want))
        tokens, news = inputs(cfg)
        prefill = make_prefill_step(cfg, mi, PAGE)
        decode = make_decode_step(cfg, mi, page_size=PAGE)
        sample = make_decode_step(cfg, mi, sample=True, page_size=PAGE)
        lg, cache = prefill(params, {"tokens": torch.from_numpy(tokens)},
                            cache)
        res["logits"] = [lg.numpy().copy()]
        res["prefill_cache"] = [_numpy(e) for e in cache]
        res["tokens"] = []
        for i, new in enumerate(news):
            tok = torch.from_numpy(new)
            twin = [e._replace(k_pool=e.k_pool.clone(),
                               v_pool=e.v_pool.clone()) for e in cache]
            t, _ = sample(params, tok, S + i, twin)
            res["tokens"].append(t.numpy().copy())
            lg, cache = decode(params, tok, S + i, cache)
            res["logits"].append(lg.numpy().copy())
        res["cache"] = [_numpy(e) for e in cache]
        out[case] = res
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, each rank's). The JAX subprocess and the
    four ranks run at once."""
    import jax
    import torch.multiprocessing as mp
    from repro.models import init_params as j_init_params
    tmp = tmp_path_factory.mktemp("mesh_serve")
    code = JAX_SCRIPT.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"),
                             out_pkl=str(tmp / "ref.pkl"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    jparams = {m: jax.tree.map(np.asarray, j_init_params(
        _cfg(True, m), jax.random.key(0))) for m in MODELS}
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
    return dict(ref=ref, ranks=ranks)


# ---------------------------------------------------------------- helpers

def _standin(shape, coords):
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import MeshInfo
    return MeshInfo(abstract_mesh(shape, ("data", "model"), coords))


def _rows(shape, coords):
    from repro_torch.models.model import batch_sharding
    return batch_sharding((B,), _standin(shape, coords))


def _cache_shards(case, coords):
    from repro_torch.models.model import cache_specs
    from repro_torch.models.params import shardings
    model, shape = CASES[case]
    return shardings(cache_specs(_cfg(False, model), B, MAX_LEN, PAGE),
                     _standin(shape, coords))


def _assert_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a.astype(np.float64) - b).max())
    assert err <= TOL * max(float(np.abs(b).max()), 1.0), err


def _held_cache(ours, ref, shards):
    """Each entry's blocks against the rank's block of the reference's
    whole cache; the lengths against the reference's scalar."""
    from test_torch_steps import _slice
    assert len(ours) == len(ref) == len(shards)
    for o, r, sh in zip(ours, ref, shards):
        for f, leaf in r.items():
            whole = _slice(leaf)
            if f == "length":
                assert whole.shape == () and (o[f] == whole).all(), f
                continue
            block = np.asarray(getattr(sh, f).cut(whole))
            if f == "block_table":
                np.testing.assert_array_equal(o[f], block)
            else:
                _assert_close(o[f], block)


# ---------------------------------------------------------------- the cases

@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_reference_steps(runs, case):
    """The prefill's and each decode step's logits: each rank's rows within
    1e-5 of the reference's (of the largest logit)."""
    _, shape = CASES[case]
    ref = runs["ref"][case]["logits"]
    assert len(ref) == STEPS + 1
    for r in runs["ranks"]:
        rows = _rows(shape, r[case]["coords"])
        for ours, want in zip(r[case]["logits"], ref):
            _assert_close(ours, rows.cut(want))


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_are_reference_argmax(runs, case):
    _, shape = CASES[case]
    for r in runs["ranks"]:
        rows = _rows(shape, r[case]["coords"])
        for ours, want in zip(r[case]["tokens"],
                              runs["ref"][case]["logits"][1:]):
            assert ours.dtype == np.int32
            np.testing.assert_array_equal(
                ours, rows.cut(np.argmax(want, -1)).astype(np.int32))


@pytest.mark.parametrize("when", ["prefill_cache", "cache"])
@pytest.mark.parametrize("case", list(CASES))
def test_cache_blocks_match_reference(runs, case, when):
    """After the prefill and after the last decode step, each rank's cache
    blocks are its blocks of the reference's cache."""
    for r in runs["ranks"]:
        _held_cache(r[case][when], runs["ref"][case][when],
                    _cache_shards(case, r[case]["coords"]))


@pytest.mark.parametrize("case", list(CASES))
def test_model_ranks_agree_bit_for_bit(runs, case):
    """Ranks that differ only along ``model`` return the same rows, bit
    for bit (their sums over ``model`` are one all-reduce's)."""
    by_rows = {}
    for r in runs["ranks"]:
        by_rows.setdefault(r[case]["coords"][0], []).append(r[case])
    for group in by_rows.values():
        for other in group[1:]:
            for a, b in zip(other["logits"] + other["tokens"],
                            group[0]["logits"] + group[0]["tokens"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_are_the_predicted_shapes_and_bytes(runs, case):
    """Each rank's parameter and cache blocks have the local shapes of
    ``abstract``/``input_specs``' stand-ins, and hold exactly their
    bytes."""
    for r in runs["ranks"]:
        res = r[case]
        assert res["shapes"] == res["want_shapes"]
        assert res["nbytes"] == res["want_nbytes"]


def test_placements_are_the_ones_meant():
    """The cases reach both placements: llama's and gemma2's pools split
    each page's tokens over ``model``, the 16-head config its KV heads."""
    from repro_torch.models.model import page_split
    for case, want in (("llama_2x2", 2), ("llama_1x4", 4),
                       ("gemma2_1x4", 4), ("heads16_2x2", 1)):
        model, shape = CASES[case]
        cfg = _cfg(False, model)
        assert page_split(cfg, PAGE, _standin(shape, (0, 0))) == want
        kv = _cache_shards(case, (0, 0))[0]
        split = 3 if model == "heads16" else 2
        assert kv.k_pool.axes(split) == ("model",), case


def test_other_kinds_refuse_on_a_mesh():
    """An MoE arch's serve steps refuse on a mesh, naming the kind; on one
    device they build."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import NO_MESH
    cfg = tconfigs.reduce_for_smoke(tconfigs.get_config("olmoe-1b-7b"))
    mi = _standin((2, 2), (0, 0))
    for make in (make_prefill_step, make_decode_step):
        with pytest.raises(NotImplementedError, match="attn_moe"):
            make(cfg, mi)
        assert callable(make(cfg, NO_MESH))


def test_sp_layout_refuses_placed_weights():
    """One sequence of 262144 tokens (the sequence-parallel layout) with
    placed weights refuses by name, at the cache and at the step."""
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import init_cache
    from repro_torch.models.blocks import SP_MIN_LEN
    cfg = tconfigs.reduce_for_smoke(tconfigs.get_config("llama3.2-1b"))
    mi = _standin((2, 2), (0, 0))
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        init_cache(cfg, 1, SP_MIN_LEN, 64, device="meta", mi=mi, placed=True)
    cache = init_cache(cfg, 1, SP_MIN_LEN, 64, device="meta")
    step = make_decode_step(cfg, mi, page_size=64)
    with pytest.raises(NotImplementedError, match="sequence-parallel"):
        step(None, torch.zeros((1, 1), dtype=torch.long), 0, cache)
