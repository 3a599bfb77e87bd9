"""The port's step builders and input stand-ins against the JAX package's,
without a mesh (``launch/steps.py``, ``launch/input_specs.py``,
``models/model.py::cache_specs``, ``models/params.py::abstract``):

  (a) ``make_step``'s three kinds on one device against the reference's
      ``make_step``, on the same weights: smoke llama3.2-1b and gemma2-2b
      (a sliding-window ring past its capacity, softcaps), a prefill's
      logits and cache, then three decode steps' logits and caches, fp32
      within 1e-5; ``make_decode_step(..., sample=True)``'s tokens equal
      to the reference's; a train step's loss and gradient norm, and the
      state specs' shapes;
  (b) ``input_specs`` and ``cache_specs`` for all 40 cells of
      ``all_cells()`` on the production meshes (16, 16) and (2, 16, 16):
      every leaf's resolved spec and local shape against the reference's
      ``resolve_spec`` on a stand-in mesh, the bytes a device holds summed
      (the one kept difference, a PagedKV's ``length``: (B,) over the
      batch axes here, one scalar a stacked leaf there), and every tensor
      on the meta device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402

B, S, MAX_LEN, PAGE, STEPS = 3, 13, 24, 4, 3
ARCHS = ("llama3.2-1b", "gemma2-2b")
TOL = 1e-5
MESHES = ((("data", "model"), (16, 16)), (("pod", "data", "model"),
                                          (2, 16, 16)))


def _cfgs(arch):
    from repro.configs import get_config
    from repro.configs import reduce_for_smoke as j_reduce
    return (j_reduce(get_config(arch)),
            tconfigs.reduce_for_smoke(tconfigs.get_config(arch)))


def _inputs(cfg):
    r = np.random.default_rng(11)
    return (r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            [r.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
             for _ in range(STEPS)])


def ref_entries(jcfg, jcache) -> list:
    """The reference's cache (a dict of stacked leaves) as the port's flat
    list, one {field: leaf} a layer in ``layer_kinds()`` order (two for a
    cross_mlp layer), and the encoder output last. Works on any tree of
    the reference's structure: arrays, or ParamSpecs (``stacked`` then
    marks each leaf that carries the leading block axis)."""
    def fields(e, take):
        if isinstance(e, dict):          # cross K/V
            return {"k": take(e["k"]), "v": take(e["v"])}
        return {f: take(getattr(e, f)) for f in e._fields}

    def layer(c, take):
        out = []
        for key in ("kv", "xkv", "ssm", "rwkv"):
            if c and key in c:
                out.append(fields(c[key], take))
        return out

    out = []
    for i in range(jcfg.first_k_dense):
        out += layer(jcache["first"][str(i)], lambda a: (a, False))
    blk = jcache.get("blocks", {})
    for b in range(jcfg.n_blocks):
        for i, _ in enumerate(jcfg.block_pattern):
            out += layer(blk.get(str(i)), lambda a, b=b: (a, b))
    if "enc_out" in jcache:
        out.append({"x": (jcache["enc_out"], False)})
    return out


def _port_fields(e) -> dict:
    """An entry's leaves as numpy copies (the port updates pools in
    place)."""
    return {f: getattr(e, f).numpy().copy() for f in e._fields}


def _slice(leaf):
    a, b = leaf
    a = np.asarray(a)
    return a if b is False else a[b]


# ---------------------------------------------------------------- (a)

@pytest.fixture(scope="module", params=ARCHS)
def steps(request):
    import jax
    import jax.numpy as jnp
    from repro.configs import ShapeConfig as JShape
    from repro.launch.steps import make_decode_step as j_decode_step
    from repro.launch.steps import make_step as j_make_step
    from repro.models import NO_MESH as J_NO_MESH
    from repro.models import init_cache as j_init_cache
    from repro.models import init_params as j_init_params
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import make_decode_step, make_step
    from repro_torch.models import NO_MESH, from_jax_params, init_cache
    arch = request.param
    jcfg, cfg = _cfgs(arch)
    jp = j_init_params(jcfg, jax.random.key(0))
    tp = from_jax_params(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    tokens, news = _inputs(cfg)
    out = {"arch": arch, "cfg": cfg, "jcfg": jcfg, "ref": [], "port": []}

    pre = ShapeConfig("p", seq_len=S, global_batch=B, kind="prefill")
    dec = ShapeConfig("d", seq_len=MAX_LEN, global_batch=B, kind="decode")
    jfn, _ = j_make_step(jcfg, JShape("p", S, B, "prefill"), J_NO_MESH)
    jdec, _ = j_make_step(jcfg, JShape("d", MAX_LEN, B, "decode"), J_NO_MESH)
    jsample = j_decode_step(jcfg, J_NO_MESH, sample=True)
    jfn, jdec, jsample = jax.jit(jfn), jax.jit(jdec), jax.jit(jsample)
    fn, _ = make_step(cfg, pre, NO_MESH)
    dfn, _ = make_step(cfg, dec, NO_MESH)
    sample = make_decode_step(cfg, NO_MESH, sample=True)

    jc = j_init_cache(jcfg, B, MAX_LEN, PAGE)
    tc = init_cache(cfg, B, MAX_LEN, PAGE, device="cpu")
    lg, jc = jfn(jp, {"tokens": jnp.asarray(tokens)}, jc)
    out["ref"].append((np.asarray(lg), ref_entries(jcfg, jc)))
    lg, tc = fn(tp, {"tokens": torch.from_numpy(tokens).long()}, tc)
    out["port"].append((lg.numpy(), [_port_fields(e) for e in tc]))
    for i, new in enumerate(news):
        pos = S + i
        jt, _ = jsample(jp, jnp.asarray(new), jnp.int32(pos), jc)
        tt, _ = sample(tp, torch.from_numpy(new).long(), pos,
                       [e._replace(k_pool=e.k_pool.clone(),
                                   v_pool=e.v_pool.clone()) for e in tc])
        lg, jc = jdec(jp, jnp.asarray(new), jnp.int32(pos), jc)
        out["ref"].append((np.asarray(lg), ref_entries(jcfg, jc),
                           np.asarray(jt)))
        lg, tc = dfn(tp, torch.from_numpy(new).long(), pos, tc)
        out["port"].append((lg.numpy(), [_port_fields(e) for e in tc],
                            tt.numpy()))
    return out


def assert_close(a, b, tol=TOL):
    """``a`` within ``tol`` of the largest |b| (at least 1) of ``b``."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
    assert err <= tol * max(float(np.abs(b).max()) if b.size else 0.0,
                            1.0), err


def test_prefill_and_decode_match_reference(steps):
    """Every step's logits and every layer's pools within 1e-5 of the
    reference's (of the largest value); the tables equal; the lengths
    equal (one scalar there, one a row here)."""
    for (rl, rc, *_), (pl, pc, *_) in zip(steps["ref"], steps["port"]):
        assert_close(pl, rl)
        assert len(rc) == len(pc)
        for re, pe in zip(rc, pc):
            for f in ("k_pool", "v_pool"):
                assert_close(pe[f], _slice(re[f]))
            np.testing.assert_array_equal(pe["block_table"],
                                          _slice(re["block_table"]))
            ln = _slice(re["length"])
            assert ln.shape == ()
            assert (pe["length"] == ln).all()


def test_sample_tokens_equal_reference(steps):
    for r, p in zip(steps["ref"][1:], steps["port"][1:]):
        assert p[2].dtype == np.int32 and p[2].shape == r[2].shape == (B, 1)
        np.testing.assert_array_equal(p[2], r[2])


@pytest.mark.parametrize("steps", ["gemma2-2b"], indirect=True)
def test_gemma_ring_wrapped(steps):
    """gemma2's sliding-window ring holds 8 tokens in 2 pages: the prefill
    of 13 tokens wrapped it."""
    cfg = steps["cfg"]
    pc = steps["port"][0][1]
    assert cfg.layer_kinds()[0] == "attn_mlp_local"
    assert tuple(pc[0]["k_pool"].shape[1:3]) == (cfg.sliding_window // PAGE,
                                                 PAGE)
    assert S > cfg.sliding_window


def test_train_kind_matches_reference():
    """``make_step`` of a train cell: the reference's step and state
    specs; one step's loss and gradient norm within 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.configs import ShapeConfig as JShape
    from repro.configs import TrainConfig as JTrain
    from repro.launch.steps import make_step as j_make_step
    from repro.models import NO_MESH as J_NO_MESH
    from repro.models import init_params as j_init_params
    from repro.optim import init_opt_state as j_init_opt
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch.steps import make_step
    from repro_torch.models import from_jax_params
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import leaves
    jcfg, cfg = _cfgs("llama3.2-1b")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jfn, jspecs = j_make_step(jcfg, JShape("t", 16, 4, "train"), J_NO_MESH,
                              JTrain(**kw))
    fn, specs = make_step(cfg, ShapeConfig("t", 16, 4, "train"),
                          tc=TrainConfig(**kw))
    assert set(specs) == set(jspecs) == {"params", "opt_state"}
    assert [tuple(s.shape) for s in leaves(specs["opt_state"].mu)] == \
        [tuple(s.shape) for s in leaves(specs["params"])]
    jp = j_init_params(jcfg, jax.random.key(0))
    r = np.random.default_rng(3)
    batch = {k: r.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    _, _, jm = jax.jit(jfn)(jp, j_init_opt(jp),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    tp = from_jax_params(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    _, _, m = fn(tp, init_opt_state(tp),
                 {k: torch.from_numpy(v).long() for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= TOL * abs(float(jm[k])), k


def test_serve_kinds_return_params_specs():
    from repro_torch.configs import SHAPES
    from repro_torch.launch.steps import make_step
    from repro_torch.models.params import model_specs
    cfg = tconfigs.reduce_for_smoke(tconfigs.get_config("llama3.2-1b"))
    for name in ("prefill_32k", "decode_32k"):
        fn, specs = make_step(cfg, SHAPES[name])
        assert callable(fn) and set(specs) == {"params"}
        assert specs["params"] == model_specs(cfg)


# ---------------------------------------------------------------- (b)

class _StandIn:
    """What the reference's ``resolve_spec`` reads of a mesh."""

    def __init__(self, axes, shape):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _itemsize(dtype) -> int:
    return np.dtype(dtype).itemsize


def _local(shape, spec, sizes) -> tuple:
    ax = lambda e: () if e is None else (e if isinstance(e, tuple) else (e,))
    return tuple(n // int(np.prod([sizes[a] for a in ax(e)]))
                 for n, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def _ref_batch(jcfg, jshape) -> dict:
    """The reference's batch inputs of a cell, or a decode cell's token and
    position: name -> (shape, dtype, logical spec), the specs its
    ``input_specs`` gives them (its ``_sds`` places them on a real mesh
    alone, so they are written out here)."""
    from repro.launch.input_specs import batch_specs
    if jshape.kind == "decode":
        B = jshape.global_batch
        return {"token": ((B, 1), np.int32, ("batch", None)),
                "pos": ((), np.int32, ())}
    specs = {"tokens": ("batch", None), "labels": ("batch", None),
             "enc_x": ("batch", None, None), "img_x": ("batch", None, None)}
    return {k: (tuple(v.shape), v.dtype, specs[k])
            for k, v in batch_specs(jcfg, jshape, None).items()}


@pytest.mark.parametrize("axes,mesh_shape", MESHES,
                         ids=["16x16", "2x16x16"])
def test_input_specs_match_reference_on_every_cell(axes, mesh_shape):
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get_config
    from repro.models import cache_specs as j_cache_specs
    from repro.models.model import ENCDEC_SRC_LEN as J_SRC
    from jax.sharding import PartitionSpec as JP
    from repro.models.params import resolve_spec as j_resolve
    from repro_torch.configs import SHAPES, all_cells
    from repro_torch.launch.input_specs import input_specs
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import MeshInfo
    from repro_torch.tree import leaves
    sizes = dict(zip(axes, mesh_shape))
    stand = _StandIn(axes, mesh_shape)
    coords = tuple(n - 1 for n in mesh_shape)       # the last rank
    mi = MeshInfo(abstract_mesh(mesh_shape, axes, coords))
    cells = all_cells()
    assert len(cells) == 40
    n_leaves = 0
    for arch, sname, _ in cells:
        cfg, jcfg, shape = (tconfigs.get_config(arch), j_get_config(arch),
                            SHAPES[sname])
        jshape = J_SHAPES[sname]
        tensors, shards = input_specs(cfg, shape, mi)
        assert all(t.device.type == "meta" for t in leaves(tensors))
        port_bytes = sum(t.numel() * t.element_size()
                         for t in leaves(tensors))
        # the batch, or the decode step's token and position
        got = (tensors["batch"], shards["batch"]) if "batch" in tensors \
            else ({k: tensors[k] for k in ("token", "pos")},
                  {k: shards[k] for k in ("token", "pos")})
        want = _ref_batch(jcfg, jshape)
        assert set(got[0]) == set(want), (arch, sname)
        ref_bytes = 0
        for k, (wshape, wdt, wspec) in want.items():
            res = tuple(j_resolve(JP(*wspec), wshape, stand))
            assert got[1][k].spec == res, (arch, sname, k)
            assert tuple(got[0][k].shape) == _local(wshape, res, sizes), k
            assert got[0][k].element_size() == _itemsize(wdt), (arch, k)
            ref_bytes += int(np.prod(_local(wshape, res, sizes))) \
                * _itemsize(wdt)
        # the cache
        if shape.kind == "train":
            assert set(tensors) == {"batch"}
            assert port_bytes == ref_bytes, (arch, sname)
            continue
        jc = j_cache_specs(jcfg, jshape.global_batch, max_len=jshape.seq_len,
                           page_size=64, src_len=J_SRC)
        ref = ref_entries(jcfg, jc)
        cache_t, cache_s = tensors["cache"], shards["cache"]
        assert len(ref) == len(cache_t), (arch, sname)
        length_diff = 0
        for re, te, se in zip(ref, cache_t, cache_s):
            tf = dict(zip(te._fields, te))
            sf = dict(zip(se._fields, se))
            assert set(tf) == set(re), (arch, sname)
            for f, (spec, stacked) in re.items():
                full = tuple(j_resolve(spec.pspec, spec.shape, stand))
                rshape = tuple(spec.shape)
                if stacked is not False:
                    assert full[0] is None
                    full, rshape = full[1:], rshape[1:]
                nbytes = int(np.prod(_local(rshape, full, sizes))) \
                    * _itemsize(spec.dtype)
                if stacked is False or stacked == 0:
                    # a stacked leaf's bytes once, at its first block
                    ref_bytes += nbytes * (1 if stacked is False
                                           else jcfg.n_blocks)
                if f == "length":       # the kept difference
                    assert rshape == () and full == ()
                    assert tuple(tf[f].shape[1:]) == ()
                    b_spec = j_resolve(JP("batch"), (jshape.global_batch,),
                                       stand)
                    assert sf[f].spec == tuple(b_spec)
                    length_diff += tf[f].numel() * 4 - nbytes
                    continue
                assert sf[f].spec == full, (arch, sname, f)
                assert tuple(tf[f].shape) == _local(rshape, full, sizes), \
                    (arch, sname, f)
                assert tf[f].element_size() == _itemsize(spec.dtype)
                n_leaves += 1
        assert port_bytes - ref_bytes == length_diff, (arch, sname)
    assert n_leaves > 1000


def test_abstract_allocates_nothing_and_gives_local_shapes():
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models import MeshInfo
    from repro_torch.models.params import abstract, model_specs, shardings
    from repro_torch.tree import leaves
    cfg = tconfigs.get_config("llama3.2-1b")
    mi = MeshInfo(abstract_mesh((16, 16), ("data", "model"), (3, 5)))
    specs = model_specs(cfg)
    ts, ss = leaves(abstract(specs, mi, cfg=cfg)), leaves(shardings(specs, mi))
    assert all(t.device.type == "meta" for t in ts)
    assert all(tuple(t.shape) == s.local_shape(p.shape)
               for t, s, p in zip(ts, ss, leaves(specs)))
    table = abstract(specs, mi, cfg=cfg)["embed"]["table"]
    assert tuple(table.shape) == (128256 // 16, 2048 // 16)
    assert table.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        abstract(specs, mi)              # a leaf without a dtype, no cfg


def test_abstract_mesh_checks_its_coords():
    from repro_torch.launch.mesh import abstract_mesh
    with pytest.raises(ValueError):
        abstract_mesh((2, 2), ("data", "model"), (2, 0))
    m = abstract_mesh((2, 3), ("data", "model"), (1, 2))
    assert (m.size(1), m.get_local_rank("model")) == (3, 2)
    with pytest.raises(RuntimeError):
        m.get_group("data")
