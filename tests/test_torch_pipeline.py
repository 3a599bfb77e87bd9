"""The port's GPipe (``repro_torch.launch.pipeline.pipeline_apply``) against
the JAX package's: four stage ranks over ``torch.distributed`` (gloo, on
the CPU) against the reference on four host devices
(``--xla_force_host_platform_device_count=4``, the recipe of
``tests/test_multidevice.py``), from the same numpy-seeded inputs.

One JAX subprocess writes the reference's outputs and gradients, one
``mp.spawn`` of four ranks the port's; they run side by side and this
process compares them. The stack is the reference test's: blocks ``w``
(n_blocks, d, d), ``x -> tanh(x @ w)`` a block, the loss
``sum(sin(out))``. The cases:

  (a) the reference's own (tests/test_multidevice.py:23-52): 4 stages, W
      (8, 16, 16), x (6, 2, 4, 16): the output within 1e-5 on every rank,
      each stage's block gradient and x's gradient (whole on every rank)
      within 1e-4;
  (b) the same with fewer microbatches than stages (x (2, 2, 4, 16));
  (c) a planted fault, the shift sent the wrong way (stage s to s - 1),
      which must miss those limits;
  (d) one stage, on a (1, 4) ("stage", "data") mesh and without a mesh:
      the plain stack, microbatch by microbatch, bit for bit.
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 300        # each side takes ~10 s
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
# (n_blocks, n_micro, mb, S, d)
CASES = {"reference": (8, 6, 2, 4, 16), "few_micro": (8, 2, 2, 4, 16)}


def inputs(case: str):
    """W (n_blocks, d, d) at scale 0.3, as the reference test draws it,
    and x (n_micro, mb, S, d), float32 from a seed."""
    nb, nm, mb, S, d = CASES[case]
    r = np.random.default_rng(sorted(CASES).index(case))
    W = (r.standard_normal((nb, d, d)) * 0.3).astype(np.float32)
    return W, r.standard_normal((nm, mb, S, d)).astype(np.float32)


def apply_stage(w_loc, x):
    for w in w_loc:
        x = torch.tanh(x @ w)
    return x


def plain_stack(W, x):
    """Every microbatch through the whole stack, one after another."""
    return torch.stack([apply_stage(W, xi) for xi in x])


# ---------------------------------------------------------------- the reference

JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path[:0] = [{src!r}, {tests!r}]
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh, mesh_context
from repro.launch.pipeline import pipeline_apply
import test_torch_pipeline as T

def apply_stage(w_loc, x):
    return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, w_loc)[0]

mesh = make_mesh((4,), ("stage",))
run = lambda W, x: pipeline_apply(W, x, apply_stage, mesh)
loss = lambda W, x: jnp.sum(jnp.sin(run(W, x)))
out = {{}}
with mesh_context(mesh):
    for case in T.CASES:
        W, x = map(jnp.asarray, T.inputs(case))
        out[case + "_out"] = np.asarray(jax.jit(run)(W, x))
        gW, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(W, x)
        out[case + "_gW"], out[case + "_gx"] = np.asarray(gW), np.asarray(gx)
np.savez({out_npz!r}, **out)
print("reference OK")
"""


# ---------------------------------------------------------------- the port

def _wrong_way():
    """The planted fault: ``_Shift`` with both directions reversed (stage s
    sends to s - 1 and receives from s + 1; the gradient likewise)."""
    from repro_torch.launch import pipeline

    class WrongWay(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, anchor, group, s, n):
            ctx.group, ctx.s, ctx.n = group, s, n
            return pipeline._exchange(y, s - 1 if s > 0 else None, y,
                                      s + 1 if s + 1 < n else None, group)

        @staticmethod
        def backward(ctx, g):
            s, n = ctx.s, ctx.n
            return (pipeline._exchange(g, s + 1 if s + 1 < n else None, g,
                                       s - 1 if s > 0 else None, ctx.group),
                    None, None, None, None)
    return mock.patch.object(pipeline, "_Shift", WrongWay)


def _run(case, mesh, rank, n_stages):
    """(output, this stage's block gradient, x's gradient) of the port."""
    from repro_torch.launch.pipeline import pipeline_apply
    W, x = inputs(case)
    per = W.shape[0] // n_stages
    w = torch.from_numpy(W[rank * per:(rank + 1) * per]).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = pipeline_apply(w, xt, apply_stage, mesh)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), w.grad.numpy(), xt.grad.numpy()


def _rank(rank: int, port: int, tmp: str) -> None:
    """One rank: every case on a (4,) ("stage",) mesh, the fault, and one
    stage on a (1, 4) ("stage", "data") mesh; results to a file."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.launch.pipeline import pipeline_apply
    init_distributed(rank, WORLD, f"tcp://localhost:{port}", device="cpu")
    mesh = make_mesh((WORLD,), ("stage",), device="cpu")
    out = {}
    for case in CASES:
        out[case + "_out"], out[case + "_gW"], out[case + "_gx"] = _run(
            case, mesh, rank, WORLD)
        with _wrong_way():
            (out[case + "_fault_out"], out[case + "_fault_gW"],
             out[case + "_fault_gx"]) = _run(case, mesh, rank, WORLD)
    one = make_mesh((1, WORLD), ("stage", "data"), device="cpu")
    W, x = inputs("reference")
    with torch.no_grad():
        out["one_stage"] = pipeline_apply(torch.from_numpy(W),
                                          torch.from_numpy(x), apply_stage,
                                          one).numpy()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    import torch.distributed as dist
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference arrays, [each rank's arrays]). The JAX subprocess and the
    four ranks run at once."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("pipeline")
    code = JAX_SCRIPT.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"),
                             out_npz=str(tmp / "ref.npz"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    try:
        ctx = mp.spawn(_rank, args=(_free_port(), str(tmp)), nprocs=WORLD,
                       join=False)
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
    ref = dict(np.load(tmp / "ref.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return ref, ranks


def _err(a, b) -> float:
    return float(np.abs(a - b).max())


def _block(g, rank):
    per = g.shape[0] // WORLD
    return g[rank * per:(rank + 1) * per]


@pytest.mark.parametrize("case", CASES)
def test_output_matches_reference(runs, case):
    ref, ranks = runs
    for r in ranks:
        assert _err(r[case + "_out"], ref[case + "_out"]) < OUT_TOL


@pytest.mark.parametrize("case", CASES)
def test_outputs_equal_across_ranks(runs, case):
    """The last stage's outputs, summed with the other stages' zeros, are
    the same bits on every rank."""
    _, ranks = runs
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[case + "_out"], ranks[0][case + "_out"])


@pytest.mark.parametrize("case", CASES)
def test_block_grads_match_reference(runs, case):
    """Each rank's gradient of its stage's blocks against the reference's
    gradient of the whole stack, that stage's rows."""
    ref, ranks = runs
    for rank, r in enumerate(ranks):
        assert r[case + "_gW"].shape == _block(ref[case + "_gW"], rank).shape
        assert _err(r[case + "_gW"], _block(ref[case + "_gW"], rank)) \
            < GRAD_TOL


@pytest.mark.parametrize("case", CASES)
def test_x_grad_whole_on_every_rank(runs, case):
    """x enters through ``copy_to``: its gradient (stage 0's) is summed over
    the stages, so every rank holds the reference's whole gradient."""
    ref, ranks = runs
    assert np.abs(ref[case + "_gx"]).max() > 1e-2
    for r in ranks:
        assert _err(r[case + "_gx"], ref[case + "_gx"]) < GRAD_TOL


@pytest.mark.parametrize("case", CASES)
def test_wrong_way_shift_misses(runs, case):
    """The shift sent to s - 1 instead of s + 1: the output and the block
    gradients must miss the limits the port meets."""
    ref, ranks = runs
    assert max(_err(r[case + "_fault_out"], ref[case + "_out"])
               for r in ranks) > 100 * OUT_TOL
    assert max(_err(r[case + "_fault_gW"], _block(ref[case + "_gW"], rank))
               for rank, r in enumerate(ranks)) > 100 * GRAD_TOL


@pytest.mark.parametrize("where", ["mesh", "no_mesh"])
def test_one_stage_equals_plain_stack(runs, where):
    """n_stages = 1: T = n_micro ticks, every microbatch through all blocks
    on one rank, the plain stack bit for bit (on a (1, 4) mesh on every
    rank)."""
    from repro_torch.launch.pipeline import pipeline_apply
    from repro_torch.models.dist import NO_MESH
    W, x = (torch.from_numpy(a) for a in inputs("reference"))
    with torch.no_grad():
        want = plain_stack(W, x).numpy()
        if where == "mesh":
            got = [r["one_stage"] for r in runs[1]]
        else:
            got = [pipeline_apply(W, x, apply_stage, NO_MESH).numpy()]
    for g in got:
        np.testing.assert_array_equal(g, want)
