"""The port's checkpoints and fault tolerance: mirrors of
``tests/test_ft_ckpt.py`` (roundtrip, atomicity, async and keep, the
restart loop, straggler, heartbeats, injection) against
``repro_torch.checkpoint.ckpt`` and the copied ``runtime/ft.py``; a
checkpoint of smoke parameters and optimizer state (bf16 and fp32 leaves)
written by the JAX package's ``save`` and restored bit for bit by the
port's launcher; and the train launcher's restart recipe on the CPU."""
import dataclasses
import json
import pathlib
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.ckpt import save as j_save  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import init_opt_state as j_init_opt_state  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint.ckpt import (latest_step, restore,  # noqa: E402
                                         save)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.params import unstack_blocks  # noqa: E402
from repro_torch.optim import init_opt_state  # noqa: E402
from repro_torch.runtime.ft import (FailureInjector,  # noqa: E402
                                    HeartbeatMonitor, StragglerDetector,
                                    WorkerFailure, run_with_restarts)
from repro_torch.tree import leaves, tree_map  # noqa: E402


def _state(scale=1.0):
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(8, 16, generator=g) * scale,
            "nested": {"b": torch.arange(4.0),
                       "c": torch.tensor(7, dtype=torch.int32)}}


# ------------------------------------------------ tests/test_ft_ckpt.py mirrors

def test_ckpt_roundtrip(tmp_path):
    st = _state()
    save(str(tmp_path), 5, st)
    assert latest_step(str(tmp_path)) == 5
    out = restore(str(tmp_path), 5, tree_map(torch.zeros_like, st))
    for a, b in zip(leaves(st), leaves(out)):
        assert torch.equal(a, b)


def test_ckpt_async_and_keep(tmp_path):
    ex = ThreadPoolExecutor(max_workers=1)
    futs = [save(str(tmp_path), s, _state(s), keep=2, executor=ex)
            for s in (1, 2, 3, 4)]
    for f in futs:
        f.result()
    ex.shutdown()
    kept = sorted(int(p.name.split("_")[1])
                  for p in pathlib.Path(tmp_path).glob("step_*"))
    assert kept == [3, 4]
    out = restore(str(tmp_path), 4, _state())
    torch.testing.assert_close(out["w"], _state(4.0)["w"])


def test_ckpt_async_save_holds_the_saved_step(tmp_path):
    """An asynchronous save on the CPU, then the next train step (which
    updates the master and moments in place) before the write runs: the
    checkpoint restores bit for bit the state at save time."""
    import threading
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.steps import make_train_step
    cfg = dataclasses.replace(
        tconfigs.reduce_for_smoke(tconfigs.get_config("llama3.2-1b")),
        n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params)
    step = make_train_step(cfg, TrainConfig(total_steps=4, warmup_steps=1))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
             for k in ("tokens", "labels")}
    params, opt, _ = step(params, opt, batch)
    state = train.ckpt_state(params, opt)
    at_save = [t.clone() for t in leaves(state)]
    ex = ThreadPoolExecutor(max_workers=1)
    gate = threading.Event()
    ex.submit(gate.wait)                # the write waits behind this
    fut = save(str(tmp_path), 1, state, executor=ex)
    params, opt, _ = step(params, opt, batch)
    gate.set()
    fut.result()
    ex.shutdown()
    moved = [not torch.equal(a, b) for a, b in
             zip(at_save, leaves(train.ckpt_state(params, opt)))]
    assert sum(moved) > len(moved) // 2
    out = leaves(restore(str(tmp_path), 1, state))
    assert all(torch.equal(a, b) for a, b in zip(out, at_save))


def test_ckpt_atomic_no_partial(tmp_path):
    save(str(tmp_path), 9, _state())
    # a stale tmp dir from a crashed writer must not be visible
    (pathlib.Path(tmp_path) / "step_11.tmp").mkdir()
    assert latest_step(str(tmp_path)) == 9


def test_restart_loop_restores():
    calls = []

    def loop(resume):
        calls.append(resume)
        if len(calls) < 3:
            raise WorkerFailure("boom")
        return 42

    assert run_with_restarts(loop, max_restarts=3) == 42
    assert calls == [None, -1, -1]


def test_restart_loop_gives_up():
    def loop(resume):
        raise WorkerFailure("always")
    with pytest.raises(WorkerFailure):
        run_with_restarts(loop, max_restarts=2)


def test_failure_injection_fires_once():
    inj = FailureInjector(fail_at_steps=(3,))
    for s in range(3):
        inj.check(s)
    with pytest.raises(WorkerFailure):
        inj.check(3)
    inj.check(3)          # second pass (post-restart) does not re-fire


def test_straggler_detector():
    det = StragglerDetector(window=16, factor=3.0)
    for s in range(10):
        assert not det.record(s, 1.0)
    assert det.record(10, 10.0)
    assert det.events[0]["step"] == 10


def test_heartbeats():
    mon = HeartbeatMonitor(["w0", "w1"], timeout_s=1000)
    mon.assert_alive()
    mon.last["w1"] -= 5000
    assert mon.dead_workers() == ["w1"]
    with pytest.raises(WorkerFailure):
        mon.assert_alive()


# ------------------------------------------------ across the two packages

def test_bf16_leaves_roundtrip_bit_exact(tmp_path):
    """bf16 leaves keep every bit (NaN, inf and subnormal words too), and
    the manifest names them as the reference's does."""
    words = torch.from_numpy(np.array(
        [0x7FC1, 0xFF80, 0x0001, 0x8000, 0x3F80, 0x4049],
        dtype=np.uint16).view(np.int16))
    st = {"h": words.view(torch.bfloat16), "f": torch.arange(3.0)}
    save(str(tmp_path), 1, st)
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert manifest["dtypes"] == ["float32", "bfloat16"]
    out = restore(str(tmp_path), 1, tree_map(torch.zeros_like, st))
    assert out["h"].dtype == torch.bfloat16
    assert torch.equal(out["h"].view(torch.int16), words)


def _bits(t) -> np.ndarray:
    """A leaf's raw words (bf16 as int16, fp32 and int32 as int32)."""
    a = np.asarray(t)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def test_reference_checkpoint_restores_bit_exact(tmp_path):
    """The JAX package saves smoke llama3.2-1b's parameters in bf16 and its
    AdamW state (fp32, int32 count) as its launcher does; the port's
    launcher restores it into its own layout, every leaf bit for bit."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("llama3.2-1b")),
                              n_layers=2, param_dtype="bfloat16")
    tcfg = dataclasses.replace(
        reduce_for_smoke(tconfigs.get_config("llama3.2-1b")), n_layers=2,
        param_dtype="bfloat16")
    jp = j_init_params(cfg, jax.random.key(3))
    jopt = j_init_opt_state(jp)
    jopt = jopt._replace(mu=jax.tree.map(lambda m: m + 0.25, jopt.mu),
                         count=jopt.count + 6)
    j_save(str(tmp_path), 6, {"params": jp, "opt": jopt})

    params = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    target = train.ckpt_state(params, init_opt_state(params))
    got_params, got_opt = train.from_ckpt_state(
        restore(str(tmp_path), 6, target))

    assert leaves(got_params)[0].dtype == torch.bfloat16
    assert int(got_opt.count) == 6 and got_opt.ef is None
    ref_tree = lambda t: unstack_blocks(jax.tree.map(np.asarray, t))
    pairs = [(got_params, ref_tree(jp))] + [
        (getattr(got_opt, f), ref_tree(getattr(jopt, f)))
        for f in ("master", "mu", "nu")]
    for ours, ref in pairs:
        assert len(leaves(ours)) == len(leaves(ref))
        for a, b in zip(leaves(ours), leaves(ref)):
            a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
            assert np.array_equal(_bits(a.numpy()), _bits(b))


# ------------------------------------------------ the launcher

def test_train_launcher_restart_recipe(tmp_path, capsys):
    """The verify skill's recipe, on the CPU: a failure injected at step 7
    rolls back to the checkpoint of step 5 and the run completes."""
    assert train.main([
        "--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
        "--steps", "12", "--batch", "2", "--seq", "32",
        "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "5",
        "--inject-failure-at", "7", "--log-every", "100"]) == 0
    out = capsys.readouterr().out
    for line in ("injected worker failure at step 7", "restored step 5",
                 "[train] done"):
        assert line in out, out
    assert latest_step(str(tmp_path / "ck")) == 10


def test_train_launcher_refuses_mesh(capsys):
    """A mesh whose model axis does not split an arch's widths is refused
    with an argparse error naming them: the cross-attention archs' smoke
    heads (4) and d_ff (128) on a model axis of 3."""
    for arch in ("seamless-m4t-medium", "llama-3.2-vision-90b"):
        with pytest.raises(SystemExit) as e:
            train.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--mesh", "1,3"])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert "heads 4" in err and "model axis of 3" in err, err


def test_train_launcher_mesh_cross_runs():
    """``--mesh 2,2`` with smoke seamless-m4t-medium (its encoder, and 2 of
    its 4 heads a model rank): four gloo ranks take three steps and the
    run ends."""
    import os
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "seamless-m4t-medium", "--smoke", "--device", "cpu", "--mesh",
         "2,2", "--steps", "3"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("[train] done 3 steps") == 1, r.stdout
    assert r.stdout.count("step     2 loss") == 1, r.stdout


def test_train_launcher_mesh_recurrent_runs():
    """``--mesh 2,2`` with smoke rwkv6-3b (2 of its 4 heads a model rank):
    four gloo ranks take three steps and the run ends."""
    import os
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rwkv6-3b", "--smoke", "--device", "cpu", "--mesh", "2,2",
         "--steps", "3"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("[train] done 3 steps") == 1, r.stdout
    assert r.stdout.count("step     2 loss") == 1, r.stdout


def test_train_launcher_mesh_moe_restart_recipe(tmp_path):
    """``--mesh 2,2`` with smoke olmoe-1b-7b (2 of its 4 experts a model
    rank): a failure injected at step 5 restarts every rank from the
    checkpoint of step 3, and the run ends."""
    import os
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmoe-1b-7b", "--smoke", "--device", "cpu", "--mesh", "2,2",
         "--steps", "8", "--ckpt-every", "3", "--inject-failure-at", "5",
         "--ckpt-dir", str(tmp_path / "ck")],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    for line in ("injected worker failure at step 5", "restored step 3",
                 "[train] done"):
        assert r.stdout.count(line) == 1, r.stdout
    assert latest_step(str(tmp_path / "ck")) == 6


@pytest.mark.parametrize("how", ["spawn", "torchrun"])
def test_train_launcher_mesh_restart_recipe(tmp_path, how):
    """``--mesh 2,2`` on the CPU, the launcher starting four gloo ranks
    itself or joining the group ``torchrun`` starts: a failure injected at
    step 5 restarts every rank from the checkpoint of step 3 (each
    restoring its blocks), and the run ends; rank 0 alone prints, so each
    line appears once."""
    import os
    import socket
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    launch = [sys.executable, "-m"]
    if how == "torchrun":
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        launch += ["torch.distributed.run", "--nnodes", "1",
                   "--nproc_per_node", "4", "--master_addr", "localhost",
                   "--master_port", str(port), "-m"]
    r = subprocess.run(
        launch + ["repro_torch.launch.train", "--arch",
                  "llama3.2-1b", "--smoke", "--device", "cpu", "--mesh",
                  "2,2", "--steps", "8", "--ckpt-every", "3",
                  "--inject-failure-at", "5", "--ckpt-dir",
                  str(tmp_path / "ck")],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    for line in ("injected worker failure at step 5", "restored step 3",
                 "[train] done"):
        assert r.stdout.count(line) == 1, r.stdout
    assert r.stdout.count("step     3 loss") == 2, r.stdout
    assert latest_step(str(tmp_path / "ck")) == 6
