"""The PyTorch port stands alone: importing it never imports JAX, no file
of it imports ``jax`` or ``repro``, and the modules it copies from the JAX
package stay the same programs as their originals (once the
``repro_torch.`` prefix is undone)."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

COPIED = ("configs/base.py", "configs/llama3_2_1b.py", "configs/qwen2_7b.py",
          "configs/llama3_2_3b.py", "configs/gemma2_2b.py", "core/__init__.py",
          "core/sva/__init__.py", "core/sva/page_pool.py", "core/sva/tlb.py",
          "core/sva/iommu.py", "core/sva/sanitizer.py", "core/sva/mapping.py",
          "core/sva/kv_manager.py", "core/serving/sequence_buffer.py",
          "core/serving/scheduler.py", "configs/deployment.py",
          "core/serving/disagg/workers.py", "core/serving/disagg/__init__.py",
          "configs/olmoe_1b_7b.py", "configs/kimi_k2_1t_a32b.py",
          "configs/rwkv6_3b.py", "configs/jamba_1_5_large_398b.py",
          "configs/seamless_m4t_medium.py", "configs/llama3_2_vision_90b.py",
          "runtime/ft.py", "data/pipeline.py")


def test_import_all_submodules_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m == 'repro' or "
        "m.startswith('repro.')], 'repro imported'\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("module", ["repro_torch.models.dist",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.models.params",
                                    "repro_torch.models.model",
                                    "repro_torch.models.blocks",
                                    "repro_torch.optim.adamw",
                                    "repro_torch.optim.compression",
                                    "repro_torch.checkpoint.ckpt",
                                    "repro_torch.launch.steps",
                                    "repro_torch.launch.input_specs",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.pipeline",
                                    "repro_torch.configs"])
def test_mesh_modules_stand_alone(module):
    """The multi-device modules import neither ``jax`` nor ``repro``, and
    importing one joins no process group and touches no device."""
    code = (f"import sys, torch\nimport {module}\n"
            "import torch.distributed as dist\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not [m for m in sys.modules if m == 'repro' or "
            "m.startswith('repro.')], 'repro imported'\n"
            "assert not (dist.is_available() and dist.is_initialized())\n"
            "assert not torch.cuda.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_file_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_original(rel):
    """Compared as syntax trees, which keep code and docstrings but not
    comments or line breaks: the copies of ``core/sva`` carry
    ``# svalint: disable=`` pragmas (and three continuation lines put in
    parentheses to hold one) where tools/svalint, whose allow-lists name
    only ``src/repro/...`` paths, would flag a module's use of its own
    internals."""
    port = re.sub(r"\brepro_torch\.", "repro.", (PORT / rel).read_text())
    orig = (SRC / "repro" / rel).read_text()
    assert ast.dump(ast.parse(port)) == ast.dump(ast.parse(orig))


def test_registry_serves_only_ported_archs():
    """Every arch of the reference, in its order, and nothing else."""
    from repro_torch.configs import ARCH_IDS, get_config
    assert ARCH_IDS == ("llama3.2-1b", "gemma2-2b", "llama3.2-3b", "qwen2-7b",
                        "olmoe-1b-7b", "kimi-k2-1t-a32b",
                        "llama-3.2-vision-90b", "rwkv6-3b",
                        "seamless-m4t-medium", "jamba-1.5-large-398b")
    assert len(ARCH_IDS) == 10
    assert [get_config(a).name for a in ARCH_IDS] == list(ARCH_IDS)
    with pytest.raises(KeyError):
        get_config("paper-soc")
