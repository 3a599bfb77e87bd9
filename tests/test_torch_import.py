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

COPIED = ("configs/base.py", "configs/llama3_2_1b.py", "core/__init__.py",
          "core/sva/__init__.py", "core/sva/page_pool.py", "core/sva/tlb.py",
          "core/sva/iommu.py", "core/sva/sanitizer.py", "core/sva/mapping.py",
          "core/sva/kv_manager.py")


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
    from repro_torch.configs import ARCH_IDS, get_config
    assert ARCH_IDS == ("llama3.2-1b",)
    with pytest.raises(KeyError):
        get_config("gemma2-2b")
