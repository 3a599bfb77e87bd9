"""Count the SASS instructions of the port's CUDA kernels.

    python3 -m repro_torch.kernels.sass heat3d [more source names]

(with ``src`` on ``PYTHONPATH``, on a machine with the CUDA toolkit). Builds
each named ``csrc/<name>.cu`` as the port does, disassembles its library
with ``cuobjdump -sass`` and prints one JSON line per kernel: its
instructions, the count of each opcode, and the same over its main loop
(the longest backward branch's span that holds a ``BAR.SYNC``, or the
longest one). ``fma_unit`` counts the ``HFMA2`` that multiply by the
constant 1: adds, not a multiply contracted into an add.
"""
from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys

_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\S*)\s*(.*?);")
_TARGET = re.compile(r"(0x[0-9a-f]+)")
_UNIT = re.compile(r"^R\d+, R\d+(\.\w+)*, 1, 1,")


def _functions(sass: str):
    """(name, [(address, opcode, operands)]) for each kernel of a listing."""
    name, insns = None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                yield name, insns
            name, insns = m.group(1), []
            continue
        m = _INSN.match(line)
        if m and name:
            insns.append((int(m.group(1), 16), m.group(3), m.group(5)))
    if name:
        yield name, insns


def _loop(insns):
    """The instructions of the main loop."""
    spans = []
    for addr, op, args in insns:
        t = _TARGET.search(args) if op == "BRA" else None
        if t and int(t.group(1), 16) < addr:
            spans.append((int(t.group(1), 16), addr))
    with_bar = [s for s in spans if any(s[0] <= a <= s[1] and op == "BAR"
                                        for a, op, _ in insns)]
    if not (with_bar or spans):
        return []
    lo, hi = max(with_bar or spans, key=lambda s: s[1] - s[0])
    return [i for i in insns if lo <= i[0] <= hi]


def _counts(insns) -> dict:
    ops = collections.Counter(op for _, op, _ in insns)
    unit = sum(op == "HFMA2" and bool(_UNIT.match(args)) for _, op, args in insns)
    return {"instructions": len(insns), "FFMA": ops["FFMA"], "HFMA2": ops["HFMA2"],
            "fma_unit": unit, "opcodes": dict(ops.most_common())}


def main(argv=None) -> int:
    from repro_torch.kernels.build import build, library_path
    names = (argv if argv is not None else sys.argv[1:]) or ["heat3d"]
    build(names)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in names:
        sass = subprocess.run([tool, "-sass", str(library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        for fn, insns in _functions(sass):
            print(json.dumps({"source": name, "kernel": fn, **_counts(insns),
                              "loop": _counts(_loop(insns))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
