"""Registers, spills and SASS instruction mix of the port's CUDA kernels.

    python3 scripts/kernel_registers.py [--sources radix_sort,topk] [--sass PATTERN]

Compiles each named source of ``src/repro_torch/kernels/csrc`` (default:
all six) with the flags of ``kernels/_build.py`` and ``-Xptxas -v`` into a
cubin under ``build/kernel_report/``, and prints one JSON line per kernel
instance: its source, template arguments, registers and spill bytes.
With ``--sass``, each instance whose mangled name contains PATTERN (for
example ``radix_sort_kernelILi1ELi16ELb0E``, K5 with one word, 16 items
and one row a CTA) also gets the counts of its SASS opcodes
(``cuobjdump -sass``): over the whole function and over its outermost
loop that holds a barrier (K5's pass loop).  Needs the CUDA toolkit, not
a card; exits non-zero when a compile fails.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

_OUT = ROOT / "build" / "kernel_report"
_INSTR = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^;]*?(?:\s(0x[0-9a-f]+))?\s*;")


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise SystemExit(f"{name} not found (PATH or /usr/local/cuda/bin)")
    return path


def ptxas_report(text: str, source: str) -> list[dict]:
    """One entry per kernel instance from nvcc's ``-Xptxas -v`` output."""
    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            rows.append({"source": source, "function": name,
                         "template": [int(a) for a in re.findall(
                             r"L[ib](\d+)E", name.split("kernel", 1)[-1])]})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and rows:
            rows[-1]["spill_store_bytes"] = int(m.group(1))
            rows[-1]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def sass_mix(text: str, pattern: str) -> list[dict]:
    """Opcode counts of each function whose name holds ``pattern``: in all,
    and inside the outermost backward branch that spans a barrier."""
    out = []
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if pattern not in name:
            continue
        instrs = [(int(m.group(1), 16), m.group(2), m.group(3))
                  for m in _INSTR.finditer(chunk)]
        bars = [a for a, op, _ in instrs if op == "BAR"]
        loops = [(int(t, 16), a) for a, op, t in instrs
                 if op == "BRA" and t and int(t, 16) < a
                 and any(int(t, 16) <= b <= a for b in bars)]
        lo, hi = max(loops, key=lambda s: s[1] - s[0]) if loops else (0, -1)
        inner = [op for a, op, _ in instrs if lo <= a <= hi]
        out.append({
            "function": name,
            "instructions": len(instrs),
            "opcodes": dict(collections.Counter(op for _, op, _ in instrs).most_common()),
            "loop_instructions": len(inner),
            "loop_opcodes": dict(collections.Counter(inner).most_common()),
        })
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sources", default=",".join(_build.SOURCES),
                        help="comma-separated csrc sources (default: all)")
    parser.add_argument("--sass", default="",
                        help="print the SASS opcode mix of instances whose "
                             "mangled name contains this")
    args = parser.parse_args()
    nvcc = _tool("nvcc")
    flags = [f for f in _build._FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    _OUT.mkdir(parents=True, exist_ok=True)
    names = args.sources.split(",")
    procs = {
        name: subprocess.Popen(
            [nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o",
             str(_OUT / f"{name}.cubin"), str(_build._CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names
    }
    failed = False
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log, file=sys.stderr)
            failed = True
            continue
        for row in ptxas_report(log, name):
            print(json.dumps(row))
        if args.sass:
            sass = subprocess.run(
                [_tool("cuobjdump"), "-sass", str(_OUT / f"{name}.cubin")],
                check=True, capture_output=True, text=True).stdout
            for row in sass_mix(sass, args.sass):
                print(json.dumps({"source": name} | row))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
