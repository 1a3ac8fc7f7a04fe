#!/usr/bin/env python3
"""Where the register spills of each kernel instance fall in its SASS.

    python3 tools/sass_spills.py [--match 240]

Builds the kernel library (``repro_torch.kernels.build``, on a machine with
the card's toolkit), disassembles it with ``cuobjdump -sass`` and prints, for
each kernel instance whose name holds ``--match``: its instructions, its
tensor-core products (HMMA), and its local-memory stores and loads (STL,
LDL: what ``-Xptxas -v`` reports as spill stores and loads), apart by
whether they sit inside a loop (between a label and a later branch back to
it) or outside every loop. A spill outside the loops is paid once a thread;
one inside is paid on each trip, against the products of that trip.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import _kernel_name  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRANCH = re.compile(r"\bBRA\b(?:\.\w+)*\s.*?(?:`\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\s*$)")


def _functions(sass: str):
    """(mangled name, its SASS lines) for each function of a ``cuobjdump -sass`` dump."""
    name, lines = None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                yield name, lines
            name, lines = m.group(1), []
        elif name:
            lines.append(line)
    if name:
        yield name, lines


def count(lines) -> dict:
    """Instructions, HMMA, and STL / LDL inside and outside loops."""
    insns, labels, branches = [], {}, []
    pending = []
    for line in lines:
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), m.group(2)
        for lab in pending:
            labels[lab] = addr
        pending = []
        insns.append((addr, text))
        b = _BRANCH.search(text)
        if b:     # a target by label (nvdisasm's form) or by address (cuobjdump's)
            branches.append((addr, b.group(1) or int(b.group(2), 16)))
    targets = [(labels.get(t) if isinstance(t, str) else t, a) for a, t in branches]
    loops = [(t, a) for t, a in targets if t is not None and t <= a]

    def in_loop(addr):
        return any(lo <= addr <= hi for lo, hi in loops)

    out = {"insns": len(insns), "hmma": 0, "stl_loop": 0, "stl_out": 0, "ldl_loop": 0,
           "ldl_out": 0, "loops": len(loops)}
    for addr, text in insns:
        op = text.split()[0] if not text.startswith("@") else text.split()[1]
        if op.startswith("HMMA"):
            out["hmma"] += 1
        for kind in ("STL", "LDL"):
            if op.startswith(kind):
                out[f"{kind.lower()}_{'loop' if in_loop(addr) else 'out'}"] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--match", default="", help="only kernels whose name holds this")
    args = ap.parse_args()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = build.load()
    del lib
    sass = subprocess.run([tool, "-sass", str(build.library_path())], capture_output=True,
                          text=True, check=True).stdout
    for mangled, lines in _functions(sass):
        name = _kernel_name(mangled)
        if args.match not in name:
            continue
        c = count(lines)
        print(f"[sass] {name}: {c['insns']} instructions, {c['hmma']} HMMA, {c['loops']} "
              f"backward branches; STL {c['stl_loop']} in loops, {c['stl_out']} outside; "
              f"LDL {c['ldl_loop']} in loops, {c['ldl_out']} outside")
    return 0


if __name__ == "__main__":
    sys.exit(main())
