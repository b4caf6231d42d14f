"""Instruction mix of a built kernel, from its SASS (needs the CUDA toolkit).

    PYTHONPATH=src python -m repro_torch.launch.sass_mix bitplane_add \
        --match 'bitplane_add_kernelILi16E'

Builds ``csrc/<name>.cu`` like the kernel wrappers do, disassembles it
with ``cuobjdump -sass`` and prints, for each kernel whose mangled name
contains ``--match``, the count of each opcode in its innermost loops (the
instructions between a backward branch and its target) and in the rest of
the function.  With the per-lane trip counts this says how many
instructions of each pipe one lane costs, against the bytes it moves.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

from repro_torch.kernels import _build

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)"
                   r"[^;]*?(?:\s0x([0-9a-f]+))?\s*;")


def _functions(sass: str) -> Dict[str, List[Tuple[int, str, int]]]:
    """Mangled name -> [(address, opcode, branch target or -1)]."""
    out: Dict[str, List[Tuple[int, str, int]]] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and current is not None:
            target = int(m.group(3), 16) if m.group(2) == "BRA" and \
                m.group(3) else -1
            current.append((int(m.group(1), 16), m.group(2), target))
    return out


def mix(insns: List[Tuple[int, str, int]]):
    """(opcode counts inside backward-branch loops, counts elsewhere)."""
    loops = [(t, a) for a, op, t in insns if op == "BRA" and 0 <= t < a]
    inner, rest = collections.Counter(), collections.Counter()
    for a, op, _ in insns:
        in_loop = any(lo <= a <= hi for lo, hi in loops)
        (inner if in_loop else rest)[op] += 1
    return inner, rest


def cuobjdump() -> Optional[str]:
    """The toolkit's ``cuobjdump``, or None where there is none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return tool if os.path.exists(tool) else None


def kernel_mixes(name: str, match: str = ""):
    """Mangled name -> :func:`mix` of each kernel of ``csrc/<name>.cu``
    whose name contains ``match``; builds the source first."""
    tool = cuobjdump()
    if tool is None:
        raise RuntimeError("cuobjdump not found (PATH or /usr/local/cuda/bin)")
    _build.build(name)
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return {fn: mix(insns) for fn, insns in _functions(sass).items()
            if match in fn}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", help="kernel source csrc/<name>.cu")
    ap.add_argument("--match", default="", help="substring of kernel names")
    args = ap.parse_args(argv)
    for fn, (inner, rest) in kernel_mixes(args.name, args.match).items():
        fmt = lambda c: ", ".join(f"{op} {n}" for op, n in c.most_common())
        print(f"[sass] {fn}: loop {sum(inner.values())} instructions "
              f"({fmt(inner)}); outside loops {sum(rest.values())} "
              f"({fmt(rest)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
