"""Count the instructions in the loop bodies of the built CUDA kernels.

Run on the machine with the card, after the kernels are built (for
example by ``chip_smoke.py``)::

    python -m is3d_tpu_torch.tools.sass_count [pattern]

For every library under is3d_tpu_torch/_build/ it disassembles the SASS
(``cuobjdump -sass``) and, for each kernel whose mangled name matches the
regular expression ``pattern`` (default: every kernel), prints its
innermost loops -- the bodies between a backward branch and its target --
with the instruction count, the FP32-pipe instructions (FFMA, FMUL, FADD,
FSETP, FSEL, FMNMX, ...), the SFU instructions (MUFU.*) and the shared-
memory loads.  Divide a body's counts by its MUFU.EX2 count for the
instructions per evaluation of the spectra, dN/dX and prototype kernels.
"""

from __future__ import annotations

import collections
import glob
import os
import re
import shutil
import subprocess
import sys

FP32 = ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FCHK", "FSET",
        "FRND")


def _opcode(op: str) -> str:
    parts = op.split()
    return parts[1] if parts[0].startswith("@") else parts[0]


def loops(sass: str, pattern: str, n_loops: int = 3):
    """(kernel, [(length, Counter of opcodes)]) for the ``n_loops``
    shortest loops holding an SFU instruction, per matching kernel."""
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if not re.search(pattern, name):
            continue
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in (
            re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            for line in func.splitlines()) if m]
        index = {a: i for i, (a, _) in enumerate(ins)}
        found = []
        for i, (a, op) in enumerate(ins):
            m = re.search(r"BRA.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < a and int(m.group(1), 16) in index:
                body = [_opcode(o) for _, o in ins[index[int(m.group(1), 16)]:
                                                   i + 1]]
                if any(o.startswith("MUFU") for o in body):
                    found.append(body)
        found.sort(key=len)
        yield name, [(len(b), collections.Counter(b)) for b in found[:n_loops]]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    pattern = argv[0] if argv else "."
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_build")
    for lib in sorted(glob.glob(os.path.join(build, "*.so"))):
        proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True)
        if proc.returncode != 0:         # a host library (fastio): no SASS
            continue
        sass = proc.stdout
        for name, bodies in loops(sass, pattern):
            print(f"{os.path.basename(lib)} {name}")
            for length, c in bodies:
                base = collections.Counter()
                for k, v in c.items():
                    base[k.split(".")[0]] += v
                fp32 = sum(base[k] for k in FP32)
                sfu = {k: v for k, v in c.items() if k.startswith("MUFU")}
                print(f"  loop of {length} instructions: FP32 {fp32}, "
                      f"SFU {sfu}, LDS {base['LDS']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
