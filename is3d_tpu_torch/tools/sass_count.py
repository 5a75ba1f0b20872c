"""Count the instructions in the loop bodies of the built CUDA kernels.

Run on the machine with the card, after the kernels are built (for
example by ``chip_smoke.py``)::

    python -m is3d_tpu_torch.tools.sass_count [pattern]

For every library under is3d_tpu_torch/_build/ it disassembles the SASS
(``cuobjdump -sass``) and, for each kernel whose mangled name matches the
regular expression ``pattern`` (default: every kernel), prints its
innermost loops -- the bodies between a backward branch and its target --
with the instruction count, the FP32-pipe instructions (FFMA, FMUL, FADD,
FSETP, FSEL, FMNMX, ...), the SFU instructions (MUFU.*), the shared-
memory loads and the atomics and reductions (ATOM and RED on device
memory, ATOMS on shared memory; CAS those that compare and swap, the
instruction of a CAS loop).  Divide a body's counts by its MUFU.EX2 count for the
instructions per evaluation of the spectra, dN/dX and prototype kernels
(``per_eval`` does that for one kernel of one library).
"""

from __future__ import annotations

import collections
import functools
import glob
import os
import re
import shutil
import subprocess
import sys

FP32 = ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FCHK", "FSET",
        "FRND")
F64 = ("DADD", "DFMA", "DMUL", "DSETP", "DMNMX", "F2F")
BRANCH = ("BRA", "BSSY", "BSYNC", "BRX", "JMP", "CALL", "RET")
ATOMIC = ("ATOM", "ATOMG", "RED", "REDG")   # device memory (G: global)
SHARED_ATOMIC = ("ATOMS",)


def _opcode(op: str) -> str:
    parts = op.split()
    return parts[1] if parts[0].startswith("@") else parts[0]


def loops(sass: str, pattern: str, n_loops: int | None = 3,
          innermost: bool = False):
    """(kernel, [(length, Counter of opcodes)]) for the ``n_loops``
    shortest loops holding an SFU instruction (all if None; only loops
    that hold no other loop with an SFU instruction if ``innermost``, so a
    compare-and-swap loop inside counts as the body's), per matching
    kernel."""
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if not re.search(pattern, name):
            continue
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in (
            re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            for line in func.splitlines()) if m]
        index = {a: i for i, (a, _) in enumerate(ins)}
        spans = []
        for i, (a, op) in enumerate(ins):
            m = re.search(r"BRA.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < a and int(m.group(1), 16) in index:
                spans.append((index[int(m.group(1), 16)], i))
        sfu = lambda a, b: any(_opcode(o).startswith("MUFU")
                               for _, o in ins[a:b + 1])
        found = []
        for lo, hi in spans:
            if not sfu(lo, hi):
                continue
            if innermost and any(lo <= a and b <= hi and (a, b) != (lo, hi)
                                 and sfu(a, b) for a, b in spans):
                continue
            found.append([_opcode(o) for _, o in ins[lo:hi + 1]])
        found.sort(key=len)
        yield name, [(len(b), collections.Counter(b)) for b in found[:n_loops]]


def _tool() -> str | None:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return tool if os.path.exists(tool) else None


def _base(c: collections.Counter) -> collections.Counter:
    base = collections.Counter()
    for k, v in c.items():
        base[k.split(".")[0]] += v
    return base


def _summary(c: collections.Counter) -> tuple[int, dict, int]:
    """(FP32-pipe, MUFU.* by name, shared loads) of one loop body."""
    base = _base(c)
    sfu = {k: v for k, v in c.items() if k.startswith("MUFU")}
    return sum(base[k] for k in FP32), sfu, base["LDS"]


def _atomics(c: collections.Counter) -> tuple[int, int, int]:
    """(device-memory atomics and reductions, shared-memory atomics,
    compare-and-swaps among them) of one loop body."""
    base = _base(c)
    cas = sum(v for k, v in c.items()
              if k.split(".")[0] in ATOMIC + SHARED_ATOMIC and "CAS" in k)
    return (sum(base[k] for k in ATOMIC),
            sum(base[k] for k in SHARED_ATOMIC), cas)


@functools.lru_cache(maxsize=None)
def _sass(tool: str, lib: str, mtime: float) -> str | None:
    """cuobjdump -sass of a library, once a process for each build of it."""
    proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True)
    return proc.stdout if proc.returncode == 0 else None


def per_eval(lib: str, pattern: str) -> dict | None:
    """Instructions per evaluation in the innermost loop of the first
    kernel of ``lib`` matching ``pattern`` whose body holds the most
    MUFU.EX2 (one per evaluation): dict(instructions, fp32, sfu, lds, sts,
    f64 (the float64 pipe and conversions), branch (with the convergence
    barriers), fchk (of those counted in fp32), atom (device-memory
    atomics and reductions), atoms (shared-memory atomics), cas (compare-
    and-swaps among them), evaluations), or None where cuobjdump is missing
    or finds no such loop."""
    tool = _tool()
    if tool is None or not os.path.exists(lib):
        return None
    sass = _sass(tool, lib, os.path.getmtime(lib))
    if sass is None:
        return None
    for _, bodies in loops(sass, pattern, None, innermost=True):
        bodies = [(n, c) for n, c in bodies if c["MUFU.EX2"]]
        if not bodies:
            continue
        length, c = max(bodies, key=lambda b: b[1]["MUFU.EX2"])
        fp32, sfu, lds = _summary(c)
        atom, atoms, cas = _atomics(c)
        base = _base(c)
        n = c["MUFU.EX2"]
        return dict(instructions=length / n, fp32=fp32 / n,
                    sfu=sum(sfu.values()) / n, lds=lds / n,
                    sts=base["STS"] / n,
                    f64=sum(base[k] for k in F64) / n,
                    branch=sum(base[k] for k in BRANCH) / n,
                    fchk=base["FCHK"] / n, atom=atom / n, atoms=atoms / n,
                    cas=cas / n, evaluations=n)
    return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    pattern = argv[0] if argv else "."
    tool = _tool() or "cuobjdump"
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
                fp32, sfu, lds = _summary(c)
                atom, atoms, cas = _atomics(c)
                print(f"  loop of {length} instructions: FP32 {fp32}, "
                      f"SFU {sfu}, LDS {lds}, atomics {atom} device, "
                      f"{atoms} shared ({cas} CAS)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
