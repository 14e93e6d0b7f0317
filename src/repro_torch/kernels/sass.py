"""Instruction census of a built kernel's SASS (``cuobjdump -sass``).

K1 is limited by the instructions each element issues, not by its
bytes.  :func:`census` reads the SASS of one kernel and counts the instructions one element
issues on the kernel's hot path, split by pipe: the body of its vector
loop (a backward branch whose body holds a 128-bit global load and
store) divided by the elements one iteration updates.

Slow paths that the hot path branches around are left out: a forward
branch whose skipped code calls a subroutine, uses local memory or
float64 (sqrtf's slow path, cosf's large-argument reduction) is taken.
Predicated instructions count: they issue whatever the predicate.

The count describes one build: ``chip_smoke.py`` reports it, and the
share of the SMs' issue rate it takes, beside K1's time.  It is not a
bound, which must not move with the code it judges.

    python -m repro_torch.kernels.sass LIBRARY_OR_SASS FUNCTION ELEMENTS
"""
from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List, NamedTuple

_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:(@!?U?P[T0-9]+)\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_COLD = ("CALL", "LDL", "STL", "DMUL")
PIPES = ("integer", "fp32", "conversion", "mufu", "tensor", "memory",
         "branch", "uniform", "other")


class Insn(NamedTuple):
    addr: int
    pred: str
    op: str
    args: str


def pipe(op: str) -> str:
    """The pipe (or class) an opcode issues to."""
    base = op.split(".")[0]
    if base in ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FSET",
                "FCHK", "FSWZADD"):
        return "fp32"
    if base in ("I2F", "F2I", "F2F", "I2FP", "F2FP", "FRND", "I2I"):
        return "conversion"
    if base == "MUFU":
        return "mufu"
    if base in ("HMMA", "HGMMA", "IMMA", "BMMA", "WARPGROUP"):
        return "tensor"
    if base in ("BRA", "BRX", "JMP", "BSSY", "BSYNC", "EXIT", "CALL", "RET",
                "WARPSYNC", "BAR", "BREAK", "NANOSLEEP", "YIELD"):
        return "branch"
    if (base.startswith(("LD", "ST", "ATOM", "RED", "CCTL"))
            or base in ("S2R", "CS2R", "MEMBAR", "SHFL", "LDGSTS", "LDSM")):
        return "memory"
    if base.startswith("U") or base == "S2UR":
        return "uniform"
    if base in ("IMAD", "IADD3", "VIADD", "LOP3", "SHF", "LEA", "ISETP",
                "IABS", "IMNMX", "VIMNMX", "SEL", "MOV", "PRMT", "FLO",
                "POPC", "BREV", "PLOP3", "P2R", "R2P", "SGXT", "BMSK",
                "IDP", "IADD", "ISCADD", "VOTE", "VOTEU", "LOP", "SHL",
                "SHR", "BFE", "BFI", "MATCH", "ISET", "ICMP"):
        return "integer"
    return "other"


def functions(sass: str) -> Dict[str, List[Insn]]:
    """Instructions of every function in a ``cuobjdump -sass`` listing."""
    out: Dict[str, List[Insn]] = {}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            out[cur] = []
            continue
        m = _LINE.match(line)
        if m and cur is not None and m.group(3) != "NOP":
            out[cur].append(Insn(int(m.group(1), 16), m.group(2) or "",
                                 m.group(3), m.group(4).strip()))
    return out


def _one(sass: str, function: str) -> List[Insn]:
    found = [v for k, v in functions(sass).items() if function in k]
    if len(found) != 1:
        raise ValueError(f"{len(found)} functions match {function!r}")
    return found[0]


def _target(ins: Insn):
    if ins.op.split(".")[0] != "BRA":
        return None
    m = re.search(r"0x([0-9a-f]+)\s*$", ins.args)
    return int(m.group(1), 16) if m else None


def _cold(insns: List[Insn]) -> set:
    """Addresses that the hot path branches around (see module note)."""
    cold = set()
    for ins in insns:
        tgt = _target(ins)
        if tgt is None or not ins.pred or tgt <= ins.addr:
            continue
        skipped = [i for i in insns if ins.addr < i.addr < tgt]
        ops = [i.op.split(".")[0] for i in skipped]
        if any(o in _COLD for o in ops) and "STG" not in ops:
            cold.update(i.addr for i in skipped)
    return cold


def census(sass: str, function: str, elements: int) -> dict:
    """Instructions per element on the hot path of the one function whose
    name holds ``function``, whose vector loop updates ``elements`` a
    iteration.  Returns ``{"per_element", "by_pipe", "static"}``."""
    insns = _one(sass, function)
    cold = _cold(insns)
    loops = []
    for ins in insns:
        tgt = _target(ins)
        if tgt is not None and tgt < ins.addr:
            body = [i for i in insns if tgt <= i.addr <= ins.addr]
            ops = {i.op for i in body}
            if (any(o.startswith("LDG") and "128" in o for o in ops)
                    and any(o.startswith("STG") and "128" in o for o in ops)):
                loops.append(body)
    if not loops:
        raise ValueError(f"{function!r} has no vector loop")
    if elements <= 0:
        raise ValueError("elements per iteration must be positive")
    hot = [i for i in min(loops, key=len) if i.addr not in cold]
    by = collections.Counter(pipe(i.op) for i in hot)
    return {"per_element": len(hot) / elements,
            "by_pipe": {p: by[p] / elements for p in PIPES if by[p]},
            "static": len(insns)}


def count_ops(sass: str, function: str, prefix: str) -> int:
    """Static count of opcodes starting with ``prefix`` (e.g. ``HMMA``) in
    the one function whose name holds ``function``."""
    return sum(i.op.startswith(prefix) for i in _one(sass, function))


def disassemble(path: str) -> str:
    """``cuobjdump -sass`` of a built library (or the text of a saved
    listing)."""
    if path.endswith(".sass"):
        with open(path) as f:
            return f.read()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found (CUDA toolkit)")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print(__doc__.strip().splitlines()[-1].strip(), file=sys.stderr)
        return 2
    res = census(disassemble(argv[0]), argv[1], int(argv[2]))
    print(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
