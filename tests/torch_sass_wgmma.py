"""A check of Hopper SASS for the registers of in-flight wgmma.

``wgmma.mma_async`` (SASS ``HGMMA``) reads its A fragments from registers
(the RS form) and writes its accumulators asynchronously: until a
``wgmma.wait_group`` (``WARPGROUP.DEPBAR.LE gsb0, N``) has retired the
group an HGMMA belongs to, no other instruction may write its A
registers, or read or write its accumulators (PTX ISA, "Asynchronous
Warpgroup Level Matrix Multiply-Accumulate"). ptxas allocates the
registers; this module checks what it allocated, on the disassembly
``cuobjdump -sass`` prints.

It is a forward dataflow over the function's instructions (branches by
address, fall-through, predicated exits; a function with an indirect
branch or a call is refused). The state is the list
of groups still in flight, oldest first: an HGMMA adds its A and
accumulator registers to the open group, one carrying ``gsb0`` closes
it, and ``WARPGROUP.DEPBAR.LE gsb0, N`` keeps the last N. At a join the
states are aligned at their newest group and united group by group, so
a register counts as in flight if it is on any path. Every other
instruction is held to the rule above; ``hazards`` lists the breaches.

``loop_mix`` counts a kernel's tile loop by the pipe each instruction
issues to. Run as a script it prints that count for the functions of a
built library:

    python3 tests/torch_sass_wgmma.py LIBRARY.so NAME_PART SCORES

(each function whose mangled name holds NAME_PART, divided by SCORES,
the scores a thread holds a tile: 64 for the TMA flash kernel at head
dim 64, ``flash_wgmma_kernelILi64E``).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List, NamedTuple, Optional, Tuple

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_REG = re.compile(r"(?<![A-Z_.])R(\d+)\b")
_HGMMA = re.compile(r"HGMMA\.64x(\d+)x\d+")
# opcodes whose first operand is not a register they write
_NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BAR", "WARPSYNC", "BRX",
            "RET", "CALL", "NANOSLEEP", "BSYNC", "BSSY", "EXIT", "BRA",
            "JMP", "JMX", "MEMBAR", "FENCE", "ERRBAR", "CCTL", "DEPBAR",
            "YIELD", "NOP", "WARPGROUP", "UTMALDG", "UTMASTG", "UTMACMDFLUSH",
            "UTMAPF", "UBLKCP", "ACQBULK", "SYNCS", "KILL", "BPT")
MAX_GROUPS = 8


class Inst(NamedTuple):
    addr: int
    pred: str          # "" or the guard, e.g. "@P0", "@!P1"
    op: str            # the opcode with its modifiers
    operands: List[str]


class Group(NamedTuple):
    a: frozenset        # A registers
    acc: frozenset      # accumulator registers


def functions(sass: str) -> Dict[str, List[Inst]]:
    """``cuobjdump -sass`` text → {mangled function name: instructions}."""
    out: Dict[str, List[Inst]] = {}
    cur: Optional[List[Inst]] = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m is None or cur is None:
            continue
        text = m.group(2).strip()
        pred = ""
        if text.startswith("@"):
            pred, text = text.split(None, 1)
        op, _, rest = text.partition(" ")
        cur.append(Inst(int(m.group(1), 16), pred, op, _split(rest)))
    return out


def _split(rest: str) -> List[str]:
    """Operands at the top level of brackets, separated by commas."""
    ops, depth, tok = [], 0, ""
    for c in rest:
        if c in "[(":
            depth += 1
        elif c in "])":
            depth -= 1
        if c == "," and depth == 0:
            ops.append(tok.strip())
            tok = ""
        else:
            tok += c
    if tok.strip():
        ops.append(tok.strip())
    return ops


def _regs(operand: str, width: int = 1) -> List[int]:
    """The registers an operand names: a register (``width`` of them
    from it), or those of an address (``.64``: a pair)."""
    if operand.startswith("["):
        out = []
        for m in re.finditer(r"(?<![A-Z_.])R(\d+)(\.64)?", operand):
            r = int(m.group(1))
            out += [r, r + 1] if m.group(2) else [r]
        return out
    m = _REG.search(operand)
    if m is None:
        return []
    r = int(m.group(1))
    return list(range(r, r + width))


def _width(op: str) -> int:
    if ".128" in op:
        return 4
    if ".64" in op:
        return 2
    return 1


def _dest_width(op: str) -> int:
    base = op.split(".")[0]
    if base == "LDSM":
        return {"4": 4, "2": 2}.get(op.rsplit(".", 1)[-1], 1)
    if base == "CS2R":
        return 1 if ".32" in op else 2
    if base == "IMAD" and ".WIDE" in op:
        return 2
    return _width(op)


def uses(inst: Inst) -> Tuple[List[int], List[int]]:
    """(registers written, registers read) by a non-HGMMA instruction."""
    base = inst.op.split(".")[0]
    ops = inst.operands
    written: List[int] = []
    reads = ops
    if ops and base not in _NO_DEST and not ops[0].startswith("["):
        written = _regs(ops[0], _dest_width(inst.op))
        reads = ops[1:]
    read: List[int] = []
    data_width = _width(inst.op) if base in ("ST", "STS", "STG",
                                             "STL") else 1
    for o in reads:
        read += _regs(o, data_width if not o.startswith("[") else 1)
    return written, read


def _hgmma(inst: Inst) -> Tuple[Group, bool]:
    """An HGMMA's registers, and whether it closes its group (gsb0)."""
    n = int(_HGMMA.match(inst.op).group(1))
    acc = frozenset(_regs(inst.operands[0], n // 2))
    a = frozenset(_regs(inst.operands[1], 4)
                  if _REG.match(inst.operands[1]) else [])
    return Group(a, acc), any(o.strip() == "gsb0" for o in inst.operands)


State = Tuple[Tuple[Group, ...], Group]      # (closed groups, open group)
_EMPTY = Group(frozenset(), frozenset())


def _join(x: Optional[State], y: State) -> State:
    if x is None:
        return y
    gx, gy = list(x[0]), list(y[0])
    n = max(len(gx), len(gy))
    gx = [_EMPTY] * (n - len(gx)) + gx
    gy = [_EMPTY] * (n - len(gy)) + gy
    both = tuple(Group(a.a | b.a, a.acc | b.acc) for a, b in zip(gx, gy))
    return both, Group(x[1].a | y[1].a, x[1].acc | y[1].acc)


def _cap(groups: List[Group]) -> Tuple[Group, ...]:
    while len(groups) > MAX_GROUPS:
        a, b = groups[0], groups[1]
        groups[:2] = [Group(a.a | b.a, a.acc | b.acc)]
    return tuple(groups)


def _target(inst: Inst) -> Optional[int]:
    """A branch's target address (cuobjdump prints it absolute)."""
    for o in inst.operands:
        m = re.fullmatch(r"0x([0-9a-f]+)", o)
        if m:
            return int(m.group(1), 16)
    return None


def hazards(insts: List[Inst]) -> List[str]:
    """The breaches of the in-flight rule in one function's instructions
    (empty when there are none)."""
    index = {inst.addr: i for i, inst in enumerate(insts)}
    for inst in insts:
        if inst.op.split(".")[0] in ("BRX", "JMX", "CALL"):
            return [f"{inst.addr:#06x} {inst.op}: control flow this "
                    f"check does not follow"]
    succ: List[List[int]] = []
    for i, inst in enumerate(insts):
        base = inst.op.split(".")[0]
        nxt = [i + 1] if i + 1 < len(insts) else []
        if base == "BRA":
            t = _target(inst)
            if t not in index:
                return [f"{inst.addr:#06x} BRA: a target this check does "
                        f"not find"]
            # a guard, a predicate operand (BRA P2, target) or .DIV: the
            # branch may fall through
            cond = (inst.pred or "DIV" in inst.op
                    or re.match(r"!?U?P[0-9T]$", inst.operands[0]))
            succ.append([index[t]] + (nxt if cond else []))
        elif base in ("EXIT", "RET") and not inst.pred:
            succ.append([])
        else:
            succ.append(nxt)
    states: List[Optional[State]] = [None] * len(insts)
    if insts:
        states[0] = ((), _EMPTY)
    found: Dict[str, None] = {}
    work = [0] if insts else []
    while work:
        i = work.pop()
        groups, open_g = list(states[i][0]), states[i][1]
        inst = insts[i]
        base = inst.op.split(".")[0]
        if base == "HGMMA":
            g, closes = _hgmma(inst)
            open_g = Group(open_g.a | g.a, open_g.acc | g.acc)
            if closes:
                groups.append(open_g)
                open_g = _EMPTY
        elif inst.op.startswith("WARPGROUP.DEPBAR"):
            keep = int(inst.operands[-1], 0)
            groups = groups[len(groups) - keep:] if keep else []
            if keep == 0:
                open_g = _EMPTY
        elif base != "WARPGROUP":
            written, read = uses(inst)
            a_busy = set().union(open_g.a, *(g.a for g in groups))
            acc_busy = set().union(open_g.acc, *(g.acc for g in groups))
            for r in written:
                if r in a_busy or r in acc_busy:
                    kind = "A fragment" if r in a_busy else "accumulator"
                    found[f"{inst.addr:#06x} {inst.op}: writes R{r}, an "
                          f"in-flight wgmma's {kind}"] = None
            for r in read:
                if r in acc_busy:
                    found[f"{inst.addr:#06x} {inst.op}: reads R{r}, an "
                          f"in-flight wgmma's accumulator"] = None
        out = (_cap(groups), open_g)
        for j in succ[i]:
            new = _join(states[j], out)
            if new != states[j]:
                states[j] = new
                work.append(j)
    return list(found)


# SASS opcodes by the pipe they issue to (the rest count as "other")
PIPES = {"mufu": ("MUFU",),
         "fp32": ("FFMA", "FADD", "FMUL", "FMNMX", "FSEL", "FSETP", "FSET",
                  "FSWZADD", "FCHK"),
         "integer": ("IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL",
                     "SHR", "ISETP", "LEA", "SEL", "PRMT", "IMNMX", "IABS",
                     "POPC", "FLO", "BMSK", "SGXT", "VIADD", "VIMNMX"),
         "conversion": ("F2FP", "F2F", "I2F", "F2I", "FRND", "I2FP", "F2IP"),
         "move": ("MOV", "CS2R", "S2R", "R2UR", "S2UR", "UMOV"),
         "tensor": ("HGMMA",)}


def loop_mix(insts: List[Inst], scores: int) -> Optional[Dict[str, float]]:
    """A function's tile loop by pipe (PIPES), each count divided by
    ``scores``: the loop is the shortest backward branch whose body
    holds at least ``scores`` MUFU ops, less the largest region a branch
    in it skips forward (an edge tile's column test). None when no loop
    holds that many."""
    def branch(inst):
        return _target(inst) if inst.op.startswith("BRA") else None
    loops = []
    for inst in insts:
        t = branch(inst)
        if t is not None and t <= inst.addr:
            body = [x for x in insts if t <= x.addr <= inst.addr]
            if sum(x.op.startswith("MUFU") for x in body) >= scores:
                loops.append(body)
    if not loops:
        return None
    body = min(loops, key=len)
    skips = [(x.addr, branch(x)) for x in body if branch(x) is not None
             and x.addr < branch(x) <= body[-1].addr]
    lo, hi = max(skips, key=lambda r: r[1] - r[0], default=(0, 0))
    counts = dict.fromkeys([*PIPES, "other"], 0)
    for x in body:
        if not lo < x.addr < hi:
            base = x.op.split(".")[0]
            counts[next((p for p, ops in PIPES.items() if base in ops),
                        "other")] += 1
    return {p: n / scores for p, n in counts.items()}


def main(argv: List[str]) -> int:
    library, part, scores = argv[1], argv[2], int(argv[3])
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], check=True,
                          capture_output=True, text=True).stdout
    for name, insts in functions(sass).items():
        if part in name:
            mix = loop_mix(insts, scores)
            print(name, "no loop" if mix is None else " ".join(
                f"{p} {v:.2f}" for p, v in mix.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
