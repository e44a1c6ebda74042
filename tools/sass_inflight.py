"""Wide global loads whose registers are written while the load is in
flight, in a CUDA kernel's SASS (the port's `movi_tpu_torch` kernels).

    python tools/sass_inflight.py LIB.so FUNCTION [FUNCTION ...]

On Hopper a write to any register of an in-flight `LDG.E.64`/`.128`
waits on the whole load, so a tick whose next rows are issued early
still waits on them if the compiler reuses one of their registers.  For
each FUNCTION (a part of its mangled name, for example `11mem2_kernel`)
the script disassembles LIB.so with the toolkit's `cuobjdump -sass` and
prints, for the wide global loads of the function's main loop, the first
later instruction that touches a register of the load, and counts those
that write before they read.  It needs `cuobjdump` (beside `nvcc`).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

# SASS: "/*0a30*/  @!P0 LDG.E.128 R4, [R2.64] ;"
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_REG = re.compile(r"\bR(\d+)\b")
_NO_DEST = {"ST", "STG", "STS", "STL", "RED", "BRA", "EXIT", "BAR", "RET",
            "CALL", "BSYNC", "BSSY", "NOP", "WARPSYNC", "MEMBAR", "ERRBAR",
            "CCTL", "JMP"}


def _widths(op: str) -> int:
    """Registers an instruction's destination spans."""
    if ".128" in op:
        return 4
    if ".64" in op or ".WIDE" in op:
        return 2
    return 1


def _dest_and_srcs(text: str):
    """(opcode, destination registers, source registers) of one SASS
    instruction (predicate guard dropped); stores, reductions and branches
    have no destination."""
    text = re.sub(r"^@!?U?P\w+\s+", "", text)
    op, _, rest = text.partition(" ")
    operands = [o.strip() for o in rest.split(",")] if rest else []
    has_dest = op.split(".")[0] not in _NO_DEST
    srcs, dest = set(), set()
    for i, o in enumerate(operands):
        regs = [int(x) for x in _REG.findall(o)]
        if i == 0 and has_dest and regs and not o.startswith("["):
            dest = set(range(regs[0], regs[0] + _widths(op)))
        else:
            for x in regs:
                srcs.add(x)
                if ".64" in o:
                    srcs.add(x + 1)
    return op, dest, srcs


def _function_body(sass: str, function: str) -> str:
    """The SASS of the first function whose mangled name contains
    `function`."""
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if function in part.split("\n", 1)[0]:
            return part
    raise KeyError(f"no function {function} in the SASS")


def inflight_writes(sass: str, function: str):
    """For each 64- or 128-bit global load in `function`'s SASS: the
    first later instruction that touches a register of the load's
    destination, on the path that falls through forward branches and
    takes backward ones (a loop's next iteration) once.  Returns [(load
    address, load text, address, instruction text, "write" or "read")],
    "write" where that instruction writes one of those registers without
    reading any: it waits on the whole load in flight."""
    out = []
    instrs = [(int(m.group(1), 16), m.group(2))
              for m in _INSTR.finditer(_function_body(sass, function))]
    at = {a: k for k, (a, _) in enumerate(instrs)}
    for i, (addr, text) in enumerate(instrs):
        op, dest, _ = _dest_and_srcs(text)
        if not op.startswith("LDG") or _widths(op) < 2:
            continue
        j, looped = i + 1, False
        while j < len(instrs):
            addr2, text2 = instrs[j]
            _, d2, s2 = _dest_and_srcs(text2)
            if dest & s2 or dest & d2:
                out.append((f"{addr:04x}", text, f"{addr2:04x}", text2,
                            "read" if dest & s2 else "write"))
                break
            back = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text2)
            if back and int(back.group(1), 16) < addr2 and not looped:
                j, looped = at.get(int(back.group(1), 16), j + 1), True
            else:
                j += 1
    return out


def main_loop(sass: str, function: str):
    """The (first, last) address of `function`'s longest backward
    branch: its main loop; the whole function where it has no loop."""
    spans, addrs = [], []
    for m in _INSTR.finditer(_function_body(sass, function)):
        addrs.append(int(m.group(1), 16))
        back = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", m.group(2))
        if back and int(back.group(1), 16) < int(m.group(1), 16):
            spans.append((int(back.group(1), 16), int(m.group(1), 16)))
    if not spans:
        return addrs[0], addrs[-1]
    return max(spans, key=lambda sp: sp[1] - sp[0])


def report(sass: str, function: str) -> str:
    """The main loop's wide loads of `function` and those whose first
    later touch is a write, as text."""
    lo, hi = main_loop(sass, function)
    found = [x for x in inflight_writes(sass, function)
             if lo <= int(x[0], 16) <= hi]
    writes = [x for x in found if x[4] == "write"]
    return (f"{function}: {len(found)} wide global loads in the main loop "
            f"({lo:04x}-{hi:04x}), {len(writes)} whose first later touch "
            f"is a write" + "".join(f"\n    {a} {t} -> {a2} {t2}"
                                    for a, t, a2, t2, _ in writes))


def disassemble(lib: str) -> str:
    """`cuobjdump -sass` of a library, from the toolkit of `nvcc`."""
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sass = disassemble(argv[0])
    for function in argv[1:]:
        print(report(sass, function))
    return 0


if __name__ == "__main__":
    sys.exit(main())
