"""Instruction mix of the port's kernels as the card runs them.

    python -m rustsasa_tpu_torch.scripts.sass_mix ke_maxplus ke_bf16
    python -m rustsasa_tpu_torch.scripts.sass_mix --lib path/to/lib.so

Builds the named `ops/csrc/` sources (or takes built libraries),
disassembles each with the CUDA toolkit's `cuobjdump -sass` and prints,
per kernel instantiation, its instruction count and, for each innermost
loop (a backward branch and the instructions from its target), the
loop's length and its instructions by opcode.  Needs the toolkit, not
the card.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

from ..ops import _kernels

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;/]*?)\s*;")
_PREDICATE = re.compile(r"^@!?U?P\w+\s+")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\b")


def parse(text: str) -> dict[str, list[tuple[int, str]]]:
    """{function: [(address, instruction), ...]} of cuobjdump -sass text."""
    functions: dict[str, list[tuple[int, str]]] = {}
    code = None
    for line in text.splitlines():
        head = _FUNCTION.match(line)
        if head:
            code = functions.setdefault(head.group(1), [])
            continue
        ins = _INSTR.search(line)
        if code is not None and ins:
            code.append((int(ins.group(1), 16), ins.group(2).strip()))
    return functions


def opcode(instruction: str) -> str:
    """The mnemonic with its modifiers, without a predicate."""
    return _PREDICATE.sub("", instruction).split()[0]


def innermost_loops(code) -> list[tuple[int, int]]:
    """(first, last) instruction indices of each loop that holds no other:
    a branch to an address at or before its own, and its target."""
    index = {addr: i for i, (addr, _) in enumerate(code)}
    spans = []
    for i, (addr, ins) in enumerate(code):
        if not opcode(ins).startswith("BRA"):
            continue
        target = _TARGET.search(_PREDICATE.sub("", ins))
        if target and int(target.group(1), 16) <= addr:
            first = index.get(int(target.group(1), 16))
            if first is not None:
                spans.append((first, i))
    return sorted(s for s in spans
                  if not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                             for o in spans))


def mix(code, first: int, last: int) -> collections.Counter:
    return collections.Counter(opcode(ins) for _, ins in code[first:last + 1])


def _demangle(names):
    tool = shutil.which("c++filt")
    if not tool:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def _cuobjdump() -> str:
    return os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")


def report(lib: str, min_loop: int = 16) -> None:
    text = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    functions = parse(text)
    names = _demangle(list(functions))
    print(f"{os.path.basename(lib)}:", flush=True)
    for fn, code in functions.items():
        print(f"  {names[fn]}: {len(code)} instructions", flush=True)
        for first, last in innermost_loops(code):
            if last - first + 1 < min_loop:
                continue
            counts = mix(code, first, last)
            body = ", ".join(f"{op} {n}" for op, n in counts.most_common())
            print(f"    loop 0x{code[first][0]:04x}-0x{code[last][0]:04x}, "
                  f"{last - first + 1} instructions: {body}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="sass_mix")
    parser.add_argument("sources", nargs="*", help="csrc/<name>.cu to build")
    parser.add_argument("--lib", action="append", default=[],
                        help="a built library to disassemble")
    args = parser.parse_args(argv)
    libs = list(args.lib)
    if args.sources:
        built = _kernels.build()
        for name in args.sources:
            if name not in built:
                print(f"sass_mix: no source {name!r}", file=sys.stderr)
                return 1
            libs.append(built[name].path)
    if not libs:
        parser.print_usage(sys.stderr)
        return 1
    for lib in libs:
        report(lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
