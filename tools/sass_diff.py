#!/usr/bin/env python3
"""Compare the machine code (SASS) of kernels in two CUDA sources.

    python3 tools/sass_diff.py OLD.cu NEW.cu OLD_KERNEL=NEW_KERNEL [...]

Each source is compiled for sm_90a with the port's flags (as a cubin, in
a temporary directory) and disassembled with ``cuobjdump -sass``. Each
pair names two kernels by a substring of their mangled names (for
example ``l2_topk_kernelIfEE=l2_topk_kernelIfLi64EE``); their instruction
streams are compared with addresses and encodings dropped. Prints one
JSON object per pair: the kernels found, their instruction counts and
whether the streams are equal (with the first differing instruction
otherwise), and whether they are equal once registers are renamed in
order of first use (the same code under another register allocation).
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); it imports
nothing of the port or of JAX.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")


def _tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def sass_by_kernel(src: str, tmp: str) -> dict:
    cubin = os.path.join(tmp, os.path.basename(src) + ".cubin")
    subprocess.run([_tool("nvcc"), *FLAGS, "-cubin", "-o", cubin, src],
                   check=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def canonical(stream: list) -> list:
    """The instructions with each register (R, UR, P, UP) renamed by its
    first appearance, so that two streams that differ only in register
    allocation compare equal."""
    names: dict = {}

    def rename(m):
        return names.setdefault(m.group(0), f"%{m.group(1)}{len(names)}")
    return [re.sub(r"\b(UR|UP|R|P)(?!Z\b|T\b)\d+\b", rename, ins)
            for ins in stream]


def main() -> int:
    if len(sys.argv) < 4:
        print(__doc__, file=sys.stderr)
        return 2
    old_src, new_src, pairs = sys.argv[1], sys.argv[2], sys.argv[3:]
    with tempfile.TemporaryDirectory() as tmp:
        old, new = sass_by_kernel(old_src, tmp), sass_by_kernel(new_src, tmp)
    for pair in pairs:
        a, b = pair.split("=")
        ka = [k for k in old if a in k]
        kb = [k for k in new if b in k]
        row = {"old": ka, "new": kb}
        if len(ka) == 1 and len(kb) == 1:
            ia, ib = old[ka[0]], new[kb[0]]
            row.update(old_instructions=len(ia), new_instructions=len(ib),
                       equal=ia == ib,
                       equal_up_to_registers=canonical(ia) == canonical(ib))
            if ia != ib:
                j = next((j for j, (x, y) in enumerate(zip(ia, ib))
                          if x != y), min(len(ia), len(ib)))
                row["first_difference"] = [j, ia[j:j + 1], ib[j:j + 1]]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
