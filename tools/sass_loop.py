#!/usr/bin/env python3
"""The instruction mix of a kernel library's main loops, from its SASS, on
a machine with nvcc and cuobjdump (the GPU's).

    python3 tools/sass_loop.py [NAME] [FILTER]   # default: wire_mlp tc_

Builds csrc/NAME.cu as the package does (ops/build.py), disassembles it
with cuobjdump -sass, and for every kernel whose mangled name contains
FILTER prints one JSON line: the kernel's instruction count, and for its
loop with the most HMMA instructions (the span from a backward branch's
target to the branch) the instructions per pass, the HMMA among them and
the most frequent opcodes.  Static counts: one pass of the loop as
compiled, not a measured issue rate.
"""
import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def loops(lines):
    """(start, end) index spans of backward branches."""
    addr = {}
    parsed = []
    for i, line in enumerate(lines):
        m = INSN.search(line)
        parsed.append(m)
        if m:
            addr[int(m.group(1), 16)] = i
    for i, line in enumerate(lines):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", line)
        if m and parsed[i]:
            target = int(m.group(1), 16)
            if target < int(parsed[i].group(1), 16) and target in addr:
                yield addr[target], i


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "wire_mlp"
    filt = sys.argv[2] if len(sys.argv) > 2 else "tc_"
    from wire_tpu_torch.ops import build
    so, _ = build.build(name)
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        fname = func.split("\n", 1)[0].strip()
        if filt not in fname:
            continue
        lines = [ln for ln in func.split("\n") if INSN.search(ln)]
        best = None
        for a, b in loops(lines):
            ops = [INSN.search(ln).group(2).split(".")[0]
                   for ln in lines[a:b + 1]]
            hmma = ops.count("HMMA")
            if best is None or hmma > best[0]:
                best = (hmma, ops)
        out = {"kernel": fname, "instructions": len(lines)}
        if best and best[0]:
            out.update(loop_instructions=len(best[1]), loop_hmma=best[0],
                       loop_opcodes=collections.Counter(best[1])
                       .most_common(12))
        print(json.dumps(out))


if __name__ == "__main__":
    main()
