#!/usr/bin/env python3
"""Static SASS counts of the kernels in a built library.

    python tools/sass_count.py LIBRARY.so NAME [NAME ...]

Runs ``cuobjdump -sass`` on the library (the CUDA toolkit's; run it on
the machine with the card, after ``emqx_tpu_torch.ops._kernels.load()``
built the library) and, for each function whose mangled name contains
one of the NAMEs, prints one JSON line: its instruction count (NOPs
left out), its local-memory loads and stores (LDL/STL: a register file
that spilled or was indexed at run time), its shared and global memory
instructions, its indirect branches (BRX: a jump table), and every
loop (a backward branch), innermost first, with the instructions of its
body and the local-memory instructions among them.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
TARGET = re.compile(r"`?\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\s*$")


def functions(text: str):
    """(mangled name, [(address, opcode, operands)], {label: address})."""
    name, insns, labels, pending = None, [], {}, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name is not None:
                yield name, insns, labels
            name, insns, labels, pending = m.group(1), [], {}, []
            continue
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSN.search(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    if name is not None:
        yield name, insns, labels


def summary(insns, labels) -> dict:
    ops = [op for _, op, _ in insns if op != "NOP"]

    def count(prefixes, among=ops):
        return sum(op.split(".")[0] in prefixes for op in among)

    loops = []
    for addr, op, rest in insns:
        m = TARGET.search(rest)
        if not op.startswith("BRA") or not m:
            continue
        start = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if start is not None and start < addr:
            body = [o for a, o, _ in insns if start <= a <= addr and o != "NOP"]
            loops.append({"from": hex(start), "to": hex(addr),
                          "instructions": len(body),
                          "local": count(("LDL", "STL"), body),
                          "shared": count(("LDS", "STS"), body),
                          "brx": count(("BRX",), body)})
    loops.sort(key=lambda lp: lp["instructions"])
    return {"instructions": len(ops), "local": count(("LDL", "STL")),
            "shared": count(("LDS", "STS")),
            "global": count(("LDG", "STG")), "brx": count(("BRX",)),
            "loops": loops}


def main(argv) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", argv[1]], check=True,
                          capture_output=True, text=True).stdout
    for name, insns, labels in functions(text):
        if any(n in name for n in argv[2:]):
            print(json.dumps({"function": name, **summary(insns, labels)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
