#!/usr/bin/env python3
"""Sweep K6's launch shape on the card: messages a lane and threads a
block of ``emqx_tpu_torch/ops/csrc/predicate_kernels.cu``.

    python tools/k6_sweep.py [--per 1,2,4] [--threads 32,64,128]

Run from the repository root on a machine with a CUDA card.  Each
variant is the kernel source built with ``-DK6_PER=p -DK6_THREADS=t``
(one ``nvcc`` per variant, all started together, into
``emqx_tpu_torch/ops/build/k6_sweep/``) and loaded on its own.  On
config 4's longest compiled rule over chip_smoke.py's window of 4,096
messages, and over that window tiled to 262,144, every variant is held
against the plain version and then timed: CUDA events over launches
back to back, and the same queued behind a spin kernel (the device
time).  It prints the device time of an empty launch
(``torch.cuda._sleep(0)`` queued the same way), ptxas's registers and
stack frame per variant, one line per variant and size, and one JSON
line with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(variants):
    """One library a variant: ``{(per, threads): (path, ptxas log)}``."""
    from emqx_tpu_torch.ops import _kernels

    src = os.path.join(_kernels._HERE, "csrc", "predicate_kernels.cu")
    out = os.path.join(_kernels.BUILD_DIR, "k6_sweep")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for per, threads in variants:
        lib = os.path.join(out, f"libk6_p{per}_t{threads}.so")
        procs[(per, threads)] = (lib, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, f"-DK6_PER={per}",
             f"-DK6_THREADS={threads}", "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = (lib, log)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--per", default="1,2,4")
    ap.add_argument("--threads", default="32,64,128")
    opt = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from emqx_tpu_torch.ops import match_kernel as mk
    from emqx_tpu_torch.rules import predicate as P

    if not torch.cuda.is_available():
        print("k6_sweep: CUDA is not available", file=sys.stderr)
        return 1
    card = cs.phase_device()
    variants = [(int(p), int(t)) for p in opt.per.split(",")
                for t in opt.threads.split(",")]
    libs = build(variants)
    progs, envs = cs.predicate_window()
    lens = [(len(P.lower_predicate(p.where, p.var_paths).steps), rid, p)
            for rid, p in progs]
    n_steps, rid, prog = max(lens, key=lambda x: x[0])
    cols, sdict = prog.extract_columns(envs)
    lit_ids = P._literal_ids(prog.where, sdict)
    windows = {cs.RULES_W: cols, cs.RULES_W * cs.PRED_STRESS_TILES: {
        k: np.tile(v, cs.PRED_STRESS_TILES) for k, v in cols.items()}}
    empty_ms = cs.cuda_ms(lambda: torch.cuda._sleep(0), 50, 5, queued=True)
    print(f"empty launch (torch.cuda._sleep(0), queued): device "
          f"{empty_ms:.4f} ms [{card}]", flush=True)
    rows = []
    for (per, threads), (path, log) in sorted(libs.items()):
        name = f"per={per} threads={threads}"
        ptx = cs.ptxas_table(log)
        regs = {n: (row.get("regs"), row.get("stack"), row.get("spill"))
                for (name, n), row in ptx.items()
                if name == "predicate_eval_kernel"}
        print(f"K6 {name}: ptxas (registers, stack, "
              f"spills) by numeric slots {dict(sorted(regs.items()))}",
              flush=True)
        lib = ctypes.CDLL(path)
        fn = lib.emqx_predicate_eval
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        for w, c in windows.items():
            args, slots = cs.predicate_args(prog, c, lit_ids)
            out = torch.empty(w, dtype=torch.bool, device="cuda")
            ptrs = [ctypes.c_void_p(t.data_ptr()) for t in args[:2]]
            vals = [ctypes.c_void_p(t.data_ptr()) for t in args[3:6]]
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

            def launch():
                rc = fn(*ptrs, args[0].shape[0], args[2], *vals,
                        args[3].shape[0], ctypes.c_void_p(args[6].data_ptr()),
                        args[6].shape[0], w, slots,
                        ctypes.c_void_p(out.data_ptr()), stream)
                if rc:
                    raise RuntimeError(f"launch failed ({rc})")

            launch()
            cs.exact_equal(f"k6 sweep {name} W={w}",
                           (out,), (mk.predicate_eval_plain(*args),))
            ms = cs.cuda_ms(launch, 50, 5)
            dev_ms = cs.cuda_ms(launch, 50, 5, queued=True)
            print(f"K6 {name} {rid} S={n_steps} "
                  f"W={w}: kernel {ms:.4f} ms, device {dev_ms:.4f} ms "
                  f"[{card}]", flush=True)
            rows.append(dict(per=per, threads=threads, w=w, ms=ms,
                             device_ms=dev_ms, ptxas=regs.get(next(
                                 n for n in (2, 4, 8, 16) if n >= slots))))
    print(json.dumps({"k6_sweep": rows, "rule": rid, "steps": n_steps,
                      "empty_launch_ms": empty_ms, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
