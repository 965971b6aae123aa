#!/usr/bin/env bash
# Run chip_smoke.py's `exhook broker` phase alone, in whole processes of
# two trees on one card, in the order given (e.g. parent change change
# parent), each run's figures on one `AB {...} {...}` line: msgs/s in,
# the verdict RPC's p50/p99, delivery p50, decide windows, then the
# ring median of each window stage in ms.
#
#     tools/exhook_ab.sh OUT_DIR TREE [TREE ...]
#
# A tree is a checkout holding chip_smoke.py and emqx_tpu_torch/ (unpack
# a parent with `git archive` into .archive/, which .gitignore lists).
# Each tree's first process builds the kernels inside its load.
set -u
out=$1
shift
mkdir -p "$out"
out=$(cd "$out" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
n=0
for tree in "$@"; do
  n=$((n + 1))
  (cd "$tree" && python3 - <<'PY') > "$out/$(printf '%02d' $n).txt" 2>&1
import json
import sys

sys.path.insert(0, ".")
import chip_smoke as CS
from emqx_tpu_torch import workload as W

r = {"kernels": {"match_batch_compact": {}, "decide_batch": {}}}
r["card"] = CS.phase_device()
filters, _ = W.make_filters(1_000_000, 8)
CS.phase_exhook_broker(r, filters)
x = r["exhook"]
print("AB", json.dumps({k: x[k] for k in (
    "msgs_per_s", "rpc_p50_ms", "rpc_p99_ms", "delivery_p50_ms",
    "decide_windows")}), json.dumps({
        k: v["ring_median_ms"] for k, v in x["stages"].items()
        if isinstance(v, dict) and "ring_median_ms" in v}))
PY
  echo "run $n $tree: rc=$? $(grep '^AB' "$out/$(printf '%02d' $n).txt" | cut -c1-160)"
done
