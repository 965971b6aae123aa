#!/usr/bin/env bash
# Run N pairs of whole `python3 chip_smoke.py` processes of two trees
# on one card, alternating which tree goes first (the parent first in
# odd pairs), with the card's clocks, power and temperature read before
# each process.
#
#     tools/ab_pairs.sh PARENT_DIR CHANGE_DIR N OUT_DIR
#
# Each run's output goes to OUT_DIR/NN_parent.txt or NN_change.txt;
# summarise them with
#     python tools/ab_summary.py 'OUT_DIR/*_parent.txt' 'OUT_DIR/*_change.txt'
set -u
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
n=$3
out=$4
mkdir -p "$out"
out=$(cd "$out" && pwd)
run() {  # tree, label, pair
  local f
  f=$(printf '%s/%02d_%s.txt' "$out" "$3" "$2")
  nvidia-smi --query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu \
    --format=csv,noheader > "$f"
  (cd "$1" && python3 chip_smoke.py) >> "$f" 2>&1
  echo "pair $3 $2: rc=$? $(head -n 1 "$f") $(tail -n 1 "$f" | cut -c1-40)"
}
for i in $(seq 1 "$n"); do
  if [ $((i % 2)) -eq 1 ]; then
    run "$parent" parent "$i"; run "$change" change "$i"
  else
    run "$change" change "$i"; run "$parent" parent "$i"
  fi
done
