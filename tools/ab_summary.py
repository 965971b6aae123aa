#!/usr/bin/env python3
"""Summarise an A/B of whole ``chip_smoke.py`` runs of two trees.

    python tools/ab_summary.py 'DIR/*_parent.txt' 'DIR/*_this.txt'

Each argument is a glob of saved ``chip_smoke.py`` outputs, one file a
run; files are paired in sorted order (run i of the parent with run i
of the change).  For each kernel time line both trees print (``time
<name> [<label>] <sizes>: kernel X ms (device Y ms ... wrapper ... Z
ms``, keyed by the name, the label and the first size) and for
the broker's end-to-end numbers, it prints one JSON line: the median
and quartiles of each tree, and in how many pairs the change was better
(lower for times, higher for rates; ties count for neither).
"""

from __future__ import annotations

import glob
import json
import re
import statistics
import sys

TIME = re.compile(r"^time (\w+) ([\w (),]*?)((?:[A-Z]=\d+ ?)+): kernel "
                  r"([\d.]+) ms \(device ([\d.]+) ms.*?wrapper.*?([\d.]+) ms")
END_TO_END = (  # (name, pattern, higher is better)
    ("broker msgs/s in", re.compile(r"^broker: .* ([\d.]+) msgs/s in"), True),
    ("broker p50 ms", re.compile(r"^broker: .*latency p50 ([\d.]+) ms"),
     False),
    ("rules broker msgs/s in",
     re.compile(r"^rules broker: \d+ QoS .* ([\d.]+) msgs/s in"), True),
    ("rules lap ms", re.compile(r"rules lap ([\d.]+) ms per window"), False),
)


def metrics(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            m = TIME.match(line)
            if m:  # keyed by the name, the label and the first size
                key = " ".join((m.group(1), *m.group(2).split(),
                                m.group(3).split()[0]))
                for what, v in zip(("event", "device", "wrapper"),
                                   m.group(4, 5, 6)):
                    out[f"{key} {what}"] = float(v)
                continue
            for name, pat, _ in END_TO_END:
                m = pat.search(line)
                if m:
                    out[name] = float(m.group(1))
    return out


def quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return [statistics.median(xs), q[0], q[2]]


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a_runs = [metrics(p) for p in sorted(glob.glob(argv[1]))]
    b_runs = [metrics(p) for p in sorted(glob.glob(argv[2]))]
    pairs = list(zip(a_runs, b_runs))
    higher = {name: hi for name, _, hi in END_TO_END}
    keys = sorted(set().union(*a_runs) & set().union(*b_runs))
    for key in keys:
        both = [(a[key], b[key]) for a, b in pairs if key in a and key in b]
        if len(both) < 2:
            continue
        better = (lambda a, b: b > a) if higher.get(key) else (
            lambda a, b: b < a)
        print(json.dumps({
            "metric": key, "pairs": len(both),
            "parent": quartiles([a for a, _ in both]),
            "change": quartiles([b for _, b in both]),
            "change_wins": sum(better(a, b) for a, b in both),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
