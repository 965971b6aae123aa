"""The rules x window evaluator: the registry's stacked WHERE program
over one window's column planes, on one device.

The broker's match engine holds one (its ``rules_evaluator``), so the
matrix runs on the engine's device; a standalone `RuleEngine` builds
its own.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np

from ..ops.match_kernel import rules_eval_batch, rules_eval_lowered
from ..ops.rules_lowering import LoweredRules, lower_rules
from ..state import (
    HostStage, columns_from_reference, resolve_device,
    rules_program_from_reference,
)


class RulesEvaluator:
    """Evaluates `predicate.StackedRules` over `columns.WindowColumns`
    on ``device``; on a card the lowered program is cached per rules
    rev."""

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)
        # (rules rev, the lowered WHERE program on the device)
        self._prog: Optional[Tuple[int, LoweredRules]] = None
        self._stage = HostStage(self.device)
        self._lock = threading.Lock()  # the stage, from fill to download
        self.counters = {"rules_host_windows": 0, "rules_dev_windows": 0}

    def eval_window(self, stack, rev: int, cols, rows=None):
        """``(matrix, path)``: the ``[n_rules, n_msgs]`` bool pass
        matrix of ``stack`` (``rev``, the rule engine's mutation
        counter) over ``cols``.

        On the card the program is lowered and uploaded once per
        ``rev``; per window the planes and literal ranks go up in one
        copy from a pinned buffer, the rules kernel evaluates every row
        (the JAX engine's device path) and the matrix comes down in one
        copy, after one synchronise.  ``rows``, the matrix rows whose
        rules matched this window, is not needed there.  On the CPU the
        plain version evaluates just ``rows`` and scatters them back, as
        the JAX engine's host twin does.  Both compute in float64, so no
        window needs another route.

        Only the planes of ``stack.paths`` go to the kernel: they are a
        prefix of ``cols``' rows, which the SELECT lane extends with
        the paths only a SELECT reads (a row prefix of a C-ordered
        plane is contiguous)."""
        r_n, w_n = stack.n_rules, cols.n
        k = len(stack.paths)
        dev = self.device
        if dev.type == "cpu":
            self.counters["rules_host_windows"] += 1
            mat = np.zeros((r_n, w_n), bool)
            sel = (np.arange(r_n) if rows is None
                   else np.asarray(rows, dtype=np.int64))
            if sel.size and w_n:
                prog = rules_program_from_reference(
                    *(a[sel] for a in (stack.code, stack.a0, stack.a1,
                                       stack.a2, stack.a3, stack.litn,
                                       stack.last)), dev,
                )
                planes = columns_from_reference(
                    cols.num[:k], cols.sid[:k], cols.err[:k],
                    cols.prs[:k], cols.lit_ranks, dev)
                mat[sel] = rules_eval_batch(
                    prog.code, prog.a0, prog.a1, prog.a2, prog.a3,
                    prog.litn, planes.lit_ranks, prog.last, planes.num,
                    planes.sid, planes.err, planes.prs,
                ).numpy()
            return mat, "host"
        self.counters["rules_dev_windows"] += 1
        cache = self._prog
        if cache is None or cache[0] != rev:
            cache = self._prog = (rev, lower_rules(
                stack.code, stack.a0, stack.a1, stack.a2, stack.a3,
                stack.litn, stack.last, dev, n_lits=len(stack.lit_strings),
            ))
        return self._eval(cache[1], cols, k), "dev"

    def _eval(self, prog: LoweredRules, cols, p: int) -> np.ndarray:
        """K4 over the first ``p`` planes of ``cols``."""
        w = cols.n
        with self._lock:
            host = self._stage.views([
                (np.float64, (p, w)), (np.int32, (p, w)),
                (np.int32, (cols.lit_ranks.size,)), (bool, (p, w)),
                (bool, (p, w)),
            ])
            for dst, src in zip(host, (cols.num[:p], cols.sid[:p],
                                       cols.lit_ranks, cols.err[:p],
                                       cols.prs[:p])):
                dst[...] = src
            num, sid, lit_ranks, err, prs = self._stage.upload()
            mat = rules_eval_lowered(prog, lit_ranks, num, sid, err, prs)
            return self._stage.download(mat)[0]
