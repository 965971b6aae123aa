"""Rule registry + execution, wired into the broker's match step.

A port of the JAX package's ``rules/engine.py``, which mirrors EMQX's
`emqx_rule_engine` (apps/emqx_rule_engine/src/emqx_rule_engine.erl):
each rule's FROM filters register in the topic index (:536
`emqx_topic_index:insert` into ?RULE_TOPIC_INDEX) and per-message lookup
is a match over that index (:226-231 `get_rules_for_topic`).  Here the
rule filters go into the *same* MatchEngine as subscriptions under a
distinct fid class ``("rule", rule_id, i)``, so one batched match
returns routes and rule hits together; `Broker._dispatch_window` splits
the classes.

Actions: republish (with ${var} placeholder templates, `emqx_placeholder`
semantics), console, arbitrary Python callables, and the egress
actions: a sink (the broker's `resources.ResourceManager` buffer
worker under a resource id) and an aggregate (`aggregator.Aggregator`).

Execution is window-at-a-time: `apply_batch` decodes the dispatch window
ONCE into shared column planes and evaluates every lowerable rule's
WHERE as one rules x window boolean matrix
(`ops.match_kernel.rules_eval_batch`: the CUDA kernel on the card, its
plain PyTorch version on the CPU).  Non-lowerable predicates degrade per
RULE to the interpreter over the same lazily materialized envs, never
pushing the window off the matrix path.  ``eval_force = "scalar"`` (or
the broker's ``engine.rules_matrix = False``) pins the per-rule
interpreter walk, the referee the matrix path must equal.

The output half mirrors it: a rule whose SELECT lowers
(`select.build_select_stack`) and whose actions are all sinks or
aggregates takes the batched SELECT lane — its matched rows
materialize from raw-value planes of the same `WindowColumns` walk
(`select.materialize_rows`) and leave as ONE `enqueue_batch` per sink
and ONE `push` per aggregator a window.  Other rules take the scalar
lane (`eval_select` per row).  A cost EWMA per lane trips the batched
lane off when it measures slower (re-armed by registry churn);
``select_force`` pins ``"batched"`` or ``"scalar"``.
"""

from __future__ import annotations

import json as _json
import logging
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..message import Message
from .columns import WindowColumns
from .predicate import StackedRules, build_stack
from .runtime import LazyEnv, build_env, eval_select, eval_where
from .select import (
    SelectStack, build_select_stack, compile_template, materialize_rows,
)
from .sql import ParsedSql, parse_sql

log = logging.getLogger("emqx_tpu_torch.rules")

RULE_FID = "rule"  # fid class tag

# republish chains are legal but must terminate (EMQX relies on operator
# care; this engine hard-caps recursion)
MAX_REPUBLISH_DEPTH = 8


def render_template(template: str, data: Dict[str, Any]) -> str:
    """${a.b} placeholder substitution (emqx_placeholder parity)."""
    return compile_template(template).render(data)


@dataclass
class RepublishAction:
    topic: str  # template
    payload: str = "${payload}"  # template
    qos: int = 0
    retain: bool = False

    kind: str = "republish"


@dataclass
class ConsoleAction:
    kind: str = "console"


@dataclass
class FunctionAction:
    fn: Callable[[Dict[str, Any], Message], None]
    kind: str = "function"


@dataclass
class SinkAction:
    """Forward the rule output to a registered resource's buffer worker
    (the bridge/action path: emqx_resource buffered IO).  The payload
    template renders against the SELECTed columns; None sends them as
    JSON."""

    resource_id: str
    payload: Optional[str] = None  # template; None => selected as JSON
    kind: str = "sink"


@dataclass
class AggregateAction:
    """Push the SELECTed columns into an Aggregator (the
    emqx_connector_aggregator path: records batch into time-bucketed
    CSV/JSONL objects and flush to the aggregator's delivery sink)."""

    aggregator: Any  # aggregator.Aggregator
    kind: str = "aggregate"


Action = Any


@dataclass
class Rule:
    rule_id: str
    sql: str
    parsed: ParsedSql
    actions: List[Action] = field(default_factory=list)
    enabled: bool = True
    description: str = ""
    # counters (emqx_rule_metrics)
    matched: int = 0
    passed: int = 0
    failed: int = 0
    actions_success: int = 0
    actions_failed: int = 0

    def metrics(self) -> Dict[str, int]:
        return {
            "matched": self.matched,
            "passed": self.passed,
            "failed": self.failed,
            "actions.success": self.actions_success,
            "actions.failed": self.actions_failed,
        }


class RuleEngine:
    """The rule registry.  With a ``broker`` the FROM filters live in its
    match engine and the WHERE matrix runs on the engine's device;
    standalone (tests, tools) the matrix runs on ``device``."""

    def __init__(self, broker=None, device="cuda") -> None:
        self.broker = broker
        self.device = device
        self._evaluator = None  # standalone: built at first window
        self.rules: Dict[str, Rule] = {}
        # registry mutation counter: the stacked matrix program and the
        # match engine's device program cache both key on it, so
        # add/remove/enable churn invalidates them coherently
        self.rules_rev = 0
        self._stack_cache: Optional[Tuple[int, StackedRules]] = None
        # "scalar" pins the per-rule interpreter referee; None takes
        # the matrix path
        self.eval_force: Optional[str] = None
        # the broker's ``engine.rules_matrix = False`` pins it as well
        self._matrix_enabled = (broker is None
                                or broker.config.engine.rules_matrix)
        # SELECT lane pin: "scalar" keeps the interpreter referee for
        # every rule's SELECT+actions, "batched" pins the column
        # transform past the cost gate, None auto (EWMA-gated)
        self.select_force: Optional[str] = None
        self._sel_cache: Optional[Tuple[int, SelectStack]] = None
        # cost-EWMA gate state: per-row us for each lane, sampled on
        # single-lane windows only; tripping the breaker pins scalar
        # until registry churn
        self._sel_batch_off = False
        self._sel_us_b: Optional[float] = None
        self._sel_us_s: Optional[float] = None
        self._sel_n_b = 0
        self._sel_n_s = 0
        self._stats = {
            "matrix_windows": 0, "scalar_windows": 0,
            "fallback_rule_evals": 0,
            "select_batched_rows": 0, "select_scalar_rows": 0,
            "select_ewma_off": 0,
        }
        # rev-keyed flatten tables: a stable position per rule (the
        # REGISTRY enumeration order — deterministic, so action order
        # is reproducible across paths and runs), its Rule object /
        # liveness / matrix row resolved once per rev, and a cache
        # mapping each distinct raw id-list the router's expansion
        # emits to its deduped position array — same-topic messages
        # share one entry
        self._flat_key: Optional[Tuple[int, bool]] = None
        self._pos_objs: List[Rule] = []
        self._pos_live = np.zeros(0, bool)
        self._pos_row = np.zeros(0, np.int64)
        self._pos_of: Dict[str, int] = {}
        self._ids_cache: Dict[Tuple[str, ...], np.ndarray] = {}
        # per-position batched-egress plan: (SelectProgram, planes)
        # when the rule's SELECT lowered AND every action is window-
        # shaped (Sink/Aggregate); None degrades the rule to the
        # scalar referee loop
        self._pos_selp: List[Optional[tuple]] = []

    # ------------------------------------------------------ registry

    def _stacked(self) -> StackedRules:
        """The enabled registry's stacked WHERE program, rebuilt only
        when ``rules_rev`` moved (registry churn invalidates)."""
        cached = self._stack_cache
        if cached is not None and cached[0] == self.rules_rev:
            return cached[1]
        stack = build_stack([
            (rid, r.parsed.where)
            for rid, r in self.rules.items()
            if r.enabled
        ])
        self._stack_cache = (self.rules_rev, stack)
        return stack

    def _select_stack(self, stack: StackedRules) -> SelectStack:
        """The enabled registry's lowered SELECT programs, sharing the
        WHERE stack's path union (SELECT-only paths are APPENDED, so
        the WHERE rows' plane indices survive)."""
        cached = self._sel_cache
        if cached is not None and cached[0] == self.rules_rev:
            return cached[1]
        sel = build_select_stack(
            [
                (rid, r.parsed)
                for rid, r in self.rules.items()
                if r.enabled
            ],
            stack.paths,
        )
        self._sel_cache = (self.rules_rev, sel)
        return sel

    def add_rule(
        self,
        rule_id: str,
        sql: str,
        actions: Optional[List[Action]] = None,
        enabled: bool = True,
        description: str = "",
    ) -> Rule:
        # validate fully BEFORE touching the registry/index, so a bad
        # update cannot destroy or half-register a live rule
        parsed = parse_sql(sql)
        from .. import topic as T

        for flt in parsed.froms:
            T.validate_filter(flt)
        if rule_id in self.rules:
            self.remove_rule(rule_id)
        rule = Rule(
            rule_id=rule_id,
            sql=sql,
            parsed=parsed,
            actions=list(actions or ()),
            enabled=enabled,
            description=description,
        )
        # precompile every action template ONCE at rule-add; both the
        # batched transform and the scalar referee render through the
        # attached programs
        for a in rule.actions:
            if isinstance(a, RepublishAction):
                a._topic_prog = compile_template(a.topic)
                a._payload_prog = compile_template(a.payload)
            elif isinstance(a, SinkAction) and a.payload is not None:
                a._payload_prog = compile_template(a.payload)
        self.rules[rule_id] = rule
        self.rules_rev += 1
        if self.broker is not None:
            eng = self.broker.router.engine
            for i, flt in enumerate(parsed.froms):
                eng.insert(flt, (RULE_FID, rule_id, i))
        return rule

    def remove_rule(self, rule_id: str) -> bool:
        rule = self.rules.pop(rule_id, None)
        if rule is None:
            return False
        self.rules_rev += 1
        if self.broker is not None:
            eng = self.broker.router.engine
            for i in range(len(rule.parsed.froms)):
                eng.delete((RULE_FID, rule_id, i))
        return True

    def enable_rule(self, rule_id: str, enabled: bool) -> None:
        self.rules[rule_id].enabled = enabled
        self.rules_rev += 1

    # ----------------------------------------------------- execution

    def apply(self, msg: Message, rule_ids: List[str]) -> int:
        """Run the listed rules against one message; returns how many
        passed their WHERE (emqx_rule_runtime:apply_rules/3)."""
        if not rule_ids:
            return 0
        env = build_env(msg)
        hits = 0
        for rid in rule_ids:
            rule = self.rules.get(rid)
            if rule is None or not rule.enabled:
                continue
            rule.matched += 1
            if not eval_where(rule.parsed.where, env):
                rule.failed += 1
                continue
            rule.passed += 1
            hits += 1
            selected = eval_select(rule.parsed, env)
            self._run_actions(rule, selected, msg)
        if self.broker is not None and hits:
            self.broker.metrics.inc("rules.matched", hits)
        return hits

    def _matrix(self, stack: StackedRules, cols: WindowColumns,
                active: np.ndarray) -> np.ndarray:
        """The window's ``[n_rules, n_msgs]`` pass matrix, on the
        broker's match engine (standalone: on ``self.device``)."""
        ev = self._rules_evaluator()
        return ev.eval_window(stack, self.rules_rev, cols, rows=active)[0]

    def _rules_evaluator(self):
        if self.broker is not None:
            return self.broker.router.engine.rules_evaluator
        if self._evaluator is None:
            # imported here: the kernel module takes its opcodes from
            # this package
            from .evaluator import RulesEvaluator

            self._evaluator = RulesEvaluator(self.device)
        return self._evaluator

    def apply_batch(
        self, items: List[Tuple[Message, List[str]]], rec=None
    ) -> int:
        """Run rule hits for a whole dispatch window in ONE registry
        pass: the window's messages decode once into shared column
        planes (`WindowColumns`), every lowerable rule's WHERE
        evaluates as a row of the stacked rules x window boolean
        matrix, and only non-lowerable rules (regex/UDF-shaped calls,
        CASE) degrade — per RULE, not per window — to the interpreter
        over the SAME lazily-materialized envs.  Matched/passed/failed
        counters update once per rule and broker metrics flush in one
        pass.  Passing rules with a batched plan take the SELECT lane
        (`_run_rule_batched`), the rest the scalar lane.

        ``rec`` (the window's profiler record) takes ``rules_extract``
        / ``rules_eval`` sub-stages: column extraction vs matrix
        evaluation inside the ``rules`` lap."""
        if not items:
            return 0
        msgs = [m for m, _ in items]
        n = len(msgs)
        envs: List[Optional[LazyEnv]] = [None] * n

        def env(i: int) -> LazyEnv:
            e = envs[i]
            if e is None:
                e = envs[i] = LazyEnv(msgs[i])
            return e

        # flatten the sink to (rule-position, msg) pair columns over
        # the rev-stable position space (see __init__)
        use_matrix = self._matrix_enabled and self.eval_force != "scalar"
        stack: Optional[StackedRules] = None
        selstack: Optional[SelectStack] = None
        if use_matrix:
            stack = self._stacked()
            selstack = self._select_stack(stack)
        key = (self.rules_rev, use_matrix)
        if self._flat_key != key:
            self._flat_key = key
            objs = list(self.rules.values())
            n_all = len(objs)
            self._pos_objs = objs
            self._pos_of = {
                r.rule_id: k for k, r in enumerate(objs)
            }
            self._pos_live = np.fromiter(
                (r.enabled for r in objs), bool, n_all
            )
            row_of = stack.row_of if stack is not None else {}
            self._pos_row = np.fromiter(
                (
                    row_of.get(r.rule_id, -1) if r.enabled else -1
                    for r in objs
                ),
                np.int64, n_all,
            )
            self._ids_cache = {}
            sel_progs = selstack.progs if selstack is not None else {}
            self._pos_selp = [
                (
                    (sel_progs[r.rule_id], selstack.planes[r.rule_id])
                    if r.enabled and r.rule_id in sel_progs
                    and r.actions
                    and all(
                        isinstance(a, (SinkAction, AggregateAction))
                        for a in r.actions
                    )
                    else None
                )
                for r in objs
            ]
            # registry churn re-arms the SELECT cost gate
            self._sel_batch_off = False
        objs = self._pos_objs
        n_pos = len(objs)
        pos_of = self._pos_of
        cache = self._ids_cache
        parts: List[np.ndarray] = []
        lens: List[int] = []
        for _, rids in items:
            ck = tuple(rids)
            arr = cache.get(ck)
            if arr is None:
                if len(cache) > 4096:
                    cache.clear()
                arr = cache[ck] = np.unique(np.fromiter(
                    (
                        pos_of[r] for r in rids if r in pos_of
                    ),
                    np.int64,
                ))
            parts.append(arr)
            lens.append(arr.size)
        ppos = (
            np.concatenate(parts) if parts
            else np.zeros(0, np.int64)
        )
        pmsg = np.repeat(np.arange(n, dtype=np.int64), lens)
        plive = self._pos_live[ppos]
        prow = self._pos_row[ppos]
        matrix = None
        cols: Optional[WindowColumns] = None
        if use_matrix:
            known = prow >= 0
            active = np.unique(prow[known])
            # SELECT lane decision: extract the combined WHERE+SELECT
            # path union (the WHERE rows' plane indices are a prefix,
            # which is all the rules kernel reads) and keep raw values
            # whenever some live matched rule has a batched plan
            use_all = (
                selstack.n_lowered > 0
                and self.select_force != "scalar"
                and (
                    self.select_force == "batched"
                    or not self._sel_batch_off
                )
            )
            batch_sel = False
            if use_all and ppos.size:
                selp = self._pos_selp
                batch_sel = any(
                    selp[p] is not None
                    for p in np.unique(ppos[plive]).tolist()
                )
            if active.size or batch_sel:
                t0 = time.perf_counter()
                cols = WindowColumns(
                    msgs,
                    selstack.all_paths if use_all else stack.paths,
                    stack.lit_strings, envs,
                    keep_values=batch_sel,
                )
                t1 = time.perf_counter()
                # a literal NaN payload value aliases the num lane's
                # not-a-number sentinel: this window's rules take the
                # interpreter
                if active.size and not cols.has_nan_value:
                    matrix = self._matrix(stack, cols, active)
                    self._stats["matrix_windows"] += 1
                    if rec is not None:
                        t2 = time.perf_counter()
                        rec.sub("rules_extract", t1 - t0)
                        rec.sub("rules_eval", t2 - t1)
        if matrix is None:
            self._stats["scalar_windows"] += 1
            known = np.zeros(len(ppos), bool)
        passmask = np.zeros(len(ppos), bool)
        if matrix is not None:
            passmask[known] = matrix[prow[known], pmsg[known]]
        # per-RULE interpreter fallback riding the shared lazy envs
        # (one JSON decode per message, window-wide)
        fb = np.nonzero(plive & ~known)[0]
        if fb.size:
            self._stats["fallback_rule_evals"] += int(fb.size)
            ppos_l = ppos.tolist()
            pmsg_l = pmsg.tolist()
            for j in fb.tolist():
                rule = objs[ppos_l[j]]
                passmask[j] = eval_where(
                    rule.parsed.where, env(pmsg_l[j])
                )
        passmask &= plive
        # matched/passed/failed flush: ONE bincount pass over the pair
        # columns, one += per rule TOUCHED this window
        m_cnt = np.bincount(ppos[plive], minlength=n_pos)
        p_cnt = np.bincount(ppos[passmask], minlength=n_pos)
        touched = np.nonzero(m_cnt)[0]
        for pos, mc, pc in zip(
            touched.tolist(),
            m_cnt[touched].tolist(),
            p_cnt[touched].tolist(),
        ):
            rule = objs[pos]
            rule.matched += mc
            rule.passed += pc
            rule.failed += mc - pc
        hits = int(passmask.sum())
        mloc: Counter = Counter()  # one metrics flush per window
        sel = np.nonzero(passmask)[0]
        if sel.size:
            # canonical action order: rule-major in REGISTRY order,
            # message index ascending within a rule — identical across
            # the matrix and scalar-referee paths
            order = np.lexsort((pmsg[sel], ppos[sel]))
            sel_l = sel[order].tolist()
            ppos_l = ppos.tolist()
            pmsg_l = pmsg.tolist()
            selp = self._pos_selp
            use_batched = cols is not None and cols.vals is not None
            t_act0 = time.perf_counter()  # hoisted (no clocks in loop)
            rows_b = 0
            rows_s = 0
            k = 0
            n_sel = len(sel_l)
            while k < n_sel:
                # consecutive run of pairs for ONE rule (sel_l is
                # rule-major after the lexsort)
                pos = ppos_l[sel_l[k]]
                k2 = k + 1
                while k2 < n_sel and ppos_l[sel_l[k2]] == pos:
                    k2 += 1
                rule = objs[pos]
                if not rule.actions:
                    # nothing consumes the SELECT columns: skip the
                    # per-hit projection (counter-only rules)
                    k = k2
                    continue
                plan = selp[pos] if use_batched else None
                if plan is not None:
                    rows = [pmsg_l[sel_l[t]] for t in range(k, k2)]
                    self._run_rule_batched(rule, plan, cols, rows, mloc)
                    rows_b += k2 - k
                else:
                    for t in range(k, k2):
                        i = pmsg_l[sel_l[t]]
                        selected = eval_select(rule.parsed, env(i))
                        self._run_actions(rule, selected, msgs[i], mloc)
                    rows_s += k2 - k
                k = k2
            self._sel_lane_account(
                rows_b, rows_s, time.perf_counter() - t_act0)
        if hits:
            mloc["rules.matched"] += hits
        if self.broker is not None and mloc:
            self.broker.metrics.inc_bulk(mloc)
        return hits

    def _sel_lane_account(
        self, rows_b: int, rows_s: int, dt: float
    ) -> None:
        """Fold one window's SELECT+action lap into the per-lane cost
        EWMAs (sampled on single-lane windows only, so the figures
        aren't cross-contaminated) and trip the batched lane's cost
        breaker when it measures materially slower than the scalar
        referee — re-armed by registry churn, overridden by
        ``select_force``."""
        if rows_b and not rows_s:
            us = dt * 1e6 / rows_b
            self._sel_us_b = (
                us if self._sel_us_b is None
                else 0.2 * us + 0.8 * self._sel_us_b
            )
            self._sel_n_b += 1
        elif rows_s and not rows_b:
            us = dt * 1e6 / rows_s
            self._sel_us_s = (
                us if self._sel_us_s is None
                else 0.2 * us + 0.8 * self._sel_us_s
            )
            self._sel_n_s += 1
        if rows_b:
            self._stats["select_batched_rows"] += rows_b
        if rows_s:
            self._stats["select_scalar_rows"] += rows_s
        if (
            self.select_force is None
            and not self._sel_batch_off
            and self._sel_n_b >= 16
            and self._sel_n_s >= 16
            and self._sel_us_b is not None
            and self._sel_us_s is not None
            and self._sel_us_b > self._sel_us_s * 1.5
        ):
            self._sel_batch_off = True
            self._stats["select_ewma_off"] += 1

    def _sink_worker(self, action: SinkAction):
        if self.broker is None:
            raise RuntimeError("sink action without a broker")
        worker = self.broker.resources.get(action.resource_id)
        if worker is None:
            raise RuntimeError(f"unknown resource {action.resource_id!r}")
        return worker

    def _run_rule_batched(
        self,
        rule: Rule,
        plan: tuple,
        cols: WindowColumns,
        rows: List[int],
        mloc: Counter,
    ) -> None:
        """One rule's whole matched-row set through its lowered
        SELECT and window-shaped actions: one `materialize_rows` pass
        over the shared column planes, then ONE bulk handoff per
        (action, window) — `BufferWorker.enqueue_batch` for sinks,
        one `Aggregator.push` for aggregate actions.  Counter totals
        and per-sink query streams match the scalar referee exactly
        (same values, same order); only the cross-ACTION interleave
        differs (batched emits action-major within a rule, the scalar
        lane row-major)."""
        prog, planes = plan
        names, colvals = materialize_rows(prog, planes, cols, rows)
        n = len(rows)
        for action in rule.actions:
            try:
                if isinstance(action, AggregateAction):
                    action.aggregator.push([
                        dict(zip(names, row)) for row in zip(*colvals)
                    ])
                else:  # SinkAction (plan eligibility guarantees it)
                    worker = self._sink_worker(action)
                    if action.payload is not None:
                        prog_t = getattr(action, "_payload_prog", None)
                        if prog_t is None:
                            prog_t = compile_template(action.payload)
                        colmap: Dict[str, Any] = {}
                        for nm, col in zip(names, colvals):
                            colmap[nm] = col
                        queries = prog_t.render_rows(colmap, n)
                    else:
                        queries = [
                            _json.dumps(
                                dict(zip(names, row)), default=str
                            )
                            for row in zip(*colvals)
                        ]
                    worker.enqueue_batch(queries)
                rule.actions_success += n
                mloc["actions.success"] += n
                mloc["actions.batched"] += n
            except Exception as exc:
                rule.actions_failed += n
                mloc["actions.failed"] += n
                log.warning(
                    "rule %s batched action %s failed: %s",
                    rule.rule_id,
                    getattr(action, "kind", action),
                    exc,
                )

    def _run_actions(
        self,
        rule: Rule,
        selected: Dict[str, Any],
        msg: Message,
        mloc: Optional[Counter] = None,
    ) -> None:
        for action in rule.actions:
            try:
                self._run_action(action, selected, msg)
                rule.actions_success += 1
                if mloc is not None:
                    mloc["actions.success"] += 1
                elif self.broker is not None:
                    self.broker.metrics.inc("actions.success")
            except Exception as exc:
                rule.actions_failed += 1
                if mloc is not None:
                    mloc["actions.failed"] += 1
                elif self.broker is not None:
                    self.broker.metrics.inc("actions.failed")
                log.warning(
                    "rule %s action %s failed: %s",
                    rule.rule_id,
                    getattr(action, "kind", action),
                    exc,
                )

    def _run_action(
        self, action: Action, selected: Dict[str, Any], msg: Message
    ) -> None:
        if isinstance(action, RepublishAction):
            depth = int(msg.headers.get("republish_depth", 0))
            if depth >= MAX_REPUBLISH_DEPTH:
                raise RuntimeError("republish depth cap hit (rule loop?)")
            tprog = getattr(action, "_topic_prog", None)
            if tprog is None:
                tprog = compile_template(action.topic)
            pprog = getattr(action, "_payload_prog", None)
            if pprog is None:
                pprog = compile_template(action.payload)
            out = Message(
                topic=tprog.render(selected),
                payload=pprog.render(selected).encode(),
                qos=action.qos,
                retain=action.retain,
                from_client=msg.from_client,
                from_username=msg.from_username,
                headers={"republish_depth": depth + 1},
            )
            if self.broker is None:
                raise RuntimeError("republish without a broker")
            self.broker.publish(out)
        elif isinstance(action, ConsoleAction):
            log.info("rule output: %s", selected)
        elif isinstance(action, FunctionAction):
            action.fn(selected, msg)
        elif isinstance(action, AggregateAction):
            action.aggregator.push([selected])
        elif isinstance(action, SinkAction):
            worker = self._sink_worker(action)
            if action.payload is not None:
                pprog = getattr(action, "_payload_prog", None)
                if pprog is None:
                    pprog = compile_template(action.payload)
                query: Any = pprog.render(selected)
            else:
                query = _json.dumps(selected, default=str)
            worker.enqueue(query)
        else:
            raise RuntimeError(f"unknown action {action!r}")

    def info(self) -> List[Dict[str, Any]]:
        return [
            {
                "id": r.rule_id,
                "sql": r.sql,
                "enabled": r.enabled,
                "description": r.description,
                **r.metrics(),
            }
            for r in self.rules.values()
        ]

    def stats(self) -> Dict[str, Any]:
        """The rule-eval gauges: lowered-vs-fallback registry split,
        the path window counts, the SELECT lane's split, row counts,
        cost EWMAs and breaker state and, once a matrix window has run,
        the evaluator's per-device window counts."""
        stack = self._stacked()
        out: Dict[str, Any] = {
            "rules": len(self.rules),
            "lowered": stack.n_lowered,
            "program_rows": stack.n_rules,  # after program dedup
            "fallback": len(stack.fallback),
            "matrix_enabled": self._matrix_enabled,
            **self._stats,
            "select_lowered": self._select_stack(stack).n_lowered,
            "select_batched_us_ewma": self._sel_us_b,
            "select_scalar_us_ewma": self._sel_us_s,
            "select_batch_disabled": self._sel_batch_off,
        }
        ev = (self.broker.router.engine.rules_evaluator
              if self.broker is not None else self._evaluator)
        if ev is not None:
            c = ev.counters
            out["host_windows"] = c["rules_host_windows"]
            out["dev_windows"] = c["rules_dev_windows"]
        return out
