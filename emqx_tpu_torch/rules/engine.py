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
semantics), console, and arbitrary Python callables.  The JAX package's
sink and aggregate actions wait for its resource manager and
aggregator.

Execution is window-at-a-time: `apply_batch` decodes the dispatch window
ONCE into shared column planes and evaluates every lowerable rule's
WHERE as one rules x window boolean matrix
(`ops.match_kernel.rules_eval_batch`: the CUDA kernel on the card, its
plain PyTorch version on the CPU).  Non-lowerable predicates degrade per
RULE to the interpreter over the same lazily materialized envs, never
pushing the window off the matrix path.  ``eval_force = "scalar"`` (or
the broker's ``engine.rules_matrix = False``) pins the per-rule
interpreter walk, the referee the matrix path must equal.
"""

from __future__ import annotations

import logging
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..message import Message
from .columns import WindowColumns
from .predicate import StackedRules, build_stack
from .runtime import LazyEnv, build_env, eval_select, eval_where
from .select import compile_template
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
        self._stats = {
            "matrix_windows": 0, "scalar_windows": 0,
            "fallback_rule_evals": 0,
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
        # precompile every action template ONCE at rule-add
        for a in rule.actions:
            if isinstance(a, RepublishAction):
                a._topic_prog = compile_template(a.topic)
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

    def apply_batch(self, items: List[Tuple[Message, List[str]]]) -> int:
        """Run rule hits for a whole dispatch window in ONE registry
        pass: the window's messages decode once into shared column
        planes (`WindowColumns`), every lowerable rule's WHERE
        evaluates as a row of the stacked rules x window boolean
        matrix, and only non-lowerable rules (regex/UDF-shaped calls,
        CASE) degrade — per RULE, not per window — to the interpreter
        over the SAME lazily-materialized envs.  Matched/passed/failed
        counters update once per rule and broker metrics flush in one
        pass."""
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
        if use_matrix:
            stack = self._stacked()
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
        if use_matrix:
            known = prow >= 0
            active = np.unique(prow[known])
            if active.size:
                cols = WindowColumns(
                    msgs, stack.paths, stack.lit_strings, envs,
                )
                # a literal NaN payload value aliases the num lane's
                # not-a-number sentinel: this window's rules take the
                # interpreter
                if not cols.has_nan_value:
                    matrix = self._matrix(stack, cols, active)
                    self._stats["matrix_windows"] += 1
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
            ppos_l = ppos.tolist()
            pmsg_l = pmsg.tolist()
            for j in sel[order].tolist():
                rule = objs[ppos_l[j]]
                if not rule.actions:
                    # nothing consumes the SELECT columns: skip the
                    # per-hit projection (counter-only rules)
                    continue
                i = pmsg_l[j]
                selected = eval_select(rule.parsed, env(i))
                self._run_actions(rule, selected, msgs[i], mloc)
        if hits:
            mloc["rules.matched"] += hits
        if self.broker is not None and mloc:
            self.broker.metrics.inc_bulk(mloc)
        return hits

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
        the path window counts and, once a matrix window has run, the
        evaluator's per-device window counts."""
        stack = self._stacked()
        out: Dict[str, Any] = {
            "rules": len(self.rules),
            "lowered": stack.n_lowered,
            "program_rows": stack.n_rules,  # after program dedup
            "fallback": len(stack.fallback),
            **self._stats,
        }
        ev = (self.broker.router.engine.rules_evaluator
              if self.broker is not None else self._evaluator)
        if ev is not None:
            c = ev.counters
            out["host_windows"] = c["rules_host_windows"]
            out["dev_windows"] = c["rules_dev_windows"]
        return out
