"""SQL rule engine.

A port of the JAX package's ``rules`` package, itself modelled on
EMQX's `emqx_rule_engine` (apps/emqx_rule_engine/src/): rules are SQL
statements whose FROM topics are matched per message through the shared
topic index (emqx_rule_engine.erl:226-231) and whose WHERE/SELECT run
per match (emqx_rule_runtime.erl:60-100).  Here FROM filters are
compiled into the *same* match-engine automaton as subscriptions
(distinct fid class), and the registry's WHERE predicates compile to
one stacked program that the rules x window kernel
(`ops.match_kernel.rules_eval_batch`) evaluates per publish window,
with the interpreter as referee.
"""

from .engine import Rule, RuleEngine  # noqa: F401
from .sql import SqlError, parse_sql  # noqa: F401
