"""emqx_tpu_torch — the MQTT broker's publish path on PyTorch and CUDA.

A port of the ``emqx_tpu`` package (JAX on a TPU, which stays as the
reference) to PyTorch with hand-written CUDA kernels for Hopper.  This
package imports neither JAX nor anything of ``emqx_tpu``.

Layout:
  topic       — topic parse/validate/match semantics
  message     — broker-internal message representation
  codec       — MQTT 3.1/3.1.1/5.0 wire codec
  ops         — token dictionary, automaton assembly, host trie oracle,
                the match/decide kernels (CUDA) and their plain versions
  state       — automaton tables on the device
  engine      — MatchEngine: exact index + wildcard automaton + residual
  router      — subscription registry + CSR fan-out columns
  broker      — sessions, channels, connections, listener, dispatch
  hooks, metrics, access, auth_providers, ops_guard, limiter,
  modules, sys_topics, retainer
              — the broker's control surface: hook chains, counters,
                authentication and ACL, bans, flapping, alarms, slow
                subs, rate limits, delayed publish, topic rewrite and
                metrics, $SYS heartbeats, retained messages
"""
