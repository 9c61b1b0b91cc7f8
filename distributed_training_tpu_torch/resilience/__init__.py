"""Resilience (port): fault injection and the serving supervisor.

- ``faults.py`` — deterministic fault injection, a copy of the JAX
  package's (framework-free) module: the plan grammar, ``Fault``,
  ``FaultInjector`` with its one-shot ledger, and the hooks; the engine's
  ``faults`` slot evaluates the serving kinds.
- ``supervisor.py`` — ``RestartPolicy`` and ``supervise_serving``, which
  restarts a crashed serving engine in-process and carries its work
  across.

The training supervisor, checkpoint integrity and the elastic policy
wait for ROADMAP.md queue A item 14. Import-free, as the JAX package's
``resilience/__init__.py`` is.
"""
