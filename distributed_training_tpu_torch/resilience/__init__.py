"""Resilience (port): crash-restart-resume for training and serving.

- ``supervisor.py`` — ``supervise``, the restart supervisor that
  ``launch/local.py --supervise`` drives (exit sentinels, a retry budget
  refunded by checkpoint progress, backoff, the elastic hand-off), and
  ``supervise_serving``, which restarts a crashed serving engine
  in-process and carries its work across.
- ``integrity.py`` — per-file sha256 manifests of checkpoint steps,
  quarantine of a damaged step, and the step scan.
- ``faults.py`` — deterministic fault injection
  (``train.fault_plan="crash@40,sigterm@80,..."``), every trigger a pure
  function of the global step, one-shot across restarts through a
  ledger.
- ``elastic.py`` — the shrink/grow world-size policy (``launch.local
  --supervise --elastic``) and the per-shard batch arithmetic.

Import-free, as the JAX package's ``resilience/__init__.py`` is: the
supervisor runs in the launcher process.
"""
