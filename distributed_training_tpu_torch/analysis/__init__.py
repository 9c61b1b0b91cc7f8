"""Static analysis for the port: the collectives audit and the pitfall
lint (port of ``analysis/``).

Two halves, one gate (``python -m distributed_training_tpu_torch.analysis
--check``):

- ``audit.py`` / ``targets.py`` / ``compile.py`` / ``baseline.py``: run
  one step of each named target on a world of its processes with its
  collectives recorded, flag collectives over groups the mesh does not
  describe and replicated large params, and ratchet against the
  committed ``spmd_baseline.json`` so only NEW findings fail;
- ``pitfalls.py``: the DTT0xx AST rule registry over the port's files
  (host syncs in the step loop and the serving paths, host-local
  collective guards, unseeded data RNG, ...).

JAX's ``OVERLAP_baseline.json`` and the audit's ``overlap`` key score
XLA's compiled schedule and are not carried (ROADMAP "Differences by
design").
"""

from distributed_training_tpu_torch.analysis import (  # noqa: F401
    baseline,
    pitfalls,
    targets,
)
