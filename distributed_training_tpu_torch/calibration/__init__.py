"""Measured hardware calibration for the planner's cost model (port of
``calibration/``).

``table``: the stdlib-only artifact layer (schema, fingerprint,
interpolation, chip-slug lookup) over the committed
``conf/calibration/<chip>.json`` tables the JAX package's
``benchmarks/calibrate.py`` measured. The planner
(``parallel/planner.py``) prices a target from the table matching its
chip, or from nominal per-chip constants when none does, and records
which in the plan's provenance. ``microbench``: the micro-benchmarks
that measure a table (collective curves over the world's process group,
the matmul curve on the device); no card table is committed, since gloo
between processes on one card measures the host.
"""

from distributed_training_tpu_torch.calibration.table import (  # noqa: F401
    CALIB_DIR,
    COLLECTIVE_KINDS,
    SCHEMA,
    CalibrationError,
    CalibrationLookup,
    CalibrationTable,
    chip_slug,
    load_table,
    lookup_for_chip,
    save_table,
    table_path,
)
