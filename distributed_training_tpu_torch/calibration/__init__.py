"""Measured hardware calibration for the planner's cost model (port of
``calibration/``).

``table``: the stdlib-only artifact layer (schema, fingerprint,
interpolation, chip-slug lookup) over the committed
``conf/calibration/<chip>.json`` tables the JAX package's
``benchmarks/calibrate.py`` measured. The planner
(``parallel/planner.py``) prices a target from the table matching its
chip, or from nominal per-chip constants when none does, and records
which in the plan's provenance. Measuring a table on the card
(``calibration/microbench.py``'s counterpart) is ROADMAP.md queue A
item 17f's remainder.
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
