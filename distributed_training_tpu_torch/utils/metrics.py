"""JSON helpers shared by the port's telemetry writers.

A copy of ``sanitize_for_json`` from the JAX package's
``utils/metrics.py``: importing that module would import the JAX
package root, which imports jax.
"""

from __future__ import annotations

import math


def sanitize_for_json(value):
    """Map non-finite floats to null, recursively through dicts/lists
    — bare NaN/Infinity are not valid JSON and break strict consumers
    (jq, JSON.parse)."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    if isinstance(value, dict):
        return {k: sanitize_for_json(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [sanitize_for_json(v) for v in value]
    return value
