"""Telemetry for the port: the structured event stream (events.py).

The JAX package's other telemetry modules (goodput, metrics server,
watchdog, traces, incidents) wait for later slices (ROADMAP.md queue A).
"""

from distributed_training_tpu_torch.telemetry.events import (  # noqa: F401
    Telemetry,
    current,
    event,
    install,
    span,
    uninstall,
)
