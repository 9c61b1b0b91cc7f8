"""Telemetry for the port.

- ``span()``/``event()`` (events.py) — the structured ``events.jsonl``
  stream, doubling as ``torch.profiler`` ranges;
- ``MetricsServer`` (metrics_server.py) — the live Prometheus endpoint
  and ``/healthz``, fed from this sink (with the tenant-labeled serving
  latency histograms);
- ``write_incident_bundle`` (incident.py) — atomic incident bundles
  (event tail, serving snapshot, card memory stats);
- ``analyze_traces`` (serving_trace.py) — the per-tenant SLO ledger
  reconstructed from the serving engine's ``serving_trace`` records.

The JAX package's other telemetry modules (goodput, watchdog, anomaly,
the doctor, the summarizer) wait for ROADMAP.md queue A item 15.
"""

from distributed_training_tpu_torch.telemetry.events import (  # noqa: F401
    Telemetry,
    current,
    event,
    install,
    span,
    uninstall,
)
from distributed_training_tpu_torch.telemetry.incident import (  # noqa: F401
    write_incident_bundle,
)
from distributed_training_tpu_torch.telemetry.metrics_server import (  # noqa: F401
    MetricsServer,
)
from distributed_training_tpu_torch.telemetry.serving_trace import (  # noqa: F401
    analyze_traces,
    render_serving_lines,
    slo_attainment,
)
