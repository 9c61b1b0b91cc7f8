"""Telemetry for the port: one instrumentation surface, its consumers.

- ``span()``/``event()`` (events.py) — the structured ``events.jsonl``
  stream, doubling as ``torch.profiler`` ranges;
- ``GoodputLedger`` (goodput.py) — wall-clock decomposed into
  compile/data_wait/step/checkpoint/eval/idle, goodput and MFU;
- ``HangWatchdog`` (watchdog.py) — per-step hang detection with
  faulthandler / card-memory / event-tail postmortem bundles;
- ``HBMSampler`` (hbm.py) — periodic ``torch.cuda.memory_stats``
  samples beside the state's exact bytes (utils/memory.py);
- ``StragglerDetector`` (straggler.py) — the on-cadence cross-process
  step/data_wait exchange flagging persistently slow processes, and the
  eviction requests the elastic supervisor reads;
- ``ProfileCapture`` (attribution.py) — in-run ``torch.profiler``
  capture at configured steps (or a ``profile_now`` drop file)
  decomposed into compute / collective / host+data and overlap; the
  trace is read by kineto.py;
- ``MetricsServer`` (metrics_server.py) — the live Prometheus endpoint
  and ``/healthz``, fed from this sink (with the tenant-labeled serving
  latency histograms);
- ``AnomalyDetector`` (anomaly.py) — online median/MAD detection over
  the same stream (an observer: host-side only), arming an in-run
  capture on a sustained step-time regression;
- ``IncidentRecorder``/``write_incident_bundle`` (incident.py) — atomic
  incident bundles (event tail, anomaly verdict, latest attribution,
  serving snapshot, card memory stats);
- the offline doctor (doctor.py), the multi-host aggregator
  (aggregate.py) and ``analyze_traces`` (serving_trace.py, the
  per-tenant SLO ledger).

``python -m distributed_training_tpu_torch.telemetry <run_dir>``
renders it all (summarize.py; ``--doctor``, ``--serving-report``;
run dirs with ``host_<i>/`` streams get the merged report). The event
schema is the JAX package's, so either package's tools read the other's
run dirs.
"""

from distributed_training_tpu_torch.telemetry.anomaly import (  # noqa: F401
    AnomalyDetector,
)
from distributed_training_tpu_torch.telemetry.attribution import (  # noqa: F401
    ProfileCapture,
)
from distributed_training_tpu_torch.telemetry.events import (  # noqa: F401
    Telemetry,
    current,
    event,
    install,
    span,
    uninstall,
)
from distributed_training_tpu_torch.telemetry.goodput import (  # noqa: F401
    GoodputLedger,
)
from distributed_training_tpu_torch.telemetry.hbm import (  # noqa: F401
    HBMSampler,
)
from distributed_training_tpu_torch.telemetry.incident import (  # noqa: F401
    IncidentRecorder,
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
from distributed_training_tpu_torch.telemetry.straggler import (  # noqa: F401
    StragglerDetector,
    flag_stragglers,
)
from distributed_training_tpu_torch.telemetry.watchdog import (  # noqa: F401
    HangWatchdog,
    write_postmortem,
)
