"""Metrics: JSON helpers, step throughput and MFU accounting (port of
``utils/metrics.py``).

``sanitize_for_json`` and ``MetricsLogger`` are copies of the JAX
package's (importing that module would import the JAX package root,
which imports jax); the peak table holds the NVIDIA card instead of the
TPU generations.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


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


# Peak dense bf16 FLOP/s per card: H100/H200 SXM, 989e12 (NVIDIA data
# sheet, tensor cores, no sparsity). Other devices (the CPU) have no
# entry, and their runs log no MFU.
PEAK_FLOPS: dict[str, float] = {
    "h100": 989e12,
    "h200": 989e12,
}


def peak_flops_per_chip(device_kind: str) -> float | None:
    kind = device_kind.lower()
    for key, flops in PEAK_FLOPS.items():
        if key in kind:
            return flops
    return None


def compute_mfu(model_flops_per_sec_per_chip: float,
                device_kind: str) -> float | None:
    peak = peak_flops_per_chip(device_kind)
    return None if peak is None else model_flops_per_sec_per_chip / peak


@dataclass
class MetricsLogger:
    """Rolling per-step throughput/loss logging on the coordinator, as
    the JAX ``MetricsLogger``: a row every ``log_every`` steps, appended
    to ``jsonl_path`` when set (``jsonl_fresh`` truncates first; a
    resumed run appends after a ``run_start`` line). The first row is
    flagged ``"warmup": true`` and carries no throughput: the window
    opens there, so build and first-step time never fold into a rate.
    ``num_devices`` is the world's card count: rates and MFU are per
    card. A ``replica_divergence`` metric rides its row, and a MoE
    model's ``moe_aux`` every row.
    Reading a row's loss waits for the device (one sync per row)."""

    log_every: int = 10
    samples_per_step: int = 0
    flops_per_sample: float = 0.0
    num_devices: int = 1
    enabled: bool = True
    device_kind: str = "cpu"
    jsonl_path: str | None = None
    jsonl_fresh: bool = True
    start_step: int = 0
    on_entry: object = None

    _last_time: float | None = field(default=None)
    _last_step: int = 0
    history: list[dict] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._last_step = self.start_step
        if self.jsonl_path and self.enabled:
            os.makedirs(os.path.dirname(self.jsonl_path) or ".",
                        exist_ok=True)
            with open(self.jsonl_path, "w" if self.jsonl_fresh else "a") as f:
                f.write(json.dumps({"run_start": True,
                                    "step": self.start_step}) + "\n")

    def _append(self, entry: dict) -> None:
        self.history.append(entry)
        if self.jsonl_path:
            # The port's metrics sink, as the JAX utils/metrics.py is.
            with open(self.jsonl_path, "a") as f:  # noqa: DTT001
                f.write(json.dumps(sanitize_for_json(entry),
                                   allow_nan=False) + "\n")
        if self.on_entry is not None:
            try:
                self.on_entry(sanitize_for_json(entry))
            except Exception as e:  # noqa: BLE001 — an observer must
                # not take down the metrics path.
                logger.debug("metrics on_entry failed: %s: %s",
                             type(e).__name__, e)

    def record(self, step: int, metrics: dict, epoch: int = 0) -> None:
        if not self.enabled or self.log_every <= 0:
            return
        if step % self.log_every != 0:
            return
        loss = float(metrics.get("loss", float("nan")))
        now = time.perf_counter()
        if self._last_time is None:
            entry = {"epoch": epoch, "step": step, "loss": loss,
                     "warmup": True}
            if "moe_aux" in metrics:
                entry["moe_aux"] = float(metrics["moe_aux"])
            if "replica_divergence" in metrics:
                entry["replica_divergence"] = int(
                    metrics["replica_divergence"])
            self._append(entry)
            logger.info("step %d | epoch %d | loss %.6f | (warmup row: "
                        "throughput window starts here)", step, epoch, loss)
            self._last_time = now
            self._last_step = step
            return
        dsteps = max(step - self._last_step, 1)
        dt = max(now - self._last_time, 1e-9)
        steps_per_sec = dsteps / dt
        samples_per_sec = steps_per_sec * self.samples_per_step
        entry = {
            "epoch": epoch,
            "step": step,
            "loss": loss,
            "steps_per_sec": steps_per_sec,
            "samples_per_sec_per_chip": samples_per_sec / self.num_devices,
        }
        if "grad_norm" in metrics:
            entry["grad_norm"] = float(metrics["grad_norm"])
        if "moe_aux" in metrics:
            entry["moe_aux"] = float(metrics["moe_aux"])
        if "replica_divergence" in metrics:
            entry["replica_divergence"] = int(metrics["replica_divergence"])
        mfu = compute_mfu(
            samples_per_sec * self.flops_per_sample / self.num_devices,
            self.device_kind)
        if self.flops_per_sample and mfu is not None:
            entry["mfu"] = mfu
        self._append(entry)
        logger.info(
            "step %d | epoch %d | loss %.6f | %.1f samples/s/chip%s",
            step, epoch, loss, entry["samples_per_sec_per_chip"],
            f" | mfu {entry['mfu']:.3f}" if "mfu" in entry else "")
        self._last_time = now
        self._last_step = step

    def record_scalar(self, step: int, name: str, value: float,
                      epoch: int = 0) -> None:
        """One unthrottled scalar row (an evaluation's ``val_loss``); it
        leaves the throughput window as it is."""
        if not self.enabled:
            return
        self._append({"epoch": epoch, "step": step, name: float(value)})
        logger.info("step %d | epoch %d | %s %.6f", step, epoch, name,
                    float(value))
