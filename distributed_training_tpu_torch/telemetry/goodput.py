"""Goodput ledger: wall-clock decomposition into named buckets (port
of ``distributed_training_tpu/telemetry/goodput.py``, which is
framework-free; this is the port's own copy, with the same report
schema).

The ledger accumulates host-side seconds into fixed buckets —
``compile``, ``data_wait``, ``step``, ``checkpoint``, ``eval`` — fed by
the telemetry span layer (events.py feeds depth-0 spans only); anything
untracked is ``idle``, derived as wall minus the tracked sum, so the
report always sums to wall-clock exactly. In the port ``compile`` is the
first step, which builds the CUDA kernels.

Interpretation under asynchronous launches: ``step`` is host time up to
the enqueue of the step's last launch, plus whatever the host waits on
the card inside it (a full launch queue, a host sync). Over a window of
many steps it tracks the step's wall time while the host keeps the card
fed; ``goodput`` = step / wall is the share of wall-clock spent in
training steps, and ``mfu_wall``/``mfu_step`` put the model's FLOPs over
that wall against the card's peak (``utils/metrics.py``).
"""

from __future__ import annotations

import time

# Report bucket order (idle appended by report()).
BUCKETS = ("compile", "data_wait", "step", "checkpoint", "eval")

# span name -> bucket. Spans not named here (e.g. the loader's
# data_assemble, which runs concurrently in the prefetch thread and
# would double-count) appear in the event stream only.
SPAN_BUCKET = {
    "compile": "compile",
    "data_wait": "data_wait",
    "step": "step",
    "ckpt_save": "checkpoint",
    "ckpt_restore": "checkpoint",
    "ckpt_wait": "checkpoint",
    "eval": "eval",
}


class GoodputLedger:
    """Accumulates bucket seconds + step counts; reports goodput/MFU.

    ``flops_per_step`` (model FLOPs per optimizer step, all chips) and
    ``peak_flops`` (per chip) turn the window arithmetic into MFU —
    the same accounting as utils/metrics.py but measured against
    *wall* clock, so (goodput x step-window MFU) decomposes a headline
    MFU shortfall into "device was idle" vs "device was slow".
    """

    def __init__(self, flops_per_step: float = 0.0,
                 num_devices: int = 1, peak_flops: float = 0.0):
        self.flops_per_step = flops_per_step
        self.num_devices = max(1, num_devices)
        self.peak_flops = peak_flops
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._buckets = dict.fromkeys(BUCKETS, 0.0)
        self._steps = 0
        self._w_t0 = self._t0
        self._w_buckets = dict.fromkeys(BUCKETS, 0.0)
        self._w_steps = 0

    def add(self, span_name: str, dur_s: float, steps: int = 0) -> None:
        bucket = SPAN_BUCKET.get(span_name)
        if bucket is None:
            return
        self._buckets[bucket] += dur_s
        self._w_buckets[bucket] += dur_s
        if bucket == "step":  # compile steps don't count toward MFU
            self._steps += steps
            self._w_steps += steps

    def _report(self, t0: float, buckets: dict, steps: int) -> dict:
        wall = max(time.perf_counter() - t0, 1e-9)
        rep = {k: round(v, 4) for k, v in buckets.items()}
        # Idle from the rounded figures, so the buckets sum to the
        # reported wall exactly (JAX rounds idle from the unrounded
        # sums: within 3e-4 s of this).
        rep["idle"] = round(max(round(wall, 4) - sum(rep.values()), 0.0), 4)
        out = {
            "wall_s": round(wall, 4),
            "buckets": rep,
            "steps": steps,
            "goodput": round(buckets["step"] / wall, 4),
        }
        if self.flops_per_step and self.peak_flops:
            out["mfu_wall"] = round(
                steps * self.flops_per_step
                / (wall * self.num_devices * self.peak_flops), 4)
            step_s = buckets["step"]
            if step_s > 0:
                out["mfu_step"] = round(
                    steps * self.flops_per_step
                    / (step_s * self.num_devices * self.peak_flops), 4)
        return out

    def window_report(self) -> dict:
        """Report since the last window_report (or reset), then start a
        new window — the per-``log_every`` trajectory record."""
        rep = self._report(self._w_t0, self._w_buckets, self._w_steps)
        self._w_t0 = time.perf_counter()
        self._w_buckets = dict.fromkeys(BUCKETS, 0.0)
        self._w_steps = 0
        return rep

    def report(self) -> dict:
        """Cumulative report since reset (the run-level summary)."""
        return self._report(self._t0, self._buckets, self._steps)


def goodput_of_stream(events: list[dict]) -> dict | None:
    """Ledger-style report for one host's raw event records.

    Prefer the trainer's run-scope ledger report; fall back to
    re-aggregating depth-0 spans (a killed run emits no final report,
    but its spans are all on disk). Shared by the single-run
    summarizer and the multi-host aggregator (per-host goodput), so
    the two can never disagree about bucket accounting.
    """
    runs = [e for e in events
            if e.get("kind") == "goodput" and e.get("scope") == "run"]
    if runs:
        return {k: runs[-1][k] for k in
                ("wall_s", "buckets", "steps", "goodput", "mfu_wall",
                 "mfu_step") if k in runs[-1]}
    buckets = dict.fromkeys(BUCKETS, 0.0)
    steps = 0
    # Wall-clock is summed PER run_start segment: the stream may hold
    # several sessions (a resume, or an eval appended hours after a
    # crash — eval.py's fresh=False path), and spanning first-to-last
    # timestamp across sessions would book the dead time between them
    # as idle.
    wall = 0.0
    t_first = t_last = None
    for e in events:
        t = e.get("t")
        if isinstance(t, (int, float)):
            if e.get("kind") == "run_start" and t_first is not None:
                wall += max(t_last - t_first, 0.0)
                t_first = None
            t_first = t if t_first is None else t_first
            t_last = t
        if e.get("kind") != "span" or e.get("depth", 0) != 0:
            continue
        bucket = SPAN_BUCKET.get(e.get("name"))
        if bucket is None or not isinstance(e.get("dur_s"),
                                            (int, float)):
            continue
        buckets[bucket] += e["dur_s"]
        steps += 1 if e.get("name") == "step" else 0
    if t_first is not None:
        wall += max(t_last - t_first, 0.0)
    if wall <= 0:
        return None
    buckets = {k: round(v, 4) for k, v in buckets.items()}
    buckets["idle"] = round(max(wall - sum(buckets.values()), 0.0), 4)
    return {"wall_s": round(wall, 4), "buckets": buckets,
            "steps": steps,
            "goodput": round(buckets["step"] / wall, 4),
            "reconstructed": True}
