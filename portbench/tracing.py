"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the
first ``TRACE_S`` seconds of the window, the harness's own spans
(``record_function``) around each call into the program, and the
Chrome trace reduced by ``yardstick/timeline.py``.

Set-up opens and closes one short capture first: the first profiler
capture with CUDA activities in a process pays CUPTI's start-up, which
belongs to set-up, not to the window.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

from portbench.yardstick import timeline

# Seconds of the window that are traced.
TRACE_S = 5.0


def _activities(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if getattr(device, "type", device) == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def warm(device) -> None:
    import torch

    with torch.profiler.profile(activities=_activities(device)):
        torch.zeros(1, device=device).add_(1)
        if getattr(device, "type", device) == "cuda":
            torch.cuda.synchronize(device)


def span(name: str, on: bool):
    """A host range in the trace (a no-op outside a traced stretch)."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


class Capture:
    """One profiler capture: ``start()``, then ``stop()`` once its
    work has been synchronised; ``read()`` gives the reduced trace."""

    def __init__(self, device):
        import torch

        self.prof = torch.profiler.profile(activities=_activities(device))
        self.on = False

    def start(self) -> None:
        self.prof.__enter__()
        self.on = True

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)
        self.on = False

    def read(self, step_span: str) -> dict:
        """Device events, host spans, the traced window (ps), the count
        of ``step_span`` ranges and the timeline's attribution."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            device, host = timeline.load(path)
        finally:
            os.remove(path)
        ours = [h for h in host if h.name in SPANS]
        starts = [h.start_ps for h in ours] + [d.start_ps for d in device]
        ends = [h.end_ps for h in ours] + [d.end_ps for d in device]
        window = (min(starts), max(ends)) if starts else (0, 0)
        return {"device": device, "host": ours, "window": window,
                "steps": sum(1 for h in ours if h.name == step_span),
                "attribution": timeline.attribution(device, window)}


# The harness's span names: what the host was doing.
SPANS = frozenset({"data_wait", "train_step", "engine_step"})


def breakdown(traced: dict) -> dict:
    return {"device_ops": timeline.device_ops(traced["device"],
                                              traced["window"]),
            "idle_gaps": timeline.idle_gaps(traced["device"],
                                            traced["host"],
                                            traced["window"])}
