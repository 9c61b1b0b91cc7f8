"""Tracing (port of ``utils/profiler.py``) on ``torch.profiler``.

A bounded trace of CPU activity and, when a card is in use, CUDA
kernels and copies (CUPTI), written as a Chrome-trace JSON
(``export_chrome_trace``) that ``telemetry/kineto.py`` reads and
Perfetto or ``chrome://tracing`` display. ``trace`` wraps a region,
``trace_steps`` a short window of training steps, ``annotate`` names a
range on the timeline (``record_function``, which every telemetry span
already opens).

The JAX module's ``start_server``/``stop_server`` (an XProf server from
which a running job is traced on demand) have no ``torch.profiler``
counterpart; the port serves that need with the ``profile_now`` drop
file in the run directory (``telemetry/attribution.py``).
"""

from __future__ import annotations

import contextlib
import logging
import os
from dataclasses import dataclass

import torch

logger = logging.getLogger(__name__)

# The file name a trace lands under in its directory.
TRACE_FILE = "trace.json"


def activities() -> list:
    """CPU, plus CUDA once this process has initialised a card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start(logdir: str):
    """Start a profiler whose trace ``stop`` writes under ``logdir``.
    Raises while another profiler runs (one session at a time: a second
    one breaks both)."""
    if torch._C._autograd._profiler_enabled():
        raise RuntimeError("a profiler is already running in this process")
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities())
    prof.start()
    return prof


def stop(prof, logdir: str) -> str:
    """Wait for the card's queued work, stop ``prof`` and write its
    Chrome trace into ``logdir``; returns the trace's path."""
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        prof.stop()
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return path


@contextlib.contextmanager
def trace(logdir: str, host_only_on_coordinator: bool = False,
          process_index: int = 0):
    """Trace everything inside the block into ``logdir``. In a world of
    several processes each traces itself; ``host_only_on_coordinator``
    traces process 0 only."""
    if host_only_on_coordinator and process_index != 0:
        yield
        return
    prof = start(logdir)
    try:
        yield
    finally:
        stop(prof, logdir)


def annotate(name: str):
    """Named range on the trace timeline (host, and the card's lanes)."""
    return torch.profiler.record_function(name)


@dataclass(frozen=True)
class TraceResult:
    """What a bounded trace produced: how many steps were captured and
    where the trace landed."""

    steps: int
    logdir: str


def trace_steps(trainer, batches, logdir: str,
                warmup: int = 2) -> TraceResult:
    """Profile a short step window: run ``warmup`` steps untraced (the
    kernels' build and first launches), then trace the remaining
    batches."""
    it = iter(batches)
    done = 0
    for _ in range(warmup):
        try:
            trainer.train_step(next(it))
        except StopIteration:
            break
    with trace(logdir):
        for batch in it:
            trainer.train_step(batch)
            done += 1
    return TraceResult(steps=done, logdir=logdir)
