"""Card memory telemetry: periodic allocator samples (port of
``telemetry/hbm.py``, with its ``hbm`` event schema).

``utils/memory.py`` predicts the footprint before a run; this records
what the caching allocator did during one, into the event stream the
goodput ledger and the watchdog share. ``torch.cuda.memory_stats``
counters map onto the JAX keys: ``allocated_bytes.all.current`` →
``bytes_in_use``, ``allocated_bytes.all.peak`` → ``peak_bytes_in_use``,
``reserved_bytes.all.current`` → ``bytes_reserved``, the allocation
count → ``num_allocs``, and the card's total memory → ``bytes_limit``.
The optional ``estimate_bytes`` (the state's exact per-device bytes,
``utils/memory.py::state_bytes_per_device``) rides along on every sample
as the cross-check: a growing gap between it and ``bytes_in_use`` is
activations and caching, not state.

A CPU run has no allocator stats; its samples carry ``"stats": null``,
as the JAX package's CPU samples do.
"""

from __future__ import annotations

import torch


def device_stats(device: torch.device) -> dict | None:
    """The sampled counters of ``device`` (None off the card)."""
    if device.type != "cuda":
        return None
    raw = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(raw.get("reserved_bytes.all.current", 0)),
        "num_allocs": int(raw.get("allocation.all.allocated", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(
            device).total_memory),
    }


class HBMSampler:
    """Emit an ``hbm`` event every ``every`` steps (0 disables) for this
    process's device."""

    def __init__(self, telemetry, every: int = 0,
                 estimate_bytes: int = 0, device=None):
        self.telemetry = telemetry
        self.every = every
        self.estimate_bytes = int(estimate_bytes)
        self.device = torch.device(device or "cpu")

    def maybe_sample(self, step: int) -> None:
        if self.every > 0 and step % self.every == 0:
            self.sample(step)

    def sample(self, step: int) -> None:
        try:
            entry = {"id": 0, "stats": device_stats(self.device)}
        except RuntimeError as e:  # telemetry must not kill the loop
            entry = {"id": 0, "error": f"{type(e).__name__}: {e}"}
        rec = {"step": step, "devices": [entry]}
        if self.estimate_bytes:
            rec["estimate_bytes"] = self.estimate_bytes
        self.telemetry.event("hbm", **rec)
