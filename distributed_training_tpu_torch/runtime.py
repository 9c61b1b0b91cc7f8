"""Runtime layer for the port: device resolution and seeding.

The JAX package's runtime builds a device mesh over every addressable
chip (``distributed_training_tpu/runtime.py``); the serving slice runs
on one card, so this module only resolves the device an entry point
runs on and makes seeded generators. The mesh waits for the sharded
slices (ROADMAP.md queue A).
"""

from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """An entry point was asked to run on CUDA and no card is visible."""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card; without one this raises rather than
    running on the CPU. The CPU is taken only when the caller names it
    (``device="cpu"``), as the tests do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device is visible; pass device='cpu' explicitly "
                "to run on the CPU")
        if dev.index is None:
            # Tensors report an indexed device; compare like with like.
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` — the
    port's counterpart of a ``jax.random.PRNGKey``. The two frameworks
    draw different numbers from the same seed; parity tests make their
    inputs with numpy and hand them to both."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen
