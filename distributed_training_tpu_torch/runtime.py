"""Runtime layer for the port: device resolution, seeding, and the
single-process training runtime.

The JAX package's runtime builds a device mesh over every addressable
chip (``distributed_training_tpu/runtime.py``). This slice runs on one
card in one process: ``initialize_runtime`` resolves the device and a
mesh of size 1, and refuses anything larger; ``torch.distributed`` and
the mesh wait for ROADMAP.md queue A item 4.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

logger = logging.getLogger(__name__)

MESH_AXES = ("pp", "dp", "fsdp", "sp", "tp")


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


@dataclass
class Runtime:
    """Where a training program runs: one process driving one device.
    The JAX ``Runtime``'s interface (``process_index``,
    ``process_count``, ``num_devices``, ``data_shard_count``,
    ``device_kind``, ``is_coordinator``, ``describe``) over a
    ``torch.device``."""

    device: torch.device
    process_index: int = 0
    process_count: int = 1

    @property
    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else self.device.type

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0

    @property
    def num_devices(self) -> int:
        return 1

    @property
    def data_shard_count(self) -> int:
        return 1

    @property
    def device_kind(self) -> str:
        """e.g. "NVIDIA H100 80GB HBM3" — feeds MFU's peak lookup."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def describe(self) -> str:
        return (f"platform={self.platform} device={self.device} "
                f"kind={self.device_kind} devices={self.num_devices} "
                f"processes={self.process_count}")


def initialize_runtime(cfg) -> Runtime:
    """The runtime for ``cfg`` (a ``config.Config``): ``train.device``
    "auto" or "cuda" means the CUDA card (raises without one), "cpu" the
    CPU. Every mesh axis must resolve to 1 (``-1`` fills with the one
    device); a larger mesh raises."""
    pref = cfg.train.device
    if pref in ("auto", "", "cuda", "gpu"):
        device = resolve_device(None)
    elif pref == "cpu":
        device = resolve_device("cpu")
    else:
        raise ValueError(f"train.device '{pref}' is not a device of the "
                         "port (auto | cuda | cpu)")
    sizes = {a: getattr(cfg.mesh, a) for a in MESH_AXES}
    wide = {a: n for a, n in sizes.items() if n not in (1, -1)}
    if wide:
        raise NotImplementedError(
            f"mesh {wide} needs more than one device; multi-device "
            "training waits for ROADMAP.md queue A item 4 (sharded "
            "training)")
    rt = Runtime(device=device)
    logger.info("runtime initialized: %s", rt.describe())
    return rt
