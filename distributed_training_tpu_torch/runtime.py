"""Runtime layer for the port: device resolution, seeding, the process
group and the device mesh.

The JAX package's runtime builds a device mesh over every addressable
chip (``distributed_training_tpu/runtime.py``). Here one process drives
one device, so the mesh's devices are processes: ``initialize_runtime``
adopts a ``torch.distributed`` process group that is already initialized,
or starts one from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL on
``cuda:LOCAL_RANK``, or gloo under ``train.device=cpu``. Over the group
it builds a ``DeviceMesh`` with all five axes (``pp, dp, fsdp, sp,
tp``), size-1 ones included, so every axis has a group to name, even in a
world of one, and a group over every set of two or more axes that are
larger than 1 and do not span the world (``Runtime.group``): the batch
axes (dp, fsdp) under a mesh with tp > 1, (fsdp, tp) for a leaf split on
both. Every process creates every one of them at initialization, in the
same order, as ``torch.distributed.new_group`` requires. A world of 1
with neither a group nor torchrun's environment runs without a process
group, as before.

Sequence and pipeline parallelism (``sp``, ``pp``) wait for ROADMAP.md
queue A item 16.
"""

from __future__ import annotations

import itertools
import logging
import math
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

MESH_AXES = ("pp", "dp", "fsdp", "sp", "tp")
# The batch dimension is sharded over both data-parallel-like axes,
# dp-major (the JAX package's BATCH_AXES).
BATCH_AXES = ("dp", "fsdp")
# Mesh axes this port does not shard over yet → their ROADMAP.md item.
_UNPORTED_AXES = {"sp": "16 (sequence parallelism)",
                  "pp": "16 (pipeline parallelism)"}


class MeshSpecError(ValueError):
    """A mesh shape that does not fit the world (the JAX package's
    ``RuntimeError_`` from ``MeshSpec.resolve``)."""


@dataclass(frozen=True)
class MeshSpec:
    """Resolved (all-positive) mesh shape: a copy of the JAX
    ``MeshSpec``."""

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1

    def as_dict(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in MESH_AXES}

    @staticmethod
    def resolve(cfg, num_devices: int) -> "MeshSpec":
        """Fill at most one ``-1`` axis with the remaining device count."""
        sizes = {a: getattr(cfg, a) for a in MESH_AXES}
        bad = [a for a, s in sizes.items() if s != -1 and s < 1]
        if bad:
            raise MeshSpecError(
                f"mesh axis size must be -1 or >= 1; got "
                f"{ {a: sizes[a] for a in bad} }")
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise MeshSpecError(
                f"at most one mesh axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if num_devices % fixed != 0:
                raise MeshSpecError(
                    f"fixed mesh axes {sizes} (product {fixed}) do not "
                    f"divide device count {num_devices}")
            sizes[wild[0]] = num_devices // fixed
        elif fixed != num_devices:
            raise MeshSpecError(
                f"mesh {sizes} needs {fixed} devices but {num_devices} "
                "are available")
        return MeshSpec(**sizes)


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
    """Where a training program runs: this process's device, its rank in
    the world, and the mesh over the world's processes. The JAX
    ``Runtime``'s interface (``process_index``, ``process_count``,
    ``num_devices``, ``data_shard_count``, ``device_kind``,
    ``is_coordinator``, ``describe``) over a ``torch.device``. ``mesh``
    is None when no process group runs (a world of 1)."""

    device: torch.device
    process_index: int = 0
    process_count: int = 1
    spec: MeshSpec = field(default_factory=MeshSpec)
    mesh: object = None          # torch DeviceMesh over MESH_AXES
    backend: str | None = None   # "nccl" | "gloo" | None
    # Whether initialize_runtime started the group (and its owner should
    # destroy it) rather than adopting the caller's.
    owns_group: bool = False
    # Groups over two or more mesh axes (each larger than 1, together not
    # the world), keyed by the axes in MESH_AXES order: this process's
    # slice of each (sub_mesh_groups).
    groups: dict = field(default_factory=dict)

    @property
    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else self.device.type

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0

    @property
    def num_devices(self) -> int:
        """One device per process."""
        return self.process_count

    @property
    def data_shard_count(self) -> int:
        return self.spec.dp * self.spec.fsdp

    @property
    def data_shard_index(self) -> int:
        """This process's data shard: dp-major over (dp, fsdp), as the
        JAX loader lays the batch dimension out."""
        if self.mesh is None:
            return 0
        return (self.mesh.get_local_rank("dp") * self.spec.fsdp
                + self.mesh.get_local_rank("fsdp"))

    def group(self, axes: tuple[str, ...]):
        """The process group over mesh ``axes`` (this process's slice):
        the world when they span it; else, over the axes larger than 1,
        the mesh's group of the one axis or the sub-mesh group of several
        (axes of size 1 add nothing to a group); a group of one when no
        axis is larger than 1."""
        if self.mesh is None:
            raise RuntimeError("no process group: this runtime has a "
                               "world of 1 without torch.distributed")
        sizes = self.spec.as_dict()
        if math.prod(sizes[a] for a in axes) == self.process_count:
            return dist.group.WORLD
        live = tuple(a for a in MESH_AXES if a in axes and sizes[a] > 1)
        if len(live) <= 1:
            return self.mesh.get_group(live[0] if live else axes[0])
        return self.groups[live]

    def barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    @property
    def device_kind(self) -> str:
        """e.g. "NVIDIA H100 80GB HBM3" — feeds MFU's peak lookup."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def describe(self) -> str:
        mesh = {a: n for a, n in self.spec.as_dict().items() if n > 1}
        return (f"platform={self.platform} device={self.device} "
                f"kind={self.device_kind} devices={self.num_devices} "
                f"processes={self.process_count} rank={self.process_index} "
                f"backend={self.backend} mesh={mesh}")


def _refuse_unported_axes(sizes: dict) -> None:
    for axis, item in _UNPORTED_AXES.items():
        if sizes[axis] not in (1, -1):
            raise NotImplementedError(
                f"mesh.{axis}={sizes[axis]}: sharding over '{axis}' waits "
                f"for ROADMAP.md queue A item {item}")


def sub_mesh_groups(spec: MeshSpec, rank: int) -> dict:
    """This process's group over every set of two or more mesh axes
    larger than 1 that does not span the world, keyed by the axes (in
    MESH_AXES order). Collective: every process creates every slice's
    group, in one order; a group's ranks ascend with the slice's
    coordinates (row-major, so dp-major over (dp, fsdp))."""
    sizes = spec.as_dict()
    world = math.prod(sizes.values())
    ranks = torch.arange(world).view([sizes[a] for a in MESH_AXES])
    live = [a for a in MESH_AXES if sizes[a] > 1]
    out = {}
    for n in range(2, len(live)):
        for axes in itertools.combinations(live, n):
            keep = [MESH_AXES.index(a) for a in axes]
            rest = [i for i in range(len(MESH_AXES)) if i not in keep]
            size = math.prod(sizes[a] for a in axes)
            for members in ranks.permute(rest + keep).reshape(
                    -1, size).tolist():
                group = dist.new_group(members)
                if rank in members:
                    out[axes] = group
    return out


def initialize_runtime(cfg) -> Runtime:
    """The runtime for ``cfg`` (a ``config.Config``).

    ``train.device`` "auto" or "cuda" means the CUDA card
    (``cuda:LOCAL_RANK`` under torchrun; raises without one), "cpu" the
    CPU. A process group already initialized is adopted (its backend
    must be NCCL for the card, gloo for the CPU); otherwise one starts
    from torchrun's environment when ``RANK`` and ``WORLD_SIZE`` are
    set; otherwise the world is this one process. The mesh
    (``MeshSpec.resolve``, at most one ``-1`` axis) must cover the world
    exactly; ``sp`` or ``pp`` above 1 raises."""
    pref = cfg.train.device
    if pref not in ("auto", "", "cuda", "gpu", "cpu"):
        raise ValueError(f"train.device '{pref}' is not a device of the "
                         "port (auto | cuda | cpu)")
    cpu = pref == "cpu"
    _refuse_unported_axes({a: getattr(cfg.mesh, a) for a in MESH_AXES})
    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", "0"))
    device = resolve_device("cpu" if cpu else f"cuda:{local_rank}"
                            if "LOCAL_RANK" in env else None)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    want = "gloo" if cpu else "nccl"
    owns = False
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
        if backend != want:
            raise ValueError(
                f"the process group runs {backend}, but train.device="
                f"{pref} needs {want}")
    elif "RANK" in env and "WORLD_SIZE" in env:
        dist.init_process_group(
            want, init_method="env://", rank=int(env["RANK"]),
            world_size=int(env["WORLD_SIZE"]),
            device_id=None if cpu else device)
        backend, owns = want, True
    else:
        backend = None
    world = dist.get_world_size() if backend else 1
    rank = dist.get_rank() if backend else 0
    try:
        spec = MeshSpec.resolve(cfg.mesh, world)
        _refuse_unported_axes(spec.as_dict())
        mesh, groups = None, {}
        if backend:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(
                device.type, tuple(spec.as_dict()[a] for a in MESH_AXES),
                mesh_dim_names=MESH_AXES)
            groups = sub_mesh_groups(spec, rank)
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise
    rt = Runtime(device=device, process_index=rank, process_count=world,
                 spec=spec, mesh=mesh, backend=backend, owns_group=owns,
                 groups=groups)
    logger.info("runtime initialized: %s", rt.describe())
    return rt


def shutdown_runtime(rt: Runtime) -> None:
    """Destroy the process group if ``rt`` started it."""
    if rt.owns_group and dist.is_initialized():
        dist.destroy_process_group()
        rt.owns_group = False
