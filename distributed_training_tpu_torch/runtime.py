"""Runtime layer for the port: device resolution, seeding, the process
group and the device mesh.

The JAX package's runtime builds a device mesh over every addressable
chip (``distributed_training_tpu/runtime.py``). Here one process drives
one device, so the mesh's devices are processes: ``initialize_runtime``
adopts a ``torch.distributed`` process group that is already initialized,
or starts one from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL on
``cuda:LOCAL_RANK``, or gloo under ``train.device=cpu``. Over the group
it builds a ``ProcessMesh`` with all five axes (``pp, dp, fsdp, sp,
tp``), size-1 ones included, so every axis has a group to name, even in a
world of one, and a group over every set of two or more axes larger
than 1 (``Runtime.group``): the batch axes (dp, fsdp) under a mesh with
tp > 1, (fsdp, tp) for a leaf split on both. A world of 1 with neither a
group nor torchrun's environment runs without a process group.

A mesh may also cover a slice of the world (``slice_runtime``, the
port's counterpart of the JAX ``build_mesh(spec, devices)``): the world
is cut into consecutive runs of ranks, one mesh each, as the
disaggregated pipeline runs its prefill and decode meshes side by side
(``serving/disagg.py``). A slice's runtime counts its own processes
(``process_index``, ``process_count``; ``first_rank`` is its offset in
the world), and its groups never reach past it: the group over every
axis of the mesh is the slice's, not the world's. Every process creates
every group of every slice, in one order, as
``torch.distributed.new_group`` requires.

Sequence and pipeline parallelism (``sp``, ``pp``) wait for ROADMAP.md
queue A item 16.
"""

from __future__ import annotations

import datetime
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


class ProcessMesh:
    """The processes of a mesh, ranks ``first .. first + n - 1`` of the
    world laid out row-major over ``MESH_AXES`` (dp-major over (dp,
    fsdp)), and this process's group over any set of its axes.

    Built collectively (``slice_meshes``): every process of the world
    builds every slice's mesh, in one order; a process outside the slice
    keeps no group of it. One group per distinct member list; a list
    that is the whole world is ``WORLD``."""

    def __init__(self, spec: MeshSpec, first: int, rank: int):
        sizes = spec.as_dict()
        self.spec = spec
        self.first = first
        self.size = math.prod(sizes.values())
        self.ranks = (first + torch.arange(self.size)).view(
            [sizes[a] for a in MESH_AXES])
        self._groups: dict[tuple, object] = {}
        inside = first <= rank < first + self.size
        self._coords = (dict(zip(MESH_AXES, (
            int(i) for i in torch.nonzero(self.ranks == rank)[0])))
            if inside else None)
        world = dist.get_world_size()
        live = [a for a in MESH_AXES if sizes[a] > 1]
        axis_sets = [(a,) for a in MESH_AXES] + [
            axes for n in range(2, len(live) + 1)
            for axes in itertools.combinations(live, n)]
        for axes in axis_sets:
            keep = [MESH_AXES.index(a) for a in axes]
            rest = [i for i in range(len(MESH_AXES)) if i not in keep]
            n = math.prod(sizes[a] for a in axes)
            for members in self.ranks.permute(rest + keep).reshape(
                    -1, n).tolist():
                key = tuple(members)
                if key in self._groups:
                    continue
                self._groups[key] = (dist.group.WORLD
                                     if key == tuple(range(world))
                                     else dist.new_group(members))

    def get_local_rank(self, axis: str) -> int:
        """This process's coordinate on ``axis``."""
        return self._coords[axis]

    def members(self, axes: tuple[str, ...]) -> tuple[int, ...]:
        """World ranks of this process's group over ``axes``, ascending
        with their coordinates on them."""
        index = tuple(slice(None) if a in axes else self._coords[a]
                      for a in MESH_AXES)
        return tuple(self.ranks[index].reshape(-1).tolist())

    def group(self, axes: tuple[str, ...]):
        """This process's group over ``axes`` (axes of size 1 add
        nothing to it)."""
        return self._groups[self.members(axes)]


def slice_meshes(specs: list[MeshSpec], rank: int) -> list[ProcessMesh]:
    """The meshes of consecutive slices of the world, one per spec, in
    order from rank 0 (collective: every process calls this with the
    same specs)."""
    out, first = [], 0
    for spec in specs:
        out.append(ProcessMesh(spec, first, rank))
        first += out[-1].size
    if first != dist.get_world_size():
        raise MeshSpecError(
            f"meshes {[s.as_dict() for s in specs]} cover {first} "
            f"processes but the world has {dist.get_world_size()}")
    return out


@dataclass
class Runtime:
    """Where a training program runs: this process's device, its rank in
    the world, and the mesh over the world's processes. The JAX
    ``Runtime``'s interface (``process_index``, ``process_count``,
    ``num_devices``, ``data_shard_count``, ``device_kind``,
    ``is_coordinator``, ``describe``) over a ``torch.device``. ``mesh``
    is None when no process group runs (a world of 1). On a slice of the
    world (``slice_runtime``) the counts are the slice's and
    ``first_rank`` its first world rank."""

    device: torch.device
    process_index: int = 0
    process_count: int = 1
    spec: MeshSpec = field(default_factory=MeshSpec)
    mesh: ProcessMesh | None = None
    backend: str | None = None   # "nccl" | "gloo" | None
    # Whether initialize_runtime started the group (and its owner should
    # destroy it) rather than adopting the caller's.
    owns_group: bool = False

    @property
    def first_rank(self) -> int:
        """The world rank of this mesh's first process."""
        return self.mesh.first if self.mesh is not None else 0

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
        """The process group over mesh ``axes`` (this process's part of
        it): the mesh's whole group when they span it (``WORLD`` for a
        mesh over the world), a group of one when no axis of them is
        larger than 1."""
        if self.mesh is None:
            raise RuntimeError("no process group: this runtime has a "
                               "world of 1 without torch.distributed")
        return self.mesh.group(axes)

    def barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier(group=self.group(MESH_AXES))

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


def initialize_runtime(cfg, timeout: datetime.timedelta | None = None
                       ) -> Runtime:
    """The runtime for ``cfg`` (a ``config.Config``, or any object with
    its ``train.device`` and ``mesh.<axis>`` fields).

    ``train.device`` "auto" or "cuda" means the CUDA card
    (``cuda:LOCAL_RANK`` under torchrun; raises without one), "cpu" the
    CPU. A process group already initialized is adopted (its backend
    must be NCCL for the card, gloo for the CPU); otherwise one starts
    from torchrun's environment when ``RANK`` and ``WORLD_SIZE`` are
    set; otherwise the world is this one process. The mesh
    (``MeshSpec.resolve``, at most one ``-1`` axis) must cover the world
    exactly; ``sp`` or ``pp`` above 1 raises. ``timeout`` bounds each
    collective of a group started here (torch's default when None)."""
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
            device_id=None if cpu else device,
            **({} if timeout is None else {"timeout": timeout}))
        backend, owns = want, True
    else:
        backend = None
    world = dist.get_world_size() if backend else 1
    try:
        spec = MeshSpec.resolve(cfg.mesh, world)
        _refuse_unported_axes(spec.as_dict())
        rt = (slice_runtime([spec], device) if backend
              else Runtime(device=device, spec=spec))
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise
    rt.owns_group = owns
    logger.info("runtime initialized: %s", rt.describe())
    return rt


def slice_runtime(specs: list[MeshSpec], device) -> Runtime:
    """This process's runtime in one of the meshes ``specs`` laid over
    consecutive slices of the world's ranks, in order from rank 0, on
    the process group already initialized (collective: every process
    calls this with the same specs). ``specs`` of one mesh over the
    whole world is ``initialize_runtime``'s runtime."""
    for spec in specs:
        _refuse_unported_axes(spec.as_dict())
    rank = dist.get_rank()
    mesh = next(m for m in slice_meshes(specs, rank)
                if m.first <= rank < m.first + m.size)
    return Runtime(device=torch.device(device),
                   process_index=rank - mesh.first,
                   process_count=mesh.size, spec=mesh.spec, mesh=mesh,
                   backend=dist.get_backend())


def shutdown_runtime(rt: Runtime) -> None:
    """Destroy the process group if ``rt`` started it."""
    if rt.owns_group and dist.is_initialized():
        dist.destroy_process_group()
        rt.owns_group = False
