"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, ``build/lib<name>-<digest>.so``, where the digest covers the
source, every header it includes (``#include "..."``, followed
recursively) and the compiler flags: a changed source or header is
rebuilt, an unchanged one is loaded as it is. Nothing is built when a
module is imported; the first launch of a kernel builds it, and
``build()`` builds several at once, one ``nvcc`` process for each source,
all started together.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "build")
KERNELS = ("flash_fwd", "flash_bwd", "paged_decode", "flash_fwd_sm90",
           "flash_bwd_sm90", "flash_bwd_dq_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Kernel builds this process ran, per kernel (the engine's
# ``compile_counts`` reads them: they must not move after warmup).
_builds: dict[str, int] = {name: 0 for name in KERNELS}
# nvcc's resource report (-Xptxas -v) of each build this process ran.
build_logs: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's kernels are built from csrc/ at first "
            "use and have no fallback")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list[str]:
    """The kernel's source, then every header of ``csrc/`` it includes,
    directly or through another header."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel '{name}' (have {KERNELS})")
    found = [os.path.join(CSRC, f"{name}.cu")]
    for path in found:
        with open(path) as f:
            for inc in _INCLUDE.findall(f.read()):
                dep = os.path.join(os.path.dirname(path), inc)
                if dep not in found:
                    found.append(dep)
    return found


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=KERNELS) -> dict[str, float]:
    """Build every kernel in ``names`` whose library is missing, one
    ``nvcc`` per source, all running at once. Returns the wall seconds
    from the start until each build ended (0.0 for a library that was
    already there)."""
    with _lock:
        return _build_locked(tuple(names))


def _build_locked(names: tuple) -> dict[str, float]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = nvcc_path()
    procs, logs = {}, {}
    t0 = time.perf_counter()

    def reap(name, proc):
        logs[name], _ = proc.communicate()
        secs[name] = time.perf_counter() - t0

    for name in todo:
        # Write beside the target and rename: a reader never sees a
        # half-written library.
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, _sources(name)[0]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        # One reader per process, so each build's seconds end with it.
        reader = threading.Thread(target=reap, args=(name, proc))
        reader.start()
        procs[name] = (tmp, proc, reader)
    failed = []
    for name, (tmp, proc, reader) in procs.items():
        reader.join()
        log = build_logs[name] = logs[name]
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(name))
        _builds[name] += 1
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked((name,))
            lib = _libs[name] = ctypes.CDLL(library_path(name))
        return lib


def build_count(name: str) -> int:
    """How many times this process compiled kernel ``name``."""
    return _builds[name]


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")
        msg.restype = ctypes.c_char_p
        msg.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{name} launch failed: CUDA error {code} "
            f"({msg(code).decode()})")
