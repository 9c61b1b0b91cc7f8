"""ctypes bindings for the host-side data kernels (port of ``native/``).

``dtt_native.cpp`` (the port's own copy of the JAX package's source) is
compiled with g++ at first use into ``distributed_training_tpu_torch/
build/dtt_native_<digest>.so``, the digest covering the source, so an
edit rebuilds. Two entry points, each bit-identical to its NumPy path:

- ``gather_rows(src, indices)``: ``src[indices]``, multithreaded, with
  NumPy's negative-index wrap and its ``IndexError`` out of range;
- ``fill_tokens(seed, vocab, n)``: the SplitMix64 token fill; the NumPy
  path replays the same stream, so the synthetic corpus is the JAX
  package's whichever path draws it.

Without a compiler, or when the build fails, ``available()`` is False,
a warning is logged once, and both fall back to NumPy (the JAX package's
contract: only speed differs, never data). ``DTT_NATIVE_DISABLE=1``
turns the library off.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "dtt_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

DEFAULT_THREADS = int(os.environ.get("DTT_NATIVE_THREADS", "0"))  # 0=auto


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"dtt_native_{tag}.so")


def _compile(path: str) -> None:
    # -march=native is safe: the .so is built per machine, not shipped.
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                        "-shared", "-fPIC", "-pthread", _SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, path)  # atomic under concurrent builders
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("DTT_NATIVE_DISABLE"):
            logger.warning("native data kernels disabled "
                           "(DTT_NATIVE_DISABLE); using NumPy")
            return None
        try:
            path = _lib_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            i64 = ctypes.c_int64
            lib.dtt_gather_rows.restype = ctypes.c_int
            lib.dtt_gather_rows.argtypes = [
                ctypes.c_void_p, i64, i64, ctypes.c_void_p, i64,
                ctypes.c_void_p, ctypes.c_int]
            lib.dtt_fill_tokens.restype = None
            lib.dtt_fill_tokens.argtypes = [i64, i64, ctypes.c_void_p, i64,
                                            ctypes.c_int]
            _LIB = lib
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            logger.warning("native data kernels unavailable (%s%s); "
                           "falling back to NumPy", e,
                           f": {detail.decode(errors='replace')[-500:]}"
                           if detail else "")
    return _LIB


def available() -> bool:
    """Whether the C++ library is built and loaded."""
    return _load() is not None


def gather_rows(src: np.ndarray, indices: np.ndarray,
                n_threads: int = DEFAULT_THREADS) -> np.ndarray:
    """``src[indices]`` (row gather), multithreaded when the library is
    available. Exactly NumPy's fancy indexing either way, including the
    negative-index wrap and the ``IndexError`` out of range."""
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    lib = _load()
    # NumPy takes what the kernel does not cover: 0-d or non-contiguous
    # sources, multi-dim index arrays, empty rows.
    if (lib is None or src.ndim == 0 or idx.ndim != 1
            or not src.flags.c_contiguous):
        return src[idx]
    row_bytes = src.dtype.itemsize * int(
        np.prod(src.shape[1:], dtype=np.int64))
    if row_bytes == 0:
        return src[idx]
    n = src.shape[0]
    if idx.size and (idx.min() < -n or idx.max() >= n):
        raise IndexError(f"gather index out of range [-{n}, {n})")
    if idx.size and idx.min() < 0:
        idx = np.where(idx < 0, idx + n, idx)
    out = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    rc = lib.dtt_gather_rows(src.ctypes.data, n, row_bytes, idx.ctypes.data,
                             len(idx), out.ctypes.data, n_threads)
    if rc != 0:
        raise IndexError(f"gather index out of range [-{n}, {n})")
    return out


_FILL_BLOCK = 4096  # dtt_native.cpp's block constant
_SM64_GAMMA = 0x9E3779B97F4A7C15
_SM64_M1 = 0xBF58476D1CE4E5B9
_SM64_M2 = 0x94D4A2CA9C8DE917
_FILL_STREAM = 0xD1342543DE82EF95


def _fill_tokens_numpy(seed: int, vocab: int, n: int) -> np.ndarray:
    """The native SplitMix64 stream in vectorized uint64 NumPy, bit for
    bit. Per 4096-token block ``b``: state ``s0 = seed ^ (STREAM *
    (b+1))``; draw ``i`` mixes ``s0 + (i+1) * GAMMA`` through the
    SplitMix64 finalizer; token = mix % vocab. NumPy unsigned arithmetic
    wraps exactly like C."""
    n_blocks = (n + _FILL_BLOCK - 1) // _FILL_BLOCK
    seed_u = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    b = np.arange(1, n_blocks + 1, dtype=np.uint64)
    s0 = seed_u ^ (np.uint64(_FILL_STREAM) * b)          # (n_blocks,)
    i = np.arange(1, _FILL_BLOCK + 1, dtype=np.uint64)
    z = s0[:, None] + i[None, :] * np.uint64(_SM64_GAMMA)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(_SM64_M1)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(_SM64_M2)
    z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32).reshape(-1)[:n]


def fill_tokens(seed: int, vocab: int, n: int,
                n_threads: int = DEFAULT_THREADS) -> np.ndarray:
    """n int32 tokens uniform in [0, vocab), deterministic in ``seed``
    and independent of the thread count; the native and NumPy paths
    draw the same stream."""
    lib = _load()
    if lib is None:
        return _fill_tokens_numpy(seed, vocab, n)
    out = np.empty(n, dtype=np.int32)
    lib.dtt_fill_tokens(seed, vocab, out.ctypes.data, n, n_threads)
    return out
