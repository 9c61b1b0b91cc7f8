"""Package contracts of the PyTorch port.

- it imports, every module of it, with ``jax`` and the JAX package
  blocked, and no source of it (nor ``chip_smoke.py``) imports either;
- entry points resolve ``device=None`` to the CUDA card and raise
  without one instead of running on the CPU;
- the kernel build raises when ``nvcc`` is missing (no fallback);
- ``chip_smoke.py`` refuses to run without a card, and alone.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from distributed_training_tpu_torch.kernels import build
from distributed_training_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu_torch.runtime import NoCudaDeviceError
from distributed_training_tpu_torch.serving.engine import (
    Engine,
    EngineConfig,
)
from distributed_training_tpu_torch.serving.kv_cache import (
    PagedCacheConfig,
    PagedKVCache,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "distributed_training_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "distributed_training_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n"
                      for m in _modules())
            + "assert not any(m.split('.')[0] in ('jax', 'jaxlib') "
              "for m in sys.modules if sys.modules[m] is not None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_port_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


TINY = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
            max_seq_len=64, dtype="float32")


@pytest.mark.parametrize("entry", ["transformer", "engine", "cache"])
def test_default_device_is_cuda_and_raises_without_one(no_cuda, entry):
    cpu_model = Transformer(TransformerConfig(**TINY), device="cpu")
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        if entry == "transformer":
            Transformer(TransformerConfig(**TINY))
        elif entry == "engine":
            Engine(cpu_model, cpu_model.init(0),
                   EngineConfig(max_seq_len=64))
        else:
            PagedKVCache(PagedCacheConfig(n_layers=1, n_kv_heads=2,
                                          head_dim=16))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-such-cuda"))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build(["paged_decode"])
    path = build.library_path("flash_fwd")
    assert path == build.library_path("flash_fwd")
    assert path.startswith(build.BUILD_DIR)
    with pytest.raises(KeyError):
        build.library_path("nope")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=dict(env, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
