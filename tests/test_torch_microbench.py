"""The port's micro-benchmarks (``calibration/microbench.py``) held against
JAX's (``distributed_training_tpu/calibration/microbench.py``).

- the accounted-bytes shapes: for each collective kind and message size,
  the global tensor the port's inputs make is the one JAX's builder
  makes (``_collective_fns`` on a mesh of fake CPU devices);
- ``calibrate`` over a spawned gloo world of 2 with a two-size ladder
  (the module's CLI): a table of every kind's curve and the matmul
  curve, which both packages' loaders accept (the same fingerprint);
- the matmul ladder's FLOPs, the timing's call count, and the refusal of
  collective curves without a world.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from distributed_training_tpu_torch.calibration import microbench
from distributed_training_tpu_torch.calibration import table as port_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1 << 12, 1 << 14, 1 << 16, 3 * 1000 + 7, 1 << 23)


@pytest.mark.parametrize("kind", port_table.COLLECTIVE_KINDS)
def test_accounted_rows_are_jaxs(kind):
    jax = pytest.importorskip("jax")
    import numpy as np
    from jax.sharding import Mesh

    from distributed_training_tpu.calibration import microbench as jax_mb

    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("x",))
        _fn, build = jax_mb._collective_fns(mesh, n)[kind]
        for nbytes in SIZES:
            want = build(nbytes).shape[0]
            assert microbench.accounted_rows(kind, nbytes, n) == want, (
                kind, n, nbytes)
            n_in, n_out = microbench._local_shapes(kind, nbytes, n)
            sharded_in = kind in ("all-gather", "ppermute")
            assert n_in == (want // n if sharded_in else want)
            assert n_out * (1 if kind in ("all-gather", "all-reduce")
                            else n) == want


def test_calibrate_over_a_world_of_two_loads_in_both_packages(tmp_path):
    out = tmp_path / "cpu_table.json"
    run = subprocess.run(
        [sys.executable, "-m",
         "distributed_training_tpu_torch.calibration.microbench",
         "--device", "cpu", "--world", "2", "--sizes", "65536,262144",
         "--matmul-sizes", "32,64", "--iters", "2", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert run.returncode == 0, run.stdout + run.stderr
    table = port_table.load_table(str(out))
    assert table.device_kind == "cpu" and table.n_devices == 2
    assert sorted(table.collectives) == sorted(port_table.COLLECTIVE_KINDS)
    for kind, pts in table.collectives.items():
        assert [b for b, _s in pts] == [65536.0, 262144.0], kind
        assert all(s > 0 for _b, s in pts)
    assert [f for f, _r in table.matmul] == [2.0 * 32 ** 3, 2.0 * 64 ** 3]
    assert table.meta["backend"] == "gloo"
    jax_table = pytest.importorskip(
        "distributed_training_tpu.calibration.table")
    got = jax_table.load_table(str(out))
    assert got.fingerprint() == table.fingerprint()
    assert got.collective_seconds("all-reduce", 1e5) == \
        table.collective_seconds("all-reduce", 1e5)


def test_matmul_ladder_and_timing():
    pts = microbench.bench_matmul((16, 8), iters=2, device="cpu")
    assert [f for f, _r in pts] == [2.0 * 8 ** 3, 2.0 * 16 ** 3]
    assert all(r > 0 for _f, r in pts)
    calls = []
    import torch
    microbench._timeit(lambda: calls.append(1), 5, torch.device("cpu"))
    assert len(calls) == 6    # one warm-up, then the timed calls


def test_collective_curves_need_a_world():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=">= 2 processes"):
        microbench.bench_collectives((1 << 16,), iters=1)
