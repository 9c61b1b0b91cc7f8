"""The port's data layer held against the JAX package's.

Every dataset of the JAX ``build_dataset`` registry builds in the port
from the same kwargs and gives the same rows byte for byte
(``synthetic``, ``synthetic_normal``, ``synthetic_linear``,
``synthetic_lm``, ``synthetic_doc``, ``synthetic_images``, and
``memmap_tokens`` and ``bytes`` over a temporary file), with the same
``_defaults`` filtering; ``train_eval_split`` cuts the same index sets;
``data/prepare.py`` writes the same corpus bytes and sidecar in both
modes; the port's C++ gather and fill (built with g++ here) equal NumPy's
and the JAX package's; and the loader retries a transient IO error
``data_retries`` times, then raises.
"""

import json
import os

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch import native
from distributed_training_tpu_torch.data import ShardedDataLoader
from distributed_training_tpu_torch.data import datasets as port_ds
from distributed_training_tpu_torch.data import prepare as port_prepare
from distributed_training_tpu_torch.runtime import Runtime
from distributed_training_tpu_torch.telemetry import events

pytest.importorskip("jax")

from distributed_training_tpu import native as jax_native  # noqa: E402
from distributed_training_tpu.data import datasets as jax_ds  # noqa: E402
from distributed_training_tpu.data import prepare as jax_prepare  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULTS = {"size": 96, "seed": 5}
# name → explicit kwargs (the registry adds DEFAULTS where accepted).
SYNTHETIC = {
    "synthetic": {},
    "synthetic_normal": {"in_dim": 7, "out_dim": 3},
    "synthetic_linear": {"in_dim": 6},
    "synthetic_lm": {"seq_len": 33, "vocab_size": 301},
    "synthetic_doc": {"min_len": 3, "max_len": 17, "vocab_size": 999},
    "synthetic_images": {"height": 8, "width": 6, "channels": 2,
                         "num_classes": 4},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A uint16 token file and a byte file."""
    d = tmp_path_factory.mktemp("corpus")
    toks = np.random.default_rng(1).integers(0, 5000, 4000).astype(np.uint16)
    toks.tofile(d / "toks.bin")
    (d / "text.bin").write_bytes(bytes(
        np.random.default_rng(2).integers(0, 256, 3001).astype(np.uint8)))
    return d


def _cases(corpus) -> dict:
    cases = dict(SYNTHETIC)
    cases["memmap_tokens"] = {"path": str(corpus / "toks.bin"),
                              "seq_len": 16, "dtype": "uint16",
                              "vocab_size": 5000}
    cases["bytes"] = {"path": str(corpus / "text.bin"), "seq_len": 31}
    return cases


def _assert_same_rows(a, b, idx) -> None:
    ra, rb = a.batch(idx), b.batch(idx)
    assert sorted(ra) == sorted(rb)
    for k in ra:
        x, y = np.asarray(ra[k]), np.asarray(rb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("name", sorted(SYNTHETIC) + ["memmap_tokens",
                                                      "bytes"])
def test_dataset_rows_byte_equal(name, corpus):
    kw = _cases(corpus)[name]
    port = port_ds.build_dataset(name, _defaults=DEFAULTS, **kw)
    ref = jax_ds.build_dataset(name, _defaults=DEFAULTS, **kw)
    assert len(port) == len(ref)
    for attr in ("vocab_size", "seq_len", "num_classes"):
        assert getattr(port, attr, None) == getattr(ref, attr, None)
    idx = np.random.default_rng(3).permutation(len(ref))[:23]
    _assert_same_rows(port, ref, np.concatenate([idx, idx[:2]]))
    if name == "synthetic_doc":
        for i in (0, 5, len(ref) - 1):
            assert port.doc(i).tobytes() == ref.doc(i).tobytes()


def test_unknown_dataset_and_kwarg_typos_raise():
    with pytest.raises(ValueError, match="unknown dataset"):
        port_ds.build_dataset("nope")
    with pytest.raises(TypeError):
        port_ds.build_dataset("synthetic", in_dimm=3)


@pytest.mark.parametrize("frac,multiple_of", [(0.1, 1), (0.05, 8),
                                              (0.3, 16)])
def test_train_eval_split_index_sets_equal(frac, multiple_of):
    base_p = port_ds.build_dataset("synthetic", size=200, seed=4)
    base_j = jax_ds.build_dataset("synthetic", size=200, seed=4)
    tp, ep = port_ds.train_eval_split(base_p, frac, seed=9,
                                      multiple_of=multiple_of)
    tj, ej = jax_ds.train_eval_split(base_j, frac, seed=9,
                                     multiple_of=multiple_of)
    np.testing.assert_array_equal(tp._indices, tj._indices)
    np.testing.assert_array_equal(ep._indices, ej._indices)
    assert len(ep) % multiple_of == 0
    _assert_same_rows(ep, ej, np.arange(len(ej)))
    with pytest.raises(ValueError, match="leaves no training data"):
        port_ds.train_eval_split(base_p, 0.9, multiple_of=128)


def test_prepare_bytes_and_tokens_equal(tmp_path):
    files = [os.path.join(REPO, "distributed_training_tpu_torch", "data",
                          "*.py"), os.path.join(REPO, "README.md")]
    got = port_prepare.prepare_bytes(str(tmp_path / "p.bin"), files)
    want = jax_prepare.prepare_bytes(str(tmp_path / "j.bin"), files)
    assert got == want and got["n_files"] >= 5
    assert (tmp_path / "p.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    assert json.loads((tmp_path / "p.bin.json").read_text()) == \
        json.loads((tmp_path / "j.bin.json").read_text())

    for i in range(2):
        np.save(tmp_path / f"t{i}.npy",
                np.random.default_rng(i).integers(0, 70000, 500))
    pat = [str(tmp_path / "t*.npy")]
    got = port_prepare.prepare_tokens(str(tmp_path / "pt.bin"), pat, 70000)
    want = jax_prepare.prepare_tokens(str(tmp_path / "jt.bin"), pat, 70000)
    assert got == want and got["dtype"] == "uint32"
    assert (tmp_path / "pt.bin").read_bytes() == \
        (tmp_path / "jt.bin").read_bytes()
    # The CLI prints the sidecar.
    assert port_prepare.main(["--out", str(tmp_path / "c.bin"),
                              *files]) == 0
    assert (tmp_path / "c.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()


@pytest.mark.parametrize("dtype,row", [(np.int32, ()), (np.float32, (7,)),
                                       (np.uint8, (3, 5)),
                                       (np.int64, (2,))])
def test_native_gather_equals_numpy(dtype, row):
    assert native.available(), "g++ build of dtt_native.cpp failed"
    rng = np.random.default_rng(0)
    src = rng.integers(-100, 100, (5000, *row)).astype(dtype)
    idx = rng.integers(-5000, 5000, 3000)
    got = native.gather_rows(src, idx)
    assert got.tobytes() == src[idx].tobytes()
    assert got.tobytes() == jax_native.gather_rows(src, idx).tobytes()
    for bad in (np.array([0, 5000]), np.array([-5001])):
        with pytest.raises(IndexError):
            native.gather_rows(src, bad)
    # Big enough for the threaded path (> 1 MiB of rows).
    big = rng.integers(0, 2 ** 31 - 1, (300_000, 4)).astype(np.int32)
    bidx = rng.permutation(300_000)
    assert native.gather_rows(big, bidx).tobytes() == big[bidx].tobytes()


@pytest.mark.parametrize("seed,vocab,n", [(0, 50257, 100_003),
                                          (2 ** 40 + 7, 256, 4096),
                                          (42, 3, 1)])
def test_native_fill_equals_numpy(seed, vocab, n):
    assert native.available()
    got = native.fill_tokens(seed, vocab, n)
    assert got.dtype == np.int32 and got.shape == (n,)
    assert got.tobytes() == native._fill_tokens_numpy(seed, vocab,
                                                      n).tobytes()
    assert got.tobytes() == native.fill_tokens(seed, vocab, n,
                                               n_threads=1).tobytes()
    assert got.tobytes() == jax_native.fill_tokens(seed, vocab, n).tobytes()


class _Flaky:
    """A dataset whose first ``fails`` batch reads raise OSError."""

    def __init__(self, fails: int):
        self.fails = fails
        self.base = port_ds.build_dataset("synthetic", size=32, seed=0)

    def __len__(self):
        return len(self.base)

    def batch(self, idx):
        if self.fails > 0:
            self.fails -= 1
            raise OSError("transient read error")
        return self.base.batch(idx)


def test_loader_retries_transient_errors(tmp_path):
    rt = Runtime(device=torch.device("cpu"))
    tel = events.install(events.Telemetry(
        events_jsonl=str(tmp_path / "ev.jsonl")))
    try:
        ldr = ShardedDataLoader(_Flaky(2), rt, batch_size=8, shuffle=False,
                                data_retries=2)
        batches = list(ldr.epoch(0))
        want = _Flaky(0).batch(np.arange(8))
        np.testing.assert_array_equal(batches[0]["x"].numpy(), want["x"])
        assert len(batches) == 4
        with pytest.raises(OSError, match="transient"):
            list(ShardedDataLoader(_Flaky(3), rt, batch_size=8,
                                   shuffle=False, data_retries=2).epoch(0))
        # A ValueError is not retried.
        ds = _Flaky(0)
        ds.batch = lambda idx: (_ for _ in ()).throw(ValueError("bad"))
        with pytest.raises(ValueError, match="bad"):
            list(ShardedDataLoader(ds, rt, batch_size=8,
                                   data_retries=5).epoch(0))
    finally:
        events.uninstall()
        tel.close()
    recs = [json.loads(line) for line in open(tmp_path / "ev.jsonl")]
    retries = [r for r in recs if r.get("kind") == "data_retry"]
    assert len(retries) == 2 + 2
    assert [r["attempt"] for r in retries[:2]] == [1, 2]
