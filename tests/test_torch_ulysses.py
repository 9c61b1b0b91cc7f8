"""The port's Ulysses attention (``parallel/ulysses.py``) and Ulysses
sequence-parallel training held against the JAX package's.

As ``tests/test_torch_ring.py`` (its helpers): numpy inputs from a seed;
JAX's ``make_ulysses_attention`` on fake CPU devices of the same mesh;
the port in one spawned gloo world of 4 for the whole module, on sp 4,
dp 2 x sp 2, fsdp 2 x sp 2 and tp 2 x sp 2.

- Forward and gradients against JAX at ``rtol=1e-5, atol=1e-6`` in
  float32: causal and full, GQA, windows, heads split over tp and then
  over sp; bfloat16 inputs at the bfloat16 limits; sp 1 degenerate.
- The head-count refusal in JAX's words: the per-shard heads must
  divide by sp, from the attention and from the model through it.
- Training under Ulysses against JAX's trainer on the same mesh and the
  port's one-process run, masked targets included.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.models import transformer as port_tf
from distributed_training_tpu_torch.parallel.ring_attention import SPGroup
from distributed_training_tpu_torch.parallel.ulysses import ulysses_attention

jax = pytest.importorskip("jax")

from test_torch_ring import (  # noqa: E402
    F32_TOL,
    MODEL,
    attn_cases,
    attn_inputs,
    check_attention,
    check_training,
    jax_attention,
    spawn_world,
    train_cases,
)

# name → (mesh, causal, H, Hkv, window, dtype, flash): the heads
# divide by tp·sp.
ULYSSES_CASES = {
    "causal_sp4": ("sp4", True, 4, 4, 0, "float32", False),
    "full_sp4": ("sp4", False, 8, 4, 0, "float32", False),
    "gqa_sp4": ("sp4", True, 8, 4, 0, "float32", False),
    "window20_sp4": ("sp4", True, 4, 4, 20, "float32", False),
    "causal_dp2_sp2": ("dp2_sp2", True, 4, 2, 0, "float32", False),
    "window40_fsdp2_sp2": ("fsdp2_sp2", True, 4, 4, 40, "float32", False),
    "gqa_tp2_sp2": ("tp2_sp2", True, 8, 4, 0, "float32", False),
    "bf16_sp4": ("sp4", True, 4, 4, 0, "bfloat16", False),
}
TRAIN_CASES = {
    "train_sp4": ({"dp": 1, "sp": 4}, {"parallel_strategy": "ddp"}, {},
                  "synthetic_lm"),
    "train_dp2_sp2_masked": ({"dp": 2, "sp": 2},
                             {"parallel_strategy": "ddp"}, {}, "masked_lm"),
    "train_fsdp2_sp2": ({"dp": 1, "fsdp": 2, "sp": 2},
                        {"parallel_strategy": "fsdp"}, {}, "synthetic_lm"),
    "train_tp2_sp2": ({"dp": 1, "sp": 2, "tp": 2},
                      {"parallel_strategy": "tp"},
                      {"pos_encoding": "rope"}, "masked_lm"),
}

_WORLD: dict = {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's world, spawned once per test process."""
    if "out" not in _WORLD:
        out = str(tmp_path_factory.mktemp("ulysses_world"))
        spawn_world(out, attn_cases("ulysses", ULYSSES_CASES, out)
                    + train_cases("ulysses", TRAIN_CASES))
        _WORLD["out"] = out
    return _WORLD["out"]


@pytest.mark.parametrize("name", sorted(ULYSSES_CASES))
def test_ulysses_matches_jax(name, world):
    check_attention("ulysses", name, ULYSSES_CASES[name], world)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 20)])
def test_ulysses_sp1_degenerates_as_jax(causal, window):
    inputs = attn_inputs(4, 2)
    q, k, v = (torch.from_numpy(inputs[n]).requires_grad_()
               for n in ("q", "k", "v"))
    out = ulysses_attention(q, k, v, SPGroup(), causal=causal, window=window)
    out.backward(torch.from_numpy(inputs["do"]))
    want = jax_attention("ulysses", {"dp": 4}, inputs, causal, window,
                         "float32")
    for n, t in (("out", out), ("dq", q.grad), ("dk", k.grad),
                 ("dv", v.grad)):
        np.testing.assert_allclose(t.detach().numpy(), want[n],
                                   err_msg=n, **F32_TOL)


class _Group(SPGroup):
    """An sp group of ``size`` members that runs no collective (the
    refusals raise before any)."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_ulysses_head_refusals_in_jax_words():
    inputs = attn_inputs(4, 2)
    # The attention's own check: per-shard heads over sp (kv 2 over 4).
    want = _jax_error(lambda: jax_attention(
        "ulysses", {"sp": 4}, inputs, True, 0, "float32"))
    q, k = torch.zeros(1, 4, 4, 16), torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError) as got:
        ulysses_attention(q, k, k, _Group(4))
    assert str(got.value) == want
    # The model reaches the same check with the heads it holds (the JAX
    # model's own up-front check over tp·sp is not kept: one owner).
    cfg = dict(MODEL, n_heads=4, n_kv_heads=2, attention_impl="ulysses")
    pm = port_tf.Transformer(port_tf.TransformerConfig(**cfg), device="cpu")
    pm.bind_sequence_parallel(_Group(4))
    with pytest.raises(ValueError) as got:
        pm.loss(pm.init(0), {"tokens": torch.zeros(1, 9, dtype=torch.long)},
                train=False)
    assert str(got.value) == want


def test_sp_needs_sequence_parallel_attention():
    pm = port_tf.Transformer(port_tf.TransformerConfig(**MODEL),
                             device="cpu")
    with pytest.raises(ValueError, match="needs attention_impl 'ring' or "
                       "'ulysses', not 'auto'"):
        pm.bind_sequence_parallel(_Group(2))


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_ulysses_training_matches_jax_and_one_process(name, world):
    check_training("ulysses", name, TRAIN_CASES[name], world)
