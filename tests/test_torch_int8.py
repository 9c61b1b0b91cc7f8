"""Int8 weight-only serving of the port, held against the JAX package.

Same weights (``from_jax_params``), same prompts (numpy, seeded), float32
on the CPU:

- ``quantize_params_int8`` gives JAX's ``qw`` and ``scale`` bit for bit
  (``torch.round`` and ``np.round`` both round half to even), and
  ``quantized_weight_bytes`` JAX's counts;
- ``from_jax_params`` carries JAX's int8 tree as int8 and f32 leaves;
- an engine on int8 leaves emits the JAX int8 engine's tokens, one-token,
  ``spec_k`` 4 and ``resident_k`` 4, with its ``weight_bytes``; its
  first-decode logits are those of the JAX forward on the dequantized
  weights within 1e-5;
- ``checkpoint/export.py --quantize int8`` writes an artifact whose
  params load straight back into an engine.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.checkpoint import export as port_export
from distributed_training_tpu_torch.checkpoint.consolidate import (
    load_consolidated,
)
from distributed_training_tpu_torch.checkpoint.manager import WHOLE_FILE
from distributed_training_tpu_torch.models.convert import from_jax_params
from distributed_training_tpu_torch.models.transformer import (
    Transformer as PortTransformer,
    TransformerConfig as PortConfig,
    cast_for_compute,
    layer_slice,
)
from distributed_training_tpu_torch.serving import disagg as port_disagg
from distributed_training_tpu_torch.serving import engine as port_engine
from distributed_training_tpu_torch.train.optimizer import flatten

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.models.transformer import (  # noqa: E402
    Transformer,
    TransformerConfig,
)
from distributed_training_tpu.serving import disagg as jax_disagg  # noqa: E402
from distributed_training_tpu.serving import engine as jax_engine  # noqa: E402

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, max_seq_len=128, dtype="float32",
            param_dtype="float32", pos_encoding="rope",
            tie_embeddings=False)
ENGINE = dict(max_batch=4, page_size=8, num_pages=96, max_seq_len=64,
              prefill_chunk=8)


@pytest.fixture(scope="module")
def models():
    jm = Transformer(TransformerConfig(**TINY))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jq = jax_disagg.quantize_params_int8(jp)
    pm = PortTransformer(PortConfig(**TINY), device="cpu")
    pp = from_jax_params(jp, pm.cfg, device="cpu")
    pq = from_jax_params(jq, pm.cfg, device="cpu")
    return jm, jq, pm, pp, pq


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, size=int(rng.integers(3, 20)))
            .astype(np.int32) for _ in range(6)]


def _run(eng, R, prompts, n=8) -> dict:
    for i, p in enumerate(prompts):
        eng.submit(R(id=f"r{i}", prompt=p, max_new_tokens=n))
    eng.run_until_drained()
    return {r["id"]: r["tokens"] for r in eng.completed}


def test_quantize_params_int8_bit_equal_to_jax(models):
    jm, jq, pm, pp, _ = models
    got = port_disagg.quantize_params_int8(pp)
    for grp, name in port_disagg._QUANT_AXES:
        for part in ("qw", "scale"):
            want = np.asarray(jq[grp][name][part])
            have = got[grp][name][part]
            assert have.dtype == (torch.int8 if part == "qw"
                                  else torch.float32)
            assert np.array_equal(have.numpy(), want), (grp, name, part)
    assert port_disagg.quantized_weight_bytes(got) == \
        jax_disagg.quantized_weight_bytes(jq)
    # The tree with no quant leaf counts alike on both sides too.
    assert port_disagg.quantized_weight_bytes(pp) == \
        jax_disagg.quantized_weight_bytes(
            jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))


def test_quantize_rounds_half_to_even_and_keeps_zero_channels():
    """A channel of amax 127 has scale 1.0, so w / scale lands on .5
    exactly: both sides round half to even. An all-zero channel keeps
    scale 1.0."""
    col = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 0.0],
                   np.float32)
    w = np.zeros((1, 8, 2), np.float32)
    w[0, :, 0] = col
    want = jax_disagg._quantize_leaf(w, (1,))
    got = port_disagg._quantize_leaf(torch.from_numpy(w), (1,))
    assert np.array_equal(got["qw"].numpy(), want["qw"])
    assert np.array_equal(got["scale"].numpy(), want["scale"])
    assert got["qw"][0, :, 0].tolist() == [127, 0, 2, 2, -2, 0, 4, 0]
    assert got["scale"][0, 0].tolist() == [1.0, 1.0]


def test_from_jax_params_carries_the_int8_tree(models):
    _, jq, pm, pp, pq = models
    want = port_disagg.quantize_params_int8(pp)
    for grp, name in port_disagg._QUANT_AXES:
        for part in ("qw", "scale"):
            assert torch.equal(pq[grp][name][part], want[grp][name][part])
    assert pq["tok_embed"].dtype == torch.float32
    bad = dict(jq, attn=dict(jq["attn"], wq=dict(
        jq["attn"]["wq"], scale=np.ones((2, 64, 4, 16), np.float32))))
    with pytest.raises(ValueError, match="scale"):
        from_jax_params(bad, pm.cfg, device="cpu")
    bad = dict(jq, mlp=dict(jq["mlp"], wi=dict(
        jq["mlp"]["wi"], qw=jq["mlp"]["wi"]["qw"].astype(np.int32))))
    with pytest.raises(ValueError, match="int8"):
        from_jax_params(bad, pm.cfg, device="cpu")


def test_cast_for_compute_and_layer_slice_pass_int8_leaves_whole(models):
    _, _, pm, _, pq = models
    cp = cast_for_compute(pq, pm.cfg)
    assert cp["attn"]["wq"] is pq["attn"]["wq"]
    layer = layer_slice(cp, 1)
    assert torch.equal(layer["attn"]["wo"]["qw"], pq["attn"]["wo"]["qw"][1])
    assert torch.equal(layer["mlp"]["wi"]["scale"],
                       pq["mlp"]["wi"]["scale"][1])
    w = port_engine._w(layer["attn"]["wq"])
    assert w.shape == (64, 4, 16) and w.dtype == torch.float32


@pytest.mark.parametrize("over", [{}, {"spec_k": 4}, {"resident_k": 4}],
                         ids=["one_token", "spec_k_4", "resident_k_4"])
def test_int8_engine_tokens_match_jax_int8_engine(models, over):
    jm, jq, pm, _, pq = models
    want_eng = jax_engine.Engine(jm, jq,
                                 jax_engine.EngineConfig(**ENGINE, **over))
    want = _run(want_eng, jax_engine.Request, _prompts())
    eng = port_engine.Engine(pm, pq, port_engine.EngineConfig(**ENGINE,
                                                              **over),
                             device="cpu")
    counts = eng.warmup()
    assert _run(eng, port_engine.Request, _prompts()) == want
    assert eng.compile_counts() == counts
    assert eng.weight_bytes == want_eng.weight_bytes == \
        port_disagg.quantized_weight_bytes(pq)["int8"]


def test_int8_first_decode_logits_match_jax_dequantized_forward(models):
    """The logits the one-token engine samples its second token from,
    held against the JAX forward on the dequantized weights over the
    prompt and the first token."""
    jm, jq, pm, _, pq = models
    deq = jax.tree.map(
        lambda lf: (np.asarray(lf["qw"], np.float32) * lf["scale"]
                    if isinstance(lf, dict) else lf),
        jq, is_leaf=lambda lf: isinstance(lf, dict) and "qw" in lf)
    # Sequential prefill returns (V,) logits: the first (B, V) block is
    # the first decode launch's.
    eng = port_engine.Engine(pm, pq, port_engine.EngineConfig(
        **ENGINE, prefill_mode="sequential"), device="cpu")
    box = {}
    logits_fn = port_engine._logits

    def logits(*a, **kw):
        out = logits_fn(*a, **kw)
        if out.dim() == 2:
            box.setdefault("decode", out.clone())
        return out

    prompt = _prompts()[2]
    port_engine._logits = logits
    try:
        toks = eng.generate(prompt, 3)
    finally:
        port_engine._logits = logits_fn
    ids = jnp.asarray([prompt.tolist() + toks[:1]], jnp.int32)
    want, _ = jm.apply(deq, ids)
    got = box["decode"][0].numpy()
    np.testing.assert_allclose(got, np.asarray(want[0, -1]), rtol=0,
                               atol=1e-5)
    assert int(got.argmax()) == toks[1]


def test_int8_weight_bytes_shrink(models):
    _, _, pm, pp, pq = models
    sizes = port_disagg.quantized_weight_bytes(pq)
    f32 = port_engine.Engine(pm, pp, port_engine.EngineConfig(**ENGINE),
                             device="cpu")
    q = port_engine.Engine(pm, pq, port_engine.EngineConfig(**ENGINE),
                           device="cpu")
    assert f32.weight_bytes == sizes["fp32"]
    assert q.weight_bytes == sizes["int8"] < 0.5 * sizes["fp32"]


def _fresh(tree: dict) -> dict:
    return {k: (_fresh(v) if isinstance(v, dict) else v.clone())
            for k, v in tree.items()}


@pytest.mark.parametrize("which", ["fp32", "int8"])
def test_engine_holds_one_copy_of_its_weights(models, which):
    """The engine keeps no reference to the tree it was built from: once
    the caller drops it, every one of its tensors is freed, and the
    engine's own tensors hold exactly ``weight_bytes``."""
    _, _, pm, pp, pq = models
    tree = _fresh(pp if which == "fp32" else pq)
    refs = [weakref.ref(t) for t in flatten(tree).values()]
    eng = port_engine.Engine(pm, tree, port_engine.EngineConfig(**ENGINE),
                             device="cpu")
    del tree
    gc.collect()
    assert not [r for r in refs if r() is not None]
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in flatten(eng.params).values()}
    assert sum(storages.values()) == eng.weight_bytes


def test_engine_casts_int8_scales_to_compute_dtype_once(models):
    """At bf16 compute the engine holds each scale in bf16, cast once at
    build, and ``_w`` dequantizes to the bits of JAX's per-use
    ``qw.astype(dt) * scale.astype(dt)``."""
    _, _, _, _, pq = models
    pm16 = PortTransformer(PortConfig(**{**TINY, "dtype": "bfloat16"}),
                           device="cpu")
    eng = port_engine.Engine(pm16, pq, port_engine.EngineConfig(**ENGINE),
                             device="cpu")
    for grp, name in port_disagg._QUANT_AXES:
        mine, given = eng.params[grp][name], pq[grp][name]
        assert mine["scale"].dtype == torch.bfloat16
        assert torch.equal(mine["qw"], given["qw"])
        want = (given["qw"][0].to(torch.bfloat16)
                * given["scale"][0].to(torch.bfloat16))
        got = port_engine._w({"qw": mine["qw"][0],
                              "scale": mine["scale"][0]})
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_export_quantize_int8_round_trips_into_an_engine(models, tmp_path):
    """A whole-state checkpoint exported with ``--quantize int8``: the
    artifact's meta says int8, its params equal ``quantize_params_int8``
    of the checkpoint's, and an engine on them emits the tokens of an
    engine on the in-memory int8 tree."""
    _, _, pm, pp, pq = models
    step_dir = tmp_path / "ckpt" / "3"
    step_dir.mkdir(parents=True)
    torch.save({"params": pp, "opt_state": {}, "step": 3},
               step_dir / WHOLE_FILE)
    out = str(tmp_path / "int8.pt")
    info = port_export.main(["--ckpt", str(tmp_path / "ckpt"), "--out", out,
                             "--quantize", "int8"])
    assert info == 0
    state, meta = load_consolidated(out)
    assert meta["quantization"] == "int8" and meta["step"] == 3
    params = state["params"]
    for grp, name in port_disagg._QUANT_AXES:
        for part in ("qw", "scale"):
            assert torch.equal(params[grp][name][part],
                               pq[grp][name][part])
    want = _run(port_engine.Engine(pm, pq, port_engine.EngineConfig(
        **ENGINE), device="cpu"), port_engine.Request, _prompts()[:3])
    got = _run(port_engine.Engine(pm, params, port_engine.EngineConfig(
        **ENGINE), device="cpu"), port_engine.Request, _prompts()[:3])
    assert got == want
    with pytest.raises(ValueError, match="int4"):
        port_export.export(str(tmp_path / "ckpt"), out, quantize="int4")


def test_engine_rejects_a_malformed_int8_leaf(models):
    _, _, pm, pp, pq = models
    bad = dict(pq, attn=dict(pq["attn"], wq={
        "qw": pq["attn"]["wq"]["qw"].float(),
        "scale": pq["attn"]["wq"]["scale"]}))
    with pytest.raises(TypeError, match="int8"):
        port_engine.Engine(pm, bad, port_engine.EngineConfig(**ENGINE),
                           device="cpu")
