"""The tensor-core flash kernels' design, held on the CPU.

``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_sm90.cu`` and
``csrc/flash_bwd_dq_sm90.cu`` run only on the card. What can go wrong
before they get there is checked here:

- which kernel a call takes (``_design``: bf16 at head dim 64/128 →
  "wgmma", everything else → "simt"), for the forward, the fused
  backward and the split pair (dq, dk/dv);
- a plain-torch emulation of their tile walk: 64 x 64 tiles, the band
  bounds (with the ragged last tile), masks applied only on the tiles
  that need them, exp2 with log2(e) folded into the scale (the backward
  forms s scale - lse first, then scales it), the no-key rule, and the
  backward in its transposed form (S^T = K Q^T,
  dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale) with its rounding
  points (p before dV, ds before dK and dQ), with dq (the fused kernel)
  or without it (the split dk/dv kernel); and the split dq kernel's
  q-major walk (S = Q K^T, dP = dO V^T, dQ += dS K over the forward's
  band).

The emulation is held against the port's plain versions
(``flash_fwd_reference``, ``flash_bwd_reference``), against the JAX
package's ``_naive_attention`` and its ``jax.vjp``, and (the split
walks) against the JAX package's split backward kernels
(``_flash_bwd`` with ``_FORCE_SPLIT_BWD``, in interpret mode), on the
same numpy inputs from a seed. Tolerances: with f32 inputs and no rounding the
walk only reorders f32 sums (exp2 of a folded scale in place of exp of
a scaled logit adds an f32 ulp or two), so 1e-5 abs/rel; with bf16
inputs and the kernels' rounding points, 2e-2 for the output (one bf16
ulp is 2**-7 relative, and the kernels round the unnormalised p where
the plain version rounds the normalised weights) and 1e-2 of each
gradient's largest magnitude (p and ds rounded at the same points; a
value on a rounding boundary may round the other way).

The last two tests show why the card holds the tensor-core backward's
f32 gradients of bf16 inputs to 1e-3 of the largest gradient and not
1e-4: the plain version against itself, with only the head-dim
summation order of its products permuted, already moves them past 1e-4;
and that 1e-3 still catches gradients rounded to bf16.
"""

import math

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.ops import flash_attention as fa

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.ops import (  # noqa: E402
    flash_attention as jax_fa,
)
from distributed_training_tpu.ops.attention import (  # noqa: E402
    _naive_attention as jax_naive,
)

T = fa.SM90_TILE
LOG2E = 1.4426950408889634
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# The card's limit for the tensor-core backward's f32 gradients of bf16
# inputs, relative to the largest gradient (tests/test_torch_kernels_gpu.py,
# chip_smoke.py).
WGMMA_GRADS_F32_TOL = 1e-3
# (B, H, Hkv, S, Sk, D, causal, window)
CASES = [(1, 2, 2, 64, 64, 64, True, 0),
         (2, 4, 2, 192, 192, 64, True, 0),
         (2, 2, 1, 150, 150, 128, True, 0),
         (1, 4, 1, 160, 160, 64, True, 40),
         (2, 2, 2, 100, 170, 64, False, 0)]
IDS = ["one-tile", "gqa-3-tiles", "ragged-d128", "window-gqa-ragged",
       "noncausal-sq-sk"]


# -- the kernels' tile walk, in plain torch ---------------------------------

def _tile(m: torch.Tensor, r0: int) -> torch.Tensor:
    """Rows [r0, r0 + T) of m, zeros past its end (the cp.async zero
    fill)."""
    t = m.new_zeros((T,) + tuple(m.shape[1:]))
    part = m[r0:r0 + T]
    t[:part.shape[0]] = part
    return t


def _live(rows, cols, S, Sk, causal, window):
    ok = (rows < S) & (cols < Sk)
    if causal:
        ok = ok & (cols <= rows)
        if window > 0:
            ok = ok & (cols > rows - window)
    return ok


def k_band(q0, Sk, causal, window) -> range:
    """The forward's k-tiles for the q-tile at q0."""
    k_lo, k_hi = 0, Sk
    if causal:
        k_hi = min(Sk, q0 + T)
        if window > 0:
            k_lo = max(0, q0 - window + 1)
    return range(k_lo // T, -(-k_hi // T))


def q_band(k0, S, causal, window) -> range:
    """The backward's q-tiles for the k-tile at k0: from the diagonal to
    the last key's window end."""
    q_lo, q_hi = 0, S
    if causal:
        q_lo = k0
        if window > 0:
            q_hi = min(S, k0 + T - 1 + window)
    return range(q_lo // T, -(-q_hi // T))


def edge(q0, k0, S, Sk, causal, window) -> bool:
    """Whether a (q-tile, k-tile) pair is masked: it crosses the causal
    diagonal, the window's edge or a ragged end. (The forward leaves out
    the q-side ragged test: rows past S are never written.)"""
    e = k0 + T > Sk or q0 + T > S
    if causal:
        e = e or k0 + T - 1 > q0
        if window > 0:
            e = e or k0 < q0 + T - window
    return e


def online_step(s, m, l, acc, v_tile, sl2, p_dtype):
    """One k-tile of the forward's online softmax on raw scores s (rows
    x keys, -inf where masked). m is in raw-score units."""
    m_new = torch.maximum(m, s.max(1).values)
    dead = m_new == -math.inf
    alpha = torch.where(dead, 1.0, torch.exp2((m - m_new) * sl2))
    base = torch.where(dead, 0.0, m_new * sl2)
    p = torch.exp2(s * sl2 - base[:, None])
    pv = p.to(p_dtype).float() if p_dtype is not None else p
    return m_new, l * alpha + p.sum(1), acc * alpha[:, None] + pv @ v_tile


def finish(m, l, acc, scale):
    """Epilogue: O / l and lse = m scale + log l; a row with no live key
    gives zeros and NO_KEY_LSE."""
    has = l > 0
    out = torch.where(has[:, None], acc / torch.where(has, l, 1.0)[:, None],
                      0.0)
    lse = torch.where(has, m * scale + torch.log(torch.where(has, l, 1.0)),
                      fa.NO_KEY_LSE)
    return out, lse


def emulate_fwd(q, k, v, causal, window, p_dtype=None):
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = D ** -0.5
    sl2 = scale * LOG2E
    out = torch.zeros(B, H, S, D)
    lse = torch.zeros(B, H, S, 1)
    for b in range(B):
        for h in range(H):
            hk = h // (H // Hkv)
            for q0 in range(0, S, T):
                qs = _tile(q[b, h].float(), q0)
                rows = torch.arange(q0, q0 + T)[:, None]
                m = torch.full((T,), -math.inf)
                l, acc = torch.zeros(T), torch.zeros(T, D)
                for t in k_band(q0, Sk, causal, window):
                    k0 = t * T
                    s = qs @ _tile(k[b, hk].float(), k0).T
                    if edge(q0, k0, S + T, Sk, causal, window):
                        cols = torch.arange(k0, k0 + T)[None, :]
                        s = s.masked_fill(
                            ~_live(rows, cols, S + T, Sk, causal, window),
                            -math.inf)
                    m, l, acc = online_step(s, m, l, acc,
                                            _tile(v[b, hk].float(), k0),
                                            sl2, p_dtype)
                n = min(T, S - q0)
                o, ls = finish(m[:n], l[:n], acc[:n], scale)
                out[b, h, q0:q0 + n] = o
                lse[b, h, q0:q0 + n, 0] = ls
    return out, lse


def emulate_bwd(q, k, v, do, lse, delta, causal, window, round_dtype=None,
                with_dq=True):
    """The transposed walk, one k-tile at a time: (dq, dk, dv) in f32
    (the fused kernel) or, without dq, (dk, dv) (the split dk/dv
    kernel); dk/dv summed over each GQA group."""
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = D ** -0.5

    def rnd(x):
        return x.to(round_dtype).float() if round_dtype is not None else x

    dq = torch.zeros(B, H, S, D)
    dk = torch.zeros(B, H, Sk, D)
    dv = torch.zeros(B, H, Sk, D)
    for b in range(B):
        for h in range(H):
            hk = h // (H // Hkv)
            for k0 in range(0, Sk, T):
                ks = _tile(k[b, hk].float(), k0)
                vs = _tile(v[b, hk].float(), k0)
                keys = torch.arange(k0, k0 + T)[:, None]
                dkt, dvt = torch.zeros(T, D), torch.zeros(T, D)
                for t in q_band(k0, S, causal, window):
                    q0 = t * T
                    qs = _tile(q[b, h].float(), q0)
                    dos = _tile(do[b, h].float(), q0)
                    ls = _tile(lse[b, h, :, 0], q0)
                    des = _tile(delta[b, h, :, 0], q0)
                    s_t = ks @ qs.T                       # keys x queries
                    dp_t = vs @ dos.T
                    p_t = torch.exp2((s_t * scale - ls[None, :]) * LOG2E)
                    if edge(q0, k0, S, Sk, causal, window):
                        queries = torch.arange(q0, q0 + T)[None, :]
                        p_t = torch.where(
                            _live(queries, keys, S, Sk, causal, window),
                            p_t, 0.0)
                    ds_t = p_t * (dp_t - des[None, :]) * scale
                    pb, dsb = rnd(p_t), rnd(ds_t)
                    dvt += pb @ dos
                    dkt += dsb @ qs
                    if with_dq:
                        n = min(T, S - q0)
                        dq[b, h, q0:q0 + n] += (dsb.T @ ks)[:n]
                n = min(T, Sk - k0)
                dk[b, h, k0:k0 + n] = dkt[:n]
                dv[b, h, k0:k0 + n] = dvt[:n]
    group = H // Hkv
    dkv = (dk.reshape(B, Hkv, group, Sk, D).sum(2),
           dv.reshape(B, Hkv, group, Sk, D).sum(2))
    return (dq, *dkv) if with_dq else dkv


def emulate_bwd_dq(q, k, v, do, lse, delta, causal, window,
                   round_dtype=None):
    """The split dq kernel's q-major walk: per q-tile, the forward's band
    of k-tiles; S = Q K^T and dP = dO V^T, p = exp2((s scale - lse)
    log2e) masked on the tiles that cross the diagonal, the window's
    edge or the ragged key end (rows past S are left unmasked: they are
    never written), ds rounded before dQ += dS K. dq in f32."""
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = D ** -0.5

    def rnd(x):
        return x.to(round_dtype).float() if round_dtype is not None else x

    dq = torch.zeros(B, H, S, D)
    for b in range(B):
        for h in range(H):
            hk = h // (H // Hkv)
            for q0 in range(0, S, T):
                qs = _tile(q[b, h].float(), q0)
                dos = _tile(do[b, h].float(), q0)
                ls = _tile(lse[b, h, :, 0], q0)
                des = _tile(delta[b, h, :, 0], q0)
                rows = torch.arange(q0, q0 + T)[:, None]
                acc = torch.zeros(T, D)
                for t in k_band(q0, Sk, causal, window):
                    k0 = t * T
                    ks = _tile(k[b, hk].float(), k0)
                    s_ = qs @ ks.T                        # queries x keys
                    dp = dos @ _tile(v[b, hk].float(), k0).T
                    p = torch.exp2((s_ * scale - ls[:, None]) * LOG2E)
                    if edge(q0, k0, S + T, Sk, causal, window):
                        cols = torch.arange(k0, k0 + T)[None, :]
                        p = torch.where(
                            _live(rows, cols, S + T, Sk, causal, window),
                            p, 0.0)
                    ds = p * (dp - des[:, None]) * scale
                    acc += rnd(ds) @ ks
                n = min(T, S - q0)
                dq[b, h, q0:q0 + n] = acc[:n]
    return dq


# -- inputs and references ----------------------------------------------------

def _inputs(seed, B, H, Hkv, S, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32),
            rng.standard_normal((B, H, S, D)).astype(np.float32))


def _bshd(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(x.transpose(0, 2, 1, 3))


def _jax_naive(q, k, v, do, causal, window):
    """JAX _naive_attention's output and jax.vjp gradients, (B, H, S, D)."""
    def f(q, k, v):
        return jax_naive(q, k, v, causal=causal, window=window)

    out, vjp = jax.vjp(f, _bshd(q), _bshd(k), _bshd(v))
    grads = vjp(_bshd(do))
    return [np.asarray(x).transpose(0, 2, 1, 3) for x in (out, *grads)]


def _close_rel(got, want, tol):
    scale = max(float(want.abs().max()), 1.0)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"max err {err} > {tol} x {scale}"


# -- tests --------------------------------------------------------------------

@pytest.mark.parametrize("dtype,head_dim,design", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 96, "simt"), (torch.bfloat16, 256, "simt")])
def test_design_routes_by_dtype_and_head_dim(dtype, head_dim, design):
    assert fa._design(dtype, head_dim) == design


WRAPPERS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")


def _counts():
    return {n: (getattr(fa, n).launches,
                dict(getattr(fa, n).launches_by_design)) for n in WRAPPERS}


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_cpu_tensors_launch_no_design(monkeypatch, split):
    """On CPU tensors every wrapper runs the plain version: no count
    moves, and the split pair returns the plain version's gradients."""
    monkeypatch.setattr(fa, "FORCE_SPLIT_BWD", split)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(0, 1, 4, 2, 64, 64, 64))
    before = _counts()
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    got = fa.flash_bwd(q, k, v, out, lse, do, causal=True)
    pieces = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True),
              *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True))
    fused = fa.flash_bwd_fused(q, k, v, do, lse, delta, causal=True)
    assert _counts() == before
    want = fa.flash_bwd_reference(q, k, v, None, lse, do, causal=True,
                                  delta=delta)
    for g, p, f, w in zip(got, pieces, fused, want):
        assert torch.equal(g, w) and torch.equal(p, w) and torch.equal(f, w)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that a wrapper
    takes its kernel branch; the test replaces the launches."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype,head_dim", [
    (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 64),
    (torch.bfloat16, 32), (torch.bfloat16, 96)])
def test_split_wrappers_route_by_design(monkeypatch, dtype, head_dim):
    """flash_bwd_dq and flash_bwd_dkv launch the kernel _design picks
    (the split dk/dv without a dq accumulator), as the fused backward
    does, and each counts the launch under that design."""
    design = fa._design(dtype, head_dim)
    calls = []
    monkeypatch.setattr(fa, "_bwd_args", lambda q, *a: (
        [q], [], a[-1] or q.dtype))
    monkeypatch.setattr(fa, "_launch_dq", lambda ops, dims, dq, d:
                        calls.append(("dq", d)))
    monkeypatch.setattr(fa, "_launch_dkv", lambda ops, dims, dq, dk, dv, d:
                        calls.append(("dkv", d, dq)))
    q = torch.Tensor._make_subclass(_FakeCuda,
                                    torch.zeros(1, 2, 64, head_dim, dtype=dtype))
    k = torch.zeros(1, 2, 64, head_dim, dtype=dtype)
    before = _counts()
    fa.flash_bwd_dq(q, k, k, q, None, None, causal=True)
    fa.flash_bwd_dkv(q, k, k, q, None, None, causal=True)
    assert calls == [("dq", design), ("dkv", design, None)]
    after = _counts()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        n, by = before[name]
        assert after[name] == (n + 1, dict(by, **{design: by[design] + 1}))
    for name in ("flash_fwd", "flash_bwd_fused"):
        assert after[name] == before[name]


class _FakeEntry:
    """A C entry point that checks its call against the argtypes its
    loader declared."""

    def __init__(self, lib, name):
        self.lib, self.name, self.argtypes = lib, name, None

    def __call__(self, *args):
        assert self.argtypes is not None, f"{self.name}: argtypes unset"
        assert len(args) == len(self.argtypes), (self.name, len(args))
        self.lib.calls.append((self.lib.name, self.name))
        return 0


class _FakeLib:
    def __init__(self, name, calls):
        self.name, self.calls, self.entries = name, calls, {}

    def __getattr__(self, entry):
        return self.entries.setdefault(entry, _FakeEntry(self, entry))


@pytest.mark.parametrize("design", ["wgmma", "simt"])
def test_launchers_call_the_designs_entry_points(monkeypatch, design):
    """Each launcher calls the C entry point of its design, with as many
    arguments as the loader declares: the tensor-core fused kernel
    (flash_bwd_sm90), the split dk/dv without a dq accumulator
    (flash_bwd_dkv_sm90) and the split dq (flash_bwd_dq_sm90), or the
    SIMT ones of csrc/flash_bwd.cu."""
    calls = []
    monkeypatch.setattr(fa.build, "load", lambda name: _FakeLib(name, calls))
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    ops = [torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)] * 6
    dims = [1, 2, 2, 64, 64, 64, 1, 0]
    out = torch.zeros(1, 2, 64, 64)
    fa._launch_dkv(ops, dims, out, out, out, design)
    fa._launch_dkv(ops, dims, None, out, out, design)
    fa._launch_dq(ops, dims, out, design)
    assert calls == ([("flash_bwd_sm90", "flash_bwd_sm90"),
                      ("flash_bwd_sm90", "flash_bwd_dkv_sm90"),
                      ("flash_bwd_dq_sm90", "flash_bwd_dq_sm90")]
                     if design == "wgmma" else
                     [("flash_bwd", "flash_bwd_dkv")] * 2
                     + [("flash_bwd", "flash_bwd_dq")])


@pytest.mark.parametrize("S,Sk,causal,window", [
    (64, 64, True, 0), (1024, 1024, True, 0), (200, 200, True, 0),
    (300, 300, True, 90), (1000, 1000, True, 256), (100, 260, False, 0)])
def test_band_bounds_walk_exactly_the_live_tiles(S, Sk, causal, window):
    """Both kernels' loop bounds visit every tile pair that holds a live
    (query, key) pair and no other, ragged last tiles included; a tile
    left unmasked (not an edge) is live throughout."""
    live = fa._live_mask(S, Sk, causal, window, "cpu")
    if live is None:
        live = torch.ones(S, Sk, dtype=torch.bool)
    nq, nk = -(-S // T), -(-Sk // T)
    want = {(i, j) for i in range(nq) for j in range(nk)
            if live[i * T:(i + 1) * T, j * T:(j + 1) * T].any()}
    fwd = {(i, j) for i in range(nq) for j in k_band(i * T, Sk, causal,
                                                     window)}
    bwd = {(i, j) for j in range(nk) for i in q_band(j * T, S, causal,
                                                     window)}
    assert fwd == want
    assert bwd == want
    for i, j in want:
        if not edge(i * T, j * T, S, Sk, causal, window):
            assert live[i * T:(i + 1) * T, j * T:(j + 1) * T].all()


def test_no_key_rule():
    """A tile with no live key leaves the running state at its start (no
    NaN from -inf - -inf); a row that never saw a key writes zeros and
    lse NO_KEY_LSE."""
    D = 64
    m = torch.full((T,), -math.inf)
    l, acc = torch.zeros(T), torch.zeros(T, D)
    s = torch.full((T, T), -math.inf)
    v = torch.randn(T, D, generator=torch.Generator().manual_seed(0))
    m, l, acc = online_step(s, m, l, acc, v, D ** -0.5 * LOG2E,
                            torch.bfloat16)
    assert torch.isinf(m).all() and (l == 0).all() and (acc == 0).all()
    out, lse = finish(m, l, acc, D ** -0.5)
    assert (out == 0).all()
    assert (lse == fa.NO_KEY_LSE).all()


@pytest.mark.parametrize("B,H,Hkv,S,Sk,D,causal,window", CASES, ids=IDS)
def test_emulated_forward_matches_plain_and_jax(B, H, Hkv, S, Sk, D,
                                                causal, window):
    """f32, no rounding: the tile walk against flash_fwd_reference (out
    and lse) and JAX _naive_attention (out), 1e-5."""
    q, k, v, _ = _inputs(1, B, H, Hkv, S, Sk, D)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = emulate_fwd(tq, tk, tv, causal, window)
    ro, rl = fa.flash_fwd_reference(tq, tk, tv, causal=causal,
                                    window=window)
    torch.testing.assert_close(out, ro, **F32_TOL)
    torch.testing.assert_close(lse, rl, **F32_TOL)
    want = _jax_naive(q, k, v, _, causal, window)[0]
    np.testing.assert_allclose(out.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("B,H,Hkv,S,Sk,D,causal,window", CASES, ids=IDS)
def test_emulated_forward_bf16_rounding(B, H, Hkv, S, Sk, D, causal,
                                        window):
    """bf16 inputs, p rounded to bf16 before P V (the kernel's point):
    within 2e-2 of the plain version's bf16 output; lse untouched by
    the rounding (1e-5)."""
    q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _inputs(2, B, H, Hkv, S, Sk, D))
    out, lse = emulate_fwd(q, k, v, causal, window, p_dtype=torch.bfloat16)
    ro, rl = fa.flash_fwd_reference(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.to(torch.bfloat16).float(), ro.float(),
                               rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse, rl, **F32_TOL)


@pytest.mark.parametrize("B,H,Hkv,S,Sk,D,causal,window", CASES, ids=IDS)
def test_emulated_backward_matches_plain_and_jax(B, H, Hkv, S, Sk, D,
                                                 causal, window):
    """f32, no rounding: the transposed backward walk against
    flash_bwd_reference and jax.vjp of _naive_attention, 1e-5."""
    q, k, v, do = _inputs(3, B, H, Hkv, S, Sk, D)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa.flash_fwd_reference(tq, tk, tv, causal=causal,
                                      window=window)
    delta = (tdo * out).sum(-1, keepdim=True)
    got = emulate_bwd(tq, tk, tv, tdo, lse, delta, causal, window)
    want = fa.flash_bwd_reference(tq, tk, tv, None, lse, tdo, causal=causal,
                                  window=window, delta=delta)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_TOL)
    jax_grads = _jax_naive(q, k, v, do, causal, window)[1:]
    for g, w in zip(got, jax_grads):
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL)


@pytest.mark.parametrize("B,H,Hkv,S,Sk,D,causal,window", CASES, ids=IDS)
def test_emulated_backward_bf16_rounding_points(B, H, Hkv, S, Sk, D,
                                                causal, window):
    """bf16 inputs with p and ds rounded to bf16 where the kernel rounds
    them: within 1e-2 of each gradient's largest magnitude of the plain
    version (f32 gradients of bf16 inputs)."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(4, B, H, Hkv, S, Sk, D))
    out, lse = fa.flash_fwd_reference(q, k, v, causal=causal, window=window)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    got = emulate_bwd(q, k, v, do, lse, delta, causal, window,
                      round_dtype=torch.bfloat16)
    want = fa.flash_bwd_reference(q, k, v, None, lse, do, causal=causal,
                                  window=window, delta=delta,
                                  grads_dtype=torch.float32)
    for g, w in zip(got, want):
        _close_rel(g, w, 1e-2)


def _split_walks(q, k, v, do, lse, delta, causal, window, round_dtype=None):
    """(dq, dk, dv) of the split pair's walks: the q-major dq kernel and
    the transposed dk/dv kernel without dq."""
    args = (q, k, v, do, lse, delta, causal, window, round_dtype)
    return (emulate_bwd_dq(*args), *emulate_bwd(*args, with_dq=False))


@pytest.mark.parametrize("B,H,Hkv,S,Sk,D,causal,window", CASES, ids=IDS)
def test_emulated_split_backward_matches_plain_and_jax(B, H, Hkv, S, Sk, D,
                                                       causal, window):
    """f32, no rounding: the split dq walk and the dk/dv walk without dq
    against flash_bwd_reference and jax.vjp of _naive_attention, 1e-5."""
    q, k, v, do = _inputs(5, B, H, Hkv, S, Sk, D)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa.flash_fwd_reference(tq, tk, tv, causal=causal,
                                      window=window)
    delta = (tdo * out).sum(-1, keepdim=True)
    got = _split_walks(tq, tk, tv, tdo, lse, delta, causal, window)
    want = fa.flash_bwd_reference(tq, tk, tv, None, lse, tdo, causal=causal,
                                  window=window, delta=delta)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_TOL)
    jax_grads = _jax_naive(q, k, v, do, causal, window)[1:]
    for g, w in zip(got, jax_grads):
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL)


@pytest.mark.parametrize("B,H,Hkv,S,Sk,D,causal,window", CASES, ids=IDS)
def test_emulated_split_backward_bf16_rounding_points(B, H, Hkv, S, Sk, D,
                                                      causal, window):
    """bf16 inputs, ds rounded to bf16 before dQ and dK and p before dV,
    where the split kernels round them: within 1e-2 of each gradient's
    largest magnitude of the plain version (f32 gradients of bf16
    inputs)."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(6, B, H, Hkv, S, Sk, D))
    out, lse = fa.flash_fwd_reference(q, k, v, causal=causal, window=window)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    got = _split_walks(q, k, v, do, lse, delta, causal, window,
                       round_dtype=torch.bfloat16)
    want = fa.flash_bwd_reference(q, k, v, None, lse, do, causal=causal,
                                  window=window, delta=delta,
                                  grads_dtype=torch.float32)
    for g, w in zip(got, want):
        _close_rel(g, w, 1e-2)


# Shapes the JAX kernels take (its tiles must divide the sequences):
# (B, H, Hkv, S, Sk, D, causal, window).
JAX_SPLIT_CASES = [(1, 2, 2, 128, 128, 64, True, 0),
                   (1, 4, 2, 192, 192, 64, True, 0),
                   (1, 4, 1, 128, 128, 64, True, 40),
                   (1, 2, 1, 128, 128, 128, True, 0),
                   (1, 2, 2, 64, 128, 64, False, 0)]
JAX_SPLIT_IDS = ["causal", "gqa-3-tiles", "window-gqa", "d128-gqa",
                 "noncausal-sq-sk"]


def _jax_split_bwd(monkeypatch, q, k, v, do, lse, delta, causal, window,
                   dtype, grads_dtype=None):
    """The JAX package's split backward kernels (_bwd_dq_kernel,
    _bwd_dkv_kernel) in interpret mode, (B, H, S, D) numpy arrays."""
    monkeypatch.setattr(jax_fa, "_FORCE_SPLIT_BWD", True)
    got = jax_fa._flash_bwd(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), None,
        jnp.asarray(lse), jnp.asarray(do, dtype), causal=causal,
        block_q=64, block_k=64, window=window, delta=jnp.asarray(delta),
        grads_dtype=grads_dtype)
    return [np.array(x, np.float32) for x in got]


@pytest.mark.parametrize("B,H,Hkv,S,Sk,D,causal,window", JAX_SPLIT_CASES,
                         ids=JAX_SPLIT_IDS)
def test_emulated_split_backward_matches_jax_split_kernels(
        monkeypatch, B, H, Hkv, S, Sk, D, causal, window):
    """The split walks against the JAX package's own split kernels on the
    same inputs: f32 at 1e-5; bf16 inputs with the rounding points and
    f32 gradients at 1e-2 of each gradient's largest magnitude."""
    q, k, v, do = _inputs(7, B, H, Hkv, S, Sk, D)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = fa.flash_fwd_reference(tq, tk, tv, causal=causal,
                                      window=window)
    delta = (tdo * out).sum(-1, keepdim=True)
    got = _split_walks(tq, tk, tv, tdo, lse, delta, causal, window)
    want = _jax_split_bwd(monkeypatch, q, k, v, do, lse.numpy(),
                          delta.numpy(), causal, window, jnp.float32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **F32_TOL)

    bq, bk, bv, bdo = (x.to(torch.bfloat16) for x in (tq, tk, tv, tdo))
    out, lse = fa.flash_fwd_reference(bq, bk, bv, causal=causal,
                                      window=window)
    delta = (bdo.float() * out.float()).sum(-1, keepdim=True)
    got = _split_walks(bq, bk, bv, bdo, lse, delta, causal, window,
                       round_dtype=torch.bfloat16)
    want = _jax_split_bwd(monkeypatch, q, k, v, do, lse.numpy(),
                          delta.numpy(), causal, window, jnp.bfloat16,
                          grads_dtype=jnp.float32)
    for g, w in zip(got, want):
        _close_rel(g, torch.from_numpy(w), 1e-2)


def _f32_grads_of_bf16_inputs(seed, B=2, H=8, Hkv=2, S=256, D=64):
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(seed, B, H, Hkv, S, S, D))
    out, lse = fa.flash_fwd_reference(q, k, v, causal=True)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    kw = dict(causal=True, delta=delta, grads_dtype=torch.float32)
    return (q, k, v, do, lse, kw,
            fa.flash_bwd_reference(q, k, v, None, lse, do, **kw))


def _rel_err(got, want):
    return (float((got.float() - want).abs().max())
            / max(float(want.abs().max()), 1.0))


def test_summation_order_alone_moves_f32_grads_of_bf16_inputs():
    """f32 gradients of bf16 inputs round p and ds to bf16 from f32
    logits; a kernel that sums those logits in another order rounds some
    of them the other way. The plain version against itself with the
    head-dim order permuted differs by more than 1e-4 of the largest
    gradient for some seeds, and stays within WGMMA_GRADS_F32_TOL for
    all of them."""
    worst = []
    for seed in range(16):
        rng = np.random.default_rng(seed)
        q, k, v, do, lse, kw, want = _f32_grads_of_bf16_inputs(seed)
        perm = torch.from_numpy(rng.permutation(q.shape[-1]))
        got = fa.flash_bwd_reference(q[..., perm], k[..., perm],
                                     v[..., perm], None, lse, do[..., perm],
                                     **kw)
        inv = torch.argsort(perm)
        worst.append(max(_rel_err(g[..., inv], w) for g, w in zip(got, want)))
    assert max(worst) > 1e-4, worst
    assert max(worst) < WGMMA_GRADS_F32_TOL, worst


def test_bf16_rounded_f32_grads_fail_the_tensor_core_limit():
    """The control of that limit: a kernel that rounded its f32
    gradients to bf16 (half a bf16 ulp, 2e-3 to 3.9e-3 of the largest
    gradient) fails WGMMA_GRADS_F32_TOL for every seed."""
    for seed in range(16):
        want = _f32_grads_of_bf16_inputs(seed)[-1]
        ctrl = max(_rel_err(w.to(torch.bfloat16), w) for w in want)
        assert ctrl > WGMMA_GRADS_F32_TOL, (seed, ctrl)
