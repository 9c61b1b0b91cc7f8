"""The paged-decode kernel's split_kv design, held on the CPU.

``csrc/paged_decode.cu`` runs only on the card. What can go wrong before
it gets there is checked here:

- the split count (``split_kv_plan``): whole pages, splits that cover the
  table and each start inside it, at least one split, Python ints only
  (a tensor would mean a device read on every decode step), and the
  combine's workspace size;
- a plain-torch emulation of the kernel's walk: the splits of whole pages
  from ``split_kv_plan``, pages cut into items of at most 16 KB of K and
  V, copied in rounds (the whole split when it fits 64 KB, else half
  that a round), the tokens of a round dealt to lane groups (token v to
  lane group v mod (4 warps x 32 / lanes per row)), each lane group's
  online softmax in the log2 domain (log2(e) folded into q's scale) over
  tiles of 8 of its tokens, one max and one rescale a tile, the lane
  groups merged, then the splits merged by the combine with weights
  exp2(m_i - max m): an empty split (m = -inf, l = 0) weighs 0 and its
  accumulator, never written (NaN here), is selected away, never
  multiplied, so it cannot reach the output;
- the wrapper's launch on CUDA-looking tensors: the plan it passes to the
  C entry point, the workspace, the counts, and the ValueError for
  operands the kernel cannot take (misaligned or strided views).

The emulation is held against the port's plain version
(``paged_attention_reference``) and the JAX package's ``paged_attention
(impl="ref")`` on shuffled pages built as ``tests/test_torch_ops.py``
builds them, from numpy inputs with a seed. Tolerance: f32 1e-5 abs/rel,
since the walk only reorders f32 sums (exp2 of a folded scale in place
of exp of a scaled logit adds an ulp or two). With bf16 inputs the
kernel keeps the weights in f32 and normalises at the end, where the
plain version rounds the normalised weights to bf16: 2e-2, the card's
limit (one bf16 ulp is 2**-7 relative).
"""

import math

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.ops import paged_attention as pa

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from distributed_training_tpu.ops import (  # noqa: E402
    paged_attention as jax_pa,
)

LOG2E = 1.4426950408889634
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# The kernel's geometry (csrc/paged_decode.cu): 4 warps, 16-byte vectors,
# at most 16 KB of K and V an item and 64 KB in shared memory, 8 tokens a
# tile.
WARPS = 4
ITEM_BYTES = 16384
RING_BYTES = 65536
TILE = 8
# (B, H, Hkv, hd, ps, P, lengths)
CASES = [
    (4, 2, 2, 8, 16, 32, [0, 64, 144, 700]),
    (3, 6, 2, 24, 5, 40, [65, 0, 131]),
    (2, 8, 2, 128, 7, 20, [70, 300]),
    (2, 4, 1, 256, 16, 4, [37, 0]),
    (2, 3, 3, 64, 16, 64, [1000, 1]),
    (1, 4, 4, 128, 16, 128, [2048]),
]
IDS = ["g1-hd8-empty-split-edge-page-edge-past-table",
       "g3-hd24-ps5-split-edge", "g4-hd128-ps7-past-table",
       "g4-hd256-one-split", "g1-hd64-16-splits", "long-single-32-splits"]


# -- the kernel's walk, in plain torch ---------------------------------------

def _geometry(hd: int, elt: int, ps: int, pages: int) -> tuple:
    """(lane groups per block, rows per item, items per page, items per
    round) of a split of ``pages`` pages."""
    nvec = hd * elt // 16
    lpr = 1
    while lpr < nvec and lpr < 32:
        lpr *= 2
    rows = min(ps, ITEM_BYTES // (2 * hd * elt))
    ipp = -(-ps // rows)
    fit = RING_BYTES // (2 * rows * hd * elt)
    items = pages * ipp
    return WARPS * (32 // lpr), rows, ipp, items if items <= fit else fit // 2


def _merge(m, l, acc):
    """Partial softmax results merged along m's and l's last dim (acc's
    last but one): weights exp2(m_i - max m); an empty partial
    (m = -inf) weighs 0 and its accumulator is selected away."""
    mx = m.amax(-1)
    empty = m == -math.inf
    w = torch.where(empty, 0.0, torch.exp2(m - mx.unsqueeze(-1)))
    a = torch.where(empty.unsqueeze(-1), 0.0, acc * w.unsqueeze(-1))
    return mx, (l * w).sum(-1), a.sum(-2)


def _emulate(q, k_pages, v_pages, lengths, page_indices):
    """The split_kv kernel and its combine. Returns the output and each
    split's (m, l), shaped (B, Hkv, G, splits)."""
    B, H, hd = q.shape
    Hkv, N, ps, _ = k_pages.shape
    P = page_indices.shape[1]
    G = H // Hkv
    splits, pages = pa.split_kv_plan(B, Hkv, P, ps)
    assert splits * pages >= P
    groups, rows, ipp, per_round = _geometry(hd, q.element_size(), ps, pages)
    span, items = pages * ps, pages * ipp
    pid = page_indices.long().clamp(0, N - 1)

    def dense(pool):  # (B, Hkv, P * ps, hd), f32
        return pool[:, pid].float().permute(1, 0, 2, 3, 4).reshape(
            B, Hkv, P * ps, hd)

    def first(i):  # the first token of item i of a split
        return (i // ipp) * ps + (i % ipp) * rows

    k, v = dense(k_pages), dense(v_pages)
    qs = q.float().reshape(B, Hkv, G, hd) * (hd ** -0.5 * LOG2E)
    s = torch.einsum("bhgd,bhtd->bhgt", qs, k)
    length = lengths.long().clamp(0, P * ps)
    m = torch.full((B, Hkv, G, splits, groups), -math.inf)
    l = torch.zeros(B, Hkv, G, splits, groups)
    acc = torch.zeros(B, Hkv, G, splits, groups, hd)
    lane = torch.arange(groups)[:, None] + torch.arange(TILE)[None] * groups
    for sp in range(splits):
        nv = (length - sp * span).clamp(0, span)[:, None, None]
        for i0 in range(0, items, per_round):
            v_lo = first(i0)
            v_hi = first(i0 + per_round) if i0 + per_round < items else span
            for base in range(v_lo, v_hi, TILE * groups):
                tok = base + lane  # (groups, TILE): lane group, tile slot
                ok = ((tok < v_hi) & (tok < nv))[:, None, None]
                pos = (sp * span + tok).clamp(max=P * ps - 1)
                st = torch.where(ok, s[..., pos], -math.inf)
                mo = m[..., sp, :]
                mn = torch.maximum(mo, st.amax(-1))
                a = torch.where(mo == -math.inf, 0.0, torch.exp2(mo - mn))
                p = torch.where(ok, torch.exp2(st - mn[..., None]), 0.0)
                m[..., sp, :] = mn
                l[..., sp, :] = l[..., sp, :] * a + p.sum(-1)
                acc[..., sp, :, :] = (
                    acc[..., sp, :, :] * a[..., None]
                    + torch.einsum("bhgst,bhstd->bhgsd", p, v[:, :, pos]))
    # Lane groups: within each warp, then across the 4 warps.
    shape = (B, Hkv, G, splits, WARPS, groups // WARPS)
    m, l, acc = _merge(m.reshape(shape), l.reshape(shape),
                       acc.reshape(*shape, hd))
    m, l, acc = _merge(m, l, acc)
    # A split starting at or past the length writes (m, l) = (-inf, 0)
    # and leaves its accumulator unwritten (torch.empty on the card).
    dead = (torch.arange(splits) * span)[None, :] >= length[:, None]
    dead = dead[:, None, None, :].expand_as(m)
    m = torch.where(dead, -math.inf, m)
    l = torch.where(dead, 0.0, l)
    acc = torch.where(dead[..., None], math.nan, acc)
    _, total, a = _merge(m, l, acc)
    out = torch.where(total[..., None] > 0, a / total[..., None], 0.0)
    return out.reshape(B, H, hd).to(q.dtype), m, l


# -- inputs --------------------------------------------------------------------

def _paged_case(rng, B, H, Hkv, hd, ps, P, lengths):
    """Pools whose pages are deliberately shuffled, built as
    tests/test_torch_ops.py builds them; table entries past a sequence's
    pages are 0 (the scratch page)."""
    N = 1 + B * P
    k_pages = np.zeros((Hkv, N, ps, hd), np.float32)
    v_pages = np.zeros((Hkv, N, ps, hd), np.float32)
    tables = np.zeros((B, P), np.int32)
    dense_k = rng.standard_normal((B, P * ps, Hkv, hd)).astype(np.float32)
    dense_v = rng.standard_normal((B, P * ps, Hkv, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, N))
    pi = 0
    for b in range(B):
        for j in range(min(P, -(-int(lengths[b]) // ps))):
            pid = int(perm[pi])
            pi += 1
            tables[b, j] = pid
            chunk = slice(j * ps, (j + 1) * ps)
            k_pages[:, pid] = dense_k[b, chunk].transpose(1, 0, 2)
            v_pages[:, pid] = dense_v[b, chunk].transpose(1, 0, 2)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    return q, k_pages, v_pages, np.asarray(lengths, np.int32), tables


def _jax_ref(q, kp, vp, lengths, tables):
    return np.asarray(jax_pa.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(tables), impl="ref"))


# -- the split count ------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("Hkv", [1, 12])
@pytest.mark.parametrize("P,ps", [(1, 16), (4, 16), (64, 16), (128, 16),
                                  (40, 5), (20, 7), (1000, 1), (3, 300)])
def test_split_plan_invariants(B, Hkv, P, ps):
    splits, pages = pa.split_kv_plan(B, Hkv, P, ps)
    assert type(splits) is int and type(pages) is int
    assert splits >= 1 and pages >= 1
    assert splits * pages >= P            # every page is in some split
    assert (splits - 1) * pages < P       # every split starts in the table
    # About 64-256 tokens a split (a page larger than that alone).
    assert pages * ps >= min(64, P * ps) or pages == P or splits == 1
    assert pages * ps <= max(256, ps) or splits == 1
    assert pa.workspace_numel(B, 4 * Hkv, 64, splits) == (
        B * 4 * Hkv * splits * 66 if splits > 1 else 0)


@pytest.mark.parametrize("B,Hkv,P,plan", [
    (8, 12, 64, (8, 8)), (8, 4, 64, (16, 4)), (8, 8, 128, (16, 8)),
    (1, 16, 128, (32, 4))],
    ids=["gpt2-serving", "f32-gqa", "long-gqa", "long-single"])
def test_split_plan_at_the_smoke_geometries(B, Hkv, P, plan):
    """chip_smoke.py's decode cases (pages of 16): splits of a power of
    two of pages that tile the table exactly, and at least two blocks a
    streaming multiprocessor when every sequence is full."""
    splits, pages = pa.split_kv_plan(B, Hkv, P, 16)
    assert (splits, pages) == plan
    assert splits * pages == P and pages & (pages - 1) == 0
    assert B * Hkv * splits >= 2 * pa.SMS


@pytest.mark.parametrize("bad", [torch.tensor(8), np.int32(8), 8.0, True,
                                 "8"])
def test_split_plan_takes_python_ints_only(bad):
    for i in range(4):
        args = [8, 12, 64, 16]
        args[i] = bad
        with pytest.raises(TypeError, match="Python ints"):
            pa.split_kv_plan(*args)


@pytest.mark.parametrize("i", range(4))
def test_split_plan_rejects_non_positive(i):
    args = [8, 12, 64, 16]
    args[i] = 0
    with pytest.raises(ValueError, match="positive"):
        pa.split_kv_plan(*args)


def test_workspace_holds_accumulator_and_stats_per_split():
    assert pa.workspace_numel(8, 12, 64, 1) == 0
    assert pa.workspace_numel(8, 12, 64, 11) == 8 * 12 * 11 * (64 + 2)
    assert pa.workspace_numel(1, 16, 128, 32) == 16 * 32 * 130


# -- the emulated walk ------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,hd,ps,P,lengths", CASES, ids=IDS)
def test_emulated_split_walk_matches_plain_and_jax(B, H, Hkv, hd, ps, P,
                                                   lengths):
    """f32: the split walk and combine equal the port's plain version and
    the JAX reference; length-0 rows are exact zeros."""
    case = _paged_case(np.random.default_rng(7), B, H, Hkv, hd, ps, P,
                       lengths)
    args = [torch.from_numpy(x) for x in case]
    got, _, _ = _emulate(*args)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _jax_ref(*case), **F32_TOL)
    plain = pa.paged_attention_reference(*args)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()


@pytest.mark.parametrize("B,H,Hkv,hd,ps,P,lengths", CASES, ids=IDS)
def test_empty_splits_write_empty_partials(B, H, Hkv, hd, ps, P, lengths):
    """A split whose range starts at or past the length holds (-inf, 0);
    every split of a length-0 row does; a split with a key holds a finite
    max and a positive sum."""
    args = [torch.from_numpy(x) for x in _paged_case(
        np.random.default_rng(8), B, H, Hkv, hd, ps, P, lengths)]
    _, m, l = _emulate(*args)
    splits, pages = pa.split_kv_plan(B, Hkv, P, ps)
    for b, n in enumerate(lengths):
        n = min(max(n, 0), P * ps)
        for s in range(splits):
            if s * pages * ps >= n:
                assert (m[b, ..., s] == -math.inf).all()
                assert (l[b, ..., s] == 0).all()
            else:
                assert torch.isfinite(m[b, ..., s]).all()
                assert (l[b, ..., s] > 0).all()


@pytest.mark.parametrize("B,H,Hkv,hd,ps,P,lengths", CASES[:4], ids=IDS[:4])
def test_emulated_split_walk_bf16_within_card_limit(B, H, Hkv, hd, ps, P,
                                                    lengths):
    """bf16 inputs: the kernel's f32 weights, normalised at the end,
    against the plain version's bf16-rounded normalised weights, within
    the card's 2e-2."""
    case = _paged_case(np.random.default_rng(9), B, H, Hkv, hd, ps, P,
                       lengths)
    args = [torch.from_numpy(x) for x in case]
    args[:3] = [x.to(torch.bfloat16) for x in args[:3]]
    got, _, _ = _emulate(*args)
    assert got.dtype == torch.bfloat16
    plain = pa.paged_attention_reference(*args)
    torch.testing.assert_close(got.float(), plain.float(), **BF16_TOL)


def test_one_split_and_many_agree():
    """The same sequences through one split (P 4) and through many (the
    same pages at the end of a longer table) give the same output."""
    rng = np.random.default_rng(10)
    q, kp, vp, lengths, tables = _paged_case(rng, 2, 4, 2, 64, 16, 4,
                                             [50, 64])
    wide = np.zeros((2, 64), np.int32)
    wide[:, :4] = tables
    one = _emulate(*(torch.from_numpy(x) for x in (q, kp, vp, lengths,
                                                   tables)))[0]
    many = _emulate(*(torch.from_numpy(x) for x in (q, kp, vp, lengths,
                                                    wide)))[0]
    assert pa.split_kv_plan(2, 2, 4, 16)[0] == 1
    assert pa.split_kv_plan(2, 2, 64, 16)[0] > 1
    np.testing.assert_allclose(one.numpy(), many.numpy(), **F32_TOL)


# -- the wrapper's launch -----------------------------------------------------------

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that the wrapper
    takes its kernel branch; the test replaces the launch."""

    @property
    def is_cuda(self):
        return True


def _fake(t):
    return torch.Tensor._make_subclass(_FakeCuda, t)


class _FakeEntry:
    def __init__(self):
        self.calls, self.argtypes, self.restype = [], None, None

    def __call__(self, *args):
        assert self.argtypes is not None and len(args) == len(self.argtypes)
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    entry = _FakeEntry()
    entry.argtypes = [None] * 19
    monkeypatch.setattr(pa, "_ENTRY", (None, entry))
    monkeypatch.setattr(pa.torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 0}))
    return entry


def _operands(B, H, Hkv, hd, ps, P, lengths, dtype=torch.bfloat16):
    case = _paged_case(np.random.default_rng(11), B, H, Hkv, hd, ps, P,
                       lengths)
    ts = [torch.from_numpy(x) for x in case]
    ts[:3] = [x.to(dtype) for x in ts[:3]]
    return ts


@pytest.mark.parametrize("B,H,Hkv,hd,ps,P,lengths", [
    (2, 4, 2, 64, 16, 4, [40, 9]), (3, 12, 12, 64, 16, 64, [900, 0, 17]),
    (2, 8, 2, 128, 7, 20, [70, 300])], ids=["one-split", "many", "gqa-ps7"])
def test_wrapper_launches_the_plan(fake_launch, B, H, Hkv, hd, ps, P,
                                   lengths):
    """One C call with the shapes, the plan of split_kv_plan and a
    workspace of workspace_numel floats (none for one split); one launch
    counted, under split_kv."""
    ops = [_fake(t) for t in _operands(B, H, Hkv, hd, ps, P, lengths)]
    n0 = pa.paged_attention.launches
    d0 = dict(pa.paged_attention.launches_by_design)
    out = pa.paged_attention(*ops)
    assert out.shape == ops[0].shape and out.dtype == ops[0].dtype
    (args,) = fake_launch.calls
    splits, pages = pa.split_kv_plan(B, Hkv, P, ps)
    N = ops[1].shape[1]
    assert args[7:16] == (B, H, Hkv, N, ps, hd, P, splits, pages)
    assert (args[6] is None) is (splits == 1)
    assert args[16] == hd ** -0.5 and args[17] == 1
    assert pa.paged_attention.launches == n0 + 1
    assert pa.paged_attention.launches_by_design == dict(
        d0, split_kv=d0["split_kv"] + 1)


@pytest.mark.parametrize("which", ["q", "k_pages", "v_pages"])
def test_wrapper_raises_on_misaligned_operand(fake_launch, which):
    """A view that does not start on a 16-byte boundary raises
    ValueError and launches nothing."""
    ops = dict(zip(("q", "k_pages", "v_pages", "lengths", "page_indices"),
                   _operands(2, 4, 2, 64, 16, 8, [40, 100])))
    t = ops[which]
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    shifted = flat[1:].view(t.shape)
    shifted.copy_(t)
    assert shifted.data_ptr() % 16
    ops[which] = shifted
    n0 = pa.paged_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attention(*(_fake(x) for x in ops.values()))
    assert pa.paged_attention.launches == n0 and not fake_launch.calls


def test_wrapper_raises_on_strided_pool(fake_launch):
    q, kp, vp, L, T = _operands(2, 4, 2, 64, 16, 8, [40, 100])
    strided = torch.cat([kp, kp], dim=-1)[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(*(_fake(x) for x in (q, strided, vp, L, T)))
    assert not fake_launch.calls


@pytest.mark.parametrize("splits,numel,dtype", [
    (4, 10, torch.float32), (4, None, torch.float32),
    (4, 4 * 8 * 66, torch.bfloat16)])
def test_kernel_args_check_the_workspace(splits, numel, dtype):
    q, kp, vp, L, T = _operands(2, 4, 2, 64, 16, 8, [40, 100])
    ws = None if numel is None else torch.empty(numel, dtype=dtype)
    with pytest.raises(ValueError, match="workspace"):
        pa._check_kernel_args(q, kp, vp, L, T, torch.empty_like(q), ws,
                              splits)
    pa._check_kernel_args(q, kp, vp, L, T, torch.empty_like(q),
                          torch.empty(pa.workspace_numel(2, 4, 64, splits)),
                          splits)


def test_entry_point_declared_once(monkeypatch):
    """The library is loaded and its argument types set on the first
    launch only: 7 pointers, 9 ints, the scale, the dtype and the
    stream."""
    loads = []

    class Lib:
        def __init__(self):
            self.paged_decode = _FakeEntry()

    monkeypatch.setattr(pa, "_ENTRY", None)
    monkeypatch.setattr(pa.build, "load",
                        lambda name: loads.append(name) or Lib())
    lib, fn = pa._entry()
    assert pa._entry() == (lib, fn)
    assert loads == ["paged_decode"]
    assert len(fn.argtypes) == 19


def test_cpu_tensors_launch_nothing():
    ops = _operands(2, 4, 2, 64, 16, 8, [40, 0], torch.float32)
    n0 = pa.paged_attention.launches
    d0 = dict(pa.paged_attention.launches_by_design)
    out = pa.paged_attention(*ops)
    assert torch.equal(out, pa.paged_attention_reference(*ops))
    assert pa.paged_attention.launches == n0
    assert pa.paged_attention.launches_by_design == d0
