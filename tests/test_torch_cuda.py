"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip with a reason where there is no CUDA device.  The machine with
the card has no JAX, and ``tests/conftest.py`` imports it, so run them
there without the conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This file imports neither ``jax`` nor ``asyncframework_tpu``.
"""

import numpy as np
import pytest
import torch

from asyncframework_tpu_torch.ops.chunk_attention import (
    chunk_attention,
    chunk_attention_reference,
)
from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.ops import sparse_grad as sg
from asyncframework_tpu_torch.ops.masked_grad import (
    masked_grad,
    masked_grad_reference,
    saga_grad,
    saga_grad_reference,
    xt_coeff,
    xt_coeff_reference,
)
from asyncframework_tpu_torch.ops.steps import compact_mask
from torch_procs import kill_and_reap, readline_within

pytestmark = pytest.mark.cuda

# f32: the kernel and the plain version sum the same products in different
# orders; bf16: a one-ulp flip of a row coefficient's bf16 rounding moves g
# by 2^-8 of that row's term
REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _problem(n, d, dev, dtype, seed=0):
    rs = np.random.default_rng(seed)
    X = torch.tensor(rs.normal(size=(n, d)), dtype=torch.float32, device=dev)
    y = torch.tensor(rs.normal(size=n), dtype=torch.float32, device=dev)
    w = torch.tensor(rs.normal(size=d), dtype=torch.float32, device=dev)
    mask = torch.tensor(rs.random(n) < 0.5, device=dev)
    return X.to(dtype), y, w, mask


def _close(got, want, rel):
    want = want.cpu()
    torch.testing.assert_close(
        got.cpu(), want, rtol=rel, atol=rel * float(want.abs().max().clamp(min=1))
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(999, 130), (17, 8), (300, 100), (5000, 784)])
@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
def test_kernel_matches_plain_version(dev, dtype, n, d, loss):
    X, y, w, sel = _problem(n, d, dev, dtype)
    cap = max(8, n // 3)
    valid, idx = compact_mask(sel, cap)
    for m, i in ((sel.float(), None), (None, None), (valid, idx)):
        got = masked_grad(X, y, w, m, i, loss)
        _close(got, masked_grad_reference(X, y, w, m, i, loss), REL[dtype])
        assert torch.equal(got, masked_grad(X, y, w, m, i, loss))


def test_kernel_edges(dev):
    w = torch.ones(8, device=dev)
    g = masked_grad(torch.zeros(0, 8, device=dev), torch.zeros(0, device=dev), w)
    assert g.shape == (8,) and not g.any()
    # a row too wide for the shared-memory accumulator takes the global one
    X, y, w, sel = _problem(40, 60_000, dev, torch.float32, seed=1)
    _close(masked_grad(X, y, w, sel.float()),
           masked_grad_reference(X, y, w, sel.float()), REL[torch.float32])
    # a width that is no multiple of 4 takes the scalar-load path
    Xs = X[:, 1:].contiguous()
    ws = w[1:].contiguous()
    _close(masked_grad(Xs, y, ws), masked_grad_reference(Xs, y, ws),
           REL[torch.float32])


def test_launch_counter_counts_kernel_calls(dev):
    X, y, w, sel = _problem(64, 16, dev, torch.float32)
    before = masked_grad.launches
    masked_grad(X, y, w, sel.float())
    assert masked_grad.launches == before + 1


# ------------------------------------------------- masked_grad, ASAGA forms
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(999, 130), (17, 8), (5000, 784)])
def test_saga_forms_match_plain_versions(dev, dtype, n, d):
    X, y, w, sel = _problem(n, d, dev, dtype, seed=2)
    alpha = torch.randn(n, device=dev)
    for mask in (sel.float(), None):
        g, diff = saga_grad(X, y, w, alpha, mask)
        g_ref, diff_ref = saga_grad_reference(X, y, w, alpha, mask)
        _close(diff, diff_ref, REL[torch.float32])
        _close(g, g_ref, REL[dtype])
        g2, diff2 = saga_grad(X, y, w, alpha, mask)
        assert torch.equal(g, g2) and torch.equal(diff, diff2)
    c = torch.randn(n, device=dev)
    got = xt_coeff(X, c)
    # c is not rounded to bf16: the f32 tolerance holds for both dtypes
    _close(got, xt_coeff_reference(X, c), REL[torch.float32])
    assert torch.equal(got, xt_coeff(X, c))


def test_saga_forms_are_counted(dev):
    X, y, w, sel = _problem(64, 16, dev, torch.float32)
    before = (masked_grad.launches, saga_grad.launches, xt_coeff.launches)
    saga_grad(X, y, w, torch.zeros(64, device=dev), sel.float())
    xt_coeff(X, y)
    after = (masked_grad.launches, saga_grad.launches, xt_coeff.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 1, 1]


# ------------------------------------------------ masked_grad, staged route
def _route_counts():
    return masked_grad.launches_staged, masked_grad.launches_tiled


def _routed(fn):
    """The result of ``fn()`` and its (staged, tiled) launches."""
    before = _route_counts()
    out = fn()
    return out, tuple(a - b for a, b in zip(_route_counts(), before))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [784, 2_000])
@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
@pytest.mark.parametrize("m", [1, 7, 131, 1_000, 40_000])
def test_staged_route_matches_plain_version(dev, dtype, d, loss, m):
    """Duplicate rows, padding slots (row 0, weight 0) and indices outside
    [0, n), from one slot to many ring cycles and chunk rounds a block."""
    n = 3_000
    X, y, w, _ = _problem(n, d, dev, dtype, seed=8)
    rs = np.random.default_rng(9)
    idx_np = rs.integers(-5, n + 5, size=m)
    weights_np = (rs.random(m) < 0.7).astype(np.float32)
    pad = m // 10  # compact_mask's padding: index 0, weight 0
    idx_np[m - pad:] = 0
    weights_np[m - pad:] = 0.0
    idx = torch.tensor(idx_np, device=dev)
    weights = torch.tensor(weights_np, device=dev)
    with mg.pinned_route("staged"):
        (got, again), counts = _routed(
            lambda: (masked_grad(X, y, w, weights, idx, loss),
                     masked_grad(X, y, w, weights, idx, loss)))
    assert counts == (2, 0)
    inside = ((idx >= 0) & (idx < n)).float()
    want = masked_grad_reference(X, y, w, weights * inside, idx.clamp(0, n - 1),
                                 loss)
    _close(got, want, REL[dtype])
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_route_multiplies_padding_slots(dev, dtype):
    """A padding slot reads row 0 and multiplies it by weight 0, as the
    plain version does: a non-finite row 0 makes g NaN on both."""
    X, y, w, sel = _problem(40_000, 784, dev, dtype, seed=10)
    valid, idx = compact_mask(sel, 25_000)  # padding slots at the end
    assert float(valid.min()) == 0.0
    finite = masked_grad(X, y, w, valid, idx)
    assert torch.isfinite(finite).all()
    X[0, 3] = float("inf")
    got, counts = _routed(lambda: masked_grad(X, y, w, valid, idx))
    assert counts == (1, 0)
    want = masked_grad_reference(X, y, w, valid, idx)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [784, 2_000])
def test_saga_forms_on_their_routes(dev, dtype, d):
    """saga_grad and xt_coeff take the staged route, and the tiled route
    (pinned) agrees with them."""
    n = 40_000
    X, y, w, sel = _problem(n, d, dev, dtype, seed=11)
    alpha = torch.randn(n, device=dev)
    mask = sel.float()
    (g, diff), counts = _routed(lambda: saga_grad(X, y, w, alpha, mask))
    assert counts == (1, 0)
    g_ref, diff_ref = saga_grad_reference(X, y, w, alpha, mask)
    _close(diff, diff_ref, REL[torch.float32])
    _close(g, g_ref, REL[dtype])
    g2, diff2 = saga_grad(X, y, w, alpha, mask)
    assert torch.equal(g, g2) and torch.equal(diff, diff2)
    c = mask * torch.randn(n, device=dev)
    got, counts = _routed(lambda: xt_coeff(X, c))
    assert counts == (1, 0)
    _close(got, xt_coeff_reference(X, c), REL[torch.float32])
    assert torch.equal(got, xt_coeff(X, c))
    with mg.pinned_route("tiled"):
        tiled = xt_coeff(X, c)
    _close(tiled, xt_coeff_reference(X, c), REL[torch.float32])


def test_staged_launches_on_two_streams_at_once(dev):
    """Staged launches on two streams of one card may overlap (the second's
    blocks start as the first's drain); each stream claims chunks from its
    own counter, so every launch gives the one-stream result, bit for bit."""
    n = 20_000
    Xa, ya, wa, sa = _problem(n, 2_000, dev, torch.float32, seed=13)
    Xb, yb, wb, sb = _problem(n, 784, dev, torch.bfloat16, seed=14)
    ma, mb = sa.float(), sb.float()
    want_a = masked_grad(Xa, ya, wa, ma)
    want_b = masked_grad(Xb, yb, wb, mb)
    _close(want_a, masked_grad_reference(Xa, ya, wa, ma), REL[torch.float32])
    _close(want_b, masked_grad_reference(Xb, yb, wb, mb), REL[torch.bfloat16])
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize(dev)
    outs = []
    before = _route_counts()
    for _ in range(50):
        with torch.cuda.stream(streams[0]):
            a = masked_grad(Xa, ya, wa, ma)
        with torch.cuda.stream(streams[1]):
            b = masked_grad(Xb, yb, wb, mb)
        outs.append((a, b))
    torch.cuda.synchronize(dev)
    assert tuple(x - y for x, y in zip(_route_counts(), before)) == (100, 0)
    for a, b in outs:
        assert torch.equal(a, want_a) and torch.equal(b, want_b)
    # whether two cooperative launches ever overlap is the card's choice:
    # the streams must not share a counter either way
    counters = [mg._counters[(dev, s.cuda_stream)] for s in streams]
    assert counters[0].data_ptr() != counters[1].data_ptr()
    assert not any(int(c) for c in counters)


def test_routes_are_chosen_by_shape_and_counted(dev):
    n = 20_000
    X, y, w, sel = _problem(n, 2_000, dev, torch.float32, seed=12)
    mask = sel.float()
    # aligned rows, 160 MB of X: staged
    _, counts = _routed(lambda: masked_grad(X, y, w, mask))
    assert counts == (1, 0)
    # a width that is no multiple of 4: tiled
    Xu, wu = X[:, 1:].contiguous(), w[1:].contiguous()
    _, counts = _routed(lambda: masked_grad(Xu, y, wu, mask))
    assert counts == (0, 1)
    # rows at an address 4 bytes off 16: tiled
    flat = torch.zeros(n * 2_000 + 1, device=dev)
    Xo = flat[1:].view(n, 2_000)
    Xo.copy_(X)
    got, counts = _routed(lambda: masked_grad(Xo, y, w, mask))
    assert counts == (0, 1)
    _close(got, masked_grad_reference(X, y, w, mask), REL[torch.float32])
    # under the least bytes of X: tiled
    few = 16
    _, counts = _routed(lambda: masked_grad(X[:few], y[:few], w, mask[:few]))
    assert counts == (0, 1)
    # the total counts every launch of both
    before = masked_grad.launches
    _routed(lambda: masked_grad(X, y, w, mask))
    _routed(lambda: masked_grad(Xu, y, wu, mask))
    assert masked_grad.launches == before + 2


# ---------------------------------------------------------- chunk_attention
# f32 sums of D products and of Tk exponentials in another order than the
# plain version's: o to 1e-5 of max|o|, m to 1e-5 absolute (O(1) scores),
# l to 1e-5 relative
def _attention_close(got, want):
    o, m, l = (t.cpu() for t in got)
    wo, wm, wl = (t.cpu() for t in want)
    torch.testing.assert_close(o, wo, rtol=1e-5,
                               atol=1e-5 * float(wo.abs().max()))
    torch.testing.assert_close(m, wm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, wl, rtol=1e-5, atol=0.0)


def _qkv(dev, b, tq, tk, h, d, dtype, seed=0):
    rs = np.random.default_rng(seed)
    return [torch.tensor(rs.normal(size=(b, t, h, d)), dtype=torch.float32,
                         device=dev).to(dtype)
            for t in (tq, tk, tk)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,tq,tk,h,d", [
    (2, 24, 18, 3, 20), (1, 1, 18, 3, 64), (1, 100, 77, 2, 64),
    (1, 130, 200, 2, 128), (2, 70, 70, 2, 200), (1, 64, 64, 1, 256),
])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "random"])
def test_chunk_attention_matches_plain_version(dev, dtype, b, tq, tk, h, d,
                                               mask_kind):
    q, k, v = _qkv(dev, b, tq, tk, h, d, dtype)
    if mask_kind == "causal":
        mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(tk - tq)
    elif mask_kind == "random":
        mask = torch.tensor(np.random.default_rng(1).random((tq, tk)) > 0.3,
                            device=dev)
        mask[tq // 2] = False  # a fully masked row
    else:
        mask = None
    got = chunk_attention(q, k, v, mask)
    _attention_close(got, chunk_attention_reference(q, k, v, mask))
    again = chunk_attention(q, k, v, mask)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if mask_kind == "random":
        assert torch.all(got[2][:, :, tq // 2] == float(-(-tk // 8) * 8))


def _tc_launches(fn):
    """The result of ``fn()`` and the tensor-core launches it made."""
    before = chunk_attention.launches_tc
    out = fn()
    return out, chunk_attention.launches_tc - before


# f32 inputs take the f32 route, bf16 ones (D = 64) the tensor-core route
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_attention_skipped_tiles_change_no_bit(dev, dtype):
    """Under a causal mask the first 64 query rows skip every key tile
    after the first (wholly masked, and each row already has a key): their
    (o, m, l) must equal, bit for bit, those of the same rows over the
    first key tile alone."""
    q, k, v = _qkv(dev, 2, 200, 200, 3, 64, dtype, seed=5)
    mask = torch.ones(200, 200, dtype=torch.bool, device=dev).tril()
    full, tc = _tc_launches(lambda: chunk_attention(q, k, v, mask))
    assert tc == (dtype == torch.bfloat16)
    head = chunk_attention(q[:, :64], k[:, :64], v[:, :64],
                           mask[:64, :64].contiguous())
    assert torch.equal(full[0][:, :64], head[0])
    assert torch.equal(full[1][:, :, :64], head[1])
    assert torch.equal(full[2][:, :, :64], head[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_attention_reads_strided_views(dev, dtype):
    q, k, v = _qkv(dev, 2, 90, 90, 4, 64, dtype)
    qs, ks, vs = q[:, 10:70], k[:, 5:50, 1:3], v[:, 5:50, 1:3]
    qs = qs[:, :, 1:3]
    got, tc = _tc_launches(lambda: chunk_attention(qs, ks, vs))
    assert tc == (dtype == torch.bfloat16)  # the views suit TMA
    want = chunk_attention(qs.contiguous(), ks.contiguous(), vs.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_chunk_attention_counts_launches(dev):
    q, k, v = _qkv(dev, 1, 8, 8, 1, 16, torch.float32)
    before = chunk_attention.launches
    chunk_attention(q, k, v)
    assert chunk_attention.launches == before + 1


# ------------------------------------- chunk_attention, tensor-core route
@pytest.mark.parametrize("b,tq,tk,h,d", [
    (1, 300, 257, 4, 128), (2, 100, 77, 3, 64), (1, 1, 18, 3, 128),
    (1, 64, 64, 2, 64), (2, 130, 200, 2, 128), (1, 70, 90, 2, 16),
    (1, 65, 300, 2, 256),
])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "random"])
def test_tensor_core_route_matches_plain_version(dev, b, tq, tk, h, d,
                                                 mask_kind):
    q, k, v = _qkv(dev, b, tq, tk, h, d, torch.bfloat16, seed=6)
    if mask_kind == "causal":
        mask = torch.ones(tq, tk, dtype=torch.bool, device=dev).tril(tk - tq)
    elif mask_kind == "random":
        mask = torch.tensor(np.random.default_rng(2).random((tq, tk)) > 0.3,
                            device=dev)
        mask[tq // 2] = False  # a fully masked row
    else:
        mask = None
    got, tc = _tc_launches(lambda: chunk_attention(q, k, v, mask))
    assert tc == 1
    _attention_close(got, chunk_attention_reference(q, k, v, mask))
    again = chunk_attention(q, k, v, mask)
    assert all(torch.equal(a, b2) for a, b2 in zip(got, again))
    if mask_kind == "random":
        assert torch.all(got[2][:, :, tq // 2] == float(-(-tk // 8) * 8))


def test_bf16_views_tma_cannot_read_take_the_f32_route(dev):
    """Heads 68 elements apart (no multiple of 16 bytes): the f32 route
    reads the bf16 view, and agrees with the tensor-core route on a
    packed copy within the tolerance."""
    rs = np.random.default_rng(7)
    base = torch.tensor(rs.normal(size=(1, 96, 2 * 68)), dtype=torch.float32,
                        device=dev).to(torch.bfloat16)
    x = base.view(1, 96, 2, 68)[..., :64]
    got, tc = _tc_launches(lambda: chunk_attention(x, x, x))
    assert tc == 0
    packed, tc = _tc_launches(
        lambda: chunk_attention(x.contiguous(), x.contiguous(), x.contiguous()))
    assert tc == 1
    _attention_close(got, packed)


def test_chunk_attention_counts_launches_per_route(dev):
    f32 = _qkv(dev, 1, 8, 8, 1, 16, torch.float32)
    bf16 = _qkv(dev, 1, 8, 8, 1, 16, torch.bfloat16)
    odd = _qkv(dev, 1, 8, 8, 1, 20, torch.bfloat16)  # D % 16 != 0
    before = (chunk_attention.launches, chunk_attention.launches_tc)
    for qkv in (f32, bf16, odd, bf16):
        chunk_attention(*qkv)
    after = (chunk_attention.launches, chunk_attention.launches_tc)
    assert (after[0] - before[0], after[1] - before[1]) == (4, 2)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_and_ulysses_on_one_card(dev, causal):
    """Four ranks on one card: the "cuda" block path against the "torch"
    path and exact attention, within test_ring.py's output tolerance."""
    from asyncframework_tpu_torch.parallel import (
        make_mesh,
        reference_attention,
        ring_attention,
        ulysses_attention,
    )

    mesh = make_mesh(4, axis_names=("sp",), devices=[dev] * 4)
    q, k, v = _qkv(dev, 1, 256, 256, 8, 64, torch.float32, seed=3)
    want = reference_attention(q, k, v, causal=causal)
    before = chunk_attention.launches
    for out in (ring_attention(q, k, v, mesh, causal=causal, block_kernel="cuda"),
                ring_attention(q, k, v, mesh, causal=causal),
                ulysses_attention(q, k, v, mesh, causal=causal,
                                  block_kernel="cuda", pallas_block=64)):
        torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-5)
    assert chunk_attention.launches - before == (10 if causal else 16) + 16


def test_asaga_run_sync_on_the_card_matches_the_cpu(dev):
    from asyncframework_tpu_torch.solvers import ASAGA, SolverConfig

    rs = np.random.default_rng(4)
    X = rs.normal(size=(2048, 64)).astype(np.float32)
    y = (X @ rs.normal(size=64)).astype(np.float32)
    cfg = SolverConfig(num_workers=4, num_iterations=20, gamma=0.3,
                       batch_rate=1.0, printer_freq=5)
    w_gpu = ASAGA(X, y, cfg, devices=[dev]).run_sync().final_w
    w_cpu = ASAGA(X, y, cfg, devices=[torch.device("cpu")]).run_sync().final_w
    np.testing.assert_allclose(w_gpu, w_cpu, rtol=1e-4,
                               atol=1e-4 * float(np.abs(w_cpu).max()))


# ------------------------------------------------------------ sparse_grad
def _ell(m, K, d, dev, rate=0.5, cap=None, one_column=False, seed=0):
    """A padded-ELL shard of ``m`` rows, a quarter of each row padding, and
    a compacted sample of ``cap`` slots."""
    rs = np.random.default_rng(seed)
    cols = rs.integers(0, d, size=(m, K)).astype(np.int32)
    if one_column:
        cols[:] = d // 2
    vals = rs.normal(size=(m, K)).astype(np.float32)
    live = K - K // 4
    cols[:, live:], vals[:, live:] = 0, 0.0
    y = rs.normal(size=m).astype(np.float32)
    w = rs.normal(size=d).astype(np.float32)
    sel = torch.tensor(rs.random(m) < rate, device=dev)
    valid, idx = compact_mask(sel, cap if cap is not None else max(8, m // 2))
    t = [torch.tensor(a, device=dev) for a in (cols, vals, y, w)]
    return (*t, valid, idx)


# (rows, K, d, rate, one_column): rcv1's pad width, the edges chip_smoke.py
# times (no valid slot, d = 1, every update in one column, K = 8)
SPARSE_CASES = [(2_000, 80, 47_236, 0.1, False), (300, 80, 5_000, 0.0, False),
                (500, 16, 1, 0.5, False), (400, 80, 1_000, 0.5, True),
                (999, 8, 300, 0.3, False), (64, 200, 77, 1.0, False)]


@pytest.mark.parametrize("m,K,d,rate,one_column", SPARSE_CASES)
def test_sparse_grad_matches_plain_versions(dev, m, K, d, rate, one_column):
    """Both entry points bit-equal to their plain versions (the residual's
    plain version takes the kernel's lane order; the segment sum's, on the
    CPU, adds in sorted order as the kernel does) and across launches; the
    segment sum within 1e-5 of the plain version on the card, whose
    index_add_ sums with atomics in another order."""
    cols, vals, y, w, valid, idx = _ell(m, K, d, dev, rate,
                                        one_column=one_column)
    for i, v in ((idx, valid), (None, None)):
        r, keys = sg.ell_residual(cols, vals, y, w, i, v, with_keys=True)
        r_ref, keys_ref = sg.ell_residual_plain(cols, vals, y, w, i, v, True)
        assert torch.equal(r, r_ref) and torch.equal(keys, keys_ref)
        r2, keys2 = sg.ell_residual(cols, vals, y, w, i, v, with_keys=True)
        assert torch.equal(r, r2) and torch.equal(keys, keys2)
        skeys, perm = sg.sort_keys(keys)
        g = sg.segment_sum(skeys, perm, vals, r, d, i, v)
        assert torch.equal(g, sg.segment_sum(skeys, perm, vals, r, d, i, v))
        cpu = [None if t is None else t.cpu()
               for t in (skeys, perm, vals, r, i, v)]
        g_cpu = sg.segment_sum_plain(*cpu[:4], d, *cpu[4:])
        assert torch.equal(g.cpu(), g_cpu)
        _close(g, sg.segment_sum_plain(skeys, perm, vals, r, d, i, v), 1e-5)
        if rate == 0.0 and i is not None:  # no valid slot
            assert not r.any() and not g.any()


def test_sparse_grad_steps_on_the_card_match_the_cpu(dev):
    """The sparse ASGD and SAGA steps, the commit and the table delta on
    the card equal the same calls on CPU copies bit for bit."""
    from asyncframework_tpu_torch.ops import steps as st

    cols, vals, y, w, valid, idx = _ell(3_000, 80, 4_000, dev, 0.2, cap=800)
    alpha = torch.randn(3_000, device=dev)
    on_cpu = [t.cpu() for t in (cols, vals, y, w, alpha, valid, idx)]
    g = st.make_sparse_asgd_worker_step(0.2, 4_000).grad(
        cols, vals, y, w, valid, idx)
    g_cpu = st.make_sparse_asgd_worker_step(0.2, 4_000).grad(
        *on_cpu[:4], *on_cpu[5:])
    assert torch.equal(g.cpu(), g_cpu)
    saga = st.make_sparse_saga_worker_step(0.2, 4_000)
    out = saga.grad(cols, vals, y, w, alpha, valid, idx)
    out_cpu = saga.grad(*on_cpu)
    for a, b in zip(out, out_cpu):
        assert torch.equal(a.cpu(), b)
    _, diff, i, v, c_sel, v_sel = out
    delta = st.make_sparse_table_delta(4_000)(c_sel, v_sel, diff, alpha, i)
    delta_cpu = st.make_sparse_table_delta(4_000)(*out_cpu[4:], out_cpu[1],
                                                  on_cpu[4], out_cpu[2])
    assert torch.equal(delta.cpu(), delta_cpu)
    commit = st.make_sparse_saga_commit()
    assert torch.equal(commit(alpha, diff, i, v).cpu(),
                       commit(on_cpu[4], *out_cpu[1:4]))


def test_sparse_grad_counts_launches(dev):
    cols, vals, y, w, valid, idx = _ell(64, 16, 40, dev)
    before = (sg.ell_residual.launches, sg.segment_sum.launches,
              sg.ell_residual_plain.calls, sg.segment_sum_plain.calls)
    r, keys = sg.ell_residual(cols, vals, y, w, idx, valid, with_keys=True)
    sg.segment_sum(*sg.sort_keys(keys), vals, r, 40, idx, valid)
    after = (sg.ell_residual.launches, sg.segment_sum.launches,
             sg.ell_residual_plain.calls, sg.segment_sum_plain.calls)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0, 0]


def test_sparse_asgd_run_sync_on_the_card_matches_the_cpu(dev):
    from asyncframework_tpu_torch.data import (SparseShardedDataset,
                                               make_sparse_regression)
    from asyncframework_tpu_torch.solvers import ASGD, SolverConfig

    csr = make_sparse_regression(2_048, 3_000, 0.01, seed=4)
    cfg = SolverConfig(num_workers=4, num_iterations=20, gamma=0.5,
                       batch_rate=1.0, printer_freq=5)
    runs = []
    for device in (dev, torch.device("cpu")):
        ds = SparseShardedDataset(*csr, 3_000, 4, [device])
        runs.append(ASGD(ds, None, cfg, devices=[device]).run_sync().final_w)
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-5,
                               atol=1e-5 * float(np.abs(runs[1]).max()))


# ------------------------------------------------- sparse_grad, fused (S1)
def _cpu(*ts):
    return [None if t is None else t.cpu() for t in ts]


def _fused_equal(cols, vals, y, w, idx, valid, d, alpha=None):
    """compacted_grad and grad_sum on the card against their plain versions
    on CPU copies (bit for bit) and against a second launch."""
    g, r = sg.compacted_grad(cols, vals, y, w, idx, valid, d, alpha)
    g2, r2 = sg.compacted_grad(cols, vals, y, w, idx, valid, d, alpha)
    assert torch.equal(g, g2) and torch.equal(r, r2)
    chunk = sg.launch_plan(1, 1, d).chunk
    g_cpu, r_cpu = sg.compacted_grad_plain(*_cpu(cols, vals, y, w, idx, valid),
                                           d, *_cpu(alpha), chunk=chunk)
    assert torch.equal(r.cpu(), r_cpu)
    assert torch.equal(g.cpu(), g_cpu)
    coeff = torch.randn(r.shape[0], device=r.device)
    h = sg.grad_sum(cols, vals, coeff, d, idx, valid)
    assert torch.equal(h, sg.grad_sum(cols, vals, coeff, d, idx, valid))
    h_cpu = sg.grad_sum_plain(*_cpu(cols, vals, coeff), d,
                              *_cpu(idx, valid), chunk=chunk)
    assert torch.equal(h.cpu(), h_cpu)
    return g, r


@pytest.mark.parametrize("route", ["auto", "global"])
@pytest.mark.parametrize("m,K,d,rate,one_column", SPARSE_CASES)
def test_compacted_grad_matches_plain_versions(dev, m, K, d, rate, one_column,
                                               route):
    """The fused kernel at every shape the earlier chain is tested at, with
    and without slots and alpha, on the route it picks and on the global
    route, bit-equal to its plain versions on CPU copies and across
    launches; no valid slot gives r = 0 and g = 0."""
    cols, vals, y, w, valid, idx = _ell(m, K, d, dev, rate,
                                        one_column=one_column)
    alpha = torch.randn(m, device=dev)
    with sg.pinned_plan(route=route):
        for i, v in ((idx, valid), (None, None)):
            for a in (None, alpha):
                g, r = _fused_equal(cols, vals, y, w, i, v, d, a)
                if rate == 0.0 and i is not None and a is None:
                    assert not r.any() and not g.any()


def _route(*args):
    stamps = torch.zeros(torch.cuda.get_device_properties(0)
                         .multi_processor_count, sg.STAMPS,
                         dtype=torch.int64, device="cuda")
    with sg.record_timeline(stamps):
        sg.compacted_grad(*args)
    return "local" if int(stamps[0, sg.ROUTE_STAMP]) else "global"


def test_compacted_grad_picks_its_route_from_the_buckets(dev):
    """Local where every top-digit bucket of live entries holds at most
    4,096 (and at most L); global with a bucket longer, keys of three
    digits, or the route pinned."""
    cols, vals, y, w, valid, idx = _ell(2_000, 80, 47_236, dev, 0.5, cap=1_200)
    args = (cols, vals, y, w, idx, valid, 47_236)
    assert _route(*args) == "local"
    with sg.pinned_plan(route="global"):
        assert _route(*args) == "global"
    with sg.pinned_plan(chunk=64):  # buckets of ~400 > L
        assert _route(*args) == "global"
    one = _ell(2_000, 80, 47_236, dev, 0.5, cap=1_200, one_column=True)
    assert _route(*one[:4], one[5], one[4], 47_236) == "global"
    wide_d = _ell(500, 16, 70_000, dev, 0.5, cap=300)
    assert _route(*wide_d[:4], wide_d[5], wide_d[4], 70_000) == "global"


@pytest.mark.parametrize("chunk,wide", [(4096, False), (64, False),
                                        (7, True), (4096, True),
                                        (400, False)])
def test_compacted_grad_splits_long_columns(dev, chunk, wide):
    """Columns longer than L (one of ~7,500 entries, and with a small L
    every column of a skewed shard) are summed in chunks of L, added in
    chunk order, bit-equal to the plain version; also with 64-bit
    positions."""
    cols, vals, y, w, valid, idx = _ell(10_000, 16, 3_000, dev, 0.8,
                                        cap=8_000)
    cols[::4, :6] = 5  # one long column, ~7,500 live entries
    with sg.pinned_plan(chunk=chunk, wide=wide):
        _fused_equal(cols, vals, y, w, idx, valid, 3_000,
                     torch.randn(10_000, device=dev))
        _fused_equal(cols, vals, y, w, None, None, 3_000)


@pytest.mark.parametrize("K", [13, 300, 700])
def test_compacted_grad_row_widths(dev, K):
    """Rows read without 16-byte loads (K = 13), one whole row a warp at a
    time (K = 300), and rows longer than a warp stages, read twice in
    pieces (K = 700), on both routes: bit-equal to the plain versions."""
    cols, vals, y, w, valid, idx = _ell(300, K, 5_000, dev, 0.5, cap=160)
    alpha = torch.randn(300, device=dev)
    for route in ("auto", "global"):
        with sg.pinned_plan(route=route):
            _fused_equal(cols, vals, y, w, idx, valid, 5_000, alpha)
            _fused_equal(cols, vals, y, w, None, None, 5_000)


def test_compacted_grad_is_one_launch(dev):
    cols, vals, y, w, valid, idx = _ell(500, 80, 2_000, dev, 0.3, cap=200)
    names = ("compacted_grad", "grad_sum", "ell_residual", "segment_sum")
    plains = ("compacted_grad_plain", "grad_sum_plain", "ell_residual_plain",
              "segment_sum_plain")

    def counts():
        return ([getattr(sg, n).launches for n in names]
                + [getattr(sg, n).calls for n in plains])

    before = counts()
    g, r = sg.compacted_grad(cols, vals, y, w, idx, valid, 2_000,
                             torch.randn(500, device=dev))
    sg.grad_sum(cols, vals, r, 2_000, idx, valid)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1] + [0] * 6


def test_compacted_grad_edges(dev):
    """No slot, no column, K = 0, and d = 1 with every entry in it."""
    cols, vals, y, w, valid, idx = _ell(64, 8, 40, dev)
    empty = idx[:0]
    g, r = sg.compacted_grad(cols, vals, y, w, empty, valid[:0], 40)
    assert r.shape == (0,) and torch.equal(g, torch.zeros(40, device=dev))
    z = torch.zeros(64, 0, dtype=torch.int32, device=dev)
    g, r = sg.compacted_grad(z, z.float(), y, w, idx, valid, 40)
    assert torch.equal(r, -(y[idx] * valid)) and not g.any()
    c1 = torch.zeros_like(cols)
    _fused_equal(c1, vals, y, w[:1].contiguous(), idx, valid, 1)


# ------------------------------------------------------------- run_fused
def _fused_solver(kind, dev, batch_rate=0.3):
    """A solver on the card whose worker tasks take B1's staged route
    (dense: ~1,500 compacted slots of 5,000 x 512 f32 a shard) or S1
    (sparse: 5,000 x 20 padded ELL a shard, d = 4,096)."""
    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.data.sparse import SparseShardedDataset
    from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig

    solver, layout = kind.split("_")
    if layout == "sparse":
        ds = SparseShardedDataset.generate_on_device(
            40_000, 4_096, 20, 8, devices=[dev], seed=3, noise=0.01)
    else:
        ds = ShardedDataset.generate_on_device(40_000, 512, 8, [dev], seed=3,
                                               noise=0.01)
    cfg = SolverConfig(num_workers=8, num_iterations=200, batch_rate=batch_rate,
                       gamma=0.3 if solver == "asaga" else 0.05 * ds.d,
                       printer_freq=8, seed=5)
    return (ASAGA if solver == "asaga" else ASGD)(ds, None, cfg, devices=[dev])


@pytest.mark.parametrize("kind", ["asgd_dense", "asgd_sparse", "asaga_dense",
                                  "asaga_sparse"])
def test_fused_graph_replay_matches_eager_rounds(dev, kind):
    """A chunk captured as a CUDA graph and replayed is the same chunk run
    eagerly from the same state and generator states, bit for bit (model,
    counter or alpha_bar, history slices, every snapshot row)."""
    from asyncframework_tpu_torch.tools import runs

    rec = runs.graph_check(_fused_solver(kind, dev), rounds=5)
    assert rec["replay_bit_equal"] and rec["snapshots_bit_equal"], rec
    assert rec["rounds_moved_model"] and rec["ok"], rec
    form = "compacted_grad" if kind.endswith("sparse") else (
        "saga_grad" if kind.startswith("asaga") else "masked_grad_staged")
    # one launch a task in the warm-up and one in the capture
    assert rec["launches_warm_and_capture"][form] == 2 * 5 * 8


def test_fused_capture_restores_state_and_generators(dev):
    from asyncframework_tpu_torch.solvers.base import RoundChunk, capture_chunks

    fused = _fused_solver("asgd_dense", dev).fused_rounds()
    states = [g.get_state() for g in fused.generators]
    chunks = [RoundChunk(fused, 4), RoundChunk(fused, 3)]
    capture_chunks(fused, chunks)  # warms both eagerly, then captures
    assert all(torch.equal(g.get_state(), s)
               for g, s in zip(fused.generators, states))
    assert not fused.carry[0].any() and float(fused.carry[1]) == 0.0
    chunks[0]()
    torch.cuda.synchronize()
    assert float(fused.carry[1]) == 4 * 8 and fused.carry[0].any()


def test_fused_capture_failure_raises(dev):
    """A round that copies to the host cannot be captured: the run raises
    and does not fall back to eager rounds."""
    from asyncframework_tpu_torch.solvers.base import FusedRounds, run_fused_plan

    def host_sync(w, k):
        return w - float(w.sum()), k + 1.0

    fused = FusedRounds(host_sync, (torch.ones(8, device=dev),
                                    torch.zeros((), device=dev)), ())
    with pytest.raises(RuntimeError):
        run_fused_plan(fused, 4, nw=1, printer_freq=1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("solver", ["asgd", "asaga"])
def test_run_fused_on_the_card_matches_the_cpu(dev, solver):
    """``batch_rate=1.0``: every sample is the whole shard on both devices,
    so the graph replays on the card and the eager rounds on the CPU run
    the same arithmetic (f32 sums in other orders)."""
    from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig

    rs = np.random.default_rng(4)
    X = (rs.normal(size=(4_096, 64)) / 8).astype(np.float32)
    y = (X @ rs.normal(size=64)).astype(np.float32)
    cls = ASGD if solver == "asgd" else ASAGA
    cfg = SolverConfig(num_workers=4, num_iterations=100, gamma=0.5,
                       batch_rate=1.0, printer_freq=20)
    gpu = cls(X, y, cfg, devices=[dev]).run_fused()
    cpu = cls(X, y, cfg, devices=[torch.device("cpu")]).run_fused()
    assert gpu.extras["graph_replays"] == 2 and cpu.extras["graph_replays"] == 0
    np.testing.assert_allclose(gpu.final_w, cpu.final_w, rtol=1e-4,
                               atol=1e-4 * float(np.abs(cpu.final_w).max()))
    np.testing.assert_allclose([o for _, o in gpu.trajectory],
                               [o for _, o in cpu.trajectory], rtol=1e-4)


# ------------------------------------------- the run() switches on the card
def _copy_task(dev, sparse, solver_name):
    """A worker task of an epsilon-shaped (B1, staged) or rcv1-shaped (S1)
    shard, its generator and a fresh generator from the same seed."""
    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.data.sparse import SparseShardedDataset
    from asyncframework_tpu_torch.engine.straggler import DelayModel
    from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig

    if sparse:  # rcv1's shard (87,205 x 80) and b = 0.05
        ds = SparseShardedDataset.generate_on_device(
            174_410, 47_236, 75, 2, devices=[dev], seed=7, noise=0.01)
        rate = 0.05
    else:  # epsilon's shard (50,000 x 2,000) and b = 0.1
        ds = ShardedDataset.generate_on_device(100_000, 2_000, 2, [dev],
                                               seed=7, noise=0.01)
        rate = 0.1
    cls = ASGD if solver_name == "asgd" else ASAGA
    s = cls(ds, None, SolverConfig(num_workers=2, batch_rate=rate, seed=42),
            devices=[dev])
    gens, locks = s._generators()
    w = torch.linspace(-0.01, 0.01, ds.d, device=dev)
    extra = ((s._zeros(ds.shard(1).size, dev),) if solver_name == "asaga"
             else ())
    fn = s._make_task(1, w, *extra, gens[1], locks[1], DelayModel(0.0, 2))
    return s, fn, gens[1]


@pytest.mark.parametrize("solver_name", ["asgd", "asaga"])
@pytest.mark.parametrize("sparse", [False, True], ids=["epsilon_b1", "rcv1_s1"])
def test_speculative_copy_is_bit_equal_to_its_primary(dev, sparse,
                                                      solver_name):
    """A task's primary and its speculative copy, run at once on two
    threads as the executor and its spare do: both queue their cooperative
    launch on the device's stream, neither deadlocks, and the two results
    are bit-equal; the worker's generator advanced by one draw."""
    import threading

    from asyncframework_tpu_torch.ops.sampling import worker_generator
    from asyncframework_tpu_torch.tools import runs

    s, fn, gen = _copy_task(dev, sparse, solver_name)
    fn()  # builds the kernels; the draw it makes is the task's one draw
    state = gen.get_state()
    runs.zero_counts()
    out = [None, None]

    def body(i):
        out[i] = fn()

    threads = [threading.Thread(target=body, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a launch deadlocked"
    torch.cuda.synchronize()
    first = out[0] if isinstance(out[0], tuple) else (out[0],)
    second = out[1] if isinstance(out[1], tuple) else (out[1],)
    for a, b in zip(first, second):
        assert a.device.type == "cuda" and torch.equal(a, b)
    counts = runs.counts()
    form = ("compacted_grad" if sparse
            else "saga_grad" if solver_name == "asaga" else "masked_grad_staged")
    assert counts[form] == 2
    assert torch.equal(gen.get_state(), state)  # no second draw
    once = worker_generator(42, 1, dev)
    s._step.sample(once, s.ds.shard(1).size)
    assert torch.equal(gen.get_state(), once.get_state())


@pytest.mark.parametrize("solver_name", ["asgd", "asaga"])
def test_checkpoint_of_a_card_run_restores_on_the_card(dev, tmp_path,
                                                       solver_name):
    """A run on the card saves mid-run (its ``w`` a CUDA tensor, its
    generators CUDA generators); a run to the same budget restores the
    model (and ASAGA's table) bit-equal, and a longer run resumes through
    the kernels on the card."""
    from asyncframework_tpu_torch.checkpoint import CheckpointManager
    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig
    from asyncframework_tpu_torch.tools import runs

    ds = ShardedDataset.generate_on_device(40_000, 256, 4, [dev], seed=3,
                                           noise=0.01)
    cls = ASGD if solver_name == "asgd" else ASAGA
    gamma = 1.0 if solver_name == "asgd" else 0.05

    def cfg(iters):
        return SolverConfig(num_workers=4, num_iterations=iters, gamma=gamma,
                            batch_rate=0.1, printer_freq=20, seed=42,
                            checkpoint_dir=str(tmp_path / "ck"),
                            checkpoint_freq=25)

    first = cls(ds, None, cfg(100), devices=[dev]).run()
    ck = CheckpointManager(tmp_path / "ck").restore()
    assert ck["k"] == 100 and set(ck["worker_gens"]) == set(range(4))
    assert all(g.dtype == np.uint8 for g in ck["worker_gens"].values())
    np.testing.assert_array_equal(ck["w"], first.final_w)
    same = cls(ds, None, cfg(100), devices=[dev]).run()
    assert same.accepted == 0
    np.testing.assert_array_equal(same.final_w, ck["w"])
    if solver_name == "asaga":
        np.testing.assert_array_equal(same.extras["alpha_bar"],
                                      ck["alpha_bar"])
        for wid, a in ck["alpha"].items():
            np.testing.assert_array_equal(same.extras["alpha"][wid], a)
    runs.zero_counts()
    more = cls(ds, None, cfg(200), devices=[dev]).run()
    counts = runs.counts()
    assert more.accepted == 100 and more.extras["resumed_from"] == 100
    form = "masked_grad" if solver_name == "asgd" else "saga_grad"
    assert counts[form] >= 100
    assert np.isfinite(more.final_w).all()


# ------------------------------------------------ the DCN plane's forms
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["auto", "tiled"])
@pytest.mark.parametrize("n_valid", [0, 1_500, 5_408])
def test_saga_slots_form_matches_plain_version(dev, dtype, route, n_valid):
    """B1's per-slot ASAGA form at the DCN epsilon worker's shape (5,408
    slots of a 50,000 x 2,000 shard; the staged route, and the tiled one
    pinned) against its plain version; bit-equal from launch to launch,
    ``diff`` 0 on padding slots, one launch a call."""
    import contextlib

    n, d, cap = 50_000, 2_000, 5_408
    X, y, w, _ = _problem(n, d, dev, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    idx = torch.sort(torch.randperm(n, generator=gen, device=dev)[:cap]).values
    idx[n_valid:] = 0
    alpha = torch.randn(cap, generator=gen, device=dev)
    valid = (torch.arange(cap, device=dev) < n_valid).float()
    pin = (mg.pinned_route("tiled") if route == "tiled"
           else contextlib.nullcontext())
    before = mg.saga_slots_grad.launches
    with pin:
        g, diff = mg.saga_slots_grad(X, y, w, idx, alpha, valid)
        g2, diff2 = mg.saga_slots_grad(X, y, w, idx, alpha, valid)
    assert mg.saga_slots_grad.launches == before + 2
    want_g, want_diff = mg.saga_slots_grad_reference(X, y, w, idx, alpha,
                                                     valid)
    _close(g, want_g, REL[dtype])
    _close(diff, want_diff, 1e-5)
    assert not diff[n_valid:].any()
    assert torch.equal(g, g2) and torch.equal(diff, diff2)


@pytest.mark.parametrize("n_valid", [0, 2_000, 4_752])
def test_sparse_saga_slots_form_matches_plain_version(dev, n_valid):
    """S1's per-slot ASAGA form at the DCN rcv1 worker's shape (4,752
    slots of an 87,205 x 80 shard, d = 47,236) bit-equal to its plain
    version on CPU copies and to ``compacted_grad`` with the scalars
    placed at their rows."""
    from asyncframework_tpu_torch.data.sparse import SparseShardedDataset

    ds = SparseShardedDataset.generate_on_device(
        87_205 * 2, 47_236, 75, 2, devices=[dev], seed=7, noise=0.01)
    sh = ds.shard(0)
    n, cap = sh.y.shape[0], 4_752
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    idx = torch.sort(torch.randperm(n, generator=gen, device=dev)[:cap]).values
    alpha = torch.randn(cap, generator=gen, device=dev)
    valid = (torch.arange(cap, device=dev) < n_valid).float()
    w = torch.randn(47_236, generator=gen, device=dev) * 0.01
    before = sg.saga_slots_grad.launches
    g, diff = sg.saga_slots_grad(sh.cols, sh.vals, sh.y, w, idx, valid, alpha)
    assert sg.saga_slots_grad.launches == before + 1
    want_g, want_diff = sg.compacted_grad_plain(
        *(t.cpu() for t in (sh.cols, sh.vals, sh.y, w, idx, valid)), None,
        alpha.cpu(), alpha_slots=True)
    assert torch.equal(g.cpu(), want_g) and torch.equal(diff.cpu(), want_diff)
    full = torch.zeros(n, device=dev)
    full[idx] = alpha
    g_rows, _ = sg.compacted_grad(sh.cols, sh.vals, sh.y, w, idx, valid,
                                  None, full)
    assert torch.equal(g, g_rows)


@pytest.mark.parametrize("algo", ["asgd", "asaga"])
def test_merge_drain_is_bit_equal_to_serial_applies_on_the_card(dev, algo):
    from asyncframework_tpu_torch.ops import steps

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    G = torch.randn(8, 2_000, generator=gen, device=dev)
    mask = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.float32,
                        device=dev)
    w0 = torch.randn(2_000, generator=gen, device=dev)
    one = torch.ones(1, device=dev)
    if algo == "asgd":
        merge = steps.make_asgd_apply_merge(100.0, 0.1, 400_000, 8)
        s0 = torch.tensor(3.0, device=dev)
    else:
        merge = steps.make_saga_apply_merge(0.5, 0.1, 400_000, 8)
        s0 = torch.randn(2_000, generator=gen, device=dev) * 1e-3
    if algo == "asgd":
        w, s = merge(w0, G, mask, s0)
    else:
        w, s = merge(w0, s0, G, mask)
    ws, ss = w0, s0
    for j in range(8):
        if mask[j] > 0:
            if algo == "asgd":
                ws, ss = merge(ws, G[j:j + 1], one, ss)
            else:
                ws, ss = merge(ws, ss, G[j:j + 1], one)
    assert torch.equal(w, ws) and torch.equal(s, ss)


def test_pipelined_transfer_on_the_card(dev):
    from asyncframework_tpu_torch.ops import steps

    stage, readback = steps.make_pipelined_transfer(dev)
    rs = np.random.default_rng(0)
    hosts = [rs.normal(size=2_000).astype(np.float32) for _ in range(5)]
    staged = [stage(h) for h in hosts]  # two pinned buffers, reused
    for h, t in zip(hosts, staged):
        assert np.array_equal(readback(t * 1.0), h)


def test_pipelined_staging_beside_other_threads_launches(dev):
    """Four worker threads share the compute stream, as a worker process's
    logical workers do, each staging its models on its own side stream
    while the others' B1 launches run: every gradient is bit-equal to the
    same step computed alone (a staged model must never land in a block
    another thread's queued kernels still use)."""
    import threading

    from asyncframework_tpu_torch.ops import steps

    n, d, cap = 50_000, 2_000, 5_408
    X, y, _w, sel = _problem(n, d, dev, torch.float32)
    valid, idx = compact_mask(sel, cap)
    rs = np.random.default_rng(4)
    models = [[rs.normal(size=d).astype(np.float32) for _ in range(20)]
              for _ in range(4)]
    want = [[mg.masked_grad(X, y, torch.tensor(m, device=dev), valid,
                            idx).cpu().numpy() for m in ms] for ms in models]
    got = [[None] * 20 for _ in range(4)]
    errors = []

    def worker(t):
        try:
            stage, readback = steps.make_pipelined_transfer(dev)
            for j, m in enumerate(models[t]):
                got[t][j] = readback(mg.masked_grad(X, y, stage(m), valid,
                                                    idx))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert not errors, errors
    for t in range(4):
        for j in range(20):
            assert np.array_equal(got[t][j], want[t][j]), (t, j)


def test_saga_slots_form_edges(dev):
    """A zero-width X launches nothing and gives the plain version's
    ``diff``; an index outside the shard adds nothing and gets ``diff``
    0, on the card as in the plain version."""
    y = torch.arange(5, dtype=torch.float32, device=dev)
    idx = torch.tensor([1, 3, 7], device=dev)
    valid = torch.tensor([1.0, 0.0, 1.0], device=dev)
    alpha = torch.zeros(3, device=dev)
    before = mg.saga_slots_grad.launches
    g, diff = mg.saga_slots_grad(torch.zeros(5, 0, device=dev), y,
                                 torch.zeros(0, device=dev), idx, alpha, valid)
    assert mg.saga_slots_grad.launches == before and g.shape == (0,)
    want = mg.saga_slots_grad_reference(torch.zeros(5, 0, device=dev), y,
                                        torch.zeros(0, device=dev), idx,
                                        alpha, valid)[1]
    assert torch.equal(diff, want)
    assert diff.tolist() == [-1.0, 0.0, 0.0]
    X, y, w, _ = _problem(40, 8, dev, torch.float32)
    idx = torch.tensor([0, 39, 40, -1], device=dev)
    valid = torch.ones(4, device=dev)
    g, diff = mg.saga_slots_grad(X, y, w, idx, torch.zeros(4, device=dev),
                                 valid)
    want_g, want_diff = mg.saga_slots_grad_reference(
        X, y, w, idx, torch.zeros(4, device=dev), valid)
    _close(g, want_g, REL[torch.float32])
    assert torch.equal(diff[2:], torch.zeros(2, device=dev))
    _close(diff, want_diff, 1e-5)


# ------------------------------------------------------- telemetry plane
def test_memory_gauges_read_the_card_only_once_cuda_is_up(dev):
    """In a fresh process, a profiler readout before the first CUDA
    allocation reports host memory only and leaves CUDA uninitialized (a
    readout never creates a context); after it, ``device_bytes_in_use``
    counts the allocation and ``device_bytes_limit`` is the card's."""
    import json
    import os
    import subprocess
    import sys

    code = """
import json, torch
from asyncframework_tpu_torch.metrics import profiler
before = profiler.memory_gauges()
init_after_read = torch.cuda.is_initialized()
x = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
after = profiler.memory_gauges()
print(json.dumps({"before": before, "init": init_after_read, "after": after,
                  "total": torch.cuda.get_device_properties(0).total_memory}))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "device_bytes_in_use" not in got["before"]
    assert got["init"] is False
    assert got["after"]["device_bytes_in_use"] >= 64 << 20
    assert got["after"]["device_bytes_limit"] == got["total"]


def test_profiled_fused_chunk_captures_and_replays_bit_equal(dev):
    """With the profiler installed the worker steps are wrapped (host
    timing only, no device synchronization): a chunk of the fused loop
    still captures as a CUDA graph, and its replay leaves the state and
    snapshots bit-equal to the unprofiled solver's replay of the same
    chunk from the same state."""
    from asyncframework_tpu_torch.metrics import profiler
    from asyncframework_tpu_torch.solvers.base import RoundChunk, capture_chunks

    def replay(profiled):
        profiler.uninstall()
        if profiled:
            profiler.install("t-fused", hz=0)
        try:
            fused = _fused_solver("asgd_dense", dev).fused_rounds()
            chunk = RoundChunk(fused, 4)
            capture_chunks(fused, [chunk])
            chunk()
            torch.cuda.synchronize()
            snap = profiler.active().snapshot() if profiled else None
            return [t.clone() for t in (*fused.carry, chunk.snap)], snap
        finally:
            profiler.uninstall()

    plain, _ = replay(False)
    profiled, snap = replay(True)
    assert all(torch.equal(a, b) for a, b in zip(plain, profiled))
    assert bool((plain[-1][0] != plain[-1][-1]).any())  # the model moved
    # warm-up and capture each called every worker's step four times
    calls = snap["dispatch"]["labels"]["asgd_worker_step"]
    assert calls["compile"] == 1
    assert calls["compile"] + calls["dispatch"] == 2 * 4 * 8


def test_sparse_dcn_worker_launches_one_residual_a_sample(dev):
    """A sparse DCN worker with ``async.convergence.sample=3``: each
    sample is one launch of S1's ``ell_residual`` (no plain call), and
    the PS's convergence history holds every sample."""
    from asyncframework_tpu_torch.conf import AsyncConf, set_global_conf
    from asyncframework_tpu_torch.data.sparse import SparseShardedDataset
    from asyncframework_tpu_torch.metrics import timeseries
    from asyncframework_tpu_torch.parallel import ps_dcn
    from asyncframework_tpu_torch.solvers import SolverConfig
    from asyncframework_tpu_torch.tools import runs

    conf = AsyncConf()
    conf.set("async.convergence.sample", 3)
    set_global_conf(conf)
    timeseries.convergence().reset()
    try:
        ds = SparseShardedDataset.generate_on_device(
            8_000, 2_048, 20, 4, devices=[dev], seed=3, noise=0.01)
        cfg = SolverConfig(num_workers=4, num_iterations=60, gamma=0.05 * ds.d,
                           batch_rate=0.3, bucket_ratio=0.5, printer_freq=20,
                           seed=5, calibration_iters=10, run_timeout_s=60.0)
        ps = ps_dcn.ParameterServer(cfg, ds.d, ds.n, device=dev,
                                    port=0).start()
        runs.zero_counts()
        ps_dcn.reset_conv_samples_taken()
        counts = ps_dcn.run_worker_process(
            "127.0.0.1", ps.port, list(range(4)),
            {w: ds.shard(w) for w in range(4)}, cfg, ds.d, ds.n,
            deadline_s=60.0)
        launches = runs.counts()
        assert ps.wait_done(timeout_s=30.0)
        ps.stop()
        samples = ps_dcn.conv_samples_taken()
        assert samples == sum(c // 3 for c in counts.values()) > 0
        assert launches["ell_residual"] == samples
        assert launches["ell_residual_plain"] == 0
        assert timeseries.convergence().offered == samples
    finally:
        timeseries.convergence().reset()
        set_global_conf(None)


@pytest.mark.parametrize("solver", ["asgd", "asaga"])
@pytest.mark.parametrize("mode", ["run", "run_sync"])
def test_ui_port_on_the_card(dev, solver, mode):
    """``ui_port=0`` on ASGD and ASAGA ``run()`` and ``run_sync()`` on the
    card: every endpoint answers 200 during the run (``/metrics`` parsed
    strictly), the port is in the extras, and the server is gone after."""
    from asyncframework_tpu_torch.metrics import live
    from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig
    from asyncframework_tpu_torch.tools.telemetry import Poller

    rs = np.random.default_rng(2)
    X = rs.normal(size=(40_000, 512)).astype(np.float32)
    y = (X @ rs.normal(size=512)).astype(np.float32)
    cfg = SolverConfig(num_workers=8, num_iterations=300, gamma=0.3,
                       batch_rate=0.3, printer_freq=50, seed=3, ui_port=0)
    cls = ASGD if solver == "asgd" else ASAGA
    with Poller(period_s=0.05) as poller:
        res = getattr(cls(X, y, cfg, devices=[dev]), mode)()
    assert res.extras["ui_port"] > 0
    assert (res.rounds if mode == "run_sync" else res.accepted) == 300
    assert poller.answers and all(c == 200 for _p, c in poller.answers)
    assert not poller.parse_errors and res.extras["ui_status"]
    assert not live.active_servers()


@pytest.mark.parametrize("sparse", [False, True])
def test_fenced_sharded_group_on_the_card(dev, sparse):
    """A fenced 3-shard in-process group (``parallel/shardgroup.py``)
    with every range's model on the card, and a worker process's
    loops on it: each gradient one launch of B1's compacted form (dense)
    or S1's ``compacted_grad`` (padded ELL), no plain call; every pull a
    version vector of 3 clocks; every shard under epoch 1, counting each
    push once with no fenced reject; the objective down (dense: below
    1/10 of its value at w = 0)."""
    from asyncframework_tpu_torch.conf import AsyncConf, set_global_conf
    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.data.sparse import SparseShardedDataset
    from asyncframework_tpu_torch.parallel import ps_dcn, shardgroup
    from asyncframework_tpu_torch.solvers import SolverConfig
    from asyncframework_tpu_torch.tools import runs

    set_global_conf(AsyncConf({"async.fence.enabled": True}))
    try:
        if sparse:
            ds = SparseShardedDataset.generate_on_device(
                8_000, 2_048, 20, 4, devices=[dev], seed=3, noise=0.01)
            gamma, form = 0.05 * ds.d, "compacted_grad"
        else:
            ds = ShardedDataset.generate_on_device(
                40_000, 512, 4, [dev], seed=7, noise=0.01)
            gamma, form = 30.0, "masked_grad"
        cfg = SolverConfig(num_workers=4, num_iterations=200, gamma=gamma,
                           batch_rate=0.1, bucket_ratio=0.5,
                           printer_freq=50, seed=5, calibration_iters=10,
                           run_timeout_s=60.0)
        ps_list, smap = shardgroup.launch_inprocess_group(
            cfg, ds.d, ds.n, 3, device=dev)
        shardgroup.reset_shard_totals()
        try:
            assert [p.epoch for p in ps_list] == [1, 1, 1]
            assert all(p._w.device.type == "cuda" for p in ps_list)
            runs.zero_counts()
            counts = ps_dcn.run_worker_process(
                "127.0.0.1", ps_list[0].port, list(range(4)),
                {w: ds.shard(w) for w in range(4)}, cfg, ds.d, ds.n,
                eval_wid=0, deadline_s=60.0)
            launches = runs.counts()
            assert ps_list[0].wait_done(timeout_s=30.0)
            total = ps_list[0].collect_eval(num_worker_procs=1,
                                            timeout_s=30.0)
        finally:
            for p in ps_list:
                p.stop()
        gradients = sum(counts.values())
        assert ps_list[0].accepted == 200
        assert launches[form] == gradients + 1  # + the warm-up launch
        assert not any(launches[k] for k in (
            "compacted_grad_plain", "grad_sum_plain", "ell_residual_plain",
            "segment_sum_plain"))
        totals = shardgroup.shard_totals()
        assert totals["sharded_pulls"] == totals["pull_vector_len_3"] > 0
        for p in ps_list:
            assert sum(p.pushes_by_wid.values()) == p.accepted + p.dropped
            assert p.fenced_rejects == 0 and p.dedup_hits == 0
        # the sparse recipe (gamma 0.05 d) as test_sparse_dcn_worker_...;
        # the dense one below 1/10, as chip_smoke.py's phase 3
        frac = 0.5 if sparse else 0.1
        assert total is not None and total[-1] < total[0] * frac
    finally:
        set_global_conf(None)


@pytest.mark.parametrize("d", [2_000, 47_236])
def test_damped_merge_is_bit_equal_to_serial_damped_applies(dev, d):
    """On the card: the merge drain with 8 slots of random damps in
    (0, 1] is bit-equal (``torch.equal``) to 8 serial
    ``make_asgd_apply_damped`` calls, and at damp 1.0 to 8 serial
    ``make_asgd_apply`` calls."""
    from asyncframework_tpu_torch.ops import steps

    gen = torch.Generator(device=dev)
    gen.manual_seed(d)
    G = torch.randn(8, d, device=dev, generator=gen)
    w0 = torch.randn(d, device=dev, generator=gen)
    damps = 1.0 - torch.rand(8, device=dev, generator=gen)
    k0 = torch.tensor(11.0, device=dev)
    merge = steps.make_asgd_apply_merge(100.0, 0.1, 400_000, 8)
    damped = steps.make_asgd_apply_damped(100.0, 0.1, 400_000, 8)
    plain = steps.make_asgd_apply(100.0, 0.1, 400_000, 8)
    w_m, k_m = merge(w0, G, damps, k0)
    w_s, k_s = w0, k0
    for j in range(8):
        w_s, k_s = damped(w_s, G[j], k_s, np.float32(damps[j].item()))
    assert torch.equal(w_m, w_s) and torch.equal(k_m, k_s)
    assert float(k_s) == 19.0 and float(k0) == 11.0  # nothing in place
    w_1, _ = merge(w0, G, torch.ones(8, device=dev), k0)
    w_p, k_p = w0, k0.clone()
    for j in range(8):
        w_p, k_p = plain(w_p, G[j], k_p)
    assert torch.equal(w_1, w_p)


def test_standby_mirror_is_bit_equal_after_50_batches_on_the_card(dev):
    """A primary and its hot standby, both with their models on the card:
    50 pushes (re-pushed against an old basis, so most are damped by the
    controller's law; a fused drain where they coalesce), each drained
    batch replicated, and the standby's model is ``torch.equal`` to the
    primary's at the same clock, its ledgers and dedup window the
    primary's."""
    import time

    from asyncframework_tpu_torch.conf import AsyncConf, set_global_conf
    from asyncframework_tpu_torch.parallel import ps_dcn
    from asyncframework_tpu_torch.solvers import SolverConfig

    set_global_conf(AsyncConf({"async.fence.enabled": True}))
    cfg = SolverConfig(num_workers=2, num_iterations=10**6, gamma=1.0,
                       taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                       printer_freq=10, seed=42, calibration_iters=10**9,
                       run_timeout_s=60.0)
    prim = sb = None
    try:
        prim = ps_dcn.ParameterServer(cfg, 2_000, 400_000, device=dev,
                                      port=0).start()
        sb = ps_dcn.ParameterServer(cfg, 2_000, 400_000, device=dev, port=0,
                                    standby=True).start()
        prim.attach_standby("127.0.0.1", sb.port)
        prim.set_control({"seq": 1, "ep": prim.epoch,
                          "damp": [1.0, 0.1, 0.0]})
        rng = np.random.default_rng(50)
        clients = [ps_dcn.PSClient("127.0.0.1", prim.port) for _ in range(2)]
        bases = [c.pull(w)[0] for w, c in enumerate(clients)]
        for i in range(50):
            w = i % 2
            clients[w].push(w, bases[w],
                            rng.normal(size=2_000).astype(np.float32))
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not (
                sb._clock >= prim._clock and prim.repl.synced
                and prim.repl.acked_clock >= prim._clock):
            time.sleep(0.02)
        assert (sb._clock, sb._k, sb.accepted) == (prim._clock, prim._k,
                                                   prim.accepted) == (
            50, 50, 50)
        assert prim.damped_applies > 0
        assert sb._w.device.type == "cuda"
        assert torch.equal(prim._w, sb._w)
        assert sb.accepted_by_wid == prim.accepted_by_wid
        for c in clients:
            c.bye()
    finally:
        for p in (prim, sb):
            if p is not None:
                p.stop()
        set_global_conf(None)


# ---------------------------------------------- the data-parallel plane
def test_mesh_steps_on_one_card(dev, monkeypatch):
    """chip_smoke.py phase 14 (a) at a small shard: the ASGD mesh step
    equal to 4 B1 launches folded in rank order (exactly 4 launches, no
    plain call), the ASAGA step's ``diff`` equal to single-device
    ``saga_slots_grad``; the check raises where a gate fails."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "MESH_SHARD", (8_000, 512))
    monkeypatch.setattr(chip_smoke, "MESH_SLOTS", 880)
    chip_smoke.mesh_steps_check(torch, "test", dev)


def test_minibatch_sgd_on_one_card(dev, monkeypatch):
    """chip_smoke.py phase 14 (b) at a small width: 1-rank and 4-rank
    meshes below 1/10 of the objective at w = 0 with one B1 launch a rank
    an iteration, graph replays bit-equal to eager iterations, and the
    1-rank, 4-rank and (dp 2, md 2) layouts agreeing at b = 1.0."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "MB_GAMMA", 128.0)  # d / 2
    launches = chip_smoke.minibatch_phase(torch, "test", dev,
                                          shape=(20_000, 256), iters=40)
    assert launches["saga_grad"] == (1 + 4 + 4 + 1 + 4) * 40
    assert launches["xt_coeff"] == 4 * 40


def test_dcn_mesh_worker_on_one_card(dev):
    """A DCN worker with a 4-rank mesh of this card against the port's
    PS: every gradient 4 B1 launches, exactly once."""
    from asyncframework_tpu_torch.conf import AsyncConf, set_global_conf
    from asyncframework_tpu_torch.data.sharded import ShardedDataset
    from asyncframework_tpu_torch.parallel import ps_dcn
    from asyncframework_tpu_torch.solvers import SolverConfig
    from asyncframework_tpu_torch.tools import runs

    set_global_conf(AsyncConf().set("async.trace.sample", 0.0))
    cfg = SolverConfig(num_workers=2, num_iterations=60, gamma=1.2,
                       taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                       printer_freq=20, seed=42, calibration_iters=8,
                       run_timeout_s=120.0, mesh_devices=4)
    try:
        ds = ShardedDataset.generate_on_device(4_096, 64, 2, devices=[dev],
                                               seed=11, noise=0.01)
        ps = ps_dcn.ParameterServer(cfg, 64, 4_096, device=dev,
                                    port=0).start()
        runs.zero_counts()
        ps_dcn.reset_mesh_counts()
        counts = ps_dcn.run_worker_process(
            "127.0.0.1", ps.port, [0, 1], {w: ds.shard(w) for w in (0, 1)},
            cfg, 64, 4_096, deadline_s=120.0, devices=[dev] * 4)
        assert ps.wait_done(timeout_s=30.0)
        ps.stop()
        c = runs.counts()
        steps = sum(counts.values()) + 1  # and one warm-up
        assert ps.accepted == 60
        assert ps_dcn.mesh_counts()["steps"] == steps
        assert c["masked_grad"] == 4 * steps
        assert not any(v for k, v in c.items() if k.endswith("_plain"))
    finally:
        set_global_conf(None)


# ------------------------------------------------------- the serving replica
def _serving_ps(d, dev=torch.device("cpu")):
    from asyncframework_tpu_torch.parallel import ps_dcn
    from asyncframework_tpu_torch.solvers import SolverConfig

    cfg = SolverConfig(num_workers=2, num_iterations=100_000, gamma=0.5,
                       taw=2**31 - 1, batch_rate=0.3, bucket_ratio=0.0,
                       printer_freq=10_000, seed=42, calibration_iters=4,
                       run_timeout_s=600.0)
    return ps_dcn.ParameterServer(cfg, d, 1_024, device=dev, port=0).start()


def _within(y, X, w, rtol=1e-5):
    """``y`` against ``X @ w`` in float64, relative to each row's
    ``|X| @ |w|``."""
    X64, w64 = X.astype(np.float64), w.astype(np.float64)
    err = np.abs(y.astype(np.float64) - X64 @ w64)
    return bool(np.all(err <= rtol * (np.abs(X64) @ np.abs(w64))))


@pytest.mark.serve
def test_replica_refresh_races_predict_on_the_card(dev):
    """1,000 refreshes, each a new version copied to the card, raced by
    three threads sending PREDICT: every reply equals ``X @ w`` of the
    version the reply stamps (a handler never computes against a model
    whose copy has not landed, nor one rewritten in place)."""
    import threading

    from asyncframework_tpu_torch.net import frame
    from asyncframework_tpu_torch.parallel import ps_dcn
    from asyncframework_tpu_torch.serving import ModelReplica

    d = 2_000
    rs = np.random.default_rng(3)
    ps = _serving_ps(d)
    rep = None
    stop = threading.Event()
    X = rs.normal(size=(8, d)).astype(np.float32)
    replies = [[] for _ in range(3)]
    try:
        rep = ModelReplica("127.0.0.1", ps.port, rid=0, host="127.0.0.1",
                           device=dev, refresh_interval_s=3600.0,
                           max_stale_ms=0.0).start()
        pusher = ps_dcn.PSClient("127.0.0.1", ps.port, pull_mode="full")
        direct = ps_dcn.PSClient("127.0.0.1", ps.port, pull_mode="full")
        versions = {}
        ts, w, *_ = direct.subscribe(9)
        versions[ts] = w.copy()
        assert rep.refresh_once()

        def predictor(out):
            sock = frame.connect(("127.0.0.1", rep.port))
            try:
                while not stop.is_set():
                    frame.send_msg(sock, {"op": "PREDICT", "n": 8},
                                   X.tobytes())
                    hdr, body = frame.recv_msg(sock)
                    assert hdr["op"] == "PREDICTION", hdr
                    out.append((hdr["ts"], np.frombuffer(body, np.float32)))
            finally:
                sock.close()

        threads = [threading.Thread(target=predictor, args=(out,),
                                    name=f"race-predict-{i}", daemon=True)
                   for i, out in enumerate(replies)]
        for t in threads:
            t.start()
        for _ in range(1_000):
            pts, _w, _a, _c = pusher.pull(0)
            pusher.push(0, pts, (0.01 * rs.normal(size=d)).astype(np.float32))
            ts, w, *_ = direct.subscribe(9)
            versions[ts] = w.copy()
            assert rep.refresh_once()
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
        assert rep.status()["device"].startswith("cuda")
        n = sum(len(r) for r in replies)
        assert n > 1_000
        seen = {ts for r in replies for ts, _y in r}
        assert len(seen) > 100
        for r in replies:
            for ts, y in r:
                assert _within(y, X, versions[ts]), ts
    finally:
        stop.set()
        if rep is not None:
            rep.stop()
        ps.stop()


@pytest.mark.serve
@pytest.mark.parametrize("loss", ["least_squares", "logistic"])
def test_replica_process_predict_matches_the_cpu(dev, loss):
    """A ``serving.cli replica`` process on the card (TF32 off, whatever
    its caller set) against the CPU's predict step on the same model, at
    every power-of-two bucket up to 256 rows."""
    import json
    import os
    import subprocess
    import sys
    import time

    from asyncframework_tpu_torch.net import frame
    from asyncframework_tpu_torch.ops.steps import make_predict_step
    from asyncframework_tpu_torch.parallel import ps_dcn

    d = 2_000
    rs = np.random.default_rng(4)
    ps = _serving_ps(d)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "ASYNCTPU_FORCE_CPU"}
    env["PYTHONPATH"] = repo
    proc = subprocess.Popen(
        [sys.executable, "-m", "asyncframework_tpu_torch.serving.cli",
         "replica", "--ps", f"127.0.0.1:{ps.port}", "--host", "127.0.0.1",
         "--loss", loss], env=env, cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        port = json.loads(readline_within(proc))["port"]
        pusher = ps_dcn.PSClient("127.0.0.1", ps.port, pull_mode="full")
        for _ in range(3):
            pts, _w, _a, _c = pusher.pull(0)
            pusher.push(0, pts, (0.05 * rs.normal(size=d)).astype(np.float32))
        ts, w, *_ = ps_dcn.PSClient("127.0.0.1", ps.port,
                                    pull_mode="full").subscribe(9)

        def call(hdr, payload=b""):
            sock = frame.connect(("127.0.0.1", port))
            try:
                frame.send_msg(sock, hdr, payload)
                return frame.recv_msg(sock)
            finally:
                sock.close()

        deadline = time.monotonic() + 60.0
        while call({"op": "STATUS"})[0].get("ts") != ts:
            assert time.monotonic() < deadline, "the replica never caught up"
            time.sleep(0.05)
        assert call({"op": "STATUS"})[0]["device"].startswith("cuda")
        step = make_predict_step(loss)
        for n in (1, 3, 17, 64, 256):
            X = rs.normal(size=(n, d)).astype(np.float32)
            hdr, body = call({"op": "PREDICT", "n": n}, X.tobytes())
            assert hdr["op"] == "PREDICTION" and hdr["ts"] == ts
            got = np.frombuffer(body, np.float32)
            want = step(torch.from_numpy(X), torch.from_numpy(w.copy())).numpy()
            if loss == "least_squares":
                assert _within(got, X, w)
                np.testing.assert_allclose(
                    got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
            else:
                np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    finally:
        kill_and_reap(proc)
        ps.stop()


# ------------------------------------------------------------ the ML library
def _ml_problem(n, d, seed=0, labels=False):
    rs = np.random.default_rng(seed)
    X = (rs.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    y = X @ rs.normal(size=d).astype(np.float32) * 4.0
    if labels:
        y = (rs.random(n) < 1.0 / (1.0 + np.exp(-y))).astype(np.float32)
    return X, y.astype(np.float32)


@pytest.mark.parametrize("name,form", [
    ("LeastSquaresGradient", "saga_grad"), ("LogisticGradient", "masked_grad"),
    ("HingeGradient", "xt_coeff")])
def test_ml_gradient_is_one_b1_launch_and_matches_the_cpu(dev, name, form):
    from asyncframework_tpu_torch import ml
    from asyncframework_tpu_torch.tools import runs

    X, y = _ml_problem(4_096, 300, labels=name != "LeastSquaresGradient")
    w = np.random.default_rng(1).normal(size=300).astype(np.float32) * 0.1
    mask = (np.random.default_rng(2).random(4_096) < 0.5).astype(np.float32)
    grad = getattr(ml, name)()
    cpu = grad.local(*(torch.from_numpy(a) for a in (X, y, w, mask)))
    runs.zero_counts()
    gpu = grad.local(*(torch.from_numpy(a).to(dev) for a in (X, y, w, mask)))
    c = runs.counts()
    full = "full" if form == "masked_grad" else form
    assert runs.b1_forms(c) == {f: int(f == full)
                                for f in runs.b1_forms(c)}, c
    assert sum(v for k, v in c.items() if k.endswith("_plain")) == 0
    _close(gpu[0], cpu[0], 1e-4)
    _close(gpu[1], cpu[1], 1e-5)


@pytest.mark.parametrize("estimator", ["LinearRegression", "LogisticRegression",
                                       "LinearSVM"])
def test_ml_sgd_estimator_on_the_card_matches_the_cpu(dev, estimator):
    """Captured as CUDA graphs on the card (one B1 launch an iteration),
    eager on the CPU: the same iterations at fraction 1.0."""
    from asyncframework_tpu_torch import ml
    from asyncframework_tpu_torch.parallel import make_mesh
    from asyncframework_tpu_torch.tools import runs

    X, y = _ml_problem(20_000, 500, labels=estimator != "LinearRegression")
    kw = dict(num_iterations=40, reg_param=0.01, step_size=1.0)
    cpu = getattr(ml, estimator)(**kw).fit(
        X, y, mesh=make_mesh(1, devices=[torch.device("cpu")]))
    est = getattr(ml, estimator)(**kw)
    runs.zero_counts()
    gpu = est.fit(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev))
    info = est.optimizer.last_run
    assert info["graph_replays"] > 0
    form = {"LinearRegression": "saga_grad", "LogisticRegression": "full",
            "LinearSVM": "xt_coeff"}[estimator]
    forms = runs.b1_forms(runs.counts())
    assert forms == {f: info["enqueued_iterations"] * (f == form)
                     for f in forms}, forms
    np.testing.assert_allclose(gpu.weights, cpu.weights, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gpu.loss_history, cpu.loss_history,
                               rtol=1e-4, atol=1e-6)


def test_ml_lbfgs_on_the_card_matches_the_cpu(dev):
    from asyncframework_tpu_torch import ml
    from asyncframework_tpu_torch.parallel import make_mesh
    from asyncframework_tpu_torch.tools import runs

    X, y = _ml_problem(20_000, 200, labels=True)
    cpu_w, cpu_h = ml.LBFGS(ml.LogisticGradient(), max_iterations=6).optimize(
        X, y, mesh=make_mesh(1, devices=[torch.device("cpu")]))
    lb = ml.LBFGS(ml.LogisticGradient(), max_iterations=6)
    runs.zero_counts()
    w, h = lb.optimize(X, y)
    forms = runs.b1_forms(runs.counts())
    assert forms == {f: lb.last_run["evaluations"] * (f == "full")
                     for f in forms}, forms
    # f32 sums over 20,000 rows in two orders: the objective agrees; the
    # two-loop recursion carries the difference into the flat directions
    # of w, so w is held by its norm
    assert len(h) == len(cpu_h)
    np.testing.assert_allclose(h, cpu_h, rtol=1e-4)
    assert np.linalg.norm(w - cpu_w) <= 1e-2 * np.linalg.norm(cpu_w)


def test_ml_library_on_the_card_matches_the_cpu(dev):
    """Statistics, PCA, SVD, the distributed matrices, k-means, an ALS
    half step, a Word2Vec step and an LDA fit: the card against the CPU on
    the same inputs."""
    from asyncframework_tpu_torch import ml
    from asyncframework_tpu_torch.ml import recommendation, word2vec
    from asyncframework_tpu_torch.parallel import make_mesh

    cpu = torch.device("cpu")
    rs = np.random.default_rng(0)
    A = (rs.normal(size=(2_048, 24)) * np.linspace(3, 0.3, 24)).astype(
        np.float32)
    for dv in (dev, cpu):
        assert ml.col_stats(A, device=dv).count == 2_048
    np.testing.assert_allclose(ml.col_stats(A, device=dev).variance,
                               ml.col_stats(A, device=cpu).variance,
                               rtol=1e-5)
    np.testing.assert_allclose(ml.corr(A, device=dev), ml.corr(A, device=cpu),
                               atol=1e-5)
    kde = [ml.KernelDensity(0.5, device=dv).set_sample(A[:, 0]).estimate(
        np.linspace(-3, 3, 9)) for dv in (dev, cpu)]
    np.testing.assert_allclose(kde[0], kde[1], rtol=1e-5)
    assert ml.chi_sq_test([16, 18, 16, 14, 12, 12], device=dev).statistic \
        == pytest.approx(ml.chi_sq_test([16, 18, 16, 14, 12, 12],
                                        device=cpu).statistic, rel=1e-6)
    pcs = [ml.PCA(4).fit(A, device=dv) for dv in (dev, cpu)]
    np.testing.assert_allclose(pcs[0].explained_variance,
                               pcs[1].explained_variance, rtol=1e-4)
    _u, s_gpu, _v = ml.svd(A, 6, device=dev)
    _u, s_cpu, _v = ml.svd(A, 6, device=cpu)
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=1e-4)
    mesh4 = make_mesh(4, devices=[dev] * 4)
    _q, R4 = ml.RowMatrix(A, mesh4).tall_skinny_qr()
    _q, R1 = ml.RowMatrix(A, device=cpu).tall_skinny_qr()
    _close(R4, R1, 1e-3)
    B = rs.normal(size=(24, 37)).astype(np.float32)
    C = ml.BlockMatrix.from_dense(A, 512, devices=[dev]).multiply(
        ml.BlockMatrix.from_dense(B, 512, devices=[dev]))
    np.testing.assert_allclose(C.to_local(), A @ B, rtol=1e-3, atol=1e-3)
    km = [ml.KMeans(5, seed=1).fit(A, make_mesh(2, devices=[dv] * 2))
          for dv in (dev, cpu)]
    np.testing.assert_allclose(km[0].centers, km[1].centers, rtol=1e-4,
                               atol=1e-4)
    R = rs.normal(size=(60, 40)).astype(np.float32)
    mask = (rs.random((60, 40)) < 0.5).astype(np.float32)
    F = rs.normal(size=(40, 5)).astype(np.float32)
    halves = [recommendation._half_step(*(torch.from_numpy(a).to(dv)
                                          for a in (F, R, mask)), 0.1)
              for dv in (dev, cpu)]
    _close(halves[0], halves[1], 1e-4)
    V, d, Bsz, K = 30, 8, 64, 4
    state = [rs.normal(size=(V, d)).astype(np.float32) for _ in range(2)]
    idx = [rs.integers(0, V, Bsz), rs.integers(0, V, Bsz),
           rs.integers(0, V, (Bsz, K))]
    outs = []
    for dv in (dev, cpu):
        W_in, W_out = (torch.from_numpy(s.copy()).to(dv) for s in state)
        word2vec._sgns_step(W_in, W_out, *(torch.from_numpy(i).to(dv)
                                           for i in idx), 0.3)
        outs.append((W_in, W_out))
    _close(outs[0][0], outs[1][0], 1e-5)
    _close(outs[0][1], outs[1][1], 1e-5)
    docs = rs.poisson(1.0, size=(100, 30)).astype(np.float32)
    ldas = [ml.LDA(k=3, max_iterations=5, seed=0).fit(docs, device=dv)
            for dv in (dev, cpu)]
    np.testing.assert_allclose(ldas[0].topics, ldas[1].topics, rtol=1e-3,
                               atol=1e-6)


# ------------------------------------------------- the ML library's breadth
def test_ml_regression_tree_refits_on_the_card_are_identical(dev):
    """Fixed-point histogram sums: two fits of the same data on the card
    grow the same tree, and it is the CPU's."""
    from asyncframework_tpu_torch import ml

    rs = np.random.default_rng(0)
    X = rs.normal(size=(50_000, 20)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + X[:, 1] * X[:, 2]
         + 0.1 * rs.normal(size=50_000)).astype(np.float32)
    Xd = torch.from_numpy(X).to(dev)
    fits = [ml.DecisionTree("regression", max_depth=6, device=dev).fit(Xd, y)
            for _ in range(2)]
    fits.append(ml.DecisionTree("regression", max_depth=6,
                                device=torch.device("cpu")).fit(X, y))
    for t in fits[1:]:
        for field in ("feature", "threshold", "prediction"):
            np.testing.assert_array_equal(getattr(t, field),
                                          getattr(fits[0], field))
    gbts = [ml.GradientBoostedTrees("regression", num_iterations=4,
                                    device=dev).fit(Xd, y) for _ in range(2)]
    for a, b in zip(gbts[0].trees, gbts[1].trees):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.prediction, b.prediction)
    np.testing.assert_array_equal(fits[0].predict(Xd).cpu().numpy(),
                                  fits[0].predict(X))


def test_ml_cross_validator_indexes_a_cuda_tensor_on_the_card(
        dev, monkeypatch):
    """Every fold's rows are gathered on the card: no estimator sees a host
    array, and nothing copies the matrix to the host on the way."""
    from asyncframework_tpu_torch import ml

    rs = np.random.default_rng(1)
    X = torch.from_numpy(rs.normal(size=(3_000, 16)).astype(
        np.float32)).to(dev)
    y = (X[:, 0] > 0).float()
    seen = []

    class Probe:
        def __init__(self, reg_param):
            self.inner = ml.LogisticRegression(reg_param=reg_param,
                                               num_iterations=5)

        def fit(self, Xf, yf):
            seen.append((Xf.device.type, yf.device.type, tuple(Xf.shape)))
            return self.inner.fit(Xf, yf)

    fold_numel = X.shape[0] // 3 * X.shape[1]
    original = {name: getattr(torch.Tensor, name)
                for name in ("cpu", "__array__")}

    def guarded(name):
        def call(self, *args, **kwargs):
            if self.numel() >= fold_numel:
                raise AssertionError(f"a fold's rows went to the host "
                                     f"({name})")
            return original[name](self, *args, **kwargs)
        return call

    for name in original:
        monkeypatch.setattr(torch.Tensor, name, guarded(name))
    cv = ml.CrossValidator(Probe, {"reg_param": [0.0, 0.1]},
                           ml.accuracy_scorer, num_folds=3).fit(X, y)
    assert len(seen) == 7
    assert all((xd, yd) == ("cuda", "cuda") for xd, yd, _ in seen)
    assert seen[-1][2] == tuple(X.shape)
    assert 0.5 < cv.best_score <= 1.0


def test_ml_load_model_defaults_to_the_card(dev, tmp_path):
    from asyncframework_tpu_torch import ml

    rs = np.random.default_rng(2)
    X = rs.poisson(2.0, size=(500, 12)).astype(np.float32)
    y = rs.integers(0, 3, 500)
    cpu = torch.device("cpu")
    nb = ml.NaiveBayes(device=cpu).fit(X, y)
    pipe = ml.Pipeline([ml.IDF(device=cpu).fit(X),
                        ml.NaiveBayes(device=cpu)]).fit(X, y)
    loaded = ml.load_model(ml.save_model(nb, tmp_path / "nb"))
    assert loaded.log_pi.device.type == "cuda"
    np.testing.assert_array_equal(loaded.predict(X), nb.predict(X))
    lp = ml.load_model(ml.save_model(pipe, tmp_path / "pipe"))
    assert lp.transformers[0].idf.device.type == "cuda"
    assert lp.model.log_theta.device.type == "cuda"
    out = lp.predict(torch.from_numpy(X).to(dev))
    assert out.device.type == "cuda"
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  pipe.predict(torch.from_numpy(X)).numpy())


def test_ml_gaussian_mixture_on_the_card_matches_the_cpu(dev):
    """More rows than a CUDA grid's 65,535 blocks in one dimension: the
    EM steps on the card agree with the CPU's."""
    from asyncframework_tpu_torch import ml

    rs = np.random.default_rng(3)
    X = np.vstack([rs.normal(c, s, size=(40_000, 4)) for c, s in
                   ((-4.0, 1.0), (3.0, 2.0), (9.0, 0.5))]).astype(np.float32)
    fits = [ml.GaussianMixture(3, seed=1, max_iterations=20,
                               device=dv).fit(X)
            for dv in (dev, torch.device("cpu"))]
    assert np.isfinite(fits[0].log_likelihood)
    np.testing.assert_allclose(fits[0].means, fits[1].means, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(fits[0].log_likelihood,
                               fits[1].log_likelihood, rtol=1e-5)


# ------------------------------------------ the dataset layer and the graph
def test_reduce_by_key_on_card_tensors_takes_the_device_plane(dev):
    """Card blocks take the device plane under ``auto`` (nothing leaves the
    card to pick it), and agree key for key with the host plane."""
    from asyncframework_tpu_torch.conf import AsyncConf, set_global_conf
    from asyncframework_tpu_torch.data.dataset import DistributedDataset
    from asyncframework_tpu_torch.engine.scheduler import JobScheduler
    from asyncframework_tpu_torch.ops import shuffle

    rs = np.random.default_rng(3)
    blocks = {w: (rs.integers(0, 5_000, size=20_000),
                  rs.integers(-9, 9, size=20_000).astype(np.int32))
              for w in range(4)}
    sched = JobScheduler(num_workers=4)
    try:
        ds = DistributedDataset.from_array_pairs(sched, blocks)
        assert all(ds._compute(w)[0][0].is_cuda for w in range(4))
        out = {}
        for plane in (None, "host"):
            set_global_conf(None if plane is None else AsyncConf(
                {"async.shuffle.data.plane": plane}))
            before = dict(shuffle.calls)
            got = ds.reduce_by_key("sum")
            out[plane] = {p: got._compute(p)[0] for p in got.partition_ids()}
            taken = {k: shuffle.calls[k] - before[k] for k in before}
            assert taken == ({"device": 1, "host": 0} if plane is None
                             else {"device": 0, "host": 1})
    finally:
        set_global_conf(None)
        sched.shutdown()
    for p in range(4):
        np.testing.assert_array_equal(out[None][p][0], out["host"][p][0])
        np.testing.assert_array_equal(out[None][p][1], out["host"][p][1])


def test_graph_library_on_the_card_matches_the_cpu(dev):
    from asyncframework_tpu_torch import graph as tg

    rs = np.random.default_rng(8)
    e = rs.integers(0, 300, size=(2_000, 2)).astype(np.int32)
    G = tg.Graph(e[:, 0], e[:, 1], 300, device=dev)
    C = tg.Graph(e[:, 0], e[:, 1], 300, device=torch.device("cpu"))
    assert G.src.is_cuda and G.src.dtype == torch.int32
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for algo in ("connected_components", "triangle_count",
                     "label_propagation", "strongly_connected_components"):
            np.testing.assert_array_equal(
                getattr(tg, algo)(G).cpu().numpy(),
                getattr(tg, algo)(C).numpy(), err_msg=algo)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    np.testing.assert_array_equal(tg.shortest_paths(G, [0, 7]).cpu().numpy(),
                                  tg.shortest_paths(C, [0, 7]).numpy())
    for strategy in ("edge_1d", "edge_2d", "random_vertex_cut",
                     "canonical_random_vertex_cut"):
        np.testing.assert_array_equal(
            tg.partition_edges(G, 7, strategy).cpu().numpy(),
            tg.partition_edges(C, 7, strategy).numpy())
    r_g = tg.pagerank(G, num_iterations=50, tol=1e-6)
    it_g = tg.pregel.last_iterations
    r_c = tg.pagerank(C, num_iterations=50, tol=1e-6)
    assert tg.pregel.last_iterations == it_g
    np.testing.assert_allclose(r_g.cpu().numpy(), r_c.numpy(), atol=1e-6)


def test_svd_plus_plus_on_the_card_matches_the_cpu(dev):
    from asyncframework_tpu_torch.graph import algorithms as alg

    rs = np.random.default_rng(2)
    u = rs.integers(0, 40, size=600)
    i = rs.integers(0, 30, size=600)
    r = rs.normal(3.0, 1.0, size=600).astype(np.float32)
    P0, Q0, Y0 = (torch.from_numpy(rs.normal(size=(rows, 4)).astype(
        np.float32) * 0.05) for rows in (40, 30, 30))
    got = alg._train_svd_plus_plus(u, i, r, P0.to(dev), Q0.to(dev),
                                   Y0.to(dev), 100, 0.5, 0.015)
    want = alg._train_svd_plus_plus(u, i, r, P0, Q0, Y0, 100, 0.5, 0.015)
    for f in ("user_vectors", "item_vectors", "user_bias", "item_bias"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=1e-5, err_msg=f)
