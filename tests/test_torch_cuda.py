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

    mesh = make_mesh(4, devices=[dev] * 4)
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
