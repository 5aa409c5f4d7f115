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
