"""The port's masked-gradient contraction against the JAX package.

On the CPU :func:`masked_grad` runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode (as ``tests/test_aux.py`` does) and
the XLA gradient sums.  Inputs come from a seeded numpy generator and go to
both packages as numpy.

Tolerances: f32 ``rtol=1e-5, atol=1e-5 * max|g|`` -- both sides sum the
same f32 products in different orders.  bf16 ``rtol=1e-2, atol=1e-2 *
max|g|`` -- a one-ulp flip of a row coefficient's bf16 rounding follows from
the f32 order of its dot product and moves g by 2^-8 of that row's term.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asyncframework_tpu.ops import gradients as jgrad
from asyncframework_tpu.ops.pallas_kernels import fused_masked_grad
from asyncframework_tpu_torch.ops import gradients as tgrad
from asyncframework_tpu_torch.ops import masked_grad as mg
from asyncframework_tpu_torch.ops.masked_grad import (
    masked_grad,
    masked_grad_reference,
)

SHAPES = [(256, 128), (300, 100), (64, 17), (17, 8)]


def _problem(n, d, seed=0):
    rs = np.random.default_rng(seed)
    X = rs.normal(size=(n, d)).astype(np.float32)
    y = rs.normal(size=(n,)).astype(np.float32)
    w = rs.normal(size=(d,)).astype(np.float32)
    mask = (rs.random(n) < 0.5).astype(np.float32)
    return X, y, w, mask


def _bf16_rows(X):
    """X rounded to bf16 by JAX, as exact f32 numpy and as a torch bf16."""
    Xb = np.array(jnp.asarray(X, jnp.bfloat16).astype(jnp.float32))
    return Xb, torch.from_numpy(Xb).to(torch.bfloat16)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        got, want, rtol=rel, atol=rel * float(np.abs(want).max(initial=1.0))
    )


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("masked", [True, False])
def test_f32_matches_pallas_and_xla(n, d, masked):
    X, y, w, mask = _problem(n, d)
    m = mask if masked else None
    got = masked_grad(torch.from_numpy(X), torch.from_numpy(y),
                      torch.from_numpy(w),
                      None if m is None else torch.from_numpy(m))
    _close(got, fused_masked_grad(X, y, w, m, interpret=True), 1e-5)
    ones = np.ones(n, np.float32) if m is None else m
    _close(got, jgrad.least_squares_grad_sum(X, y, w, ones), 1e-5)


@pytest.mark.parametrize("n,d", SHAPES)
def test_bf16_matches_mm_f32_contract(n, d):
    X, y, w, mask = _problem(n, d, seed=1)
    Xb_np, Xb = _bf16_rows(X)
    got = masked_grad(Xb, torch.from_numpy(y), torch.from_numpy(w),
                      torch.from_numpy(mask))
    want = jgrad.least_squares_grad_sum(
        jnp.asarray(Xb_np, jnp.bfloat16), y, w, mask
    )
    _close(got, want, 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compacted_idx_form_matches_gathered_rows(dtype):
    n, d, cap = 300, 100, 64
    X, y, w, mask = _problem(n, d, seed=2)
    rs = np.random.default_rng(3)
    count = 50
    idx = np.zeros(cap, np.int64)
    idx[:count] = np.sort(rs.choice(n, size=count, replace=False))
    valid = (np.arange(cap) < count).astype(np.float32)
    if dtype == "bfloat16":
        X, Xt = _bf16_rows(X)
        Xj = jnp.asarray(X, jnp.bfloat16)
        rel = 1e-2
    else:
        Xt, Xj, rel = torch.from_numpy(X), X, 1e-5
    got = masked_grad(Xt, torch.from_numpy(y), torch.from_numpy(w),
                      torch.from_numpy(valid), torch.from_numpy(idx))
    want = jgrad.least_squares_grad_sum(Xj[idx], y[idx], w, valid)
    _close(got, want, rel)


@pytest.mark.parametrize("compact", [False, True])
def test_logistic_matches_logistic_grad_sum(compact):
    n, d = 256, 32
    X, _, w, mask = _problem(n, d, seed=4)
    y = (np.random.default_rng(5).random(n) < 0.5).astype(np.float32)
    if compact:
        idx = np.arange(0, n, 3, dtype=np.int64)
        weights = np.ones(idx.shape[0], np.float32)
        want = jgrad.logistic_grad_sum(X[idx], y[idx], w, weights)
        t_idx = torch.from_numpy(idx)
    else:
        weights, t_idx = mask, None
        want = jgrad.logistic_grad_sum(X, y, w, mask)
    got = tgrad.logistic_grad_sum(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
        torch.from_numpy(weights), t_idx,
    )
    _close(got, want, 1e-5)


def test_empty_inputs_give_zeros():
    d = 8
    w = torch.ones(d)
    g = masked_grad(torch.zeros(0, d), torch.zeros(0), w)
    assert g.shape == (d,) and not g.any()
    X = torch.ones(5, d)
    g = masked_grad(X, torch.zeros(5), w, torch.zeros(0),
                    torch.zeros(0, dtype=torch.int64))
    assert g.shape == (d,) and not g.any()


@pytest.mark.parametrize("bad,exc", [
    (dict(y=torch.zeros(5, dtype=torch.float64)), TypeError),
    (dict(w=torch.zeros(3)), ValueError),
    (dict(mask=torch.ones(4)), ValueError),
    (dict(idx=torch.zeros(2, dtype=torch.int32)), TypeError),
    (dict(X=torch.zeros(8, 5).T), ValueError),
    (dict(X=torch.zeros(5, 4, dtype=torch.float16)), TypeError),
    (dict(loss="hinge"), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, exc):
    args = dict(X=torch.zeros(5, 4), y=torch.zeros(5), w=torch.zeros(4),
                mask=None, idx=None, loss="least_squares")
    args.update(bad)
    with pytest.raises(exc):
        masked_grad(**args)


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    X, y, w, mask = (torch.from_numpy(a) for a in _problem(64, 17))
    before = masked_grad.launches
    assert torch.equal(masked_grad(X, y, w, mask),
                       masked_grad_reference(X, y, w, mask))
    assert masked_grad.launches == before
    assert mg.LOSSES == {"least_squares": 0, "logistic": 1}



# ------------------------------------------------------------ launch plan
# The staged route's plan is plain Python, so its layout is checked here;
# the kernel computes the same chunks (``chunk_slots``) on the card.
H100_SMS = 132


def _occupancy(smem):
    """An H100's answer for the staged block at any shared memory: one an
    SM (544 threads at 80-94 registers each leave no room for a second)."""
    return 1


# chip_smoke.py's phase-2 B1 shapes: (name, d, m, elem bytes, mode, route)
SMOKE_PLANS = [
    ("a_epsilon_full", 2_000, 50_000, 4, 0, "staged"),
    ("b_epsilon_idx", 2_000, 5_408, 4, 0, "staged"),
    ("c_mnist8m_idx", 784, 103_064, 2, 0, "staged"),
    ("c_mnist8m_full", 784, 1_012_500, 2, 0, "staged"),
    ("d_ragged_300x100", 100, 300, 4, 0, "tiled"),
    ("d_ragged_17x8", 8, 17, 4, 0, "tiled"),
    ("d_empty_0x8", 8, 0, 4, 0, "tiled"),
    ("d_small_132x2000", 2_000, 132, 4, 0, "staged"),
    ("e_epsilon_logistic", 2_000, 50_000, 4, 1, "staged"),
    ("saga_epsilon", 2_000, 50_000, 4, 2, "staged"),
    ("xt_epsilon", 2_000, 50_000, 4, 3, "staged"),
    ("saga_mnist8m_shard", 784, 1_012_500, 2, 2, "staged"),
    ("xt_mnist8m_shard", 784, 1_012_500, 2, 3, "staged"),
]

# ragged edges on the staged route (pinned, as the probe pins it): m = 0,
# 1, 7, fewer slots than blocks, just past a whole first round, many
# rounds; d = 8, 784, 2,000 and the widest rows it takes
EDGE_D = [(8, 4), (8, 2), (784, 4), (784, 2), (2_000, 4), (2_000, 2),
          (2_048, 4), (4_096, 2)]
EDGE_M = [0, 1, 7, 131, 133, 2 * 132 * 8 + 1, 40_000]


def _check_plan(plan, d, m, elem_bytes):
    geo = plan.geometry
    vec = 16 // elem_bytes
    pad = -(-(d // vec) // 32) * 32
    assert geo.lanes == d // vec
    assert geo.groups * pad <= mg.CONSUMERS
    assert geo.rows % geo.groups == 0
    assert geo.rows // geo.groups <= mg.MAX_GROUP_ROWS
    assert geo.rows <= mg.MAX_STAGE_ROWS and geo.stages >= 2
    assert geo.smem + mg.STAGED_STATIC_SMEM <= mg.SMEM_LIMIT
    slots = geo.stages * geo.rows
    assert geo.smem == (slots * d * elem_bytes + 8 * slots + 16 * geo.stages
                        + 16 * slots + 8 * geo.stages
                        + (4 * geo.groups * d if geo.groups > 1 else 0))
    assert plan.blocks == H100_SMS * _occupancy(geo.smem)
    chunks = plan.chunks()
    assert len(chunks) == plan.nchunks
    # every slot in exactly one chunk, in order
    covered = [slot for lo, hi in chunks for slot in range(lo, hi)]
    assert covered == list(range(m))
    # chunks are whole stages (the last one cut at m), one round of
    # `blocks` equal chunks after another, never growing
    sizes = [hi - lo for lo, hi in chunks]
    assert all(sz % geo.rows == 0 for sz in sizes[:-1])
    assert all(a >= b for a, b in zip(sizes, sizes[1:]))
    for r in range(0, len(sizes) - 1, plan.blocks):
        rnd = sizes[r:r + plan.blocks]
        assert len(set(rnd[:-1])) <= 1 and rnd[-1] <= rnd[0]
    # the first round: one chunk a block, lengths within one stage
    first = sizes[:plan.blocks]
    assert not first or max(first) - min(first) <= geo.rows


@pytest.mark.parametrize("name,d,m,elem_bytes,mode,route", SMOKE_PLANS)
def test_plan_routes_chip_smoke_shapes(name, d, m, elem_bytes, mode, route):
    plan = mg.launch_plan(d, m, elem_bytes, True, mode, H100_SMS, _occupancy)
    assert plan.route == route, name
    if route == "staged":
        _check_plan(plan, d, m, elem_bytes)
    else:
        assert plan.blocks == min(-(-m // mg.TILE_ROWS), 2 * H100_SMS)


@pytest.mark.parametrize("d,elem_bytes", EDGE_D)
@pytest.mark.parametrize("m", EDGE_M)
def test_plan_chunks_cover_every_slot_once(d, elem_bytes, m):
    plan = mg.launch_plan(d, m, elem_bytes, True, 0, H100_SMS, _occupancy,
                          route="staged")
    assert plan.route == "staged"
    _check_plan(plan, d, m, elem_bytes)


@pytest.mark.parametrize("d,elem_bytes,why", [
    (130, 4, "rows of 520 bytes are no multiple of 16"),
    (130, 2, "rows of 260 bytes are no multiple of 16"),
    (100, 2, "rows of 200 bytes are no multiple of 16"),
    (2_052, 4, "513 column lanes, more than the consumer threads"),
    (4_096, 4, "1,024 column lanes: too wide for the ring's groups"),
    (8_200, 2, "1,025 column lanes"),
])
def test_plan_leaves_unaligned_and_wide_rows_on_the_tiled_route(
        d, elem_bytes, why):
    assert mg.staged_geometry(d, elem_bytes) is None, why
    plan = mg.launch_plan(d, 50_000, elem_bytes, True, 0, H100_SMS,
                          _occupancy)
    assert plan.route == "tiled", why
    with pytest.raises(ValueError):
        mg.launch_plan(d, 50_000, elem_bytes, True, 0, H100_SMS, _occupancy,
                       route="staged")


def test_plan_leaves_unaligned_addresses_and_small_inputs_tiled():
    # X or w off a 16-byte address: the tiled route, whatever the width
    plan = mg.launch_plan(2_000, 50_000, 4, False, 0, H100_SMS, _occupancy)
    assert plan.route == "tiled"
    # just under and at the staged route's least bytes of X
    rows_min = mg.STAGED_MIN_BYTES // (2_000 * 4)
    small = mg.launch_plan(2_000, rows_min - 1, 4, True, 0, H100_SMS,
                           _occupancy)
    at = mg.launch_plan(2_000, -(-mg.STAGED_MIN_BYTES // 8_000), 4, True, 0,
                        H100_SMS, _occupancy)
    assert (small.route, at.route) == ("tiled", "staged")
    # the form does not choose: every mode alike at the same shape
    routes = {mg.launch_plan(2_000, 50_000, 4, True, mode, H100_SMS,
                             _occupancy).route for mode in range(4)}
    assert routes == {"staged"}
    # pinning the tiled route keeps its grid
    pinned = mg.launch_plan(2_000, 5_408, 4, True, 0, H100_SMS, _occupancy,
                            route="tiled")
    assert (pinned.route, pinned.blocks) == ("tiled", 2 * H100_SMS)


def test_plan_needs_an_sm_that_holds_a_block():
    with pytest.raises(RuntimeError):
        mg.launch_plan(2_000, 5_408, 4, True, 0, H100_SMS, lambda smem: 0)


def test_pinned_route_is_scoped_and_checked():
    with pytest.raises(ValueError):
        with mg.pinned_route("fast"):
            pass
    with mg.pinned_route("tiled"):
        assert mg._pinned == "tiled"
        with mg.pinned_route("staged"):
            assert mg._pinned == "staged"
        assert mg._pinned == "tiled"
    assert mg._pinned is None


@pytest.mark.parametrize("m", [7, 1_000, 5_408])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_sums_in_chunk_order_match_jax(m, dtype):
    """The staged route's decomposition on the CPU: each chunk's sum of
    c_i x_i over the plan's chunks, added in chunk order, against the JAX
    package's gradient sum over the same compacted rows."""
    n, d = 3_000, 784
    X, y, w, _ = _problem(n, d, seed=6)
    rs = np.random.default_rng(7)
    idx = rs.integers(0, n, size=m).astype(np.int64)
    weights = (rs.random(m) < 0.8).astype(np.float32)
    if dtype == "bfloat16":
        X, Xt = _bf16_rows(X)
        Xj, rel, es = jnp.asarray(X, jnp.bfloat16), 1e-2, 2
    else:
        Xt, Xj, rel, es = torch.from_numpy(X), X, 1e-5, 4
    plan = mg.launch_plan(d, m, es, True, 0, H100_SMS, _occupancy,
                          route="staged")
    yt, wt = torch.from_numpy(y), torch.from_numpy(w)
    got = torch.zeros(d)
    for lo, hi in plan.chunks():
        got += masked_grad(Xt, yt, wt, torch.from_numpy(weights[lo:hi]),
                           torch.from_numpy(idx[lo:hi]))
    want = jgrad.least_squares_grad_sum(Xj[idx], y[idx], w, weights)
    _close(got, want, rel)
