"""The port's sparse (padded-ELL, rcv1-class) path against the JAX package,
on the CPU.

Inputs come from seeded numpy generators and go to both packages as numpy;
samples are injected into both (the two draw different random bits).  On
CPU tensors kernel S1's wrappers run their plain versions.

Tolerances, each with its reason:

- exact: the data layer (CSR -> ELL packing, ``row_perm``, the parsers,
  ``make_sparse_regression``), the gathered rows, the commit, and every
  segment sum given the same coefficients.  The segment sum adds each
  column's products one at a time in sorted (stable, i.e. flat) order, as
  the JAX package's sorted scatter does on the CPU, so the two are
  bit-equal.
- the residual ``x_i . w - y_i``: ``rtol=1e-5, atol=1e-5 * max|r|``.  It
  sums K products in the kernel's lane order, XLA in its own; the port
  reaches at most 6e-8 of max|r| on these shapes (the reference's own test
  holds it to ``rtol=1e-4, atol=1e-5``, ``tests/test_sparse.py:70``).
- anything downstream of a residual (a step's gradient, the loss):
  ``rtol=1e-5, atol=1e-5 * max|.|``; the ``run_sync()`` trajectories
  ``rtol=1e-5`` on the objective and ``atol=1e-5 * max|w|`` on the model
  (the drained sum's arrival order also varies), as for the dense solvers.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asyncframework_tpu.data import SparseShardedDataset as JaxSparse
from asyncframework_tpu.data import make_sparse_regression as jax_msr
from asyncframework_tpu.data import parse_libsvm_lines as jax_parse
from asyncframework_tpu.data import parse_libsvm_lines_sparse as jax_parse_sparse
from asyncframework_tpu.data.sparse import densify as jax_densify
from asyncframework_tpu.ops import gradients as jgrad
from asyncframework_tpu.ops import steps as jsteps
from asyncframework_tpu.solvers import ASAGA as JaxASAGA
from asyncframework_tpu.solvers import ASGD as JaxASGD
from asyncframework_tpu.solvers import SolverConfig as JaxConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from asyncframework_tpu_torch.convert import (
    saga_state_from_reference,
    sparse_dataset_from_reference,
)
from asyncframework_tpu_torch.data import (
    SparseShardedDataset,
    densify,
    load_libsvm,
    load_libsvm_sparse,
    make_sparse_regression,
    parse_libsvm_lines,
    parse_libsvm_lines_sparse,
)
from asyncframework_tpu_torch.engine.recovery import ShardRecovery
from asyncframework_tpu_torch.ops import gradients as tgrad
from asyncframework_tpu_torch.ops import sparse_grad as sg
from asyncframework_tpu_torch.ops import steps as tsteps
from asyncframework_tpu_torch.ops.sampling import worker_generator
from asyncframework_tpu_torch.solvers import ASAGA, ASGD, SolverConfig
from asyncframework_tpu_torch.solvers.base import check_hbm_plan
from asyncframework_tpu_torch.utils.hbm import dataset_residency_bytes

CPU = torch.device("cpu")


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(
        got, want, rtol=rel, atol=rel * float(np.abs(want).max(initial=1.0))
    )


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.array_equal(got, np.asarray(want))


def _skewed_csr(n=400, d=1000, base_nnz=5, dense_every=50, dense_nnz=400,
                seed=0):
    """rcv1-like skew: mostly ``base_nnz`` rows, a few near-dense outliers
    (``tests/test_sparse.py::_skewed_csr``)."""
    rs = np.random.default_rng(seed)
    indptr, indices, values = [0], [], []
    for i in range(n):
        k = dense_nnz if i % dense_every == 0 else base_nnz
        indices.extend(rs.choice(d, size=k, replace=False).tolist())
        values.extend(rs.normal(size=k).tolist())
        indptr.append(len(indices))
    y = rs.normal(size=n).astype(np.float32)
    return (np.asarray(indptr), np.asarray(indices, np.int32),
            np.asarray(values, np.float32), y)


def _pair(csr, d, workers, nnz_partition=False):
    """The same CSR in both packages (JAX on its virtual CPU devices)."""
    devs = jax.devices()[:workers]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jds = JaxSparse(*csr, d, workers, devs, nnz_partition=nnz_partition)
        tds = SparseShardedDataset(*csr, d, workers, [CPU],
                                   nnz_partition=nnz_partition)
    return jds, tds


def _shard_arrays(shard):
    return [np.asarray(a) for a in (shard.cols, shard.vals, shard.y)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("n,d,density,seed", [
    (128, 64, 0.1, 3), (64, 32, 0.2, 5), (300, 47_236, 0.002, 11),
])
def test_make_sparse_regression_is_the_jax_packages(n, d, density, seed):
    for got, want in zip(make_sparse_regression(n, d, density, seed),
                         jax_msr(n, d, density, seed)):
        assert got.dtype == want.dtype
        _equal(got, want)


def test_libsvm_parsers_are_the_jax_packages(tmp_path):
    lines = ["1.0 3:2.5 7:1.0", "# comment", "", "-1 1:0.5", "0 8:-2e-3 2:4"]
    for got, want in zip(parse_libsvm_lines_sparse(lines, 8),
                         jax_parse_sparse(lines, 8)):
        assert got.dtype == want.dtype
        _equal(got, want)
    for got, want in zip(parse_libsvm_lines(lines, 8), jax_parse(lines, 8)):
        _equal(got, want)
    for bad in (["1 0:1.0"], ["1 9:1.0"]):
        with pytest.raises(ValueError, match="out of range"):
            jax_parse_sparse(bad, 8)
        with pytest.raises(ValueError, match="out of range"):
            parse_libsvm_lines_sparse(bad, 8)
    path = tmp_path / "tiny.libsvm"
    path.write_text("\n".join(lines) + "\n")
    for got, want in zip(load_libsvm_sparse(str(path), 8),
                         jax_parse_sparse(lines, 8)):
        _equal(got, want)
    _equal(load_libsvm(str(path), 8)[0], jax_parse(lines, 8)[0])


@pytest.mark.parametrize("nnz_partition", [False, True])
@pytest.mark.parametrize("workers", [1, 3, 8])
def test_csr_packing_matches_the_jax_package(nnz_partition, workers):
    csr = _skewed_csr(dense_every=10)
    jds, tds = _pair(csr, 1000, workers, nnz_partition)
    _equal(tds.row_perm, jds.row_perm)
    assert tds.partition_cum == jds.partition_cum
    assert (tds.n, tds.d, tds.num_workers) == (jds.n, jds.d, jds.num_workers)
    for wid in range(workers):
        t, j = tds.shard(wid), jds.shard(wid)
        assert t.cols.dtype == torch.int32 and t.vals.dtype == torch.float32
        for got, want in zip((t.cols, t.vals, t.y), _shard_arrays(j)):
            _equal(got, want)
        assert (t.start, t.size) == (j.start, j.size)
    assert tds.nnz() == jds.nnz() and tds.padded_nnz() == jds.padded_nnz()
    for got, want in zip(densify(tds), jax_densify(jds)):
        _equal(got, want)


def test_skew_guard_matches_the_jax_package():
    csr = _skewed_csr()
    devs = jax.devices()[:8]
    for build in (lambda: JaxSparse(*csr, 1000, 8, devs),
                  lambda: SparseShardedDataset(*csr, 1000, 8, [CPU])):
        with pytest.warns(RuntimeWarning, match="nnz_partition"):
            build()
    jds, tds = _pair(csr, 1000, 8)
    want, got = jds.skew_report(), tds.skew_report()
    assert got.keys() == want.keys()
    assert (got["nnz"], got["padded_nnz"]) == (want["nnz"], want["padded_nnz"])
    for key in ("pad_overhead", "worst_shard_skew"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    assert got["pad_overhead"] > SparseShardedDataset.PAD_OVERHEAD_WARN
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # no warning here
        sorted_ds = SparseShardedDataset(*csr, 1000, 8, [CPU],
                                         nnz_partition=True)
    assert sorted_ds.skew_report()["padded_nnz"] < got["padded_nnz"]


def test_out_of_range_columns_are_refused():
    """The kernels index the model with the columns, so the dataset checks
    them (the JAX package relies on its parser and XLA's clamping)."""
    indptr = np.array([0, 2, 3])
    y = np.zeros(2, np.float32)
    vals = np.ones(3, np.float32)
    for bad in (np.array([0, 5, 1], np.int32), np.array([0, -1, 1], np.int32)):
        with pytest.raises(ValueError, match="outside"):
            SparseShardedDataset(indptr, bad, vals, y, 5, 1, [CPU])


# -------------------------------------------------------------- operations
def _small(n, d, density, seed):
    csr = make_sparse_regression(n, d, density, seed)
    jds, tds = _pair(csr, d, 1)
    return jds.shard(0), tds.shard(0)


@pytest.mark.parametrize("n,d,density,seed", [
    (128, 64, 0.1, 3), (64, 32, 0.2, 5), (1024, 512, 0.01, 7),
])
def test_sparse_residual_and_grad_sum_match(n, d, density, seed):
    """``tests/test_sparse.py``'s operation shapes: the residual within its
    stated tolerance, the sorted segment sum bit-equal."""
    js, ts = _small(n, d, density, seed)
    rs = np.random.default_rng(seed)
    w = rs.normal(size=d).astype(np.float32)
    coeff = rs.normal(size=n).astype(np.float32)
    want = np.asarray(jgrad.sparse_residual(js.cols, js.vals, js.y, w))
    got = tgrad.sparse_residual(ts.cols, ts.vals, ts.y, torch.from_numpy(w))
    _close(got, want)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-7 * np.abs(want).max()
    jsum = jgrad.make_sparse_grad_sum(d)
    tsum = tgrad.make_sparse_grad_sum(d)
    _equal(tsum(ts.cols, ts.vals, torch.from_numpy(coeff)),
           jsum(js.cols, js.vals, coeff))
    # the gradient of the step, from the same residual: also bit-equal
    r = got.numpy()
    _equal(tsum(ts.cols, ts.vals, got), jsum(js.cols, js.vals, r))


def _sample(n, cap, rate, seed):
    """An injected compacted sample: ``(valid, idx)`` as numpy, the
    ``jnp.nonzero(size=cap, fill_value=0)`` layout."""
    rs = np.random.default_rng(seed)
    picked = np.flatnonzero(rs.random(n) < rate)[:cap]
    idx = np.zeros(cap, np.int64)
    idx[:len(picked)] = picked
    valid = (np.arange(cap) < len(picked)).astype(np.float32)
    return valid, idx


def _jax_compacted(js, w, valid, idx, d, coeff_of=lambda r: r):
    """The JAX step's arithmetic after its draw (``steps.py:526-535``)."""
    c_sel = js.cols[idx]
    v_sel = js.vals[idx] * valid[:, None]
    r = jnp.sum(v_sel * w[c_sel], axis=1) - js.y[idx] * valid
    return jgrad.make_sparse_grad_sum(d)(c_sel, v_sel, coeff_of(r)), r


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_s1_plain_versions_through_idx(rate):
    """S1 reading the sampled rows through ``idx`` (unfilled slots to row 0,
    weight 0) against the JAX step's gather-then-reduce; a cap with no
    valid slot gives r = 0 and g = 0."""
    d = 64
    js, ts = _small(128, d, 0.1, 3)
    cap = 48
    valid, idx = _sample(128, cap, rate, 1)
    w = np.random.default_rng(2).normal(size=d).astype(np.float32)
    jg, jr = _jax_compacted(js, w, valid, idx, d)
    vt, it, wt = _t(valid, idx, w)
    r, keys = sg.ell_residual(ts.cols, ts.vals, ts.y, wt, it, vt, True)
    _close(r, jr)
    K = ts.cols.shape[1]
    live = (ts.vals[it] * vt[:, None] != 0).reshape(-1)
    _equal(keys[live], ts.cols[it].reshape(-1)[live])
    assert bool((keys[~live] == d).all())
    skeys, perm = sg.sort_keys(keys)
    g = sg.segment_sum(skeys, perm, ts.vals, _t(jr)[0], d, it, vt)
    _equal(g, jg)
    if rate == 0.0:
        assert not r.any() and not g.any() and bool((keys == d).all())
    assert keys.shape == (cap * K,)


def test_segment_sum_adds_in_sorted_order():
    """Each column's products are added one at a time in flat order, as
    ``np.add.at`` adds them (its sum is order-sensitive here: the values
    span 2^40)."""
    rs = np.random.default_rng(4)
    m, K, d = 200, 8, 3
    cols = rs.integers(0, d, size=(m, K)).astype(np.int32)
    vals = (rs.normal(size=(m, K)) * 2.0 ** rs.integers(-20, 20, (m, K)))
    vals = vals.astype(np.float32)
    coeff = rs.normal(size=m).astype(np.float32)
    want = np.zeros(d, np.float32)
    np.add.at(want, cols.ravel(), (vals * coeff[:, None]).ravel())
    ct, vt, kt = _t(cols, vals, coeff)
    keys = torch.where(vt != 0, ct, torch.full_like(ct, d)).reshape(-1)
    g = sg.segment_sum(*sg.sort_keys(keys), vt, kt, d)
    _equal(g, want)
    shuffled = np.zeros(d, np.float32)
    order = rs.permutation(m * K)
    np.add.at(shuffled, cols.ravel()[order],
              (vals * coeff[:, None]).ravel()[order])
    assert not np.array_equal(shuffled, want)  # the order matters here


def test_ell_residual_plain_takes_the_kernels_lane_order():
    """Lane l sums k = l, l + 32, ... from 0, then lane l + off is added
    into lane l for off = 16, 8, 4, 2, 1 (``csrc/sparse_grad.cu``)."""
    rs = np.random.default_rng(5)
    m, K, d = 7, 80, 50
    cols = rs.integers(0, d, size=(m, K)).astype(np.int32)
    vals = (rs.normal(size=(m, K)) * 2.0 ** rs.integers(-15, 15, (m, K)))
    vals = vals.astype(np.float32)
    y = rs.normal(size=m).astype(np.float32)
    w = rs.normal(size=d).astype(np.float32)
    p = vals * w[cols]
    want = np.empty(m, np.float32)
    for i in range(m):
        lanes = [np.float32(0.0)] * 32
        for k in range(K):
            lanes[k % 32] = np.float32(lanes[k % 32] + p[i, k])
        off = 16
        while off:
            lanes = [np.float32(lanes[l] + lanes[l + off]) for l in range(off)]
            off //= 2
        want[i] = np.float32(lanes[0] - y[i])
    _equal(sg.ell_residual(*_t(cols, vals, y, w)), want)


@pytest.mark.parametrize("case", ["one_column", "d1", "k8", "empty_rows"])
def test_s1_edge_shapes(case):
    """The edge shapes ``chip_smoke.py`` times: every update in one column,
    d = 1, K = 8, and a shard of no rows; S1 against the JAX sorted
    scatter (bit-equal) and residual (within its tolerance)."""
    rs = np.random.default_rng(6)
    m, K, d = {"one_column": (64, 16, 40), "d1": (33, 8, 1),
               "k8": (50, 8, 300), "empty_rows": (0, 8, 10)}[case]
    cols = rs.integers(0, d, size=(m, K)).astype(np.int32)
    if case == "one_column":
        cols[:] = 7
    vals = rs.normal(size=(m, K)).astype(np.float32)
    y = rs.normal(size=m).astype(np.float32)
    w = rs.normal(size=d).astype(np.float32)
    coeff = rs.normal(size=m).astype(np.float32)
    want_r = np.asarray(jgrad.sparse_residual(cols, vals, y, w))
    want_g = np.asarray(jgrad.make_sparse_grad_sum(d)(cols, vals, coeff))
    _close(tgrad.sparse_residual(*_t(cols, vals, y, w)), want_r)
    _equal(tgrad.make_sparse_grad_sum(d)(*_t(cols, vals, coeff)), want_g)


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("with_alpha", [False, True])
def test_compacted_grad_and_grad_sum_match_the_jax_step(rate, with_alpha):
    """The fused entry points' plain versions against the JAX step's
    arithmetic (``steps.py:526-535``): the residual within its tolerance,
    and ``g`` bit-equal to the JAX package's sorted scatter fed the same
    coefficients (``r``, or ``r - alpha[idx]``); the coefficient form
    bit-equal to ``make_sparse_grad_sum`` over the gathered rows."""
    d = 64
    js, ts = _small(128, d, 0.1, 3)
    valid, idx = _sample(128, 48, rate, 1)
    rs = np.random.default_rng(2)
    w = rs.normal(size=d).astype(np.float32)
    alpha = rs.normal(size=128).astype(np.float32) if with_alpha else None
    coeff_of = (lambda r: r - alpha[idx]) if with_alpha else (lambda r: r)
    _, jr = _jax_compacted(js, w, valid, idx, d, coeff_of)
    vt, it, wt = _t(valid, idx, w)
    at = None if alpha is None else torch.from_numpy(alpha)
    before = sg.compacted_grad_plain.calls
    g, r = sg.compacted_grad(ts.cols, ts.vals, ts.y, wt, it, vt, d, at)
    assert sg.compacted_grad_plain.calls == before + 1
    _close(r, jr)
    _equal(r, sg.ell_residual_plain(ts.cols, ts.vals, ts.y, wt, it, vt))
    c_sel = np.asarray(js.cols)[idx]
    v_sel = np.asarray(js.vals)[idx] * valid[:, None]
    coeff = coeff_of(r.numpy())
    _equal(g, jgrad.make_sparse_grad_sum(d)(c_sel, v_sel, coeff))
    _equal(sg.grad_sum(ts.cols, ts.vals, _t(coeff)[0], d, it, vt),
           jgrad.make_sparse_grad_sum(d)(c_sel, v_sel, coeff))
    if rate == 0.0 and not with_alpha:
        assert not r.any() and not g.any()


def _chunked_reference(cols, vals, coeff, d, chunk):
    """Each column's products in flat order, added a chunk of ``chunk`` at
    a time from 0 (float32), then the chunk sums in chunk order; and the
    same columns as one serial chain."""
    prods = (vals * coeff[:, None]).astype(np.float32).ravel()
    keys = cols.ravel()
    chunked = np.zeros(d, np.float32)
    serial = np.zeros(d, np.float32)
    for c in range(d):
        mine = prods[(keys == c) & (vals.ravel() != 0)]
        total = np.float32(0.0)
        for lo in range(0, len(mine), chunk):
            part = np.float32(0.0)
            for x in mine[lo:lo + chunk]:
                part = np.float32(part + x)
            total = np.float32(total + part)
        chunked[c] = total
        one = np.float32(0.0)
        for x in mine:
            one = np.float32(one + x)
        serial[c] = one
    return chunked, serial


@pytest.mark.parametrize("chunk", [5, 64])
def test_grad_sum_adds_long_columns_in_chunks(chunk):
    """A column longer than L (passed through the plan) is added in chunks
    of L, each from 0 in flat order, then the chunk sums in chunk order;
    it differs from one serial chain only within 1e-5 * max|g|, and a
    column of at most L entries is one chain exactly."""
    rs = np.random.default_rng(8)
    m, K, d = 300, 8, 6
    cols = rs.integers(1, d, size=(m, K)).astype(np.int32)
    cols[:, :3] = 0  # column 0: 900 entries; the others about 300
    vals = (rs.normal(size=(m, K)) * 2.0 ** rs.integers(-10, 10, (m, K)))
    vals = vals.astype(np.float32)
    vals[::7, 5] = 0.0  # dead entries
    coeff = rs.normal(size=m).astype(np.float32)
    chunked, serial = _chunked_reference(cols, vals, coeff, d, chunk)
    with sg.pinned_plan(chunk=chunk):
        assert sg.launch_plan(m, K, d).chunk == chunk
        g = sg.grad_sum(*_t(cols, vals, coeff), d)
    _equal(g, chunked)
    scale = float(np.abs(serial).max())
    assert float(np.abs(g.numpy() - serial).max()) <= 1e-5 * scale
    _equal(sg.grad_sum(*_t(cols, vals, coeff), d), serial)  # L = 4,096
    assert not np.array_equal(chunked, serial)  # the order shows here


@pytest.mark.parametrize("d,passes", [(0, 1), (1, 1), (255, 1), (256, 2),
                                      (47_236, 2), (65_535, 2), (65_536, 3),
                                      (2 ** 20, 3)])
def test_launch_plan_takes_the_digits_the_keys_need(d, passes):
    """8-bit digits of the keys [0, d]: ceil(log2(d + 1) / 8), at least 1."""
    plan = sg.launch_plan(4_752, 80, d)
    assert plan.passes == passes
    assert plan.passes * 8 >= max(d.bit_length(), 1)
    assert plan.chunk == sg.CHUNK == 4_096


@pytest.mark.parametrize("m,K,wide", [(4_752, 80, False),
                                      (26_843_545, 80, False),
                                      (26_843_546, 80, True),
                                      (2 ** 31, 1, True)])
def test_launch_plan_widens_positions_past_2_31(m, K, wide):
    """64-bit entry positions only where m * K >= 2^31."""
    plan = sg.launch_plan(m, K, 47_236)
    assert plan.wide is wide
    assert plan.max_items >= min(47_236, m * K // (sg.SHORT_MAX + 1))


def test_launch_plan_vectors_pins_and_limits():
    assert sg.launch_plan(10, 80, 100).vec
    assert not sg.launch_plan(10, 78, 100).vec
    assert not sg.launch_plan(10, 80, 100, aligned=False).vec
    assert sg.launch_plan(10, 80, 100).route == "auto"
    with sg.pinned_plan(chunk=7, wide=True, route="global"):
        plan = sg.launch_plan(10, 80, 100)
        assert (plan.chunk, plan.wide, plan.route) == (7, True, "global")
    with pytest.raises(ValueError, match="route"):
        with sg.pinned_plan(route="local"):
            sg.launch_plan(10, 80, 100)
    assert sg.launch_plan(10, 80, 100) == sg.launch_plan(10, 80, 100)
    assert sg.launch_plan(10, 80, 100).chunk == sg.CHUNK
    with pytest.raises(ValueError, match="unknown"):
        with sg.pinned_plan(passes=1):
            pass
    with pytest.raises(ValueError, match="columns"):
        sg.launch_plan(10, 80, sg.COL_TILE * sg.MAX_COL_TILES + 1)


def test_s1_rejects_bad_inputs():
    cols, vals, y, w = _t(np.zeros((4, 8), np.int32), np.ones((4, 8), np.float32),
                          np.zeros(4, np.float32), np.zeros(3, np.float32))
    with pytest.raises(TypeError):
        sg.ell_residual(cols.long(), vals, y, w)
    with pytest.raises(ValueError):
        sg.ell_residual(cols, vals, y[:3], w)
    with pytest.raises(ValueError):
        sg.ell_residual(cols, vals.T.contiguous().T, y, w)
    keys, perm = sg.sort_keys(torch.zeros(32, dtype=torch.int32))
    with pytest.raises(ValueError):
        sg.segment_sum(keys[:5], perm, vals, y, 3)
    with pytest.raises(TypeError):
        sg.segment_sum(keys, perm.int(), vals, y, 3)
    with pytest.raises(ValueError, match="d must be"):
        sg.segment_sum(keys, perm, vals, y, -1)
    with pytest.raises(ValueError, match="d must be"):
        sg.grad_sum(cols, vals, y, -1)
    with pytest.raises(TypeError):
        sg.compacted_grad(cols.long(), vals, y, w)
    with pytest.raises(ValueError):
        sg.compacted_grad(cols, vals, y, w, alpha=y[:3])
    with pytest.raises(ValueError, match="d = 5"):
        sg.compacted_grad(cols, vals, y, w, d=5)


# ------------------------------------------------------------------ steps
def _jax_draw(key, rate, n):
    """The sample the JAX sparse step draws from ``key`` (``steps.py:526-
    530``), as numpy ``(valid, idx)``."""
    _key, sub = jax.random.split(key)
    mask = np.asarray(jax.random.bernoulli(sub, rate, (n,)))
    cap = jsteps.sparse_step_capacity(rate, n)
    picked = np.flatnonzero(mask)[:cap]
    idx = np.zeros(cap, np.int64)
    idx[:len(picked)] = picked
    return (np.arange(cap) < mask.sum()).astype(np.float32), idx


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_asgd_step_matches_with_the_jax_sample(rate):
    d = 512
    js, ts = _small(1024, d, 0.01, 7)
    w = np.random.default_rng(3).normal(size=d).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want, _ = jsteps.make_sparse_asgd_worker_step(rate, d)(
        js.cols, js.vals, js.y, w, key)
    valid, idx = _jax_draw(key, rate, 1024)
    step = tsteps.make_sparse_asgd_worker_step(rate, d)
    got = step.grad(ts.cols, ts.vals, ts.y, torch.from_numpy(w), *_t(valid, idx))
    _close(got, want)
    # its own draw has the same layout
    v2, i2 = step.sample(worker_generator(1, 0, CPU), 1024)
    assert v2.shape == i2.shape == (jsteps.sparse_step_capacity(rate, 1024),)
    count = int(v2.sum())
    assert bool((v2[:count] == 1).all()) and not v2[count:].any()
    assert bool((i2[1:count] > i2[:count - 1]).all()) and not i2[count:].any()
    assert step(ts.cols, ts.vals, ts.y, torch.from_numpy(w),
                worker_generator(1, 0, CPU)).shape == (d,)


def test_saga_step_commit_and_table_delta_match():
    """The JAX SAGA step returns its sample: injected into the port's, the
    gradient and candidates agree within tolerance and the gathered rows
    exactly; the commit and the table delta against the current slice are
    exact on shared inputs; ``alpha`` is never written."""
    d, rate = 512, 0.3
    js, ts = _small(1024, d, 0.01, 9)
    rs = np.random.default_rng(4)
    w = rs.normal(size=d).astype(np.float32)
    alpha = rs.normal(size=1024).astype(np.float32)
    g, diff, idx, valid, c_sel, v_sel, _ = jsteps.make_sparse_saga_worker_step(
        rate, d)(js.cols, js.vals, js.y, w, alpha, jax.random.PRNGKey(3))
    idx_np, valid_np = np.asarray(idx).astype(np.int64), np.asarray(valid)
    assert 0 < valid_np.sum() < len(valid_np)  # some unfilled slots
    step = tsteps.make_sparse_saga_worker_step(rate, d)
    at = torch.from_numpy(alpha)
    out = step.grad(ts.cols, ts.vals, ts.y, torch.from_numpy(w), at,
                    *_t(valid_np, idx_np))
    tg, tdiff, tidx, tvalid, tc, tv = out
    _close(tg, g)
    _close(tdiff, diff)
    _equal(tidx, idx_np)
    _equal(tvalid, valid_np)
    _equal(tc, c_sel)
    _equal(tv, v_sel)
    # commit and delta on the JAX step's own candidates: exact
    diff_t = _t(diff)[0]
    alpha_cur = alpha + 1.0  # the slice moved since dispatch
    ac = torch.from_numpy(alpha_cur)
    want_a = jsteps.make_sparse_saga_commit()(jnp.asarray(alpha_cur), diff,
                                              idx, valid)
    got_a = tsteps.make_sparse_saga_commit()(ac, diff_t, tidx, tvalid)
    _equal(got_a, want_a)
    _equal(ac, alpha_cur)
    want_d = jsteps.make_sparse_table_delta(d)(c_sel, v_sel, diff,
                                               jnp.asarray(alpha_cur), idx)
    got_d = tsteps.make_sparse_table_delta(d)(tc, tv, diff_t, ac, tidx)
    _equal(got_d, want_d)


def test_trajectory_loss_eval_matches():
    js, ts = _small(1024, 512, 0.01, 7)
    W = np.random.default_rng(5).normal(size=(5, 512)).astype(np.float32)
    want = jsteps.make_sparse_trajectory_loss_eval()(js.cols, js.vals, js.y, W)
    got = tsteps.make_sparse_trajectory_loss_eval()(ts.cols, ts.vals, ts.y,
                                                    torch.from_numpy(W))
    assert got.shape == (5,)
    _close(got, want)


# ----------------------------------------------------------------- solvers
def _cfg(**kw):
    base = dict(num_workers=8, num_iterations=200, gamma=0.3, taw=2**31 - 1,
                batch_rate=0.2, bucket_ratio=0.5, printer_freq=50, seed=42,
                calibration_iters=10, run_timeout_s=120.0)
    base.update(kw)
    return base


@pytest.mark.parametrize("solver", ["asgd", "asaga"])
def test_run_sync_matches_jax_trajectory(solver):
    """``taw=0``, ``batch_rate=1.0``: every sample is every row in both
    packages, so the run is deterministic; 4 workers, 40 rounds."""
    csr = make_sparse_regression(1024, 512, 0.01, 7)
    jds, tds = _pair(csr, 512, 4)
    kw = _cfg(num_workers=4, num_iterations=40, batch_rate=1.0, taw=0,
              printer_freq=10, gamma=0.5 if solver == "asgd" else 0.05)
    J, T = (JaxASGD, ASGD) if solver == "asgd" else (JaxASAGA, ASAGA)
    ref = J(jds, None, JaxConfig(**kw), devices=jax.devices()[:4]).run_sync()
    got = T(tds, None, SolverConfig(**kw), devices=[CPU]).run_sync()
    scale = float(np.abs(ref.final_w).max())
    np.testing.assert_allclose(got.final_w, ref.final_w, rtol=1e-5,
                               atol=1e-5 * scale)
    assert len(got.trajectory) == len(ref.trajectory) == 6
    np.testing.assert_allclose([o for _, o in got.trajectory],
                               [o for _, o in ref.trajectory], rtol=1e-5)
    assert got.rounds == ref.rounds == 40
    assert got.accepted == ref.accepted == 160
    assert got.total_flops == ref.total_flops
    assert got.trajectory[-1][1] < got.trajectory[0][1]


def test_run_sync_on_the_jax_shards():
    """The same run from the JAX package's own shards carried across as
    numpy (``convert.sparse_dataset_from_reference``), against the run
    from the host CSR."""
    csr = _skewed_csr(n=256, d=64, base_nnz=4, dense_every=20, dense_nnz=40)
    jds, tds = _pair(csr, 64, 4, nnz_partition=True)
    ds = sparse_dataset_from_reference(
        [_shard_arrays(s) for s in jds.shards.values()], jds.d, [CPU],
        jds.row_perm)
    _equal(ds.row_perm, tds.row_perm)
    assert ds.partition_cum == tds.partition_cum
    kw = _cfg(num_workers=4, num_iterations=10, batch_rate=1.0,
              printer_freq=5, gamma=0.1)
    got = ASGD(ds, None, SolverConfig(**kw), devices=[CPU]).run_sync()
    want = ASGD(tds, None, SolverConfig(**kw), devices=[CPU]).run_sync()
    np.testing.assert_allclose(got.final_w, want.final_w, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want.final_w).max()))


def test_asgd_run_converges_at_47k_dims():
    """``tests/test_sparse.py:130-141``: 47,236 dims at 0.2% density."""
    csr = make_sparse_regression(2048, 47_236, density=0.002, seed=11)
    ds = SparseShardedDataset(*csr, 47_236, 8, [CPU])
    res = ASGD(ds, None, SolverConfig(**_cfg(gamma=0.5)), devices=[CPU]).run()
    assert res.accepted == 200
    first, last = res.trajectory[0][1], res.trajectory[-1][1]
    assert last < first * 0.7, res.trajectory


def test_asgd_run_sync_and_nnz_partitioned_run():
    """``tests/test_sparse.py:143-149`` and the nnz-partitioned solver run
    (``:303-325``)."""
    csr = make_sparse_regression(1024, 512, 0.01, 7)
    ds = SparseShardedDataset(*csr, 512, 8, [CPU])
    res = ASGD(ds, None, SolverConfig(**_cfg(num_iterations=50, gamma=0.5)),
               devices=[CPU]).run_sync()
    assert res.rounds == 50
    assert res.trajectory[-1][1] < res.trajectory[0][1]
    indptr, indices, values, _ = _skewed_csr(n=800, d=64, base_nnz=4,
                                             dense_every=100, dense_nnz=48)
    rs = np.random.default_rng(1)
    w_true = rs.normal(size=64).astype(np.float32)
    X0 = np.zeros((800, 64), np.float32)
    for i in range(800):
        X0[i, indices[indptr[i]:indptr[i + 1]]] = values[indptr[i]:indptr[i + 1]]
    y = (X0 @ w_true + 0.01 * rs.normal(size=800)).astype(np.float32)
    ds = SparseShardedDataset(indptr, indices, values, y, 64, 8, [CPU],
                              nnz_partition=True)
    res = ASGD(ds, None, SolverConfig(**_cfg(num_iterations=300, gamma=0.5,
                                             batch_rate=0.3)),
               devices=[CPU]).run()
    assert res.trajectory[-1][1] < res.trajectory[0][1] * 0.5


def _sparse_table_mean(ds, res):
    acc = np.zeros(ds.d, np.float64)
    for wid, a in res.extras["alpha"].items():
        s = ds.shard(wid)
        # np.add.at: a real col-0 entry collides with the padding
        np.add.at(acc, s.cols.numpy().ravel(),
                  (s.vals.numpy() * a[:, None]).ravel())
    return acc / ds.n


@pytest.mark.parametrize("mode", ["run", "run_sync"])
def test_asaga_keeps_alpha_bar_the_table_mean(mode):
    """``tests/test_sparse.py:151-157`` (the objective falls) and the
    sparse invariant of ``tests/test_fused.py:166`` (``alpha_bar`` is the
    history table's mean, at that test's ``rtol=5e-3, atol=5e-5``)."""
    csr = make_sparse_regression(1024, 512, 0.01, 9)
    ds = SparseShardedDataset(*csr, 512, 8, [CPU])
    solver = ASAGA(ds, None, SolverConfig(**_cfg(
        num_iterations=150 if mode == "run" else 30, gamma=0.05)),
        devices=[CPU])
    res = getattr(solver, mode)()
    assert res.trajectory[-1][1] < res.trajectory[0][1]
    assert any(np.any(a != 0) for a in res.extras["alpha"].values())
    np.testing.assert_allclose(res.extras["alpha_bar"],
                               _sparse_table_mean(ds, res), rtol=5e-3,
                               atol=5e-5)


def test_sparse_solvers_take_least_squares_only():
    csr = make_sparse_regression(64, 32, 0.2, 5)
    ds = SparseShardedDataset(*csr, 32, 2, [CPU])
    with pytest.raises(ValueError, match="least_squares"):
        ASGD(ds, None, SolverConfig(**_cfg(num_workers=2, loss="logistic")),
             devices=[CPU])
    with pytest.raises(ValueError, match="least_squares"):
        ASAGA(ds, None, SolverConfig(**_cfg(num_workers=2, loss="logistic")),
              devices=[CPU])


def test_saga_state_carries_a_sparse_table():
    """``convert.saga_state_from_reference`` places a JAX sparse run's
    history slices as the solvers do."""
    csr = make_sparse_regression(256, 64, 0.1, 3)
    jds, _ = _pair(csr, 64, 4)
    cfg = JaxConfig(**_cfg(num_workers=4, num_iterations=6, batch_rate=1.0,
                           printer_freq=3, gamma=0.05))
    ref = JaxASAGA(jds, None, cfg, devices=jax.devices()[:4]).run()
    w, alpha, ab, k = saga_state_from_reference(
        ref.final_w, ref.extras["alpha"], ref.extras["alpha_bar"], 6, [CPU])
    assert k == 6 and set(alpha) == {0, 1, 2, 3}
    for wid, a in alpha.items():
        assert a.shape == (jds.shard(wid).size,)
        _equal(a, ref.extras["alpha"][wid])
    _equal(ab, ref.extras["alpha_bar"])


# -------------------------------------------------------------- generation
def test_generate_on_device_shapes_conditioning_and_convergence():
    """``tests/test_sparse.py:185-222``."""
    n, d, nnz = 4096, 512, 12
    ds = SparseShardedDataset.generate_on_device(n, d, nnz, 8, devices=[CPU],
                                                 seed=9)
    assert ds.n == n and ds.d == d and ds.partition_cum[-1] == n
    s = ds.shard(0)
    K = s.cols.shape[1]
    assert K % 8 == 0 and K >= nnz and s.cols.dtype == torch.int32
    cols, vals = s.cols.numpy(), s.vals.numpy()
    assert (cols[:, nnz:] == 0).all() and (vals[:, nnz:] == 0).all()
    assert (cols[:, :nnz] < d).all() and (cols >= 0).all()
    row_sq = (vals ** 2).sum(axis=1)
    assert abs(row_sq.mean() - 1.0) < 0.15  # nnz * (1/nnz) = 1
    assert ds.padded_nnz() == n * K
    assert ds.nnz() == pytest.approx(n * nnz, rel=1e-3)
    cfg = SolverConfig(num_workers=8, num_iterations=400, gamma=0.05 * d,
                       batch_rate=0.3, bucket_ratio=0.5, printer_freq=50,
                       seed=42, calibration_iters=10, run_timeout_s=120.0)
    res = ASGD(ds, None, cfg, devices=[CPU]).run()
    first, last = res.trajectory[0][1], res.trajectory[-1][1]
    best = min(obj for _t, obj in res.trajectory)
    assert best < first * 0.1, res.trajectory
    assert last < first * 0.3, res.trajectory


def test_generate_on_device_is_deterministic_per_seed():
    a, b, c = (SparseShardedDataset.generate_on_device(256, 64, 4, 8,
                                                       devices=[CPU], seed=s)
               for s in (3, 3, 4))
    _equal(a.shard(1).cols, b.shard(1).cols.numpy())
    _equal(a.shard(1).vals, b.shard(1).vals.numpy())
    assert not torch.equal(a.shard(1).vals, c.shard(1).vals)


# ---------------------------------------------------------------- recovery
def test_move_shard_and_memory_plan_on_a_sparse_shard():
    ds = SparseShardedDataset.generate_on_device(64, 16, 4, 2, devices=[CPU])
    rec = ShardRecovery(ds, [CPU])
    moved = rec.move_shard(1, 0)
    s1 = ds.shard(1)
    assert type(moved) is type(s1) and rec.owner(1) == 0
    for a, b in ((moved.cols, s1.cols), (moved.vals, s1.vals), (moved.y, s1.y)):
        assert torch.equal(a, b)
    assert (moved.start, moved.size) == (s1.start, s1.size)
    assert [s.worker_id for s in rec.assignments(0)] == [0, 1]
    assert rec.shard(1) is moved
    per_dev = dataset_residency_bytes(ds)
    assert per_dev == {CPU: 64 * 8 * (4 + 4) + 64 * 4}
    cfg = SolverConfig(num_workers=2, hbm_budget_bytes=1_000)
    with pytest.raises(MemoryError):
        check_hbm_plan(ds, cfg, [CPU], history_table=True)
    check_hbm_plan(ds, SolverConfig(num_workers=2), [CPU])


# ------------------------------------------- the DCN ASAGA worker's form
@pytest.mark.parametrize("n_valid", [0, 17, 48])
def test_saga_slots_form_matches_the_jax_dcn_sparse_step(n_valid):
    """S1's per-slot form (``sparse_grad.saga_slots_grad``, ``alpha``
    indexed by slot) and ``steps.make_saga_dcn_sparse_worker_step``
    against the JAX package's ``make_saga_dcn_sparse_worker_step`` fed the
    same numpy ``idx``/``alpha_sel``/``n_valid`` (no valid slot, some, and
    every slot of the capacity): ``diff`` within the residual's tolerance
    on the valid slots and 0 on the rest, ``g`` bit-equal to the JAX
    package's sorted scatter fed the port's coefficients and within
    ``rtol=1e-5, atol=1e-5 * max|g|`` of the JAX step's."""
    d, cap = 64, 48
    js, ts = _small(128, d, 0.1, 3)
    rs = np.random.default_rng(4)
    idx = np.zeros(cap, np.int64)
    idx[:n_valid] = np.sort(rs.choice(128, size=n_valid, replace=False))
    alpha_sel = rs.normal(size=cap).astype(np.float32)
    alpha_sel[n_valid:] = 0.0  # the PS ships table[0] in padding slots
    w = rs.normal(size=d).astype(np.float32)
    jg, jdiff = jsteps.make_saga_dcn_sparse_worker_step(d)(
        js.cols, js.vals, js.y, w, idx.astype(np.int32), alpha_sel,
        np.int32(n_valid))
    before = sg.compacted_grad_plain.calls
    g, diff = tsteps.make_saga_dcn_sparse_worker_step(d)(
        ts.cols, ts.vals, ts.y, *_t(w, idx, alpha_sel), n_valid)
    assert sg.compacted_grad_plain.calls == before + 1
    assert not diff[n_valid:].any()
    _close(diff[:n_valid], np.asarray(jdiff)[:n_valid])
    _close(g, jg)
    valid = (np.arange(cap) < n_valid).astype(np.float32)
    c_sel = np.asarray(js.cols)[idx]
    v_sel = np.asarray(js.vals)[idx] * valid[:, None]
    _equal(g, jgrad.make_sparse_grad_sum(d)(c_sel, v_sel,
                                            diff.numpy() - alpha_sel))
    # the same task as compacted_grad with alpha placed at the rows
    full = np.zeros(128, np.float32)
    full[idx[:n_valid]] = alpha_sel[:n_valid]
    g2, diff2 = sg.compacted_grad(ts.cols, ts.vals, ts.y,
                                  *_t(w, idx, valid), d, _t(full)[0])
    _equal(g, g2.numpy())
    _equal(diff, diff2.numpy())
    if n_valid == 0:
        assert not g.any()


def test_saga_slots_form_takes_alpha_by_slot_and_checks_its_inputs():
    d = 32
    _js, ts = _small(64, d, 0.2, 5)
    w, idx, valid = _t(np.ones(d, np.float32), np.arange(8, dtype=np.int64),
                       np.ones(8, np.float32))
    with pytest.raises(ValueError, match="shape"):
        sg.saga_slots_grad(ts.cols, ts.vals, ts.y, w, idx, valid,
                           torch.zeros(64))  # a row-indexed alpha
    with pytest.raises(ValueError, match="idx and valid"):
        sg.saga_slots_grad(ts.cols, ts.vals, ts.y, w, None, valid,
                           torch.zeros(8))
    g, diff = sg.saga_slots_grad(ts.cols, ts.vals, ts.y, w, idx, valid,
                                 torch.arange(8, dtype=torch.float32))
    want_g, want_diff = sg.compacted_grad_plain(
        ts.cols, ts.vals, ts.y, w, idx, valid, d,
        torch.arange(8, dtype=torch.float32), alpha_slots=True)
    _equal(g, want_g.numpy())
    _equal(diff, want_diff.numpy())
