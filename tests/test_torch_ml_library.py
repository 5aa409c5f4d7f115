"""The port's ML library beyond the linear models against the JAX
package's: statistics, PCA and SVD, the distributed matrices, k-means and
its variants, ALS, Word2Vec and LDA.

Twins of ``tests/test_ml_extra.py`` (ALS, statistics),
``tests/test_linalg_distributed.py``, ``tests/test_ml_round2.py``
(bisecting and streaming k-means, kernel density) and
``tests/test_ml_breadth.py`` (PCA, ``svd``, chi-square and KS tests, power
iteration clustering, Word2Vec, LDA) on the port with ``devices=[cpu] *
8`` or ``device=cpu``, then the two packages on the same numpy inputs:

- the statistics, PCA, the SVD and the distributed matrices agree to the
  tolerances stated at each test (f32 sums in two libraries' orders);
- k-means seeds the same centres from the same numpy draws, so the whole
  fit agrees (centres and cost to rtol 1e-5, the same iterations);
- ALS's half steps agree on the same factors, and so does a whole fit
  started from the JAX package's threefry factors; Word2Vec's step agrees
  with ``jax.value_and_grad`` of its loss on the same state; LDA's E-step
  agrees on the same state and, its start being numpy's in both, so does
  a whole fit.  The fits drawn from each package's own generator are held
  to the JAX tests' quality gates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asyncframework_tpu import ml as jml
from asyncframework_tpu.ml import clustering as jclustering
from asyncframework_tpu.ml import lda as jlda
from asyncframework_tpu.ml import persistence as jpersistence
from asyncframework_tpu.ml import recommendation as jrec
from asyncframework_tpu.parallel import make_mesh as jmake_mesh
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from asyncframework_tpu_torch import convert
from asyncframework_tpu_torch.ml import (
    ALS,
    LDA,
    PCA,
    BisectingKMeans,
    BlockMatrix,
    CoordinateMatrix,
    IndexedRowMatrix,
    KernelDensity,
    KMeans,
    PowerIterationClustering,
    RowMatrix,
    StreamingKMeans,
    Word2Vec,
    chi_sq_test,
    chi_sq_test_matrix,
    col_stats,
    corr,
    ks_test,
    svd,
)
from asyncframework_tpu_torch.ml import lda as tlda
from asyncframework_tpu_torch.ml import recommendation as trec
from asyncframework_tpu_torch.ml.word2vec import _sgns_step
from asyncframework_tpu_torch.parallel import make_mesh

CPU = torch.device("cpu")
CPU8 = [CPU] * 8


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def jmesh8(devices8):
    return jmake_mesh(8, devices=devices8)


@pytest.fixture(scope="module")
def A():
    return np.random.default_rng(3).normal(size=(256, 12)).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------------- stat
class TestStats:
    def test_col_stats_matches_numpy_and_the_jax_package(self, rng):
        X = rng.normal(size=(128, 4)).astype(np.float32)
        X[X < -1.2] = 0.0
        s = col_stats(X, device=CPU)
        assert s.count == 128
        np.testing.assert_allclose(s.mean, X.mean(axis=0), atol=1e-5)
        np.testing.assert_allclose(s.variance, X.var(axis=0, ddof=1),
                                   rtol=1e-4)
        np.testing.assert_array_equal(s.num_nonzeros, (X != 0).sum(axis=0))
        np.testing.assert_allclose(s.max, X.max(axis=0))
        np.testing.assert_allclose(s.min, X.min(axis=0))
        j = jml.col_stats(X)
        np.testing.assert_allclose(s.mean, j.mean, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(s.variance, j.variance, rtol=1e-5)

    def test_col_stats_sharded_equals_local(self, rng, mesh8, jmesh8):
        X = rng.normal(size=(160, 6)).astype(np.float32)
        local = col_stats(X, device=CPU)
        dist = col_stats(X, mesh=mesh8)
        assert dist.count == local.count
        np.testing.assert_allclose(dist.mean, local.mean, atol=1e-5)
        np.testing.assert_allclose(dist.variance, local.variance, rtol=1e-4)
        np.testing.assert_array_equal(dist.num_nonzeros, local.num_nonzeros)
        np.testing.assert_array_equal(dist.max, local.max)
        np.testing.assert_array_equal(dist.min, local.min)
        j = jml.col_stats(X, mesh=jmesh8)
        np.testing.assert_allclose(dist.variance, j.variance, rtol=1e-5)

    def test_pearson_matches_numpy_and_the_jax_package(self, rng):
        X = rng.normal(size=(300, 4)).astype(np.float32)
        X[:, 2] = 2.0 * X[:, 0] + 0.01 * rng.normal(size=300)
        C = corr(X, "pearson", device=CPU)
        np.testing.assert_allclose(C, np.corrcoef(X.T), atol=1e-4)
        np.testing.assert_allclose(C, jml.corr(X, "pearson"), atol=1e-6)
        assert C[0, 2] > 0.99

    def test_spearman_rank_invariance_and_ties(self, rng):
        x = rng.normal(size=200).astype(np.float32)
        C = corr(np.column_stack([x, np.exp(x)]), "spearman", device=CPU)
        assert C[0, 1] == pytest.approx(1.0, abs=1e-5)
        X = np.column_stack([
            np.array([1, 1, 2, 2, 3, 3], np.float32),
            np.array([2, 2, 4, 4, 6, 6], np.float32),
        ])
        C = corr(X, "spearman", device=CPU)
        assert C[0, 1] == pytest.approx(1.0, abs=1e-6)
        np.testing.assert_allclose(C, jml.corr(X, "spearman"), atol=1e-6)

    def test_unknown_method(self):
        with pytest.raises(ValueError):
            corr(np.zeros((4, 2)), "kendall", device=CPU)

    def test_chi_sq_tests_match_scipy_and_the_jax_package(self):
        from scipy.stats import chi2_contingency, chisquare

        obs = [16, 18, 16, 14, 12, 12]
        got, ref = chi_sq_test(obs, device=CPU), chisquare(obs)
        np.testing.assert_allclose(got.statistic, ref.statistic, rtol=1e-5)
        np.testing.assert_allclose(got.p_value, ref.pvalue, rtol=1e-4)
        assert got.degrees_of_freedom == 5
        j = jml.chi_sq_test(obs)
        np.testing.assert_allclose(got.statistic, j.statistic, rtol=1e-6)
        np.testing.assert_allclose(got.p_value, j.p_value, rtol=1e-4)
        table = [[10, 20, 30], [6, 9, 17]]
        got = chi_sq_test_matrix(table, device=CPU)
        ref = chi2_contingency(table, correction=False)
        np.testing.assert_allclose(got.statistic, ref.statistic, rtol=1e-5)
        np.testing.assert_allclose(got.p_value, ref.pvalue, rtol=1e-4)
        assert got.degrees_of_freedom == 2

    def test_chi_sq_rejects_zero_expected_and_keeps_tiny_p(self):
        with pytest.raises(ValueError, match="expected"):
            chi_sq_test([5, 3], expected=[1, 0], device=CPU)
        with pytest.raises(ValueError, match="positive total"):
            chi_sq_test_matrix([[0, 0], [3, 4]], device=CPU)
        res = chi_sq_test([1000, 10], device=CPU)
        assert res.statistic > 900
        assert 0.0 <= res.p_value < 1e-30

    def test_ks_test_matches_scipy_and_the_jax_package(self):
        from scipy.stats import kstest

        rs = np.random.default_rng(2)
        for sample in (rs.normal(0.2, 1.0, 400), rs.normal(0, 1, 400)):
            got, ref = ks_test(sample, "norm"), kstest(sample, "norm")
            np.testing.assert_allclose(got.statistic, ref.statistic,
                                       rtol=1e-6)
            np.testing.assert_allclose(got.p_value, ref.pvalue, rtol=0.05)
            j = jml.ks_test(sample, "norm")
            assert (got.statistic, got.p_value) == (j.statistic, j.p_value)

    def test_kernel_density_matches_the_oracle_and_the_jax_package(self):
        rs = np.random.default_rng(5)
        sample = rs.normal(size=400)
        pts = np.linspace(-3, 3, 7)
        est = KernelDensity(0.5, device=CPU).set_sample(sample).estimate(pts)
        z = (pts[None, :] - sample[:, None]) / 0.5
        want = (np.exp(-0.5 * z * z) / (0.5 * np.sqrt(2 * np.pi))).mean(0)
        np.testing.assert_allclose(est, want, rtol=1e-4, atol=1e-6)
        j = jml.KernelDensity(0.5).set_sample(sample).estimate(pts)
        np.testing.assert_allclose(est, j, rtol=1e-5, atol=1e-7)

    def test_kernel_density_validation(self):
        with pytest.raises(ValueError):
            KernelDensity(bandwidth=0.0, device=CPU)
        with pytest.raises(ValueError):
            KernelDensity(device=CPU).estimate([0.0])


# ---------------------------------------------------------- decomposition
class TestPCAandSVD:
    @pytest.fixture(scope="class")
    def clf(self):
        rs = np.random.default_rng(7)
        scales = np.linspace(3.0, 0.2, 12)
        return (rs.normal(size=(1496, 12)) * scales).astype(np.float32)

    def test_pca_matches_the_jax_package(self, clf):
        ours, ref = PCA(4).fit(clf, device=CPU), jml.PCA(4).fit(clf)
        for i in range(4):
            assert abs(np.dot(ours.components[i], ref.components[i])) > 0.9999
        np.testing.assert_allclose(ours.explained_variance,
                                   ref.explained_variance, rtol=1e-4)
        np.testing.assert_allclose(ours.mean, ref.mean, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(ours.transform(clf[:5]),
                                   np.asarray(ref.transform(clf[:5])),
                                   rtol=1e-3, atol=1e-3)

    def test_pca_distributed_matches_local(self, clf, mesh8):
        local = PCA(3).fit(clf, device=CPU)
        dist = PCA(3).fit(clf, mesh=mesh8)
        np.testing.assert_allclose(np.abs(dist.components),
                                   np.abs(local.components),
                                   rtol=1e-3, atol=1e-4)

    def test_svd_reconstructs_and_matches_numpy(self):
        rs = np.random.default_rng(3)
        X = rs.normal(size=(1200, 8)).astype(np.float32)
        U, s, V = svd(X, k=8, device=CPU)
        np.testing.assert_allclose(U.numpy() * s @ V.T, X, atol=5e-3)
        np.testing.assert_allclose(
            s, np.linalg.svd(X, compute_uv=False)[:8], rtol=1e-3)
        _ju, js, _jv = jml.svd(X, k=8)
        np.testing.assert_allclose(s, js, rtol=1e-5)

    def test_svd_truncation_drops_null_directions(self):
        rs = np.random.default_rng(5)
        base = rs.normal(size=(300, 2)).astype(np.float32)
        X = np.hstack([base,
                       base @ rs.normal(size=(2, 3)).astype(np.float32)])
        U, s, V = svd(X, k=5, compute_u=False, device=CPU)
        assert U is None and len(s) == 2 and V.shape == (5, 2)

    def test_pca_model_carries_across_both_ways(self, clf):
        jm = jml.PCA(3).fit(clf)
        tm = convert.fitted_model_from_reference(jm, CPU)
        np.testing.assert_allclose(tm.transform(clf[:9]),
                                   np.asarray(jm.transform(clf[:9])),
                                   rtol=1e-5, atol=1e-5)
        back = jpersistence._model_restore(convert.fitted_model_to_reference(
            PCA(3).fit(clf, device=CPU)))
        assert type(back) is jml.PCAModel
        assert back.components.shape == (3, 12)


# ------------------------------------------------------ distributed matrices
class TestRowMatrix:
    def test_gramian_matches_numpy_and_the_mesh(self, A, mesh8):
        g1 = RowMatrix(A, device=CPU).compute_gramian().numpy()
        np.testing.assert_allclose(g1, A.T @ A, rtol=2e-4, atol=1e-3)
        g8 = RowMatrix(A, mesh8).compute_gramian().numpy()
        np.testing.assert_allclose(g8, g1, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(
            g1, np.asarray(jml.RowMatrix(A).compute_gramian()), rtol=1e-5,
            atol=1e-4)

    def test_covariance_and_column_summary(self, A, mesh8):
        rm = RowMatrix(A, mesh8)
        np.testing.assert_allclose(rm.compute_covariance().numpy(),
                                   np.cov(A, rowvar=False), rtol=2e-3,
                                   atol=2e-3)
        st = rm.compute_column_summary_statistics()
        np.testing.assert_allclose(st.mean, A.mean(0), rtol=1e-4, atol=1e-4)

    def test_svd_reconstructs(self, A):
        U, s, V = RowMatrix(A, device=CPU).compute_svd(12)
        np.testing.assert_allclose(U.numpy() @ np.diag(s) @ V.T, A,
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(
            s, np.linalg.svd(A, compute_uv=False)[: len(s)], rtol=1e-2)

    def test_multiply(self, A, mesh8):
        B = np.random.default_rng(4).normal(size=(12, 5)).astype(np.float32)
        out = RowMatrix(A, mesh8).multiply(B)
        np.testing.assert_allclose(out.X.numpy(), A @ B, rtol=2e-4,
                                   atol=1e-3)
        assert out.mesh is mesh8

    def test_column_similarities(self, A):
        sims = RowMatrix(A, device=CPU).column_similarities().numpy()
        An = A / np.linalg.norm(A, axis=0, keepdims=True)
        np.testing.assert_allclose(sims, np.triu(An.T @ An, k=1), rtol=2e-3,
                                   atol=2e-3)
        assert np.all(np.tril(sims) == 0)

    @pytest.mark.parametrize("use_mesh", [False, True])
    def test_tall_skinny_qr(self, A, mesh8, use_mesh):
        rm = (RowMatrix(A, mesh8) if use_mesh
              else RowMatrix(A, device=CPU))
        Q, R = rm.tall_skinny_qr()
        Qh, Rh = Q.X.numpy(), R.numpy()
        np.testing.assert_allclose(Qh @ Rh, A, rtol=2e-3, atol=2e-3)
        assert np.allclose(Rh, np.triu(Rh))
        np.testing.assert_allclose(Qh.T @ Qh, np.eye(A.shape[1]), rtol=1e-3,
                                   atol=1e-3)
        assert np.all(np.diag(Rh) >= 0)

    def test_tsqr_mesh_matches_single_and_the_jax_package(self, A, mesh8,
                                                          jmesh8):
        _, R1 = RowMatrix(A, device=CPU).tall_skinny_qr()
        _, R8 = RowMatrix(A, mesh8).tall_skinny_qr()
        np.testing.assert_allclose(R8.numpy(), R1.numpy(), rtol=2e-3,
                                   atol=2e-3)
        _, jR8 = jml.RowMatrix(A, jmesh8).tall_skinny_qr()
        np.testing.assert_allclose(R8.numpy(), np.asarray(jR8), rtol=1e-4,
                                   atol=1e-4)


class TestIndexedAndCoordinateMatrices:
    def test_indexed_roundtrip_and_multiply(self, A):
        idx = np.arange(A.shape[0])[::-1].copy()
        m = IndexedRowMatrix(idx, A, device=CPU)
        assert m.num_rows() == A.shape[0]
        out = m.multiply(np.eye(12, dtype=np.float32) * 2.0)
        np.testing.assert_allclose(out.X.numpy(), A * 2.0, rtol=1e-5)
        np.testing.assert_array_equal(out.indices, idx)

    def test_indexed_to_coordinate(self):
        X = np.array([[1.0, 0.0], [0.0, 3.0]], np.float32)
        cm = IndexedRowMatrix(np.array([5, 2]), X,
                              device=CPU).to_coordinate_matrix()
        dense = cm.to_local().numpy()
        assert dense.shape == (6, 2)
        assert dense[5, 0] == 1.0 and dense[2, 1] == 3.0

    def test_coordinate_sums_duplicates_and_transposes(self):
        cm = CoordinateMatrix([0, 0, 1], [1, 1, 0], [2.0, 3.0, 4.0],
                              shape=(2, 2), device=CPU)
        dense = cm.to_local().numpy()
        assert dense[0, 1] == 5.0 and dense[1, 0] == 4.0
        t = CoordinateMatrix([0, 1], [1, 0], [2.0, 4.0], shape=(2, 3),
                             device=CPU).transpose()
        assert t.shape == (3, 2) and t.to_local().numpy()[1, 0] == 2.0

    def test_coordinate_to_block_matrix(self):
        rs = np.random.default_rng(5)
        dense = (rs.random((7, 9)) < 0.3) * rs.normal(size=(7, 9))
        r, c = np.nonzero(dense)
        cm = CoordinateMatrix(r, c, dense[r, c], shape=(7, 9), device=CPU)
        np.testing.assert_allclose(cm.to_block_matrix(block_size=4).to_local(),
                                   dense.astype(np.float32), rtol=1e-5,
                                   atol=1e-6)


class TestBlockMatrix:
    def test_multiply_matches_numpy_and_the_jax_package(self):
        rs = np.random.default_rng(6)
        A = rs.normal(size=(37, 23)).astype(np.float32)
        B = rs.normal(size=(23, 31)).astype(np.float32)
        C = BlockMatrix.from_dense(A, 8, devices=CPU8).multiply(
            BlockMatrix.from_dense(B, 8, devices=CPU8))
        assert C.shape == (37, 31)
        np.testing.assert_allclose(C.to_local(), A @ B, rtol=2e-4, atol=2e-3)
        jC = jml.BlockMatrix.from_dense(A, 8).multiply(
            jml.BlockMatrix.from_dense(B, 8))
        np.testing.assert_allclose(C.to_local(), jC.to_local(), rtol=1e-5,
                                   atol=1e-5)

    def test_add_and_transpose(self):
        A = np.random.default_rng(7).normal(size=(10, 6)).astype(np.float32)
        bm = BlockMatrix.from_dense(A, 4, devices=[CPU])
        np.testing.assert_allclose(bm.add(bm).to_local(), 2 * A, rtol=1e-6)
        np.testing.assert_allclose(bm.transpose().to_local(), A.T,
                                   rtol=1e-6)

    def test_shape_mismatch_raises(self):
        a = BlockMatrix.from_dense(np.zeros((4, 4), np.float32), 2, [CPU])
        b = BlockMatrix.from_dense(np.zeros((5, 4), np.float32), 2, [CPU])
        with pytest.raises(ValueError):
            a.multiply(b)
        with pytest.raises(ValueError):
            a.add(b)


# -------------------------------------------------------------- clustering
def _blobs(k, per, d, scale, seed):
    rs = np.random.default_rng(seed)
    centers = rs.normal(size=(k, d)).astype(np.float32) * scale
    X = np.concatenate([c + rs.normal(size=(per, d)).astype(np.float32)
                        for c in centers])
    return X, centers


class TestKMeans:
    def test_whole_fit_matches_the_jax_package(self, mesh8, jmesh8):
        """The same numpy seeding, so the same centres, cost and
        iterations (f32 sums in two orders)."""
        X, _ = _blobs(4, 200, 8, 10.0, 8)
        X = X[:797]  # padding rows on the 8-rank meshes
        for init in ("k-means++", "random"):
            kw = dict(k=4, max_iterations=30, seed=1, init=init)
            jm = jml.KMeans(**kw).fit(X, mesh=jmesh8)
            tm = KMeans(**kw).fit(X, mesh=mesh8)
            np.testing.assert_allclose(tm.centers, jm.centers, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(tm.cost, jm.cost, rtol=1e-5)
            assert tm.iterations == jm.iterations
        seeded = KMeans(k=4, max_iterations=0, seed=1).fit(X, mesh=mesh8)
        np.testing.assert_array_equal(
            seeded.centers, jml.KMeans(k=4, seed=1)._seed_centers(X))

    def test_recovers_separated_blobs(self, mesh8):
        X, true_centers = _blobs(4, 200, 8, 10.0, 8)
        model = KMeans(k=4, max_iterations=30, seed=1).fit(X, mesh=mesh8)
        d2 = ((true_centers[:, None, :] - model.centers[None]) ** 2).sum(-1)
        assert np.all(d2.min(axis=1) < 2.0 * 8)
        labels = model.predict(X)
        for i in range(4):
            blob = labels[i * 200:(i + 1) * 200]
            assert np.mean(blob == np.bincount(blob).argmax()) > 0.95
        np.testing.assert_array_equal(
            model.predict(torch.from_numpy(X)).numpy(), labels)
        assert model.cost > 0

    def test_cost_decreases_with_k(self, mesh8):
        X = np.random.default_rng(9).normal(size=(600, 5)).astype(np.float32)
        costs = [KMeans(k=k, max_iterations=15, seed=0).fit(X, mesh8).cost
                 for k in (2, 4, 8)]
        assert costs[0] > costs[1] > costs[2]

    def test_empty_cluster_keeps_its_centre(self):
        """A centre no row is nearest keeps its place (MLlib)."""
        X = np.array([[0.0], [0.1], [10.0]], np.float32)
        km = KMeans(k=2, max_iterations=1, seed=0)
        km._seed_centers = lambda _X: np.array([[5.0], [100.0]], np.float32)
        model = km.fit(X, make_mesh(1, devices=[CPU]))
        assert model.centers[1, 0] == 100.0

    def test_model_carries_across_both_ways(self, mesh8, jmesh8):
        X, _ = _blobs(3, 50, 4, 8.0, 2)
        jm = jml.KMeans(k=3, seed=0).fit(X, mesh=jmesh8)
        tm = convert.fitted_model_from_reference(jm, CPU)
        np.testing.assert_array_equal(tm.predict(X), jm.predict(X))
        back = jpersistence._model_restore(convert.fitted_model_to_reference(
            KMeans(k=3, seed=0).fit(X, mesh8)))
        assert type(back) is jclustering.KMeansModel
        np.testing.assert_array_equal(back.predict(X), tm.predict(X))


@pytest.fixture()
def blobs2d():
    rs = np.random.default_rng(0)
    centers = np.array([[-5, -5], [5, 5], [5, -5], [-5, 5]], np.float32)
    X = np.concatenate([c + 0.3 * rs.normal(size=(50, 2)).astype(np.float32)
                        for c in centers])
    return X, centers


class TestBisectingKMeans:
    def test_recovers_blobs(self, blobs2d, mesh8):
        X, centers = blobs2d
        model = BisectingKMeans(k=4, seed=1).fit(X, mesh8)
        assert model.k == 4
        d = np.linalg.norm(model.centers[:, None, :] - centers[None], axis=2)
        assert d.min(axis=0).max() < 1.0
        labels = model.predict(X)
        for b in range(4):
            assert len(np.unique(labels[50 * b: 50 * (b + 1)])) == 1

    def test_fewer_than_k_and_the_divisible_gate(self, blobs2d, mesh8):
        assert BisectingKMeans(k=4).fit(np.zeros((3, 2), np.float32),
                                        mesh8).k <= 4
        X, _ = blobs2d
        assert BisectingKMeans(k=4, min_divisible_cluster_size=1000).fit(
            X, mesh8).k == 1

    def test_continues_past_a_degenerate_leaf(self, mesh8):
        rs = np.random.default_rng(11)
        X = np.concatenate([
            np.zeros((40, 2), np.float32),
            np.float32([10, 10]) + 0.1 * rs.normal(size=(6, 2)).astype(
                np.float32),
            np.float32([-10, 10]) + 0.1 * rs.normal(size=(6, 2)).astype(
                np.float32),
        ])
        assert BisectingKMeans(k=4, seed=0).fit(X, mesh8).k == 4


class TestStreamingKMeans:
    def test_tracks_moving_centers(self):
        rs = np.random.default_rng(1)
        skm = StreamingKMeans(k=2, decay_factor=0.5, seed=3, device=CPU)
        skm.set_initial_centers(np.array([[-1.0], [1.0]], np.float32),
                                [1.0, 1.0])
        for _ in range(20):
            skm.update(np.concatenate([
                -4 + 0.1 * rs.normal(size=(20, 1)),
                4 + 0.1 * rs.normal(size=(20, 1)),
            ]).astype(np.float32))
        np.testing.assert_allclose(np.sort(skm.centers.ravel()), [-4.0, 4.0],
                                   atol=0.3)

    def test_decay_forgets_history(self):
        skm = StreamingKMeans(k=1, decay_factor=0.01, device=CPU)
        skm.set_initial_centers(np.array([[0.0]], np.float32), [1.0])
        skm.update(np.full((50, 1), 10.0, np.float32))
        skm.update(np.full((50, 1), -10.0, np.float32))
        assert abs(float(skm.centers[0, 0]) + 10.0) < 0.5

    def test_update_rule_exact_and_as_the_jax_package(self):
        skm = StreamingKMeans(k=1, decay_factor=0.5, device=CPU)
        skm.set_initial_centers(np.array([[2.0]], np.float32), [4.0])
        skm.update(np.array([[8.0], [10.0]], np.float32))
        # (2*4*0.5 + 18) / (4*0.5 + 2) = 22/4 = 5.5
        assert abs(float(skm.centers[0, 0]) - 5.5) < 1e-5
        assert abs(float(skm.weights[0]) - 4.0) < 1e-9
        rs = np.random.default_rng(4)
        ours = StreamingKMeans(k=3, decay_factor=0.7, time_unit="points",
                               device=CPU).set_random_centers(2)
        ref = jml.StreamingKMeans(k=3, decay_factor=0.7,
                                  time_unit="points").set_random_centers(2)
        for _ in range(5):
            batch = rs.normal(size=(30, 2)).astype(np.float32)
            ours.update(batch)
            ref.update(batch)
        np.testing.assert_allclose(ours.centers, ref.centers, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(ours.weights, ref.weights, rtol=1e-12)

    def test_predict_and_idle_centre(self):
        skm = StreamingKMeans(k=2, device=CPU).set_initial_centers(
            np.array([[0.0], [10.0]], np.float32))
        lab = skm.predict(np.array([[1.0], [9.0]], np.float32))
        assert lab[0] != lab[1]
        skm = StreamingKMeans(k=2, decay_factor=0.5, device=CPU)
        skm.set_initial_centers(np.array([[0.0], [100.0]], np.float32),
                                [1.0, 1.0])
        skm.update(np.full((10, 1), 1.0, np.float32))
        assert abs(float(skm.centers[1, 0]) - 100.0) < 1e-6

    def test_train_on_and_predict_on_a_stream(self):
        """``trainOn``/``predictOn`` parity through a stream's two hooks
        (the port has no DStream yet, ROADMAP A10: a stand-in calls
        them)."""
        class Stream:
            def foreach_batch(self, fn):
                self.each = fn

            def map_batch(self, fn):
                return fn

        stream = Stream()
        skm = StreamingKMeans(k=2, device=CPU).set_initial_centers(
            np.array([[0.0], [10.0]], np.float32), [1.0, 1.0])
        assert skm.train_on(stream) is skm
        stream.each(0, np.full((4, 1), 2.0, np.float32))
        assert float(skm.centers[0, 0]) == pytest.approx(1.6)
        labels = skm.predict_on(stream)(np.array([[1.0], [9.0]]))
        assert list(labels) == [0, 1]

    def test_dying_threshold_is_relative(self):
        skm = StreamingKMeans(k=2, decay_factor=1.0, device=CPU)
        skm.set_initial_centers(np.array([[0.0], [5.0]], np.float32),
                                [10.0, 1e10])
        skm.update(np.array([[0.0], [5.0]], np.float32))
        assert abs(float(skm.weights[0]) - float(skm.weights[1])) < 1e-3
        assert abs(float(skm.centers[0, 0]) - 5.0) < 0.1


class TestPowerIterationClustering:
    def test_two_blocks_recovered(self):
        rs = np.random.default_rng(0)
        n = 60
        W = np.zeros((n, n), np.float32)
        for lo, hi in [(0, 30), (30, 60)]:
            block = rs.random((30, 30)) * 0.9 + 0.1
            W[lo:hi, lo:hi] = (block + block.T) / 2
        W += rs.random((n, n)).astype(np.float32) * 0.02
        W = (W + W.T) / 2
        np.fill_diagonal(W, 0.0)
        labels = PowerIterationClustering(2, max_iterations=40,
                                          device=CPU).fit_predict(W)
        a, b = labels[:30], labels[30:]
        assert (a == np.bincount(a).argmax()).mean() > 0.9
        assert np.bincount(a).argmax() != np.bincount(b).argmax()

    def test_rejects_bad_affinity(self):
        with pytest.raises(ValueError, match="square"):
            PowerIterationClustering(2, device=CPU).fit_predict(
                np.ones((3, 4)))
        with pytest.raises(ValueError, match="nonnegative"):
            PowerIterationClustering(2, device=CPU).fit_predict(
                np.asarray([[0.0, -1.0], [-1.0, 0.0]]))


# --------------------------------------------------------------------- ALS
@pytest.fixture()
def planted(rng):
    n_u, n_i, k = 40, 30, 4
    U = rng.normal(size=(n_u, k)).astype(np.float32)
    V = rng.normal(size=(n_i, k)).astype(np.float32)
    mask = (rng.random((n_u, n_i)) < 0.6).astype(np.float32)
    return U @ V.T, mask


class TestALS:
    def test_half_steps_match_the_jax_package(self, planted):
        R, mask = planted
        rs = np.random.default_rng(1)
        F = rs.normal(size=(30, 4)).astype(np.float32)
        t = trec._half_step(torch.from_numpy(F), torch.from_numpy(R),
                            torch.from_numpy(mask), 0.1)
        j = jrec._half_step(jnp.asarray(F), jnp.asarray(R),
                            jnp.asarray(mask), 0.1)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5)
        Ri = np.where(mask > 0, np.abs(R), 0.0).astype(np.float32)
        Ri[0, 0] = -2.0  # a "dislike"
        t = trec._half_step_implicit(torch.from_numpy(F),
                                     torch.from_numpy(Ri), 5.0, 0.05)
        j = jrec._half_step_implicit(jnp.asarray(F), jnp.asarray(Ri), 5.0,
                                     0.05)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5)

    @pytest.mark.parametrize("implicit", [False, True])
    def test_whole_fit_from_the_jax_factors_matches(self, planted, implicit):
        """Started from the JAX package's threefry draws, the whole fit
        agrees."""
        R, mask = planted
        if implicit:
            R, mask = np.where(mask > 0, np.abs(R), 0.0), None
        kw = dict(rank=4, reg=0.05, num_iterations=5, seed=3,
                  implicit_prefs=implicit, alpha=2.0)
        ku, kv = jax.random.split(jax.random.PRNGKey(3))
        U0 = np.asarray(jax.random.normal(ku, (40, 4), jnp.float32)) * 0.5
        V0 = np.asarray(jax.random.normal(kv, (30, 4), jnp.float32)) * 0.5
        jm = jml.ALS(**kw).fit(R, mask)
        tm = ALS(**kw).fit(R, mask, device=CPU, init=(U0, V0))
        np.testing.assert_allclose(tm.predict_all(), jm.predict_all(),
                                   rtol=1e-3, atol=1e-3)

    def test_reconstructs_observed_and_held_out_entries(self, planted):
        R, mask = planted
        model = ALS(rank=4, reg=0.01, num_iterations=15).fit(R, mask,
                                                             device=CPU)
        assert model.rmse(R, mask) < 0.05
        assert model.rmse(R, 1.0 - mask) < 0.5

    def test_shapes_default_mask_and_seed(self, planted, rng):
        R, mask = planted
        m = ALS(rank=3, num_iterations=2).fit(R, mask, device=CPU)
        assert m.user_factors.shape == (40, 3)
        assert m.item_factors.shape == (30, 3)
        assert m.predict([0, 1], [5, 7]).shape == (2,)
        Z = np.zeros((8, 6), np.float32)
        Z[0, 0], Z[3, 4] = 2.0, -1.0
        assert np.isfinite(ALS(rank=2, num_iterations=3).fit(
            Z, device=CPU).predict_all()).all()
        a = ALS(rank=4, num_iterations=3, seed=1).fit(R, mask, device=CPU)
        b = ALS(rank=4, num_iterations=3, seed=1).fit(R, mask, device=CPU)
        np.testing.assert_array_equal(a.user_factors, b.user_factors)

    def test_reg_shrinks_factors(self, planted):
        R, mask = planted
        small = ALS(rank=4, reg=0.01, num_iterations=5).fit(R, mask,
                                                            device=CPU)
        big = ALS(rank=4, reg=100.0, num_iterations=5).fit(R, mask,
                                                           device=CPU)
        assert (np.linalg.norm(big.user_factors)
                < np.linalg.norm(small.user_factors))

    def test_implicit_ranks_positives_above_negatives(self):
        rs = np.random.default_rng(0)
        affinity = rs.normal(size=(60, 4)) @ rs.normal(size=(40, 4)).T
        R = np.where(affinity > 0.8, rs.poisson(3.0, affinity.shape),
                     0).astype(np.float32)
        scores = ALS(rank=4, reg=0.05, num_iterations=15, seed=1,
                     implicit_prefs=True, alpha=10.0).fit(
            R, device=CPU).predict_all()
        pos, neg = scores[R > 0], scores[R == 0]
        # AUC: the share of (positive, negative) pairs ranked right
        auc = (pos[:, None] > neg[None, :]).mean()
        assert auc > 0.85, auc

    def test_implicit_negative_ratings_and_mask(self):
        rs = np.random.default_rng(2)
        R = (rs.random((20, 15)) < 0.3).astype(np.float32) * 3.0
        R[0, 0] = -2.0
        m = ALS(rank=3, implicit_prefs=True, alpha=5.0,
                num_iterations=8).fit(R, device=CPU)
        assert np.isfinite(m.user_factors).all()
        assert np.isfinite(m.item_factors).all()
        with pytest.raises(ValueError, match="implicit"):
            ALS(implicit_prefs=True).fit(np.ones((4, 4), np.float32),
                                         mask=np.ones((4, 4)), device=CPU)

    def test_model_carries_across_both_ways(self, planted):
        R, mask = planted
        jm = jml.ALS(rank=3, num_iterations=3).fit(R, mask)
        tm = convert.fitted_model_from_reference(jm, CPU)
        np.testing.assert_array_equal(tm.predict_all(), jm.predict_all())
        back = jpersistence._model_restore(convert.fitted_model_to_reference(
            ALS(rank=3, num_iterations=3).fit(R, mask, device=CPU)))
        assert type(back) is jml.ALSModel
        assert back.rmse(R, mask) < 1.0


# ---------------------------------------------------------------- Word2Vec
def _corpus(n=400, seed=0):
    rs = np.random.default_rng(seed)
    tech = ["chip", "mesh", "ici", "hbm", "kernel", "compile"]
    food = ["bread", "milk", "butter", "cheese", "apple", "flour"]
    sents = [list(rs.choice(tech if rs.random() < 0.5 else food, size=6))
             for _ in range(n)]
    return sents, tech, food


class TestWord2Vec:
    def test_step_matches_jax_grad_of_the_loss(self):
        """One step on the same state and negatives: the JAX package's
        loss (``ml/word2vec.py``'s ``loss_fn``) and ``jax.value_and_grad``
        against the port's analytic step, repeated rows included."""
        rs = np.random.default_rng(0)
        V, d, B, K = 11, 6, 16, 3
        W_in = rs.normal(size=(V, d)).astype(np.float32)
        W_out = rs.normal(size=(V, d)).astype(np.float32)
        centers = rs.integers(0, V, B)
        contexts = rs.integers(0, V, B)
        negs = rs.integers(0, V, (B, K))
        negs[0, 0] = contexts[0]  # a collision, masked out

        def loss_fn(params):
            W_i, W_o = params
            v, u_pos, u_neg = W_i[centers], W_o[contexts], W_o[negs]
            pos = jnp.sum(v * u_pos, axis=1)
            neg = jnp.einsum("bd,bkd->bk", v, u_neg)
            valid = (negs != contexts[:, None]).astype(neg.dtype)
            return -(jnp.mean(jax.nn.log_sigmoid(pos)) + jnp.mean(
                jnp.sum(jax.nn.log_sigmoid(-neg) * valid, axis=1)))

        jloss, (gi, go) = jax.value_and_grad(loss_fn)(
            (jnp.asarray(W_in), jnp.asarray(W_out)))
        ti, to = torch.from_numpy(W_in.copy()), torch.from_numpy(W_out.copy())
        tloss = _sgns_step(ti, to, torch.from_numpy(centers),
                           torch.from_numpy(contexts),
                           torch.from_numpy(negs), 0.3)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(ti.numpy(), W_in - 0.3 * np.asarray(gi),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(to.numpy(), W_out - 0.3 * np.asarray(go),
                                   rtol=1e-5, atol=1e-6)

    def test_groups_separate_in_embedding_space(self):
        sents, tech, food = _corpus()
        model = Word2Vec(vector_size=16, window=3, min_count=2,
                         num_iterations=25, learning_rate=0.3,
                         batch_size=256, seed=1).fit(sents, device=CPU)
        win = [model.similarity(a, b) for a in tech for b in tech if a != b]
        cross = [model.similarity(a, b) for a in tech for b in food]
        assert np.mean(win) > np.mean(cross) + 0.2

    def test_find_synonyms_prefers_same_group(self):
        sents, tech, _ = _corpus(seed=2)
        model = Word2Vec(vector_size=16, window=3, num_iterations=25,
                         learning_rate=0.3, batch_size=256,
                         seed=3).fit(sents, device=CPU)
        top = [w for w, _ in model.find_synonyms("chip", 3)]
        assert all(w in tech for w in top), top
        assert "chip" not in top

    def test_vocab_errors_and_the_model_carried_both_ways(self):
        sents, _, _ = _corpus()
        model = Word2Vec(vector_size=8, num_iterations=1, seed=0).fit(
            sents, device=CPU)
        assert "chip" in model and "nonexistent" not in model
        with pytest.raises(KeyError):
            model.transform("nonexistent")
        with pytest.raises(ValueError, match="vocabulary"):
            Word2Vec(min_count=100).fit([["a", "b"]], device=CPU)
        ref = jml.Word2Vec(vector_size=8, num_iterations=1, seed=0).fit(sents)
        assert ref.vocab == model.vocab
        tm = convert.fitted_model_from_reference(ref, CPU)
        assert tm.find_synonyms("chip", 3) == ref.find_synonyms("chip", 3)
        back = jpersistence._model_restore(
            convert.fitted_model_to_reference(model))
        assert type(back) is jml.Word2VecModel
        np.testing.assert_array_equal(back.transform("milk"),
                                      model.transform("milk"))


# --------------------------------------------------------------------- LDA
def _lda_corpus(n_docs=200, vocab=40, seed=0):
    """Two planted topics on disjoint vocabulary halves."""
    rs = np.random.default_rng(seed)
    X = np.zeros((n_docs, vocab), np.float32)
    labels = rs.random(n_docs) < 0.5
    for i in range(n_docs):
        lo, hi = (0, vocab // 2) if labels[i] else (vocab // 2, vocab)
        np.add.at(X[i], rs.integers(lo, hi, 30), 1)
    return X, labels


class TestLDA:
    def test_e_step_matches_the_jax_package(self):
        X, _ = _lda_corpus()
        lam = np.random.default_rng(1).gamma(100.0, 0.01, size=(3, 40)
                                             ).astype(np.float32)
        beta = np.asarray(jlda._exp_elog_dirichlet(jnp.asarray(lam)))
        np.testing.assert_allclose(
            tlda._exp_elog_dirichlet(torch.from_numpy(lam)).numpy(), beta,
            rtol=1e-5)
        tg, ts = tlda._e_step(torch.from_numpy(X), torch.from_numpy(beta),
                              0.5, 20)
        jg, js = jlda._e_step(jnp.asarray(X), jnp.asarray(beta),
                              jnp.float32(0.5), 20)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4,
                                   atol=1e-4)

    def test_whole_fit_matches_the_jax_package(self):
        """Both start from numpy's topics: the same fit."""
        X, _ = _lda_corpus(seed=3)
        jm = jml.LDA(k=2, max_iterations=10, seed=2).fit(X)
        tm = LDA(k=2, max_iterations=10, seed=2).fit(X, device=CPU)
        np.testing.assert_allclose(tm.topics, jm.topics, rtol=1e-3,
                                   atol=1e-6)
        np.testing.assert_allclose(tm.log_perplexity_history,
                                   jm.log_perplexity_history, rtol=1e-5)
        back = jpersistence._model_restore(convert.fitted_model_to_reference(tm))
        assert type(back) is jlda.LDAModel
        np.testing.assert_allclose(
            back.transform(X[:10]),
            convert.fitted_model_from_reference(jm, CPU).transform(
                X[:10], device=CPU),
            rtol=1e-3, atol=1e-5)

    def test_recovers_planted_topics(self):
        X, labels = _lda_corpus()
        model = LDA(k=2, max_iterations=30, seed=1).fit(X, device=CPU)
        mass_lo = model.topics[:, :20].sum(axis=1)
        assert (mass_lo > 0.95).any() and (mass_lo < 0.05).any()
        t0 = model.doc_topics[labels].argmax(axis=1)
        t1 = model.doc_topics[~labels].argmax(axis=1)
        assert (t0 == np.bincount(t0).argmax()).mean() > 0.95
        assert np.bincount(t0).argmax() != np.bincount(t1).argmax()

    def test_perplexity_decreases_and_transform(self):
        X, _ = _lda_corpus(seed=3)
        model = LDA(k=2, max_iterations=25, seed=2).fit(X, device=CPU)
        h = model.log_perplexity_history
        assert h[-1] < h[0]
        mix = model.transform(X[:10], device=CPU)
        np.testing.assert_allclose(mix.sum(axis=1), 1.0, rtol=1e-4)
        terms, weights = model.describe_topics(5)[0]
        assert len(terms) == 5 and (np.diff(weights) <= 1e-9).all()
