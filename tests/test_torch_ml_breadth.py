"""The port's ML library breadth against the JAX package's: feature
transforms, evaluation, naive Bayes, trees, forests, boosting, isotonic
regression, FP-growth and PrefixSpan, Gaussian mixtures, pipelines with
cross-validation, and persistence.

Twins of ``tests/test_ml_breadth.py`` (``TestDecisionTree``,
``TestNaiveBayes``, ``TestEvaluation``, ``TestGaussianMixture``,
``TestFPGrowth``, ``TestRandomForest``, ``TestTFIDFandChiSq``,
``TestGradientBoostedTrees``, ``TestModelPersistence``,
``TestPipelineAndTuning`` and the isotonic cases of
``TestRegressionVariantsAndTests``), ``tests/test_ml_extra.py``
(``TestFeature``) and ``tests/test_ml_round2.py`` (``TestPrefixSpan``,
``TestAssociationRules``, ``TestFeatureSelection``, ``TestRankingMetrics``,
``TestMultilabelMetrics``) on the port with ``device=cpu`` (a CPU mesh for
the SGD estimators), then the two packages on the same numpy inputs.
Tolerances, stated at each test:

- exact: trees, forests and boosted stages' structure (split features and
  thresholds) from the same seed, classification leaves, class counts,
  confusion matrices, FP-growth itemsets, isotonic fits, the hash copy.
  A regression histogram is summed exactly in the port and in f32 in the
  JAX package: its leaves are exact where the f32 sums are too (labels on
  a coarse dyadic grid), else within 4 f32 ulps, and on other inputs two
  candidate splits whose gains tie within that rounding can part;
- a stated rtol where both packages sum f32 in their own orders: scalers,
  IDF, naive Bayes, the mixture's EM step and a whole fit, AUC and the
  regression metrics.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from asyncframework_tpu import ml as jml
from asyncframework_tpu.ml import mixture as jmixture
from asyncframework_tpu.ml import persistence as jpersistence
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from asyncframework_tpu_torch import convert
from asyncframework_tpu_torch import ml as tml
from asyncframework_tpu_torch.data.pairs import portable_hash as t_portable_hash
from asyncframework_tpu_torch.ml import feature as tfeature
from asyncframework_tpu_torch.ml import mixture as tmixture
from asyncframework_tpu_torch.parallel import make_mesh

CPU = torch.device("cpu")
#: four f32 ulps at the leaf values' scale (< 8): the JAX package's f32
#: sums against the port's exact ones
LEAF_ATOL = 4 * 2.0 ** -20


@pytest.fixture(scope="module")
def clf_data():
    from sklearn.datasets import make_classification as mk

    X, y = mk(n_samples=900, n_features=12, n_informative=6, random_state=7,
              n_classes=3, n_clusters_per_class=1)
    return X.astype(np.float32), y


@pytest.fixture(scope="module")
def reg_data():
    rs = np.random.default_rng(3)
    X = rs.normal(size=(800, 8)).astype(np.float32)
    y = (np.sin(X[:, 0]) * 3 + X[:, 1] ** 2 + 0.1 * rs.normal(size=800))
    return X, y.astype(np.float32)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1, devices=[CPU])


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_tree(t, j, exact_leaves=True):
    np.testing.assert_array_equal(t.feature, j.feature)
    np.testing.assert_array_equal(t.threshold, j.threshold)
    if exact_leaves:
        np.testing.assert_array_equal(t.prediction, j.prediction)
    else:
        np.testing.assert_allclose(t.prediction, j.prediction, rtol=0,
                                   atol=LEAF_ATOL)
    assert t.depth == j.depth and t.task == j.task


# -------------------------------------------------------------- features
class TestFeature:
    def test_standard_scaler_matches_numpy_and_the_jax_package(self, rng):
        X = rng.normal(loc=3.0, scale=2.0, size=(200, 5)).astype(np.float32)
        sc = tml.StandardScaler(device=CPU)
        Z = _np(sc.fit_transform(X))
        np.testing.assert_allclose(Z.mean(axis=0), 0.0, atol=1e-5)
        np.testing.assert_allclose(Z.std(axis=0, ddof=1), 1.0, atol=1e-4)
        js = jml.StandardScaler().fit(X)
        # f32 column sums in two orders
        np.testing.assert_allclose(sc.mean_, js.mean_, rtol=1e-6)
        np.testing.assert_allclose(sc.std_, js.std_, rtol=1e-5)
        np.testing.assert_allclose(Z, np.asarray(js.transform(X)), rtol=1e-4,
                                   atol=1e-5)

    def test_standard_scaler_constant_column_safe(self):
        X = np.ones((10, 2), np.float32)
        Z = _np(tml.StandardScaler(device=CPU).fit_transform(X))
        assert np.isfinite(Z).all()

    def test_minmax_scaler(self, rng):
        X = rng.normal(size=(50, 3)).astype(np.float32)
        Z = _np(tml.MinMaxScaler(0.0, 1.0, device=CPU).fit_transform(X))
        np.testing.assert_allclose(Z.min(axis=0), 0.0, atol=1e-6)
        np.testing.assert_allclose(Z.max(axis=0), 1.0, atol=1e-6)
        X[:, 1] = 4.0  # a constant column lands mid-range
        Zt = _np(tml.MinMaxScaler(-1.0, 3.0, device=CPU).fit_transform(X))
        Zj = np.asarray(jml.MinMaxScaler(-1.0, 3.0).fit_transform(X))
        # min and max are exact; the same f32 operations
        np.testing.assert_array_equal(Zt, Zj)

    @pytest.mark.parametrize("p", [1.0, 2.0, float("inf")])
    def test_normalizer(self, rng, p):
        X = rng.normal(size=(20, 4)).astype(np.float32)
        X[3] = 0.0  # zero row passes through
        Z = _np(tml.Normalizer(p, device=CPU).transform(X))
        norms = np.linalg.norm(Z, ord=p, axis=1)
        np.testing.assert_allclose(np.delete(norms, 3), 1.0, atol=1e-5)
        np.testing.assert_array_equal(Z[3], 0.0)
        np.testing.assert_allclose(
            Z, np.asarray(jml.Normalizer(p).transform(X)), rtol=1e-6)

    def test_elementwise_product(self):
        ep = tml.ElementwiseProduct([1.0, 2.0, 3.0], device=CPU)
        out = _np(ep.transform([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]))
        np.testing.assert_allclose(out, [[1, 2, 3], [2, 4, 6]])
        np.testing.assert_allclose(_np(ep.transform([1.0, 1.0, 1.0])),
                                   [1, 2, 3])

    def test_chisq_selector_finds_informative_as_the_jax_package(self):
        rs = np.random.default_rng(6)
        n = 400
        y = rs.integers(0, 2, n)
        X = np.zeros((n, 5))
        X[:, 1] = y  # perfectly informative
        X[:, 3] = y ^ (rs.random(n) < 0.1)  # mostly informative
        X[:, 0] = rs.integers(0, 3, n)
        X[:, 2] = rs.integers(0, 3, n)
        X[:, 4] = rs.integers(0, 2, n)
        model = tml.ChiSqSelector(num_top_features=2, device=CPU).fit(X, y)
        assert set(model.selected) == {1, 3}
        out = _np(model.transform(X))
        assert out.shape == (n, 2)
        np.testing.assert_array_equal(out[:, 0], X[:, 1])
        jm = jml.ChiSqSelector(num_top_features=3).fit(X, y)
        tm = tml.ChiSqSelector(num_top_features=3, device=CPU).fit(X, y)
        np.testing.assert_array_equal(tm.selected, jm.selected)
        back = jml.ChiSqSelectorModel(
            **convert.chisq_selector_model_to_reference(tm))
        there = convert.chisq_selector_model_from_reference(jm, CPU)
        np.testing.assert_array_equal(np.asarray(back.transform(X)),
                                      _np(there.transform(X)))


class TestTFIDF:
    DOCS = [["tpu", "async", "tpu"], ["async"], ["sgd", "tpu"]]

    def test_hashing_tf_counts(self):
        tf = tml.HashingTF(64, device=CPU)
        M = _np(tf.transform(self.DOCS))
        assert M.shape == (3, 64)
        np.testing.assert_array_equal(M.sum(axis=1), [3, 1, 2])
        assert M[0, tf.indices(["tpu"])[0]] == 2
        # the count matrix is the JAX package's, exactly
        np.testing.assert_array_equal(
            M, np.asarray(jml.HashingTF(64).transform(self.DOCS)))

    def test_hashing_tf_mixed_keys_and_generators(self):
        docs = [iter(["a", b"a", 1, 1.0, True, ("a", 2), None]), ("a", "a")]
        M = _np(tml.HashingTF(97, device=CPU).transform(docs))
        J = np.asarray(jml.HashingTF(97).transform(
            [["a", b"a", 1, 1.0, True, ("a", 2), None], ("a", "a")]))
        np.testing.assert_array_equal(M, J)

    @settings(max_examples=200, deadline=None)
    @given(st.one_of(
        st.text(), st.binary(), st.integers(-2**70, 2**70), st.none(),
        st.booleans(), st.floats(allow_nan=False),
        st.tuples(st.text(), st.integers(-2**40, 2**40)),
        st.tuples(st.binary(), st.tuples(st.text(), st.booleans()))))
    def test_hash_copy_is_portable_hash(self, key):
        """The hash ``HashingTF`` uses (the port's ``data/pairs.py``
        ``portable_hash``) against the JAX package's: the same hash, or the
        same error (bytes that are not UTF-8 fail to re-encode in both)."""
        from asyncframework_tpu.data.pairs import portable_hash

        def outcome(fn):
            try:
                return fn(key)
            except UnicodeEncodeError as e:
                return type(e)

        assert tfeature.portable_hash is t_portable_hash
        assert outcome(t_portable_hash) == outcome(portable_hash)

    def test_tf_idf_matches_the_formula_and_the_jax_package(self):
        tf = tml.HashingTF(128, device=CPU).transform(self.DOCS)
        model = tml.IDF(device=CPU).fit(tf)
        tfidf = _np(model.transform(tf))
        b = tml.HashingTF(128).indices(["sgd"])[0]
        np.testing.assert_allclose(tfidf[2, b], np.log(4 / 2), rtol=1e-5)
        b2 = tml.HashingTF(128).indices(["async"])[0]
        np.testing.assert_allclose(tfidf[1, b2], np.log(4 / 3), rtol=1e-5)
        jtf = jml.HashingTF(128).transform(self.DOCS)
        jmodel = jml.IDF().fit(jtf)
        # f32 logs of the same counts in two libraries
        np.testing.assert_allclose(_np(model.idf), np.asarray(jmodel.idf),
                                   rtol=1e-6)
        there = convert.transformer_from_reference(jmodel, CPU)
        np.testing.assert_allclose(_np(there.transform(tf)), tfidf,
                                   rtol=1e-6)
        back = jpersistence._transformer_restore(
            convert.transformer_to_reference(model), "")
        np.testing.assert_allclose(np.asarray(back.transform(jtf)), tfidf,
                                   rtol=1e-6)

    def test_min_doc_freq_zeroes_rare_terms(self):
        tf = tml.HashingTF(128, device=CPU).transform(self.DOCS)
        model = tml.IDF(min_doc_freq=2, device=CPU).fit(tf)
        b = tml.HashingTF(128).indices(["sgd"])[0]  # df=1 < 2
        assert float(model.idf[b]) == 0.0

    def test_empty_corpus_flows(self):
        tf = tml.HashingTF(32, device=CPU).transform([])
        assert tuple(tf.shape) == (0, 32)
        tml.IDF(device=CPU).fit(tf)  # no crash


# ------------------------------------------------------------ evaluation
class TestEvaluation:
    def test_auc_matches_sklearn_and_the_jax_package(self):
        from sklearn.metrics import average_precision_score, roc_auc_score

        rs = np.random.default_rng(4)
        y = (rs.random(2000) < 0.3).astype(np.float32)
        scores = (y * 0.5 + rs.normal(0, 0.6, 2000)).astype(np.float32)
        scores[:200] = np.round(scores[:200], 1)  # tied blocks
        m = tml.BinaryClassificationMetrics(scores, y, device=CPU)
        np.testing.assert_allclose(m.area_under_roc(),
                                   roc_auc_score(y, scores), atol=1e-4)
        np.testing.assert_allclose(m.area_under_pr(),
                                   average_precision_score(y, scores),
                                   atol=0.02)
        j = jml.BinaryClassificationMetrics(scores, y)
        # the port's counts are float64, the JAX package's f32 (both exact)
        np.testing.assert_allclose(m.area_under_roc(), j.area_under_roc(),
                                   rtol=1e-6)
        np.testing.assert_allclose(m.area_under_pr(), j.area_under_pr(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(m.thresholds(), j.thresholds())
        for a, b in zip(m.roc() + m.pr(), j.roc() + j.pr()):
            np.testing.assert_allclose(a, b, rtol=1e-6)
        # a tensor's metric runs on its device
        mt = tml.BinaryClassificationMetrics(torch.from_numpy(scores),
                                             torch.from_numpy(y))
        assert mt.area_under_roc() == m.area_under_roc()

    def test_regression_metrics_match_sklearn_and_the_jax_package(
            self, reg_data):
        from sklearn.metrics import (
            mean_absolute_error,
            mean_squared_error,
            r2_score,
        )

        _X, y = reg_data
        pred = y + np.random.default_rng(0).normal(0, 0.5, len(y)).astype(
            np.float32)
        m = tml.RegressionMetrics.of(pred, y, device=CPU)
        np.testing.assert_allclose(m.mean_squared_error,
                                   mean_squared_error(y, pred), rtol=1e-6)
        np.testing.assert_allclose(m.mean_absolute_error,
                                   mean_absolute_error(y, pred), rtol=1e-6)
        np.testing.assert_allclose(m.r2, r2_score(y, pred), rtol=1e-6)
        j = jml.RegressionMetrics.of(pred, y)
        # the JAX package's f32 sums against the port's float64 ones
        for field in ("mean_squared_error", "root_mean_squared_error",
                      "mean_absolute_error", "r2", "explained_variance"):
            np.testing.assert_allclose(getattr(m, field), getattr(j, field),
                                       rtol=1e-4)

    def test_multiclass_metrics(self):
        from sklearn.metrics import confusion_matrix, f1_score

        rs = np.random.default_rng(6)
        y = rs.integers(0, 3, 500)
        pred = np.where(rs.random(500) < 0.8, y, rs.integers(0, 3, 500))
        m = tml.MulticlassMetrics(pred, y, device=CPU)
        np.testing.assert_array_equal(m.confusion, confusion_matrix(y, pred))
        np.testing.assert_array_equal(
            m.confusion, jml.MulticlassMetrics(pred, y).confusion)
        np.testing.assert_allclose(
            m.weighted_f1(), f1_score(y, pred, average="weighted"),
            rtol=1e-6)
        assert 0.7 < m.accuracy <= 1.0
        assert tml.MulticlassMetrics(pred, y, num_classes=5,
                                     device=CPU).confusion.shape == (5, 5)

    def test_ranking_metrics_reference_semantics(self):
        pairs = [
            ([1, 6, 2, 7, 8, 3, 9, 10, 4, 5], {1, 2, 3, 4, 5}),
            ([4, 1, 5, 6, 2, 7, 3, 8, 9, 10], {1, 2, 3}),
            ([1, 2, 3, 4, 5], set()),
        ]
        m = tml.RankingMetrics(pairs)
        assert abs(m.precision_at(1) - 1 / 3) < 1e-9
        assert abs(m.precision_at(2) - (0.5 + 0.5 + 0.0) / 3) < 1e-9
        assert 0.0 < m.mean_average_precision() < 1.0
        j = jml.RankingMetrics(pairs)
        assert m.mean_average_precision() == j.mean_average_precision()
        assert m.ndcg_at(3) == j.ndcg_at(3)
        perfect = tml.RankingMetrics([([1, 2, 3], {1, 2, 3})])
        assert perfect.precision_at(3) == 1.0
        assert perfect.mean_average_precision() == 1.0
        assert abs(perfect.ndcg_at(3) - 1.0) < 1e-9
        # duplicate predictions each count (RankingMetrics.scala)
        assert abs(tml.RankingMetrics([([1, 1], {1})])
                   .mean_average_precision() - 2.0) < 1e-9

    def test_multilabel_metrics_hand_computed(self):
        pairs = [({0, 1}, {0, 2}), ({0, 2}, {0, 2}), ({0}, {0, 1})]
        m = tml.MultilabelMetrics(pairs)
        assert abs(m.subset_accuracy - 1 / 3) < 1e-9
        assert abs(m.accuracy - (1 / 3 + 1.0 + 0.5) / 3) < 1e-9
        assert abs(m.precision - (0.5 + 1.0 + 1.0) / 3) < 1e-9
        assert abs(m.recall - (0.5 + 1.0 + 0.5) / 3) < 1e-9
        tp, fp, fn = 4, 1, 2
        assert abs(m.micro_precision - tp / (tp + fp)) < 1e-9
        assert abs(m.micro_recall - tp / (tp + fn)) < 1e-9
        j = jml.MultilabelMetrics(pairs)
        for name in ("hamming_loss", "f1_measure", "micro_f1_measure"):
            assert getattr(m, name) == getattr(j, name)


# ------------------------------------------------------------- naive Bayes
class TestNaiveBayes:
    def test_gaussian_matches_sklearn_and_the_jax_package(self, clf_data):
        from sklearn.naive_bayes import GaussianNB

        X, y = clf_data
        tm = tml.NaiveBayes(model_type="gaussian", device=CPU).fit(X, y)
        ours = tm.predict(X)
        assert (ours == GaussianNB().fit(X, y).predict(X)).mean() > 0.97
        jm = jml.NaiveBayes(model_type="gaussian").fit(X, y)
        np.testing.assert_array_equal(_np(tm.log_pi), np.asarray(jm.log_pi))
        # per-class f32 sums in two orders
        for a, b in zip(tm._gauss, jm._gauss):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5)
        np.testing.assert_allclose(_np(tm.predict_log_likelihood(X)),
                                   np.asarray(jm.predict_log_likelihood(X)),
                                   rtol=1e-5)
        np.testing.assert_array_equal(ours, np.asarray(jm.predict(X)))

    def test_multinomial_matches_sklearn_and_the_jax_package(self):
        from sklearn.naive_bayes import MultinomialNB

        rs = np.random.default_rng(1)
        X = rs.poisson(3.0, size=(800, 20)).astype(np.float32)
        w = rs.normal(size=(20,))
        y = (X @ w > np.median(X @ w)).astype(np.int64)
        tm = tml.NaiveBayes(smoothing=1.0, model_type="multinomial",
                            device=CPU).fit(X, y)
        ours = tm.predict(X)
        assert (ours == MultinomialNB(alpha=1.0).fit(X, y).predict(X)
                ).mean() > 0.99
        jm = jml.NaiveBayes(smoothing=1.0, model_type="multinomial").fit(X, y)
        # integer counts: the class sums are exact in both
        np.testing.assert_allclose(_np(tm.log_theta),
                                   np.asarray(jm.log_theta), rtol=1e-6)
        np.testing.assert_allclose(_np(tm.predict_log_likelihood(X)),
                                   np.asarray(jm.predict_log_likelihood(X)),
                                   rtol=1e-5)
        np.testing.assert_array_equal(ours, np.asarray(jm.predict(X)))

    def test_bernoulli_matches_sklearn_and_the_jax_package(self):
        from sklearn.naive_bayes import BernoulliNB

        rs = np.random.default_rng(2)
        X = (rs.random((600, 15)) < 0.3).astype(np.float32)
        y = (X[:, :5].sum(1) > 1).astype(np.int64)
        tm = tml.NaiveBayes(smoothing=1.0, model_type="bernoulli",
                            device=CPU).fit(X, y)
        ours = tm.predict(X)
        assert (ours == BernoulliNB(alpha=1.0).fit(X, y).predict(X)
                ).mean() > 0.99
        jm = jml.NaiveBayes(smoothing=1.0, model_type="bernoulli").fit(X, y)
        np.testing.assert_allclose(_np(tm.log_theta),
                                   np.asarray(jm.log_theta), rtol=1e-6)
        np.testing.assert_allclose(_np(tm.predict_log_likelihood(X)),
                                   np.asarray(jm.predict_log_likelihood(X)),
                                   rtol=1e-5)

    def test_class_counts_are_exact(self, clf_data):
        X, y = clf_data
        tm = tml.NaiveBayes(device=CPU).fit(np.abs(X), y)
        counts = np.bincount(y)
        np.testing.assert_allclose(
            np.exp(_np(tm.log_pi).astype(np.float64)), counts / counts.sum(),
            rtol=1e-6)
        with pytest.raises(ValueError):
            tml.NaiveBayes(model_type="poisson")


# ------------------------------------------------------------------ trees
class TestDecisionTree:
    def test_classification_close_to_sklearn_and_exact(self, clf_data):
        from sklearn.tree import DecisionTreeClassifier

        X, y = clf_data
        model = tml.DecisionTree("classification", max_depth=5, max_bins=64,
                                 device=CPU).fit(X, y)
        acc = (model.predict(X) == y).mean()
        sk = DecisionTreeClassifier(max_depth=5, random_state=0).fit(X, y)
        assert acc >= (sk.predict(X) == y).mean() - 0.06
        assert acc > 0.8
        jm = jml.DecisionTree("classification", max_depth=5,
                              max_bins=64).fit(X, y)
        _same_tree(model, jm)
        np.testing.assert_array_equal(model.predict(X), jm.predict(X))
        # the device traversal equals the host one
        np.testing.assert_array_equal(
            model.predict(torch.from_numpy(X)).numpy(), model.predict(X))

    def test_regression_close_to_sklearn(self, reg_data):
        from sklearn.tree import DecisionTreeRegressor

        X, y = reg_data
        model = tml.DecisionTree("regression", max_depth=5, max_bins=64,
                                 device=CPU).fit(X, y)
        pred = model.predict(X)
        sk_pred = DecisionTreeRegressor(max_depth=5, random_state=0).fit(
            X, y).predict(X)
        ours_r2 = tml.RegressionMetrics.of(pred, y, device=CPU).r2
        sk_r2 = tml.RegressionMetrics.of(sk_pred, y, device=CPU).r2
        assert ours_r2 >= sk_r2 - 0.08 and ours_r2 > 0.5

    @pytest.mark.parametrize("max_depth,max_bins", [(5, 64), (4, 32)])
    def test_regression_with_exact_sums_is_bit_equal(self, reg_data,
                                                      max_depth, max_bins):
        """Labels on a 1/8 grid inside (-8, 8): every sum and sum of
        squares is exact in the JAX package's f32 too, so the whole tree,
        leaves included, is the JAX package's bit for bit.  (Elsewhere the
        port's exact sums and the JAX package's f32 ones can break a tie
        between two candidate splits apart.)"""
        X, y = reg_data
        yq = np.clip(np.round(y * 8) / 8, -7.875, 7.875).astype(np.float32)
        kw = dict(max_depth=max_depth, max_bins=max_bins)
        model = tml.DecisionTree("regression", **kw, device=CPU).fit(X, yq)
        _same_tree(model, jml.DecisionTree("regression", **kw).fit(X, yq))

    def test_refits_are_identical(self, reg_data):
        X, y = reg_data
        fits = [tml.DecisionTree("regression", max_depth=5,
                                 device=CPU).fit(torch.from_numpy(X), y)
                for _ in range(2)]
        _same_tree(fits[0], fits[1])

    def test_histograms_match_numpy(self, clf_data, reg_data):
        """The device binning and root histograms against the host:
        ``np.searchsorted`` and ``np.bincount``; the fixed-point sums
        against float64 sums."""
        from asyncframework_tpu_torch.ml import tree

        X, y = clf_data
        thr = tree.quantile_bins(X, 32)
        bins = tree.bin_features(torch.from_numpy(X), thr).numpy()
        want = np.stack([np.searchsorted(thr[f], X[:, f], "left")
                         for f in range(X.shape[1])], axis=1)
        np.testing.assert_array_equal(bins, want)
        F = X.shape[1]
        hist = tree._class_histogram(
            torch.from_numpy(bins), torch.zeros(len(y), dtype=torch.int64),
            torch.from_numpy(y), 1, 32, 3).numpy()
        flat = (np.arange(F)[None, :] * 32 + bins) * 3 + y[:, None]
        np.testing.assert_array_equal(
            hist.ravel(), np.bincount(flat.ravel(), minlength=F * 32 * 3))
        Xr, yr = reg_data
        thr = tree.quantile_bins(Xr, 16)
        b = tree.bin_features(torch.from_numpy(Xr), thr)
        h = tree._reg_histogram(b, torch.zeros(len(yr), dtype=torch.int64),
                                torch.from_numpy(yr), 1, 16).numpy()[0]
        y64 = yr.astype(np.float64)
        sq64 = (yr * yr).astype(np.float64)
        for f in range(Xr.shape[1]):
            np.testing.assert_array_equal(
                h[f, :, 0], np.bincount(b[:, f].numpy(), minlength=16))
            np.testing.assert_allclose(h[f, :, 1], np.bincount(
                b[:, f].numpy(), y64, minlength=16), rtol=0, atol=1e-9)
            np.testing.assert_allclose(h[f, :, 2], np.bincount(
                b[:, f].numpy(), sq64, minlength=16), rtol=0, atol=1e-9)

    def test_perfect_split_recovered(self):
        rs = np.random.default_rng(0)
        X = rs.normal(size=(400, 3)).astype(np.float32)
        y = (X[:, 1] > 0.3).astype(np.int64)
        model = tml.DecisionTree("classification", max_depth=2, max_bins=128,
                                 device=CPU).fit(X, y)
        assert model.feature[0] == 1
        assert abs(model.threshold[0] - 0.3) < 0.1
        assert (model.predict(X) == y).mean() > 0.97

    def test_pure_node_stops(self):
        X = np.asarray([[0.0], [1.0], [2.0], [3.0]], np.float32)
        y = np.asarray([0, 0, 1, 1])
        model = tml.DecisionTree("classification", max_depth=4, max_bins=8,
                                 device=CPU).fit(X, y)
        assert (model.predict(X) == y).all()
        assert model.feature[1] == -1 and model.feature[2] == -1


class TestRandomForest:
    def test_forest_beats_single_tree_on_noise(self, clf_data):
        X, y = clf_data
        rs = np.random.default_rng(0)
        flip = rs.random(len(y)) < 0.15
        y_noisy = np.where(flip, rs.integers(0, 3, len(y)), y)
        half = len(y) // 2
        forest = tml.RandomForest(num_trees=8, max_depth=6, seed=3,
                                  device=CPU).fit(X[:half], y_noisy[:half])
        tree_pred = tml.DecisionTree(max_depth=6, device=CPU).fit(
            X[:half], y_noisy[:half]).predict(X[half:])
        acc_f = (forest.predict(X[half:]) == y[half:]).mean()
        acc_t = (tree_pred == y[half:]).mean()
        assert acc_f >= acc_t - 0.01 and acc_f > 0.75

    def test_forest_is_the_jax_packages(self, clf_data):
        """The same bootstrap rows and per-node feature draws: every tree
        exact, the votes equal, on the host and the device alike."""
        X, y = clf_data
        kw = dict(num_trees=4, max_depth=4, seed=5)
        tf = tml.RandomForest(**kw, device=CPU).fit(torch.from_numpy(X), y)
        jf = jml.RandomForest(**kw).fit(X, y)
        assert len(tf.trees) == len(jf.trees) == 4
        for a, b in zip(tf.trees, jf.trees):
            _same_tree(a, b)
        np.testing.assert_array_equal(tf.predict(X), jf.predict(X))
        np.testing.assert_array_equal(
            tf.predict(torch.from_numpy(X)).numpy(), tf.predict(X))

    def test_regression_forest(self, reg_data):
        X, y = reg_data
        kw = dict(num_trees=4, max_depth=5, feature_subset_strategy="all",
                  seed=1)
        model = tml.RandomForest("regression", **kw, device=CPU).fit(X, y)
        assert tml.RegressionMetrics.of(model.predict(X), y,
                                        device=CPU).r2 > 0.5
        jf = jml.RandomForest("regression", **kw).fit(X, y)
        for a, b in zip(model.trees, jf.trees):
            _same_tree(a, b, exact_leaves=False)
        np.testing.assert_allclose(model.predict(X), jf.predict(X), rtol=0,
                                   atol=LEAF_ATOL)
        with pytest.raises(ValueError):
            tml.RandomForest(feature_subset_strategy="half",
                             device=CPU).fit(X, y.astype(np.int64) % 2)


class TestGradientBoostedTrees:
    def test_regression_beats_single_tree(self, reg_data):
        X, y = reg_data
        gbt = tml.GradientBoostedTrees("regression", num_iterations=30,
                                       learning_rate=0.2, max_depth=3,
                                       device=CPU).fit(X, y)
        tree = tml.DecisionTree("regression", max_depth=3,
                                device=CPU).fit(X, y)
        r2 = [tml.RegressionMetrics.of(m.predict(X), y, device=CPU).r2
              for m in (gbt, tree)]
        assert r2[0] > r2[1] + 0.05 and r2[0] > 0.7

    def test_classification_close_to_sklearn(self, clf_data):
        from sklearn.ensemble import GradientBoostingClassifier

        X, y3 = clf_data
        y = (y3 > 0).astype(np.int64)
        ours = tml.GradientBoostedTrees("classification", num_iterations=30,
                                        learning_rate=0.2, max_depth=3,
                                        device=CPU).fit(X, y)
        acc = (ours.predict(X) == y).mean()
        sk = GradientBoostingClassifier(n_estimators=30, learning_rate=0.2,
                                        max_depth=3, random_state=0).fit(X, y)
        assert acc >= (sk.predict(X) == y).mean() - 0.05

    @pytest.mark.parametrize("task", ["regression", "classification"])
    def test_stages_are_the_jax_packages(self, clf_data, reg_data, task):
        """Every stage's splits exact; leaves and margins within a few f32
        ulps (exact sums against f32 ones, and each stage's residuals
        carry the last's leaves)."""
        if task == "regression":
            X, y = reg_data
        else:
            X, y = clf_data[0], (clf_data[1] > 0).astype(np.int64)
        kw = dict(num_iterations=6, learning_rate=0.3, max_depth=3)
        tm = tml.GradientBoostedTrees(task, **kw, device=CPU).fit(X, y)
        jm = jml.GradientBoostedTrees(task, **kw).fit(X, y)
        assert tm.init_value == jm.init_value
        for a, b in zip(tm.trees, jm.trees):
            _same_tree(a, b, exact_leaves=False)
        np.testing.assert_allclose(tm.raw_predict(X), jm.raw_predict(X),
                                   rtol=0, atol=16 * LEAF_ATOL)
        np.testing.assert_array_equal(
            tm.raw_predict(torch.from_numpy(X)).numpy(), tm.raw_predict(X))

    def test_rejects_bad_labels(self, reg_data):
        X, y = reg_data
        with pytest.raises(ValueError, match="labels"):
            tml.GradientBoostedTrees("classification", device=CPU).fit(X, y)


# --------------------------------------------------------------- isotonic
class TestIsotonic:
    def test_isotonic_matches_sklearn_and_the_jax_package(self):
        from sklearn.isotonic import IsotonicRegression as SKIso

        rs = np.random.default_rng(1)
        x = np.sort(rs.random(200) * 10)
        y = np.log1p(x) + rs.normal(0, 0.15, 200)
        ours = tml.IsotonicRegression().fit(x, y)
        grid = np.linspace(0, 10, 50)
        np.testing.assert_allclose(
            ours.predict(grid),
            SKIso(out_of_bounds="clip").fit(x, y).predict(grid), atol=1e-6)
        j = jml.IsotonicRegression().fit(x, y)
        np.testing.assert_array_equal(ours.boundaries, j.boundaries)
        np.testing.assert_array_equal(ours.predictions, j.predictions)

    def test_isotonic_decreasing_and_weights(self):
        x = np.asarray([1.0, 2, 3, 4])
        y = np.asarray([4.0, 3, 3.5, 1])
        m = tml.IsotonicRegression(increasing=False).fit(x, y)
        pred = m.predict(x)
        assert all(a >= b - 1e-9 for a, b in zip(pred, pred[1:]))
        np.testing.assert_array_equal(
            pred, jml.IsotonicRegression(increasing=False).fit(x, y)
            .predict(x))
        with pytest.raises(ValueError, match="positive"):
            tml.IsotonicRegression().fit(x, y, weights=[1, 0, 1, 1])

    def test_isotonic_ties_pooled_and_persist(self, tmp_path):
        from sklearn.isotonic import IsotonicRegression as SKIso

        x = np.asarray([1.0, 1.0, 2.0])
        y = np.asarray([0.0, 1.0, 2.0])
        m = tml.IsotonicRegression().fit(x, y)
        np.testing.assert_allclose(
            m.predict([1.0]),
            SKIso(out_of_bounds="clip").fit(x, y).predict([1.0]))
        loaded = tml.load_model(tml.save_model(m, tmp_path / "iso"))
        grid = np.linspace(0.5, 2.5, 9)
        np.testing.assert_allclose(loaded.predict(grid), m.predict(grid))


# ---------------------------------------------------------------- mixture
class TestGaussianMixture:
    def test_recovers_separated_blobs(self):
        rs = np.random.default_rng(0)
        a = rs.normal([-4, 0], 0.5, size=(300, 2))
        b = rs.normal([4, 1], 0.8, size=(300, 2))
        X = np.vstack([a, b]).astype(np.float32)
        model = tml.GaussianMixture(2, seed=1, device=CPU).fit(X)
        pred = model.predict(X)
        pa = np.bincount(pred[:300], minlength=2)
        pb = np.bincount(pred[300:], minlength=2)
        assert pa.max() > 290 and pb.max() > 290
        assert pa.argmax() != pb.argmax()
        np.testing.assert_allclose(np.sort(model.means[:, 0]), [-4, 4],
                                   atol=0.3)

    def test_loglik_close_to_sklearn_and_monotone(self):
        from sklearn.mixture import GaussianMixture as SKGMM

        rs = np.random.default_rng(2)
        X = np.vstack([rs.normal(0, 1, size=(200, 3)),
                       rs.normal(3, 1.5, size=(200, 3))]).astype(np.float32)
        est = tml.GaussianMixture(2, seed=0, max_iterations=200, device=CPU)
        ours = est.fit(X)
        sk = SKGMM(2, random_state=0, max_iter=200).fit(X)
        assert ours.log_likelihood / len(X) >= sk.score(X) - 0.05
        lls = est.last_run["log_likelihoods"]
        assert lls[-1] == ours.log_likelihood
        assert all(b >= a - 1e-5 * abs(a) for a, b in zip(lls, lls[1:]))

    def test_proba_rows_sum_to_one(self):
        X = np.random.default_rng(3).normal(size=(100, 2)).astype(np.float32)
        model = tml.GaussianMixture(3, seed=0, max_iterations=10,
                                    device=CPU).fit(X)
        p = model.predict_proba(X)
        np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-4)
        np.testing.assert_allclose(
            model.predict_proba(torch.from_numpy(X)).numpy(), p, rtol=1e-6)

    def test_em_step_matches_the_jax_package(self):
        """One step from the same state: f32 sums over the rows in two
        orders (rtol 1e-4 on the moments, 1e-5 on the log-likelihood)."""
        rs = np.random.default_rng(4)
        X = rs.normal(size=(500, 3)).astype(np.float32) * [1.0, 3.0, 0.5]
        X = X.astype(np.float32)
        w = np.asarray([0.2, 0.3, 0.5], np.float32)
        mu = rs.normal(size=(3, 3)).astype(np.float32)
        A = rs.normal(size=(3, 3, 3)).astype(np.float32)
        covs = (A @ A.transpose(0, 2, 1) + np.eye(3)).astype(np.float32)
        L = np.linalg.cholesky(covs).astype(np.float32)
        got = tmixture._em_step(*(torch.from_numpy(a) for a in (X, w, mu, L)))
        want = jmixture._em_step(X, w, mu, L)
        for g, e in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                       atol=1e-5)
        np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)

    def test_whole_fit_matches_the_jax_package(self):
        """The same k-means seeding from the same numpy draws, then EM:
        the same iterations, parameters within 1e-4."""
        rs = np.random.default_rng(5)
        X = np.vstack([rs.normal(c, s, size=(150, 2)) for c, s in
                       (([-5, 0], 0.7), ([5, 2], 1.0), ([0, 6], 0.5))]
                      ).astype(np.float32)
        t = tml.GaussianMixture(3, seed=2, device=CPU).fit(X)
        j = jml.GaussianMixture(3, seed=2).fit(X)
        np.testing.assert_allclose(t.means, j.means, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(t.weights, j.weights, rtol=1e-4)
        np.testing.assert_allclose(t.covariances, j.covariances, rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(t.log_likelihood, j.log_likelihood,
                                   rtol=1e-5)
        np.testing.assert_array_equal(t.predict(X), j.predict(X))


# -------------------------------------------------------------------- fpm
class TestFPGrowth:
    TXS = [
        ["bread", "milk"],
        ["bread", "diapers", "beer", "eggs"],
        ["milk", "diapers", "beer", "cola"],
        ["bread", "milk", "diapers", "beer"],
        ["bread", "milk", "diapers", "cola"],
    ]

    def brute_force(self, min_support):
        from itertools import combinations

        n = len(self.TXS)
        items = sorted({i for t in self.TXS for i in t})
        out = {}
        for r in range(1, len(items) + 1):
            for combo in combinations(items, r):
                s = frozenset(combo)
                c = sum(1 for t in self.TXS if s <= set(t))
                if c / n >= min_support:
                    out[s] = c
        return out

    @pytest.mark.parametrize("min_support", [0.2, 0.4, 0.6])
    def test_matches_brute_force_and_the_jax_package(self, min_support):
        model = tml.FPGrowth(min_support).run(self.TXS)
        assert model.freq_itemsets == self.brute_force(min_support)
        assert model.freq_itemsets == jml.FPGrowth(min_support).run(
            self.TXS).freq_itemsets

    def test_association_rules(self):
        model = tml.FPGrowth(0.4).run(self.TXS)
        rules = model.association_rules(min_confidence=0.9)
        by_pair = {(tuple(sorted(r.antecedent)), tuple(r.consequent)): r
                   for r in rules}
        key = (("beer",), ("diapers",))
        assert key in by_pair and by_pair[key].confidence == 1.0
        j = jml.FPGrowth(0.4).run(self.TXS).association_rules(0.9)
        assert [(r.antecedent, r.consequent, r.confidence) for r in rules] \
            == [(r.antecedent, r.consequent, r.confidence) for r in j]

    def test_standalone_rules_runner_matches_model(self):
        txs = [["a", "b"], ["a", "b", "c"], ["a", "c"], ["a"]]
        model = tml.FPGrowth(min_support=0.5).run(txs)
        standalone = tml.AssociationRules(0.6).run(model.itemsets(),
                                                   model.num_transactions)
        assert model.association_rules(0.6) == standalone
        conf = {(tuple(sorted(r.antecedent)), tuple(r.consequent)):
                r.confidence for r in standalone}
        assert conf[(("b",), ("a",))] == 1.0
        with pytest.raises(ValueError):
            tml.AssociationRules(0.5).run([(frozenset("ab"), 2)], 0)


class TestPrefixSpan:
    def test_spark_docs_example(self):
        seqs = [[[1, 2], [3]], [[1], [3, 2], [1, 2]], [[1, 2], [5]], [[6]]]
        out = tml.PrefixSpan(min_support=0.5).run(seqs)
        found = {tuple(tuple(sorted(s)) for s in f.sequence): f.freq
                 for f in out}
        assert found[((1,),)] == 3 and found[((2,),)] == 3
        assert found[((3,),)] == 2 and found[((1, 2),)] == 3
        assert found[((1,), (3,))] == 2
        assert all(5 not in s and 6 not in s for pat in found for s in pat)
        j = jml.PrefixSpan(min_support=0.5).run(seqs)
        assert [(f.sequence, f.freq) for f in out] == \
            [(f.sequence, f.freq) for f in j]

    def test_max_pattern_length(self):
        seqs = [[[1], [1], [1], [1]]] * 2
        out = tml.PrefixSpan(min_support=1.0, max_pattern_length=2).run(seqs)
        assert max(sum(len(s) for s in f.sequence) for f in out) <= 2


# ----------------------------------------------------- pipeline and tuning
def _logreg_on(mesh):
    """The port's ``LogisticRegression`` fitting on ``mesh`` when a
    pipeline calls ``fit(X, y)``, as ``JLogReg`` pins the JAX package's."""

    class LogReg(tml.LogisticRegression):
        def fit(self, X, y):
            return super().fit(X, y, mesh=mesh)

    return LogReg


class TestPipelineAndTuning:
    def test_pipeline_scaler_into_classifier(self, clf_data):
        X, y = clf_data
        Xtr, ytr, Xte, yte = tml.train_test_split(X, y, 0.3, seed=0)
        model = tml.Pipeline([
            tml.StandardScaler(device=CPU),
            tml.DecisionTree(max_depth=5, max_bins=64, device=CPU),
        ]).fit(Xtr, ytr)
        assert tml.accuracy_scorer(model, Xte, yte) > 0.75
        assert model.transformers[0].mean_ is not None
        # the stages pass tensors: the tree saw the scaler's output
        assert isinstance(model.predict(Xte), torch.Tensor)

    def test_pipeline_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            tml.Pipeline([])
        with pytest.raises(TypeError, match="transform"):
            tml.Pipeline([tml.DecisionTree(device=CPU),
                          tml.DecisionTree(device=CPU)]).fit(
                np.zeros((4, 2), np.float32), np.zeros(4))

    def test_cross_validator_picks_better_depth_as_the_jax_package(
            self, clf_data):
        """The same folds (numpy's permutation) and exact trees: the
        same scores, bit for bit."""
        X, y = clf_data
        kw = dict(param_grid={"max_depth": [1, 5]},
                  scorer=tml.accuracy_scorer, num_folds=3, seed=1)
        cv = tml.CrossValidator(
            estimator_factory=lambda max_depth: tml.DecisionTree(
                max_depth=max_depth, max_bins=32, device=CPU), **kw
        ).fit(torch.from_numpy(X), torch.from_numpy(y))
        assert cv.best_params == {"max_depth": 5}
        scores = dict((tuple(p.items()), s) for p, s in cv.all_scores)
        assert scores[(("max_depth", 5),)] > scores[(("max_depth", 1),)]
        assert (cv.predict(torch.from_numpy(X[:50])).numpy()
                == y[:50]).mean() > 0.7
        kw["scorer"] = jml.accuracy_scorer
        j = jml.CrossValidator(
            estimator_factory=lambda max_depth: jml.DecisionTree(
                max_depth=max_depth, max_bins=32), **kw).fit(X, y)
        assert cv.all_scores == j.all_scores
        assert cv.best_score == j.best_score

    def test_scaled_logistic_cross_validation_as_the_jax_package(
            self, mesh1, devices8):
        """The arm of the card's phase at a small size: a scaler into
        ``LogisticRegression`` over a grid; the folds' accuracies agree
        within one validation row."""
        from asyncframework_tpu.parallel import make_mesh as jmake_mesh

        rs = np.random.default_rng(8)
        X = (rs.normal(size=(600, 10)) * 3 + 1).astype(np.float32)
        y = (rs.random(600) < 1 / (1 + np.exp(-(X - 1) @ rs.normal(
            size=10) / 3))).astype(np.float32)
        grid = {"reg_param": [0.0, 0.01]}
        jmesh = jmake_mesh(1, devices=devices8[:1])

        class JLogReg(jml.LogisticRegression):
            def fit(self, X, y):
                return super().fit(X, y, mesh=jmesh)

        cv = tml.CrossValidator(lambda reg_param: tml.Pipeline([
            tml.StandardScaler(device=CPU),
            _logreg_on(mesh1)(reg_param=reg_param, num_iterations=30)]),
            grid, tml.accuracy_scorer,
            num_folds=3).fit(torch.from_numpy(X), torch.from_numpy(y))
        j = jml.CrossValidator(lambda reg_param: jml.Pipeline([
            jml.StandardScaler(),
            JLogReg(reg_param=reg_param, num_iterations=30)]), grid,
            jml.accuracy_scorer, num_folds=3).fit(X, y)
        for (tp, ts), (jp, js) in zip(cv.all_scores, j.all_scores):
            assert tp == jp and abs(ts - js) <= 1.0 / 200
        np.testing.assert_allclose(cv.best_model.model.weights,
                                   j.best_model.model.weights, rtol=1e-4,
                                   atol=1e-5)

    def test_train_test_split_partitions_as_the_jax_package(self):
        X = np.arange(40).reshape(20, 2)
        y = np.arange(20)
        Xtr, ytr, Xte, yte = tml.train_test_split(X, y, 0.25, seed=3)
        assert len(Xte) == 5 and len(Xtr) == 15
        assert sorted(np.concatenate([ytr, yte]).tolist()) == list(range(20))
        for a, b in zip(tml.train_test_split(torch.from_numpy(X),
                                             torch.from_numpy(y), 0.25,
                                             seed=3),
                        jml.train_test_split(X, y, 0.25, seed=3)):
            np.testing.assert_array_equal(a.numpy(), b)

    def test_cv_rejects_all_nan_and_split_guards(self):
        X = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32)
        y = np.zeros(30)
        with pytest.raises(ValueError, match="NaN"):
            tml.CrossValidator(
                lambda max_depth: tml.DecisionTree(max_depth=max_depth,
                                                   device=CPU),
                {"max_depth": [2]}, lambda m, Xv, yv: float("nan"), 3,
            ).fit(X, y)
        with pytest.raises(ValueError, match="empty partition"):
            tml.train_test_split(X[:2], y[:2], test_fraction=0.1)

    def test_r2_scorer(self, reg_data):
        X, y = reg_data
        model = tml.DecisionTree("regression", max_depth=4,
                                 device=CPU).fit(X, y)
        got = tml.r2_scorer(model, torch.from_numpy(X), y)
        j = jml.r2_scorer(jml.DecisionTree("regression",
                                           max_depth=4).fit(X, y), X, y)
        np.testing.assert_allclose(got, j, rtol=1e-5)


# ------------------------------------------------------------ persistence
def _families(clf_data, reg_data, mesh1):
    """One fitted port model of every family persistence covers, and what
    each is fed to compare predictions."""
    X, y = clf_data
    Xr, yr = reg_data
    Xs, ys = X[:300], y[:300]
    rs = np.random.default_rng(0)
    R = ((rs.random((20, 15)) < 0.4) * rs.random((20, 15))).astype(np.float32)
    docs = (rs.random((12, 30)) < 0.3).astype(np.float32) * 3
    yb = (ys > 0).astype(np.float32)
    return {
        "tree": (tml.DecisionTree(max_depth=3, device=CPU).fit(Xs, ys), Xs),
        "forest": (tml.RandomForest(num_trees=3, max_depth=3,
                                    device=CPU).fit(Xs, ys), Xs),
        "gbt": (tml.GradientBoostedTrees("regression", num_iterations=3,
                                         device=CPU).fit(Xr[:300], yr[:300]),
                Xr[:20]),
        "nb": (tml.NaiveBayes(model_type="gaussian", device=CPU).fit(Xs, ys),
               Xs),
        "nbm": (tml.NaiveBayes(model_type="multinomial",
                               device=CPU).fit(np.abs(Xs), ys), np.abs(Xs)),
        "nbb": (tml.NaiveBayes(model_type="bernoulli",
                               device=CPU).fit(Xs > 0, ys),
                (Xs > 0).astype(np.float32)),
        "iso": (tml.IsotonicRegression().fit(Xr[:, 0], yr), Xr[:50, 0]),
        "kmeans": (tml.KMeans(3, seed=0).fit(Xs, mesh1), Xs),
        "pca": (tml.PCA(2).fit(Xs, device=CPU), Xs),
        "gmm": (tml.GaussianMixture(2, max_iterations=5, seed=0,
                                    device=CPU).fit(Xs[:, :3]), Xs[:, :3]),
        "softmax": (tml.SoftmaxRegression(num_iterations=20).fit(
            Xs, ys, device=CPU), Xs),
        "linear": (tml.LinearRegression(num_iterations=5).fit(Xr, yr,
                                                              mesh=mesh1),
                   Xr),
        "logistic": (tml.LogisticRegression(num_iterations=5).fit(
            Xs, yb, mesh=mesh1), Xs),
        "svm": (tml.LinearSVM(num_iterations=5).fit(Xs, yb, mesh=mesh1), Xs),
        "als": (tml.ALS(rank=3, num_iterations=3).fit(R, device=CPU), None),
        "w2v": (tml.Word2Vec(vector_size=4, min_count=1, num_iterations=1,
                             seed=0).fit([["a", "b", "c"], ["b", "c", "d"]],
                                         device=CPU), None),
        "lda": (tml.LDA(k=2, max_iterations=3, seed=0).fit(docs, device=CPU),
                docs),
        "pipeline": (tml.Pipeline([
            tml.StandardScaler(device=CPU), tml.MinMaxScaler(device=CPU),
            tml.Normalizer(1.0, device=CPU),
            _logreg_on(mesh1)(num_iterations=5)]).fit(
                Xs, yb), Xs),
        "pipeline_idf": (tml.Pipeline([
            tml.IDF(device=CPU).fit(np.abs(Xs)),
            tml.NaiveBayes(device=CPU)]).fit(np.abs(Xs), ys), np.abs(Xs)),
    }


def _outputs(name, model, feed):
    """A model's predictions (its natural output) as float64 numpy."""
    if name == "als":
        return np.asarray(model.predict([0, 1], [2, 3]), np.float64)
    if name == "w2v":
        return np.asarray(model.transform("b"), np.float64)
    if name == "lda" and type(model).__module__.startswith(
            "asyncframework_tpu_torch"):
        return np.asarray(model.transform(feed, device=CPU), np.float64)
    if name in ("pca", "lda"):
        return np.asarray(_np(model.transform(feed)), np.float64)
    return np.asarray(_np(model.predict(feed)), np.float64)


class TestModelPersistence:
    def test_round_trip_every_family(self, clf_data, reg_data, mesh1,
                                     tmp_path):
        for name, (model, feed) in _families(clf_data, reg_data,
                                             mesh1).items():
            p = tml.save_model(model, tmp_path / name)
            loaded = tml.load_model(p, device=CPU)
            assert type(loaded).__name__ == type(model).__name__
            np.testing.assert_array_equal(_outputs(name, loaded, feed),
                                          _outputs(name, model, feed))

    def test_files_cross_both_ways(self, clf_data, reg_data, mesh1, devices8,
                                   tmp_path):
        """Every family saved by the port loads in the JAX package, and a
        JAX package file of each loads in the port: the same keys and the
        same predictions (the JAX package's f32 products within 1e-5)."""
        for name, (model, feed) in _families(clf_data, reg_data,
                                             mesh1).items():
            p = tml.save_model(model, tmp_path / f"port_{name}")
            theirs = jml.load_model(p)
            assert type(theirs).__name__ == type(model).__name__
            np.testing.assert_allclose(_outputs(name, theirs, feed),
                                       _outputs(name, model, feed),
                                       rtol=1e-5, atol=1e-6)
            q = jml.save_model(theirs, tmp_path / f"jax_{name}")
            with np.load(p) as a, np.load(q) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
            back = tml.load_model(q, device=CPU)
            np.testing.assert_array_equal(_outputs(name, back, feed),
                                          _outputs(name, model, feed))

    def test_jax_fitted_families_load_in_the_port(self, clf_data, reg_data,
                                                  tmp_path):
        X, y = clf_data
        Xr, yr = reg_data
        fitted = {
            "forest": (jml.RandomForest(num_trees=2, max_depth=3).fit(
                X[:200], y[:200]), X[:40]),
            "gbt": (jml.GradientBoostedTrees("classification",
                                             num_iterations=2).fit(
                X[:200], (y[:200] > 0).astype(np.int64)), X[:40]),
            "nb": (jml.NaiveBayes(model_type="gaussian").fit(X[:200],
                                                             y[:200]),
                   X[:40]),
            "gmm": (jml.GaussianMixture(2, max_iterations=3).fit(Xr[:, :2]),
                    Xr[:40, :2]),
            "pipeline": (jml.Pipeline([jml.StandardScaler(),
                                       jml.DecisionTree(max_depth=3)]).fit(
                X[:200], y[:200]), X[:40]),
        }
        for name, (model, feed) in fitted.items():
            ours = tml.load_model(jml.save_model(model, tmp_path / name),
                                  device=CPU)
            np.testing.assert_allclose(_outputs(name, ours, feed),
                                       _outputs(name, model, feed),
                                       rtol=1e-5, atol=1e-6)
            carried = convert.fitted_model_from_reference(model, CPU)
            np.testing.assert_array_equal(_outputs(name, carried, feed),
                                          _outputs(name, ours, feed))
            back = jpersistence._model_restore(
                convert.fitted_model_to_reference(carried))
            np.testing.assert_array_equal(_outputs(name, back, feed),
                                          _outputs(name, model, feed))

    def test_linear_models_round_trip(self, tmp_path):
        m = tml.LogisticRegressionModel(
            weights=np.asarray([0.5, -1.0], np.float32), intercept=0.25,
            loss_history=np.asarray([1.0, 0.5]),
            weight_history=[(1.0, np.asarray([0.1, 0.2], np.float32))])
        loaded = tml.load_model(tml.save_model(m, tmp_path / "lr"))
        X = np.asarray([[1.0, 1.0], [-2.0, 0.5]], np.float32)
        np.testing.assert_allclose(loaded.predict(X), m.predict(X))
        assert loaded.weight_history[0][0] == 1.0

    def test_save_as_libsvm_round_trip(self, tmp_path):
        from asyncframework_tpu_torch.data.libsvm import load_libsvm

        rs = np.random.default_rng(1)
        X = ((rs.random((20, 6)) < 0.4) * rs.normal(size=(20, 6))).astype(
            np.float32)
        y = rs.normal(size=20).astype(np.float32)
        p = tml.save_as_libsvm_file(torch.from_numpy(X), y,
                                    tmp_path / "d.libsvm")
        X2, y2 = load_libsvm(str(p), num_features=6, use_native=False)
        np.testing.assert_array_equal(X2, X)
        np.testing.assert_array_equal(y2, y)
        q = jml.save_as_libsvm_file(X, y, tmp_path / "j.libsvm")
        assert p.read_text() == q.read_text()

    def test_unknown_class_rejected(self, tmp_path):
        with pytest.raises(TypeError, match="no persistence"):
            tml.save_model(object(), tmp_path / "x")
        np.savez(tmp_path / "y.npz", __class__=np.str_("Nope"))
        with pytest.raises(ValueError, match="unknown model class"):
            tml.load_model(tmp_path / "y.npz", device=CPU)

    def test_svdpp_refused_naming_the_graph_item(self, tmp_path):
        """``SVDPlusPlusModel`` (the graph library's) is no longer refused:
        a file either package saves loads in the other, every field
        equal, and the loaded model predicts the saver's predictions bit
        for bit."""
        from asyncframework_tpu.graph import svd_plus_plus
        from asyncframework_tpu_torch.graph import svd_plus_plus as t_svdpp

        args = ([0, 0, 1], [0, 1, 1], [5.0, 1.0, 4.0])
        fields = ("user_vectors", "item_vectors", "user_bias", "item_bias")
        jm = svd_plus_plus(*args, rank=2, num_iterations=5)
        tm = t_svdpp(*args, rank=2, num_iterations=5, device=CPU)
        for saver, loader, m, name in (
                (jml.save_model, tml.load_model, jm, "from_jax"),
                (tml.save_model, jml.load_model, tm, "from_port")):
            p = saver(m, tmp_path / name)
            got = (loader(p, device=CPU) if loader is tml.load_model
                   else loader(p))
            assert type(got).__name__ == "SVDPlusPlusModel"
            for f in fields:
                np.testing.assert_array_equal(getattr(got, f), getattr(m, f))
            assert got.mean == m.mean
            np.testing.assert_array_equal(got.predict([0, 1], [1, 1]),
                                          m.predict([0, 1], [1, 1]))


# --------------------------------------------------------- no silent CPU
def test_estimators_raise_without_a_card(clf_data):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    X, y = clf_data
    for make in (
            lambda: tml.StandardScaler().fit(X),
            lambda: tml.MinMaxScaler().fit(X),
            lambda: tml.Normalizer().transform(X),
            lambda: tml.HashingTF(8).transform([["a"]]),
            lambda: tml.IDF().fit(X),
            lambda: tml.ElementwiseProduct([1.0]),
            lambda: tml.ChiSqSelector(1).fit(X[:, :2] > 0, y),
            lambda: tml.NaiveBayes().fit(np.abs(X), y),
            lambda: tml.DecisionTree().fit(X, y),
            lambda: tml.RandomForest(num_trees=1).fit(X, y),
            lambda: tml.GradientBoostedTrees().fit(X, y.astype(np.float32)),
            lambda: tml.GaussianMixture(2).fit(X),
            lambda: tml.BinaryClassificationMetrics(X[:, 0], y > 0),
            lambda: tml.RegressionMetrics.of(X[:, 0], X[:, 1]),
            lambda: tml.MulticlassMetrics(y, y),
            lambda: tml.Pipeline([tml.StandardScaler(),
                                  tml.LogisticRegression()]).fit(X, y > 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
