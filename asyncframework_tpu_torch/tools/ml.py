"""The ML library on one GPU at epsilon's, mnist8m's, MovieLens-1M's,
Covertype's and 20 Newsgroups' shapes: arms, records and gates.

    python3 -m asyncframework_tpu_torch.tools.ml [--arms logreg,svm,...]

:func:`phase` runs the core's arms (below), :func:`breadth_phase` the
breadth's: ``pipeline_cv`` (a 3-fold ``CrossValidator`` over a scaler and
``LogisticRegression`` at epsilon's shape), ``trees`` (``DecisionTree``,
``RandomForest``, ``GradientBoostedTrees`` at Covertype's), ``text``
(``HashingTF`` -> ``IDF`` -> ``NaiveBayes`` at 20 Newsgroups') and
``gmm`` (``GaussianMixture`` on Covertype's continuous columns); each
function's docstring names its gates.

Every arm generates its data on the card from :data:`SEED` at a published
shape and frees it before the next one that needs other data (no corpus or
ratings file is in the repository):

- ``logreg_epsilon``: epsilon's shape (``bench.py:95-98``: 400,000 x 2,000
  f32), rows N(0, I/d), labels {0, 1} drawn from a planted ``w`` (margin
  std :data:`PLANTED_MARGIN_STD`).  ``LogisticRegression()`` at the JAX
  package's defaults (step 1.0, 100 iterations, fraction 1.0) on the
  default mesh (one rank), then again at fraction 0.1.  Gates: at 1.0,
  ``||w - w64|| <= 1e-3 ||w64||`` with ``w64`` the same 100 iterations in
  float64 on the card; at both, the last recorded loss below the first and
  one B1 launch (the logistic full form) an iteration;
- ``svm_epsilon``: ``LinearSVM(reg_param=0.01)`` (hinge through
  ``xt_coeff``, ``SquaredL2Updater``) on the same data: the float64 gate and
  one ``xt_coeff`` launch an iteration;
- ``lbfgs_epsilon``: ``LBFGS(LogisticGradient(), max_iterations=20)``:
  its final objective at most ``GradientDescent``'s after
  ``logreg_epsilon``'s 100 iterations (the JAX package's ``LBFGSSuite``
  claim, ``tests/test_ml.py:1-6``), one B1 launch an evaluation;
- ``pca_epsilon``: ``PCA(10)`` of the same rows: the captured variance
  within 1e-4 relative of the top-10 eigenvalue sum of the float64
  covariance (``torch.linalg.eigh`` on the card);
- ``kmeans_mnist8m``: mnist8m's shape (``bench.py:99-103``: 8,100,000 x
  784), f32 as the JAX package's ``KMeans`` takes it (25.4 GB), drawn
  around :data:`KM_CENTERS` planted centres.  ``KMeans(k=10)`` (20
  iterations at most, k-means++): the cost within 1e-4 relative of a
  float64 blockwise recomputation for the returned centres, below the
  seeded centres' cost (the same fit at ``max_iterations=0``), and the
  arm's peak device bytes under :data:`KM_PEAK_BYTES` (``X`` read in
  place);
- ``als_ml1m``: MovieLens-1M's shape (6,040 users x 3,706 items,
  1,000,209 observed ratings) at rank 10, noise std a quarter of the
  signal's, a tenth of the observed entries held out.  ``ALS(rank=10,
  reg=0.1, num_iterations=10)``: the held-out RMSE below half the global
  mean predictor's, and one half step equal to a float64 solve to 1e-4
  relative.

Each arm's record carries seconds, fenced iterations per second, B1
launches (captured iterations' launches over the iterations enqueued, as
``MiniBatchSGD``'s records count them) and per iteration, the peak device
bytes, the card and its gates.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from asyncframework_tpu_torch.ml import (
    ALS,
    KMeans,
    LBFGS,
    LinearSVM,
    LogisticGradient,
    LogisticRegression,
    PCA,
)
from asyncframework_tpu_torch.ml import recommendation as rec_mod
from asyncframework_tpu_torch.tools import runs

SEED = 7
EPS_N, EPS_D = 400_000, 2_000
PLANTED_MARGIN_STD = 4.0
MNIST_N, MNIST_D, KM_CENTERS = 8_100_000, 784, 10
KM_PEAK_BYTES = 40e9
ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS, ALS_RANK = 6_040, 3_706, 1_000_209, 10
ALS_NOISE = 0.25  # noise std over signal std
ALS_HOLDOUT = 0.1
W64_RTOL = 1e-3
KM_COST_RTOL = 1e-4
ALS_SOLVE_RTOL = 1e-4
PCA_RTOL = 1e-4
ARMS = ("logreg", "svm", "lbfgs", "pca", "kmeans", "als")
#: rows a block in the float64 recomputations
BLOCK_ROWS = 500_000


def _fence(dev) -> None:
    torch.cuda.synchronize(dev)


def _peak_reset(dev) -> None:
    _fence(dev)
    torch.cuda.reset_peak_memory_stats(dev)


def epsilon_data(dev):
    """epsilon's shape: rows N(0, I/d), labels {0, 1} ~ Bernoulli of the
    logistic of a planted margin."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    X = torch.randn(EPS_N, EPS_D, generator=gen, device=dev)
    X /= math.sqrt(EPS_D)
    w_star = torch.randn(EPS_D, generator=gen, device=dev) * PLANTED_MARGIN_STD
    p = torch.sigmoid(X @ w_star)
    y = (torch.rand(EPS_N, generator=gen, device=dev) < p).float()
    return X, y


def _gd64(X, y, iterations: int, coeff: Callable, reg: float = 0.0):
    """``GradientDescent``'s full-batch iterations (simple updater when
    ``reg`` is 0, else ``SquaredL2Updater``) in float64 on the card, the
    rows widened a block at a time; ``coeff(margin, y)`` gives the
    gradient's row coefficients."""
    n = X.shape[0]
    w = torch.zeros(X.shape[1], dtype=torch.float64, device=X.device)
    y64 = y.double()
    for it in range(1, iterations + 1):
        g = torch.zeros_like(w)
        for lo in range(0, n, BLOCK_ROWS):
            Xb = X[lo:lo + BLOCK_ROWS].double()
            g += Xb.T @ coeff(Xb @ w, y64[lo:lo + BLOCK_ROWS])
        lr = 1.0 / math.sqrt(it)
        w = w * (1.0 - lr * reg) - lr * g / n
    return w


def _logistic_loss64(X, y, w) -> float:
    """The mean logistic loss of ``w`` over every row, in float64."""
    n, total = X.shape[0], 0.0
    w64 = torch.as_tensor(w, dtype=torch.float64, device=X.device)
    for lo in range(0, n, BLOCK_ROWS):
        m = X[lo:lo + BLOCK_ROWS].double() @ w64
        total += float(torch.sum(torch.logaddexp(torch.zeros_like(m), m)
                                 - y[lo:lo + BLOCK_ROWS].double() * m))
    return total / n


def _sgd_record(name, card, dev, fit, iterations, form, extra):
    """Run ``fit()`` (a GradientDescent-backed estimator's fit, returning
    the model and its optimizer) with the counts from 0; the record."""
    _peak_reset(dev)
    runs.zero_counts()
    t0 = time.monotonic()
    model, opt = fit()
    _fence(dev)
    seconds = time.monotonic() - t0
    c = runs.counts()
    forms = runs.b1_forms(c)
    info = opt.last_run
    per_it = forms[form] / max(info["enqueued_iterations"], 1)
    plain = sum(v for k, v in c.items() if k.endswith("_plain"))
    losses = model.loss_history
    rec = {
        "phase": "ml", "arm": name, "card": card, "shape": [EPS_N, EPS_D],
        "seconds": seconds, "iterations": iterations,
        "graph_replays": info["graph_replays"],
        "fenced_s": info["elapsed_s"],
        "iterations_per_s": iterations / info["elapsed_s"],
        "b1_form": form, "b1_launches": forms[form],
        "b1_launches_per_iteration": per_it,
        "b1_launches_on_path": int(round(per_it * iterations)),
        "plain_calls": plain,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "peak_device_bytes": int(torch.cuda.max_memory_allocated(dev)),
        **extra,
    }
    rec["gates"] = {"one_launch_an_iteration": per_it == 1.0,
                    "no_other_b1_form": all(
                        v == 0 for f, v in forms.items() if f != form),
                    "no_plain_call": plain == 0,
                    "loss_decreased": rec["loss_last"] < rec["loss_first"],
                    "finite": bool(np.isfinite(model.weights).all())}
    return model, rec


def logreg_arms(X, y, dev, card) -> List[dict]:
    """``logreg_epsilon`` at fractions 1.0 and 0.1."""
    out = []
    for fraction in (1.0, 0.1):
        est = LogisticRegression(mini_batch_fraction=fraction)
        model, rec = _sgd_record(
            "logreg_epsilon", card, dev,
            lambda: (est.fit(X, y), est.optimizer), 100, "full",
            {"mini_batch_fraction": fraction})
        rec["b1_form"] = "masked_grad (logistic, full masked form)"
        with torch.no_grad():
            pred = model.predict(X)
            rec["train_accuracy"] = float((pred == y.int()).float().mean())
        if fraction == 1.0:
            t0 = time.monotonic()
            w64 = _gd64(X, y, 100, lambda m, yy: torch.sigmoid(m) - yy)
            _fence(dev)
            w = torch.as_tensor(model.weights, dtype=torch.float64,
                                device=dev)
            rel = float(torch.linalg.norm(w - w64) / torch.linalg.norm(w64))
            rec.update({"w_rel_err_vs_f64": rel, "f64_s":
                        time.monotonic() - t0,
                        "objective": _logistic_loss64(X, y, model.weights)})
            rec["gates"]["w_within_1e-3_of_f64"] = rel <= W64_RTOL
        out.append(rec)
    return out


def svm_arm(X, y, dev, card) -> dict:
    est = LinearSVM(reg_param=0.01)
    model, rec = _sgd_record("svm_epsilon", card, dev,
                             lambda: (est.fit(X, y), est.optimizer), 100,
                             "xt_coeff", {"reg_param": 0.01})
    t0 = time.monotonic()

    def hinge(m, yy):
        s = 2.0 * yy - 1.0
        return -s * ((1.0 - s * m) > 0).double()

    w64 = _gd64(X, y, 100, hinge, reg=0.01)
    w = torch.as_tensor(model.weights, dtype=torch.float64, device=dev)
    rel = float(torch.linalg.norm(w - w64) / torch.linalg.norm(w64))
    with torch.no_grad():
        rec["train_accuracy"] = float(
            (model.predict(X) == y.int()).float().mean())
    rec.update({"w_rel_err_vs_f64": rel, "f64_s": time.monotonic() - t0})
    rec["gates"]["w_within_1e-3_of_f64"] = rel <= W64_RTOL
    return rec


def lbfgs_arm(X, y, dev, card, gd_objective: float) -> dict:
    _peak_reset(dev)
    runs.zero_counts()
    lb = LBFGS(LogisticGradient(), max_iterations=20)
    t0 = time.monotonic()
    w, hist = lb.optimize(X, y)
    _fence(dev)
    seconds = time.monotonic() - t0
    c = runs.counts()
    forms = runs.b1_forms(c)
    evals = lb.last_run["evaluations"]
    objective = _logistic_loss64(X, y, w)
    rec = {
        "phase": "ml", "arm": "lbfgs_epsilon", "card": card,
        "shape": [EPS_N, EPS_D], "seconds": seconds,
        "iterations": lb.last_run["iterations"], "evaluations": evals,
        "iterations_per_s": lb.last_run["iterations"] / seconds,
        "b1_form": "masked_grad (logistic, full masked form)",
        "b1_launches": forms["full"],
        "b1_launches_per_evaluation": forms["full"] / max(evals, 1),
        "b1_launches_on_path": forms["full"],
        "plain_calls": sum(v for k, v in c.items() if k.endswith("_plain")),
        "objective_first": float(hist[0]), "objective": objective,
        "gd_objective_after_100": gd_objective,
        "peak_device_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }
    rec["gates"] = {
        "at_most_gd_objective": objective <= gd_objective,
        "one_launch_an_evaluation": forms["full"] == evals,
        "no_other_b1_form": all(v == 0 for f, v in forms.items()
                                if f != "full"),
        "no_plain_call": rec["plain_calls"] == 0,
        "finite": bool(np.isfinite(w).all()),
    }
    return rec


def pca_arm(X, dev, card) -> dict:
    _peak_reset(dev)
    t0 = time.monotonic()
    model = PCA(10).fit(X)
    _fence(dev)
    seconds = time.monotonic() - t0
    n, d = X.shape
    t1 = time.monotonic()
    gram = torch.zeros((d, d), dtype=torch.float64, device=dev)
    colsum = torch.zeros(d, dtype=torch.float64, device=dev)
    for lo in range(0, n, BLOCK_ROWS):
        Xb = X[lo:lo + BLOCK_ROWS].double()
        gram += Xb.T @ Xb
        colsum += Xb.sum(dim=0)
    mean = colsum / n
    cov = (gram - n * torch.outer(mean, mean)) / (n - 1)
    top = float(torch.linalg.eigvalsh(cov)[-10:].sum())
    got = float(np.sum(model.explained_variance, dtype=np.float64))
    rel = abs(got - top) / top
    rec = {
        "phase": "ml", "arm": "pca_epsilon", "card": card, "shape": [n, d],
        "k": 10, "seconds": seconds, "iterations": 1,
        "iterations_per_s": 1.0 / seconds, "b1_launches": 0,
        "b1_launches_per_iteration": 0.0,
        "captured_variance": got, "top10_eigenvalue_sum_f64": top,
        "rel_err": rel, "f64_s": time.monotonic() - t1,
        "peak_device_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }
    rec["gates"] = {"within_1e-4_of_f64": rel <= PCA_RTOL}
    return rec


def mnist8m_data(dev):
    """mnist8m's shape f32, rows around :data:`KM_CENTERS` planted centres
    (unit noise, centres N(0, I)), made a block at a time in place."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    centers = torch.randn(KM_CENTERS, MNIST_D, generator=gen, device=dev)
    X = torch.empty(MNIST_N, MNIST_D, device=dev)
    for lo in range(0, MNIST_N, BLOCK_ROWS):
        blk = X[lo:lo + BLOCK_ROWS]
        blk.normal_(generator=gen)
        lab = torch.randint(KM_CENTERS, (blk.shape[0],), generator=gen,
                            device=dev)
        blk += centers[lab]
    return X


def _kmeans_cost64(X, centers) -> float:
    """The sum of squared distances to the nearest of ``centers`` in
    float64, a block of rows at a time."""
    C = torch.as_tensor(centers, dtype=torch.float64, device=X.device)
    c2 = (C * C).sum(1)
    total = 0.0
    for lo in range(0, X.shape[0], BLOCK_ROWS):
        Xb = X[lo:lo + BLOCK_ROWS].double()
        d2 = (Xb * Xb).sum(1)[:, None] - 2.0 * (Xb @ C.T) + c2[None, :]
        total += float(torch.clamp_min(d2.amin(dim=1), 0.0).sum())
    return total


def kmeans_arm(dev, card) -> dict:
    _peak_reset(dev)
    t0 = time.monotonic()
    X = mnist8m_data(dev)
    _fence(dev)
    gen_s = time.monotonic() - t0
    runs.zero_counts()
    t0 = time.monotonic()
    model = KMeans(k=KM_CENTERS).fit(X)
    _fence(dev)
    seconds = time.monotonic() - t0
    peak = int(torch.cuda.max_memory_allocated(dev))
    seeded = KMeans(k=KM_CENTERS, max_iterations=0).fit(X)
    cost64 = _kmeans_cost64(X, model.centers)
    rel = abs(model.cost - cost64) / cost64
    c = runs.counts()
    rec = {
        "phase": "ml", "arm": "kmeans_mnist8m", "card": card,
        "shape": [MNIST_N, MNIST_D], "k": KM_CENTERS,
        "bytes": X.numel() * X.element_size(), "generate_s": gen_s,
        "seconds": seconds, "iterations": model.iterations,
        "iterations_per_s": model.iterations / seconds,
        "b1_launches": c["masked_grad"], "b1_launches_per_iteration": 0.0,
        "cost": model.cost, "cost_f64": cost64, "cost_rel_err": rel,
        "seeded_cost": seeded.cost, "peak_device_bytes": peak,
    }
    rec["gates"] = {"cost_within_1e-4_of_f64": rel <= KM_COST_RTOL,
                    "below_seeded_cost": model.cost < seeded.cost,
                    "peak_under_40GB": peak < KM_PEAK_BYTES}
    del X
    torch.cuda.empty_cache()
    return rec


def ml1m_data(dev):
    """MovieLens-1M's shape at rank :data:`ALS_RANK`: ``(R, train mask,
    held-out mask)`` dense on ``dev``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    U = torch.randn(ML1M_USERS, ALS_RANK, generator=gen, device=dev)
    V = torch.randn(ML1M_ITEMS, ALS_RANK, generator=gen, device=dev)
    signal = U @ V.T
    R = signal + ALS_NOISE * float(signal.std()) * torch.randn(
        signal.shape, generator=gen, device=dev)
    cells = torch.randperm(R.numel(), generator=gen, device=dev)
    observed = cells[:ML1M_RATINGS]
    held = observed[:int(ALS_HOLDOUT * ML1M_RATINGS)]
    train = torch.zeros(R.numel(), device=dev)
    train[observed] = 1.0
    train[held] = 0.0
    test = torch.zeros(R.numel(), device=dev)
    test[held] = 1.0
    return R, train.reshape(R.shape), test.reshape(R.shape)


def als_arm(dev, card) -> dict:
    _peak_reset(dev)
    R, train, test = ml1m_data(dev)
    t0 = time.monotonic()
    model = ALS(rank=ALS_RANK, reg=0.1, num_iterations=10).fit(R * train,
                                                               train)
    _fence(dev)
    seconds = time.monotonic() - t0
    pred = torch.as_tensor(model.user_factors, device=dev) @ torch.as_tensor(
        model.item_factors, device=dev).T
    n_test = float(test.sum())
    rmse = float(torch.sqrt((((pred - R) * test) ** 2).sum() / n_test))
    mean = float((R * train).sum() / train.sum())
    rmse_mean = float(torch.sqrt((((mean - R) * test) ** 2).sum() / n_test))
    # one half step against a float64 solve of the same normal equations
    V = torch.as_tensor(model.item_factors, device=dev)
    U32 = rec_mod._half_step(V, R * train, train, 0.1)
    V64, m64, R64 = V.double(), train.double(), (R * train).double()
    k = ALS_RANK
    A = (m64 @ (V64[:, :, None] * V64[:, None, :]).reshape(-1, k * k)
         ).reshape(-1, k, k)
    A += (0.1 * torch.clamp_min(m64.sum(1), 1.0))[:, None, None] * torch.eye(
        k, dtype=torch.float64, device=dev)
    U64 = torch.linalg.solve(A, (m64 * R64) @ V64)
    solve_rel = float(torch.linalg.norm(U32.double() - U64)
                      / torch.linalg.norm(U64))
    rec = {
        "phase": "ml", "arm": "als_ml1m", "card": card,
        "shape": [ML1M_USERS, ML1M_ITEMS], "ratings": ML1M_RATINGS,
        "train_ratings": int(train.sum()), "held_out": int(n_test),
        "rank": ALS_RANK, "seconds": seconds, "iterations": 10,
        "iterations_per_s": 10 / seconds, "b1_launches": 0,
        "b1_launches_per_iteration": 0.0, "held_out_rmse": rmse,
        "global_mean_rmse": rmse_mean, "half_step_rel_err_vs_f64": solve_rel,
        "peak_device_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }
    rec["gates"] = {"rmse_below_half_of_mean": rmse < 0.5 * rmse_mean,
                    "half_step_within_1e-4_of_f64":
                        solve_rel <= ALS_SOLVE_RTOL}
    del R, train, test, pred
    torch.cuda.empty_cache()
    return rec


# ------------------------------------------------------------- the breadth
#: UCI Covertype (581,012 x 54): 10 continuous columns, then 4 wilderness
#: and 40 soil one-hot columns; the class counts of its 7 cover types
COV_N, COV_D, COV_CONT, COV_WILD, COV_SOIL = 581_012, 54, 10, 4, 40
COV_CLASS_COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
#: the continuous columns' means and standard deviations (elevation,
#: aspect, slope, the distances to water, road and fire points, the three
#: hillshades), the planted per-class shifts scaled by these
COV_MEAN = (2959.4, 155.7, 14.1, 269.4, 46.4, 2350.1, 212.1, 223.3, 142.5,
            1980.3)
COV_SD = (280.0, 111.9, 7.5, 212.5, 58.3, 1559.3, 26.8, 19.8, 38.3, 1324.2)
COV_SHIFT, COV_WITHIN = 0.8, 0.6
FOREST_TREES, GBT_STAGES = 10, 10
#: 20 Newsgroups (18,846 documents, 20 classes; mean length 221.26 tokens
#: over 42,757 words, Yao et al. 2019, Table 1): a Zipf vocabulary, each
#: class a quarter of its tokens from its own permutation of the ranks
NG_DOCS, NG_CLASSES, NG_VOCAB, NG_MEAN_LEN = 18_846, 20, 42_757, 221.26
NG_FEATURES = 1 << 16
NG_CLASS_SHARE, NG_LEN_SIGMA = 0.25, 0.9
BREADTH_ARMS = ("pipeline_cv", "trees", "text", "gmm")
SCALER_RTOL = 1e-5
AUC_TOL = 1e-4
NB_RTOL = 1e-5
GMM_LL_RTOL = 1e-4


def _f64_col_stats(X):
    """Column means and corrected standard deviations of ``X`` in float64
    on its device, a block of rows at a time."""
    n = X.shape[0]
    s1 = torch.zeros(X.shape[1], dtype=torch.float64, device=X.device)
    s2 = torch.zeros_like(s1)
    for lo in range(0, n, BLOCK_ROWS):
        Xb = X[lo:lo + BLOCK_ROWS].double()
        s1 += Xb.sum(dim=0)
        s2 += (Xb * Xb).sum(dim=0)
    mean = s1 / n
    return mean, torch.sqrt(torch.clamp_min((s2 - n * mean * mean)
                                            / (n - 1), 0.0))


def _auc64(scores, labels) -> float:
    """The ROC area of float64 ``scores`` as the Mann-Whitney statistic,
    tied scores at their average rank."""
    _vals, inverse, counts = torch.unique(scores, return_inverse=True,
                                          return_counts=True)
    ends = torch.cumsum(counts, 0).double()
    ranks = (ends - (counts.double() - 1.0) / 2.0)[inverse]
    pos = labels > 0.5
    P, N = int(pos.sum()), int((~pos).sum())
    return (float(ranks[pos].sum()) - P * (P + 1) / 2.0) / (P * N)


def pipeline_cv_arm(X, y, dev, card) -> dict:
    """``CrossValidator`` over ``Pipeline([StandardScaler(),
    LogisticRegression(reg_param)])`` at epsilon's shape, the rows split
    with ``train_test_split``; every logistic fit's B1 launches counted.
    Gates: one B1 logistic launch an iteration in all 7 fits,
    ``best_score`` its folds' mean, the scaler within 1e-5 of float64,
    the held-out AUC within 1e-4 of a float64 recomputation (scores and
    Mann-Whitney statistic), the saved and loaded ``PipelineModel``'s
    predictions bit-equal."""
    import tempfile

    from asyncframework_tpu_torch.ml import (
        BinaryClassificationMetrics,
        CrossValidator,
        Pipeline,
        StandardScaler,
        accuracy_scorer,
        load_model,
        save_model,
        train_test_split,
    )

    _peak_reset(dev)
    fits: List[dict] = []
    fold_scores: List[float] = []

    class CountedLogisticRegression(LogisticRegression):
        def fit(self, X, y, w0=None, mesh=None):
            before = runs.b1_forms(runs.counts())
            model = super().fit(X, y, w0, mesh)
            after = runs.b1_forms(runs.counts())
            info = self.optimizer.last_run
            fits.append({"rows": int(X.shape[0]),
                         "iterations": info["iterations"],
                         "enqueued_iterations": info["enqueued_iterations"],
                         "graph_replays": info["graph_replays"],
                         **{f: after[f] - before[f] for f in after}})
            return model

    def scorer(model, Xv, yv):
        fold_scores.append(accuracy_scorer(model, Xv, yv))
        return fold_scores[-1]

    runs.zero_counts()
    t0 = time.monotonic()
    Xtr, ytr, Xte, yte = train_test_split(X, y, 0.25, seed=SEED)
    grid = {"reg_param": [0.0, 0.01]}
    cv = CrossValidator(lambda reg_param: Pipeline([
        StandardScaler(), CountedLogisticRegression(reg_param=reg_param)]),
        grid, scorer, num_folds=3).fit(Xtr, ytr)
    _fence(dev)
    seconds = time.monotonic() - t0
    c = runs.counts()
    best = cv.best_model
    scaler, logreg = best.transformers[0], best.model
    # the best candidate's folds' scores, in the candidates' order
    i_best = [p for p, _s in cv.all_scores].index(cv.best_params)
    best_folds = fold_scores[3 * i_best:3 * i_best + 3]
    mean64, std64 = _f64_col_stats(Xtr)
    mean_err = float(torch.max(torch.abs(torch.as_tensor(
        scaler.mean_, device=dev) - mean64)) / torch.max(std64))
    std_err = float(torch.max(torch.abs(torch.as_tensor(
        scaler.std_, device=dev) - std64) / std64))
    scores = logreg.margin(best._apply(Xte))
    auc = BinaryClassificationMetrics(scores, yte).area_under_roc()
    w64 = torch.as_tensor(logreg.weights, dtype=torch.float64, device=dev)
    s64 = torch.as_tensor(np.where(scaler.std_ > 0, scaler.std_, 1.0),
                          dtype=torch.float64, device=dev)
    m64 = torch.as_tensor(scaler.mean_, dtype=torch.float64, device=dev)
    scores64 = torch.cat([((Xte[lo:lo + BLOCK_ROWS].double() - m64) / s64)
                          @ w64 for lo in range(0, Xte.shape[0], BLOCK_ROWS)]
                         ) + logreg.intercept
    auc64 = _auc64(scores64, yte)
    with tempfile.TemporaryDirectory() as tmp:
        loaded = load_model(save_model(best, f"{tmp}/pipeline"))
    same = bool(torch.equal(loaded.predict(Xte), best.predict(Xte)))
    # B1 launches over the iterations that enqueued launches (a captured
    # iteration's launch is counted in its warm-up and its capture), as
    # ``MiniBatchSGD``'s records count them
    per_it = [f["full"] / max(f["enqueued_iterations"], 1) for f in fits]
    rec = {
        "phase": "ml_breadth", "arm": "pipeline_cv_epsilon", "card": card,
        "shape": [EPS_N, EPS_D], "train_rows": int(Xtr.shape[0]),
        "test_rows": int(Xte.shape[0]), "seconds": seconds,
        "fits": len(fits), "fits_per_s": len(fits) / seconds,
        "iterations": sum(f["iterations"] for f in fits),
        "enqueued_iterations": sum(f["enqueued_iterations"] for f in fits),
        "graph_replays": sum(f["graph_replays"] for f in fits),
        "b1_form": "masked_grad (logistic, full masked form)",
        "b1_launches": sum(f["full"] for f in fits),
        "b1_launches_per_iteration": per_it,
        "b1_launches_on_path": int(round(sum(
            p * f["iterations"] for p, f in zip(per_it, fits)))),
        "plain_calls": sum(v for k, v in c.items() if k.endswith("_plain")),
        "best_params": cv.best_params, "best_score": cv.best_score,
        "all_scores": [[p, s] for p, s in cv.all_scores],
        "best_fold_scores": best_folds,
        "scaler_mean_err_over_std": mean_err, "scaler_std_rel_err": std_err,
        "held_out_auc": auc, "held_out_auc_f64": auc64,
        "held_out_accuracy": accuracy_scorer(best, Xte, yte),
        "peak_device_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }
    rec["gates"] = {
        "one_launch_an_iteration_every_fit": len(fits) == 7 and all(
            p == 1.0 for p in per_it),
        "no_other_b1_form": all(f[k] == 0 for f in fits
                                for k in ("saga_grad", "saga_slots_grad",
                                          "xt_coeff")),
        "no_plain_call": rec["plain_calls"] == 0,
        "best_score_is_its_folds_mean":
            cv.best_score == float(np.mean(best_folds)),
        "scaler_within_1e-5_of_f64": max(mean_err, std_err) <= SCALER_RTOL,
        "auc_within_1e-4_of_f64": abs(auc - auc64) <= AUC_TOL,
        "reloaded_predictions_bit_equal": same,
    }
    del Xtr, ytr, Xte, yte, cv, best, loaded, scores, scores64
    torch.cuda.empty_cache()
    return rec


def covtype_data(dev):
    """Covertype's shape on ``dev``: labels with its class counts in a
    seeded order; the continuous columns at its means and scales, shifted
    per class; one wilderness area and one soil type a row, each drawn
    from its class's own distribution."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k = len(COV_CLASS_COUNTS)
    labels = torch.repeat_interleave(
        torch.arange(k, device=dev),
        torch.tensor(COV_CLASS_COUNTS, device=dev))
    labels = labels[torch.randperm(COV_N, generator=gen, device=dev)]
    mean = torch.tensor(COV_MEAN, device=dev)
    sd = torch.tensor(COV_SD, device=dev)
    shift = torch.randn(k, COV_CONT, generator=gen, device=dev) * COV_SHIFT
    X = torch.zeros(COV_N, COV_D, device=dev)
    X[:, :COV_CONT] = mean + sd * (shift[labels] + COV_WITHIN * torch.randn(
        COV_N, COV_CONT, generator=gen, device=dev))
    col = COV_CONT
    for width, power in ((COV_WILD, 1.0), (COV_SOIL, 2.0)):
        # Dirichlet-like class distributions: normalised exponentials
        e = (-torch.log(torch.rand(k, width, generator=gen, device=dev))
             ) ** power
        p = e / e.sum(dim=1, keepdim=True)
        pick = torch.multinomial(p[labels], 1, generator=gen)
        X.scatter_(1, col + pick, 1.0)
        col += width
    return X, labels


def _timed(dev, fn):
    t0 = time.monotonic()
    out = fn()
    _fence(dev)
    return out, time.monotonic() - t0


def trees_arm(X, labels, dev, card) -> dict:
    """``DecisionTree`` (twice), ``RandomForest`` and one-against-rest
    ``GradientBoostedTrees`` (twice) at Covertype's shape.  Gates: the
    card's bins and root histogram equal numpy's ``searchsorted`` and
    ``bincount``, both refits identical, training accuracy above the
    majority class's share, the boosting loss falling every stage, the
    card's predictions (and margins) the host traversal's."""
    from asyncframework_tpu_torch.ml import (
        DecisionTree,
        GradientBoostedTrees,
        RandomForest,
    )
    from asyncframework_tpu_torch.ml import tree as tree_mod

    _peak_reset(dev)
    t0 = time.monotonic()
    Xh = X.cpu().numpy()
    yh = labels.cpu().numpy()
    # the root histogram against the host: numpy's binning and bincount
    thr = tree_mod.quantile_bins(Xh, 32)
    bins = tree_mod.bin_features(X, thr)
    root = tree_mod._class_histogram(
        bins, torch.zeros(COV_N, dtype=torch.int64, device=dev), labels, 1,
        32, 7).cpu().numpy().ravel()
    bins_h = np.stack([np.searchsorted(thr[f], Xh[:, f], "left")
                       for f in range(COV_D)], axis=1)
    flat = (np.arange(COV_D)[None, :] * 32 + bins_h) * 7 + yh[:, None]
    root_h = np.bincount(flat.ravel(), minlength=COV_D * 32 * 7)
    bins_equal = bool(np.array_equal(bins.cpu().numpy(), bins_h))
    del bins, flat, bins_h
    check_s = time.monotonic() - t0
    est = DecisionTree(max_depth=5, max_bins=32)
    tree, tree_s = _timed(dev, lambda: est.fit(X, labels))
    split = est.last_run
    again, refit_s = _timed(dev, lambda: DecisionTree(
        max_depth=5, max_bins=32).fit(X, labels))
    forest, forest_s = _timed(dev, lambda: RandomForest(
        num_trees=FOREST_TREES, max_depth=5, max_bins=32, seed=SEED).fit(
            X, labels))
    top = int(np.argmax(COV_CLASS_COUNTS))
    yb = (labels == top).float()
    gbt, gbt_s = _timed(dev, lambda: GradientBoostedTrees(
        "classification", num_iterations=GBT_STAGES).fit(X, yb))
    # the stages are regression trees on the residuals: their int64
    # fixed-point sums make a second fit grow the same stages
    gbt2, gbt_refit_s = _timed(dev, lambda: GradientBoostedTrees(
        "classification", num_iterations=GBT_STAGES).fit(X, yb))
    # the training loss after each stage: LogLoss on the +-1 margins
    y_pm = 2.0 * yb.double() - 1.0
    raw = torch.full((COV_N,), gbt.init_value, dtype=torch.float32,
                     device=dev)
    losses = []
    for t in gbt.trees:
        raw = raw + gbt.learning_rate * t.predict(X)
        losses.append(float(torch.mean(torch.log1p(torch.exp(
            -2.0 * y_pm * raw.double())))))
    acc = {name: float((m.predict(X) == labels).double().mean())
           for name, m in (("tree", tree), ("forest", forest))}
    gbt_acc = float((gbt.predict(X) == yb.long()).double().mean())
    host_equal = {name: bool(np.array_equal(m.predict(X).cpu().numpy(),
                                            m.predict(Xh)))
                  for name, m in (("tree", tree), ("forest", forest),
                                  ("gbt", gbt))}
    host_equal["gbt_raw"] = bool(np.array_equal(
        gbt.raw_predict(X).cpu().numpy(), gbt.raw_predict(Xh)))
    majority = max(COV_CLASS_COUNTS) / COV_N
    fit_s = tree_s + refit_s + forest_s + gbt_s + gbt_refit_s

    def same_tree(a, b):
        return all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in ("feature", "threshold", "prediction"))

    rec = {
        "phase": "ml_breadth", "arm": "trees_covtype", "card": card,
        "shape": [COV_N, COV_D], "classes": len(COV_CLASS_COUNTS),
        "seconds": time.monotonic() - t0, "check_s": check_s,
        "tree_s": tree_s, "tree_refit_s": refit_s,
        "tree_host_copy_s": split["host_copy_s"],
        "tree_quantile_s": split["quantile_s"], "tree_bin_s": split["bin_s"],
        "tree_histogram_s": split["histogram_s"],
        "tree_split_search_s": split["split_search_s"],
        "forest_s": forest_s, "forest_trees": FOREST_TREES, "gbt_s": gbt_s,
        "gbt_refit_s": gbt_refit_s, "gbt_stages": GBT_STAGES, "fits": 5,
        "fits_per_s": 5 / fit_s,
        "trees_per_s": (2 + FOREST_TREES + 2 * GBT_STAGES) / fit_s,
        "b1_launches": 0, "b1_launches_per_iteration": 0.0,
        "train_accuracy": acc, "majority_share": majority,
        "gbt_one_vs_rest_class": top, "gbt_train_accuracy": gbt_acc,
        "gbt_losses": losses,
        "peak_device_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }
    rec["gates"] = {
        "bins_equal_numpy": bins_equal,
        "root_histogram_equal_bincount": bool(np.array_equal(root, root_h)),
        "refit_identical": same_tree(tree, again),
        "gbt_refit_identical": (
            len(gbt.trees) == len(gbt2.trees)
            and gbt.init_value == gbt2.init_value
            and all(same_tree(a, b) for a, b in zip(gbt.trees, gbt2.trees))),
        "tree_above_majority": acc["tree"] > majority,
        "forest_above_majority": acc["forest"] > majority,
        "gbt_loss_falling": all(b < a for a, b in zip(losses, losses[1:])),
        **{f"{k}_card_equals_host": v for k, v in host_equal.items()},
    }
    return rec


def gmm_arm(X, dev, card) -> dict:
    """``GaussianMixture(k=7)`` on Covertype's 10 continuous columns.
    Gates: no EM step's log-likelihood below the last's by more than
    1e-6 of it; the returned parameters' log-likelihood (the model's own
    is the last step's starting point's) by the port's f32 E-step within
    1e-4 of float64 (``torch.distributions``' density, independent of
    ``ml/mixture.py``), and not below the last step's."""
    from asyncframework_tpu_torch.ml import GaussianMixture

    _peak_reset(dev)
    Xc = X[:, :COV_CONT].contiguous()
    est = GaussianMixture(k=len(COV_CLASS_COUNTS), seed=SEED)
    model, seconds = _timed(dev, lambda: est.fit(Xc))
    lls = est.last_run["log_likelihoods"]
    # the returned parameters' log-likelihood: the port's f32 E-step
    # against float64 densities from torch.distributions
    ll32 = float(torch.logsumexp(model._log_resp(Xc), dim=1).sum())
    f64 = dict(dtype=torch.float64, device=dev)
    mvn = torch.distributions.MultivariateNormal(
        torch.as_tensor(model.means, **f64),
        covariance_matrix=torch.as_tensor(model.covariances, **f64))
    log_w = torch.log(torch.as_tensor(model.weights, **f64))
    ll64 = float(sum(torch.logsumexp(
        mvn.log_prob(rows.double()[:, None, :]) + log_w, dim=1).sum()
        for rows in torch.split(Xc, 1 << 16)))
    tol = 1e-6 * abs(lls[0])
    rec = {
        "phase": "ml_breadth", "arm": "gmm_covtype", "card": card,
        "shape": [COV_N, COV_CONT], "k": len(COV_CLASS_COUNTS),
        "seconds": seconds, "iterations": len(lls),
        "iterations_per_s": len(lls) / seconds, "b1_launches": 0,
        "b1_launches_per_iteration": 0.0, "log_likelihoods": lls,
        "log_likelihood": model.log_likelihood,
        "returned_ll_f32": ll32, "returned_ll_f64": ll64,
        "returned_ll_rel_err": abs(ll32 - ll64) / abs(ll64),
        "monotone_tol": tol,
        "peak_device_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }
    rec["gates"] = {
        "ll_never_falls": all(b >= a - tol for a, b in zip(lls, lls[1:])),
        "returned_ll_within_1e-4_of_f64":
            rec["returned_ll_rel_err"] <= GMM_LL_RTOL,
        "returned_not_below_last_step": ll64 >= model.log_likelihood - tol,
        "finite": bool(np.isfinite(model.means).all()
                       and np.isfinite(model.covariances).all()),
    }
    return rec


def ng_corpus(dev):
    """20 Newsgroups' shape: ``(docs, labels)``, each document an array of
    word strings (token ids drawn on ``dev``, the strings on the host)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rs = np.random.default_rng(SEED)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = np.array(["".join(rs.choice(letters, rs.integers(2, 8)))
                      + np.base_repr(i, 36).lower()
                      for i in range(NG_VOCAB)], dtype=object)
    rank_p = 1.0 / torch.arange(1, NG_VOCAB + 1, device=dev,
                                dtype=torch.float64)
    cdf = torch.cumsum(rank_p / rank_p.sum(), 0)
    cdf[-1] = 1.0
    perms = torch.stack([torch.randperm(NG_VOCAB, generator=gen, device=dev)
                         for _ in range(NG_CLASSES)])
    labels = torch.randint(NG_CLASSES, (NG_DOCS,), generator=gen, device=dev)
    mu = math.log(NG_MEAN_LEN) - NG_LEN_SIGMA ** 2 / 2
    lengths = torch.clamp_min(torch.round(torch.exp(
        mu + NG_LEN_SIGMA * torch.randn(NG_DOCS, generator=gen, device=dev,
                                        dtype=torch.float64))), 1).long()
    doc_of = torch.repeat_interleave(torch.arange(NG_DOCS, device=dev),
                                     lengths)
    T = int(lengths.sum())
    ranks = torch.clamp_max(torch.searchsorted(cdf, torch.rand(
        T, generator=gen, device=dev, dtype=torch.float64)), NG_VOCAB - 1)
    own = torch.rand(T, generator=gen, device=dev) < NG_CLASS_SHARE
    ids = torch.where(own, perms[labels[doc_of], ranks], ranks)
    tokens = words[ids.cpu().numpy()]
    docs = np.split(tokens, np.cumsum(lengths.cpu().numpy())[:-1])
    return docs, labels, T


def text_arm(dev, card) -> dict:
    """``HashingTF(2^16)`` -> ``IDF`` -> multinomial ``NaiveBayes`` at 20
    Newsgroups' shape (a 4.9 GB dense count matrix).  Gates: the counts'
    total the token count, the naive Bayes parameters and
    log-likelihoods within 1e-5 of the same fit in float64, accuracy
    above 1/20."""
    from asyncframework_tpu_torch.ml import (
        IDF,
        HashingTF,
        MulticlassMetrics,
        NaiveBayes,
    )

    _peak_reset(dev)
    t0 = time.monotonic()
    docs, labels, T = ng_corpus(dev)
    gen_s = time.monotonic() - t0
    htf = HashingTF(NG_FEATURES)
    tf, tf_s = _timed(dev, lambda: htf.transform(docs))
    idf, idf_s = _timed(dev, lambda: IDF().fit(tf))
    tfidf = idf.transform(tf)
    nb, nb_s = _timed(dev, lambda: NaiveBayes().fit(tfidf, labels,
                                                    num_classes=NG_CLASSES))
    ll = nb.predict_log_likelihood(tfidf)
    pred = torch.argmax(ll, dim=1)
    acc = MulticlassMetrics(pred, labels, NG_CLASSES).accuracy
    total = float(tf.sum(dtype=torch.float64))
    # the same fit in float64 from the same counts
    n = tf.shape[0]
    df = (tf > 0).sum(dim=0).double()
    idf64 = torch.log((n + 1.0) / (df + 1.0))
    X64 = tf.double() * idf64[None, :]
    del tf
    counts = torch.bincount(labels, minlength=NG_CLASSES).double()
    feat = torch.zeros((NG_CLASSES, NG_FEATURES), dtype=torch.float64,
                       device=dev).index_add_(0, labels, X64)
    log_theta64 = torch.log(feat + 1.0) - torch.log(
        feat.sum(dim=1, keepdim=True) + NG_FEATURES)
    log_pi64 = torch.log(counts) - torch.log(counts.sum())
    ll64 = log_pi64 + X64 @ log_theta64.T
    theta_err = float(torch.max(torch.abs(nb.log_theta.double()
                                          - log_theta64))
                      / torch.max(torch.abs(log_theta64)))
    ll_err = float(torch.max(torch.abs(ll.double() - ll64))
                   / torch.max(torch.abs(ll64)))
    rec = {
        "phase": "ml_breadth", "arm": "text_20ng", "card": card,
        "shape": [NG_DOCS, NG_FEATURES], "classes": NG_CLASSES,
        "vocabulary": NG_VOCAB, "tokens": T, "mean_length": T / NG_DOCS,
        "dense_bytes": NG_DOCS * NG_FEATURES * 4, "generate_s": gen_s,
        "host_hash_s": htf.last_run["host_hash_s"],
        "hashing_tf_s": tf_s, "idf_s": idf_s, "naive_bayes_s": nb_s,
        "seconds": time.monotonic() - t0, "fits": 2,
        "fits_per_s": 2 / (idf_s + nb_s), "b1_launches": 0,
        "b1_launches_per_iteration": 0.0, "train_accuracy": acc,
        "count_total": total, "log_theta_rel_err_vs_f64": theta_err,
        "log_likelihood_rel_err_vs_f64": ll_err,
        "peak_device_bytes": int(torch.cuda.max_memory_allocated(dev)),
    }
    rec["gates"] = {
        "count_total_is_token_count": total == T,
        "tokens_hashed": htf.last_run["tokens"] == T,
        "naive_bayes_within_1e-5_of_f64": max(theta_err, ll_err) <= NB_RTOL,
        "accuracy_above_chance": acc > 1.0 / NG_CLASSES,
    }
    del tfidf, X64, ll, ll64, feat
    torch.cuda.empty_cache()
    return rec


def breadth_phase(dev, card: str, arms=BREADTH_ARMS,
                  emit=print) -> Dict[str, object]:
    """Run the breadth ``arms`` on ``dev``, one JSON line an arm; raises
    if a gate failed.  Returns ``{"records": [...], "launches": {form: B1
    launches on the path}}``."""
    recs: List[dict] = []

    def done(rec):
        rec["ok"] = all(rec["gates"].values())
        emit(json.dumps(rec))
        recs.append(rec)

    if "pipeline_cv" in arms:
        X, y = epsilon_data(dev)
        done(pipeline_cv_arm(X, y, dev, card))
        del X, y
        torch.cuda.empty_cache()
    if {"trees", "gmm"} & set(arms):
        X, labels = covtype_data(dev)
        if "trees" in arms:
            done(trees_arm(X, labels, dev, card))
        if "gmm" in arms:
            done(gmm_arm(X, dev, card))
        del X, labels
        torch.cuda.empty_cache()
    if "text" in arms:
        done(text_arm(dev, card))
    failed = [(r["arm"], k) for r in recs for k, v in r["gates"].items()
              if not v]
    if failed:
        raise RuntimeError(f"ml breadth gates failed: {failed}")
    return {"records": recs, "launches": {"masked_grad_logistic": sum(
        r["b1_launches_on_path"] for r in recs
        if r["arm"] == "pipeline_cv_epsilon")}}


def phase(dev, card: str, arms=ARMS, emit=print) -> Dict[str, object]:
    """Run ``arms`` on ``dev``, emitting one JSON line an arm; raises if a
    gate failed.  Returns ``{"records": [...], "launches": {form: B1
    launches on the path}}``."""
    recs: List[dict] = []

    def done(rec):
        rec["ok"] = all(rec["gates"].values())
        emit(json.dumps(rec))
        recs.append(rec)

    if {"logreg", "svm", "lbfgs", "pca"} & set(arms):
        X, y = epsilon_data(dev)
        gd_objective = None
        if "logreg" in arms or "lbfgs" in arms:
            for rec in logreg_arms(X, y, dev, card):
                gd_objective = rec.get("objective", gd_objective)
                done(rec)
        if "svm" in arms:
            done(svm_arm(X, y, dev, card))
        if "lbfgs" in arms:
            done(lbfgs_arm(X, y, dev, card, gd_objective))
        if "pca" in arms:
            done(pca_arm(X, dev, card))
        del X, y
        torch.cuda.empty_cache()
    if "kmeans" in arms:
        done(kmeans_arm(dev, card))
    if "als" in arms:
        done(als_arm(dev, card))
    launches = {"masked_grad_logistic": sum(
        r["b1_launches_on_path"] for r in recs
        if r["arm"] in ("logreg_epsilon", "lbfgs_epsilon")),
        "xt_coeff": sum(r["b1_launches_on_path"] for r in recs
                        if r["arm"] == "svm_epsilon")}
    failed = [(r["arm"], k) for r in recs for k, v in r["gates"].items()
              if not v]
    if failed:
        raise RuntimeError(f"ml gates failed: {failed}")
    return {"records": recs, "launches": launches}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", default=",".join(ARMS + BREADTH_ARMS),
                    help="comma-separated subset of "
                         f"{','.join(ARMS + BREADTH_ARMS)}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools.ml: no CUDA device")
    import subprocess

    from asyncframework_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arms = args.arms.split(",")
    dev = torch.device("cuda", 0)
    t0 = time.monotonic()
    out = phase(dev, card, [a for a in arms if a in ARMS])
    t1 = time.monotonic()
    breadth = breadth_phase(dev, card, [a for a in arms
                                        if a in BREADTH_ARMS])
    print(json.dumps({"phase": "ml_total", "seconds": t1 - t0,
                      "breadth_seconds": time.monotonic() - t1,
                      "launches": out["launches"],
                      "breadth_launches": breadth["launches"]}), flush=True)


if __name__ == "__main__":
    main()
