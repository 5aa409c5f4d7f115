"""The ML library on one GPU at epsilon's, mnist8m's and MovieLens-1M's
shapes: arms, records and gates.

    python3 -m asyncframework_tpu_torch.tools.ml [--arms logreg,svm,...]

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
    ap.add_argument("--arms", default=",".join(ARMS),
                    help=f"comma-separated subset of {','.join(ARMS)}")
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
    t0 = time.monotonic()
    out = phase(torch.device("cuda", 0), card, args.arms.split(","))
    print(json.dumps({"phase": "ml_total", "seconds": time.monotonic() - t0,
                      "launches": out["launches"]}), flush=True)


if __name__ == "__main__":
    main()
