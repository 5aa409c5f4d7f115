"""Latent Dirichlet Allocation by batch variational EM.

Counterpart of ``asyncframework_tpu/ml/lda.py`` (parity:
``mllib/.../clustering/LDA.scala``, ``EMLDAOptimizer`` /
``OnlineLDAOptimizer``): topic distributions over a vocabulary, document
mixtures, Dirichlet priors alpha (document-topic) and eta (topic-word).
The variational E-step is batched over documents -- each fixed-point
iteration two (D, K) x (K, V) products -- and the M-step's sufficient
statistics one more, on a device; the term-count matrix is dense.  The
initial topics come from ``numpy.random.default_rng(seed)``, as in the
JAX package, so both fit from the same state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from asyncframework_tpu_torch.ml.stat import on_device


def _exp_elog_dirichlet(x: torch.Tensor) -> torch.Tensor:
    """exp(E[log theta]) for Dirichlet rows: digamma(x) - digamma(sum x)."""
    return torch.exp(torch.special.digamma(x)
                     - torch.special.digamma(x.sum(dim=1, keepdim=True)))


def _e_step(X, exp_elog_beta, alpha: float, n_iter: int):
    """Batched variational fixed point: ``(gamma (D, K), sstats (K, V))``."""
    D = X.shape[0]
    K = exp_elog_beta.shape[0]
    gamma = torch.full((D, K), 1.0, dtype=torch.float32, device=X.device)
    for _ in range(n_iter):
        elog_t = _exp_elog_dirichlet(gamma)          # (D, K)
        phinorm = elog_t @ exp_elog_beta + 1e-30     # (D, V)
        gamma = alpha + elog_t * ((X / phinorm) @ exp_elog_beta.T)
    elog_t = _exp_elog_dirichlet(gamma)
    phinorm = elog_t @ exp_elog_beta + 1e-30
    sstats = elog_t.T @ (X / phinorm) * exp_elog_beta
    return gamma, sstats


@dataclass
class LDAModel:
    topics: np.ndarray        # (K, V) normalized topic-word distributions
    doc_topics: np.ndarray    # (D, K) normalized training doc mixtures
    alpha: float
    log_perplexity_history: np.ndarray

    @property
    def k(self) -> int:
        return self.topics.shape[0]

    def describe_topics(self, max_terms: int = 10):
        """[(term indices, weights)] per topic, weight-descending
        (``LDAModel.describeTopics`` parity)."""
        out = []
        for k in range(self.k):
            order = np.argsort(-self.topics[k])[:max_terms]
            out.append((order, self.topics[k][order]))
        return out

    def transform(self, X, n_iter: int = 50, device=None) -> np.ndarray:
        """Document-topic mixtures of new documents, inferred on
        ``device`` (the CUDA device by default; raises without one)."""
        Xd = on_device(X, device)
        lam = torch.as_tensor(self.topics, dtype=torch.float32,
                              device=Xd.device) + 1e-12
        exp_elog_beta = lam / lam.sum(dim=1, keepdim=True)
        gamma, _ = _e_step(Xd, exp_elog_beta, float(self.alpha), n_iter)
        g = gamma.cpu().numpy()
        return g / g.sum(axis=1, keepdims=True)


class LDA:
    """``new LDA().setK(k).run(corpus)`` analog (batch variational EM)."""

    def __init__(
        self,
        k: int,
        max_iterations: int = 50,
        doc_concentration: float = None,
        topic_concentration: float = 1.01,
        e_step_iters: int = 30,
        seed: int = 0,
    ):
        if k < 2:
            raise ValueError("k must be >= 2")
        if max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")
        self.k = k
        self.max_iterations = max_iterations
        # the reference's EM default is alpha = 50/k + 1; as in the JAX
        # package, 1/k
        self.alpha = doc_concentration if doc_concentration is not None \
            else 1.0 / k
        self.eta = topic_concentration
        self.e_iters = e_step_iters
        self.seed = seed

    def fit(self, X, device=None) -> LDAModel:
        """X: (D, V) term-count matrix (dense; counts, not tf-idf), on
        ``device`` (the CUDA device by default; raises without one)."""
        Xd = on_device(X, device)
        V = Xd.shape[1]
        rs = np.random.default_rng(self.seed)
        lam = torch.from_numpy(
            rs.gamma(100.0, 0.01, size=(self.k, V)).astype(np.float32)
        ).to(Xd.device)
        total_tokens = float(torch.sum(Xd))
        hist = []
        gamma = None
        for _ in range(self.max_iterations):
            exp_elog_beta = _exp_elog_dirichlet(lam)
            gamma, sstats = _e_step(Xd, exp_elog_beta, self.alpha,
                                    self.e_iters)
            lam = self.eta + sstats  # M-step
            # variational bound proxy: per-token log likelihood
            beta = lam / lam.sum(dim=1, keepdim=True)
            theta = gamma / gamma.sum(dim=1, keepdim=True)
            ll = torch.sum(Xd * torch.log(theta @ beta + 1e-30))
            hist.append(-float(ll) / total_tokens)
        beta = (lam / lam.sum(dim=1, keepdim=True)).cpu().numpy()
        g = gamma.cpu().numpy()
        return LDAModel(
            topics=beta,
            doc_topics=g / g.sum(axis=1, keepdims=True),
            alpha=self.alpha,
            log_perplexity_history=np.asarray(hist),
        )
