"""Word2Vec: skip-gram embeddings trained on a device.

Counterpart of ``asyncframework_tpu/ml/word2vec.py`` (parity:
``mllib/.../feature/Word2Vec.scala`` -- skip-gram embeddings with windowed
contexts, a min-count vocabulary, ``findSynonyms`` by cosine).  As in the
JAX package, training is skip-gram with negative sampling (the reference's
hierarchical softmax walks a Huffman tree a word, which does not batch):
a step is embedding gathers, a batched dot-product sigmoid, and the
gradient scattered back into the rows (:func:`_sgns_step`, the analytic
gradient of the JAX package's ``loss_fn``).

The vocabulary, the per-epoch shuffles and the initial input vectors come
from ``numpy.random.default_rng(seed)``, as in the JAX package, so both
start from the same state; the negatives (unigram^(3/4)) are drawn from a
``torch.Generator`` seeded with ``seed`` where the JAX package draws them
with threefry.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

import numpy as np
import torch

from asyncframework_tpu_torch.utils.devices import resolve_devices


class Word2VecModel:
    def __init__(self, vocab: List[str], vectors: np.ndarray):
        self.vocab = vocab
        self.vectors = vectors  # (V, d)
        self._index = {w: i for i, w in enumerate(vocab)}
        norms = np.linalg.norm(vectors, axis=1, keepdims=True)
        self._unit = vectors / np.maximum(norms, 1e-12)

    def __contains__(self, word: str) -> bool:
        return word in self._index

    def _idx(self, word: str) -> int:
        if word not in self._index:
            raise KeyError(f"word {word!r} not in vocabulary")
        return self._index[word]

    def transform(self, word: str) -> np.ndarray:
        return self.vectors[self._idx(word)]

    def similarity(self, a: str, b: str) -> float:
        return float(self._unit[self._idx(a)] @ self._unit[self._idx(b)])

    def find_synonyms(self, word: str, num: int) -> List[tuple]:
        """Top-``num`` (word, cosine) excluding the query (reference API)."""
        q = self._unit[self._idx(word)]
        sims = self._unit @ q
        order = np.argsort(-sims)
        out = []
        for i in order:
            if self.vocab[i] == word:
                continue
            out.append((self.vocab[i], float(sims[i])))
            if len(out) == num:
                break
        return out


def _sgns_step(W_in, W_out, centers, contexts, negs, lr):
    """One SGD step of skip-gram negative sampling in place: ``(loss)``.

    loss = -(mean_b log s(v_b.u_b) + mean_b sum_k valid_bk log s(-v_b.u_bk)),
    with ``v = W_in[centers]``, ``u = W_out[contexts]``, the negatives'
    ``W_out[negs]``, and a negative equal to its pair's context left out
    (``valid``).  Its gradient, scattered into the gathered rows (repeated
    rows add), is the JAX package's ``jax.grad`` of that loss."""
    B = centers.shape[0]
    v = W_in[centers]                          # (B, d)
    u_pos = W_out[contexts]                    # (B, d)
    u_neg = W_out[negs]                        # (B, K, d)
    pos = torch.sum(v * u_pos, dim=1)
    neg = torch.einsum("bd,bkd->bk", v, u_neg)
    valid = (negs != contexts[:, None]).to(neg.dtype)
    loss = -(torch.mean(torch.nn.functional.logsigmoid(pos))
             + torch.mean(torch.sum(torch.nn.functional.logsigmoid(-neg)
                                    * valid, dim=1)))
    dpos = -(1.0 - torch.sigmoid(pos)) / B     # dloss / dpos
    dneg = torch.sigmoid(neg) * valid / B      # dloss / dneg
    g_v = dpos[:, None] * u_pos + torch.einsum("bk,bkd->bd", dneg, u_neg)
    g_pos = dpos[:, None] * v
    g_neg = dneg[:, :, None] * v[:, None, :]
    W_in.index_add_(0, centers, g_v, alpha=-lr)
    W_out.index_add_(0, contexts, g_pos, alpha=-lr)
    W_out.index_add_(0, negs.reshape(-1), g_neg.reshape(-1, v.shape[1]),
                     alpha=-lr)
    return loss


class Word2Vec:
    def __init__(
        self,
        vector_size: int = 64,
        window: int = 5,
        min_count: int = 2,
        negative: int = 5,
        learning_rate: float = 0.25,
        num_iterations: int = 3,
        batch_size: int = 512,
        seed: int = 0,
    ):
        if vector_size < 1 or window < 1 or negative < 1:
            raise ValueError("vector_size, window, negative must be >= 1")
        if batch_size < 1 or num_iterations < 1:
            raise ValueError("batch_size and num_iterations must be >= 1")
        self.vector_size = vector_size
        self.window = window
        self.min_count = min_count
        self.negative = negative
        self.lr = learning_rate
        self.epochs = num_iterations
        self.batch_size = batch_size
        self.seed = seed

    def _pairs(self, sentences, index) -> np.ndarray:
        pairs = []
        for sent in sentences:
            ids = [index[w] for w in sent if w in index]
            for i, c in enumerate(ids):
                lo = max(0, i - self.window)
                hi = min(len(ids), i + self.window + 1)
                for j in range(lo, hi):
                    if j != i:
                        pairs.append((c, ids[j]))
        return np.asarray(pairs, np.int64)

    def fit(self, sentences: Sequence[Sequence[str]],
            device=None) -> Word2VecModel:
        """Train on ``device`` (the CUDA device by default; raises without
        one)."""
        dev = resolve_devices(None if device is None else [device])[0]
        freq = Counter(w for s in sentences for w in s)
        vocab = sorted(w for w, c in freq.items() if c >= self.min_count)
        if len(vocab) < 2:
            raise ValueError(
                "vocabulary needs >= 2 words above min_count"
            )
        index = {w: i for i, w in enumerate(vocab)}
        V, d = len(vocab), self.vector_size
        pairs = self._pairs(sentences, index)
        if len(pairs) == 0:
            raise ValueError("no (center, context) pairs within the window")

        rs = np.random.default_rng(self.seed)
        B = min(self.batch_size, len(pairs))

        def epoch_batches() -> np.ndarray:
            """A fresh shuffle and remainder wrap each epoch: a fixed wrap
            would give the same pairs double weight every epoch."""
            perm = rs.permutation(len(pairs))
            p = pairs[perm]
            r = len(p) % B
            if r:
                p = np.concatenate([p, p[: B - r]])
            return p.reshape(len(p) // B, B, 2)

        # negative-sampling distribution: unigram^(3/4)
        counts = np.asarray([freq[w] for w in vocab], np.float64) ** 0.75
        neg_p = torch.tensor(counts / counts.sum(), dtype=torch.float32,
                             device=dev)
        W_in = torch.tensor((rs.random((V, d)) - 0.5) / d,
                            dtype=torch.float32, device=dev)
        W_out = torch.zeros((V, d), dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        K = self.negative
        for _ in range(self.epochs):
            batches = torch.from_numpy(epoch_batches()).to(dev)
            for batch in batches:
                negs = torch.multinomial(neg_p, B * K, replacement=True,
                                         generator=gen).reshape(B, K)
                _sgns_step(W_in, W_out, batch[:, 0], batch[:, 1], negs,
                           self.lr)
        return Word2VecModel(vocab, W_in.cpu().numpy())
