"""Carry model state and data across from the JAX package.

The two packages share no code, so tests and tools that run both on the
same state pass it as numpy: the JAX package's model and per-worker shards,
taken out with ``np.asarray``, become the port's tensors here.  Solver and
DCN parameter-server checkpoints share one layout across the packages
(:data:`MODEL_STATE`, :data:`PS_STATE`), a sharded group's per-shard ones too
(:func:`shard_checkpoints`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from asyncframework_tpu_torch.data.sharded import ShardedDataset
from asyncframework_tpu_torch.data.sparse import SparseShardedDataset
from asyncframework_tpu_torch.utils.devices import resolve_devices


def model_from_reference(w: np.ndarray, k: int, device=None):
    """``(w, k)`` as the port's device state: an f32 ``(d,)`` model and the
    f32 0-d iteration counter the appliers advance in place."""
    dev = resolve_devices(None if device is None else [device])[0]
    w_t = torch.tensor(np.asarray(w, np.float32), device=dev)
    k_t = torch.tensor(float(k), dtype=torch.float32, device=dev)
    return w_t, k_t


def dataset_from_reference(
    shards: Sequence[Tuple[np.ndarray, np.ndarray]],
    devices: Optional[Sequence] = None,
    dtype: Optional[torch.dtype] = None,
) -> ShardedDataset:
    """A port dataset holding the JAX package's shards, worker by worker
    (``[(np.asarray(s.X), np.asarray(s.y)) for s in ds.shards.values()]``).
    bf16 shards arrive as f32 numpy (exact) and are stored back in
    ``dtype``."""
    d = int(shards[0][0].shape[1])
    return ShardedDataset.from_shards(shards, d, devices, dtype)


def sparse_dataset_from_reference(
    shards: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    d: int,
    devices: Optional[Sequence] = None,
    row_perm: Optional[np.ndarray] = None,
) -> SparseShardedDataset:
    """A port dataset holding a JAX ``SparseShardedDataset``'s padded-ELL
    shards, worker by worker (``[(np.asarray(s.cols), np.asarray(s.vals),
    np.asarray(s.y)) for s in ds.shards.values()]``, with ``d = ds.d`` and
    ``row_perm = ds.row_perm``)."""
    return SparseShardedDataset.from_shards(shards, d, devices, row_perm)


def saga_state_from_reference(
    w: np.ndarray,
    alpha_slices: Mapping[int, np.ndarray],
    alpha_bar: np.ndarray,
    k: int,
    devices: Sequence,
) -> Tuple[torch.Tensor, Dict[int, torch.Tensor], torch.Tensor, int]:
    """ASAGA state of the JAX package as the port's: ``(w, alpha, alpha_bar,
    k)`` with ``w`` and ``alpha_bar`` f32 ``(d,)`` tensors on ``devices[0]``
    and worker ``wid``'s history slice on ``devices[wid % len(devices)]``
    (the solvers' placement), so both packages start from the same table
    (e.g. ``res.extras["alpha"]`` of a JAX run), dense or sparse alike."""
    devs = resolve_devices(devices)
    alpha = {
        int(wid): torch.tensor(np.asarray(a, np.float32),
                               device=devs[int(wid) % len(devs)])
        for wid, a in alpha_slices.items()
    }
    w_t = torch.tensor(np.asarray(w, np.float32), device=devs[0])
    ab_t = torch.tensor(np.asarray(alpha_bar, np.float32), device=devs[0])
    return w_t, alpha, ab_t, int(k)


#: the model state of a solver checkpoint, the same names and layout in both
#: packages (``solvers/base.py::SolverCheckpointer``); the worker streams are
#: each package's own (``worker_keys``: threefry keys; ``worker_gens``:
#: ``torch.Generator`` states)
MODEL_STATE = ("w", "k", "clock", "alpha", "alpha_bar", "meta")


def model_state(checkpoint: Mapping) -> dict:
    """A checkpoint of either package without its worker streams: the
    entries of :data:`MODEL_STATE` it holds."""
    return {key: checkpoint[key] for key in MODEL_STATE if key in checkpoint}


def with_worker_generators(state: Mapping, seed: int, num_workers: int,
                           device) -> dict:
    """``state`` (a JAX package checkpoint's :func:`model_state`) with the
    port's ``worker_gens``: each worker's generator as a fresh run from
    ``seed`` on ``device`` starts it, so the port resumes the JAX run's model
    with its own streams.  A CUDA generator's state differs from a CPU
    one's: give the device the resumed run draws on."""
    from asyncframework_tpu_torch.ops.sampling import worker_generator

    dev = torch.device(device)
    return {**model_state(state), "worker_gens": {
        wid: worker_generator(seed, wid, dev).get_state().numpy()
        for wid in range(num_workers)}}


#: the entries of a DCN parameter server's checkpoint
#: (``parallel/ps_dcn.py::ParameterServer.save_checkpoint``), one npz layout
#: in both packages: ``__meta__`` (JSON: the clock, ``k``, the ledgers, the
#: dedup window and, for ASAGA, the numpy sampling streams ``rng_states``),
#: ``w``, ``snap_stack`` and, for ASAGA, ``ab`` and one ``table_<wid>`` a
#: worker.  A checkpoint written by either package resumes in the other's
#: ``ParameterServer(..., checkpoint_path=...)``.
PS_STATE = ("__meta__", "w", "snap_stack", "ab", "table_<wid>")


def ps_checkpoint(path) -> Tuple[dict, Dict[str, np.ndarray]]:
    """A PS checkpoint of either package as ``(meta, arrays)``: the parsed
    ``__meta__`` and every array, read into memory."""
    import json

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k].copy() for k in z.files if k != "__meta__"}
    return meta, arrays


def shard_checkpoints(directory
                      ) -> Dict[int, Tuple[dict, Dict[str, np.ndarray]]]:
    """A sharded PS group's checkpoints (``ps_shard{i}.npz``, written by
    either package's shards into one directory) as ``{i: (meta,
    arrays)}``, by shard index.  Each one resumes in either package's
    ``ParameterServer(..., checkpoint_path=...)`` for its range; a fenced
    one (``meta["epoch"] > 0``) resumes one epoch above the one it saved.

    A promoted hot standby checkpoints its range beside the primary's
    file, one file per standby generation (``ps_shard{i}.standby{g}.npz``,
    either package's ``ShardGroup``).  A range's image is then its
    freshest file by the image's own ``(epoch, clock)``, as the group
    picks it for a relaunch: a deposed primary's last save never wins
    over its successor's."""
    import os
    import re

    found: Dict[int, list] = {}
    for name in os.listdir(directory):
        m = re.fullmatch(r"ps_shard(\d+)(?:\.standby\d+)?\.npz", name)
        if m:
            found.setdefault(int(m.group(1)), []).append(
                ps_checkpoint(os.path.join(directory, name)))
    out = {}
    for i, images in found.items():
        out[i] = max(images, key=lambda img: (int(img[0].get("epoch", 0)),
                                              int(img[0]["clock"])))
    return dict(sorted(out.items()))


def assembled_ps_model(directory) -> Tuple[np.ndarray, list, list]:
    """The whole model of a sharded group's checkpoints: each shard's
    ``w`` concatenated in range order, with the shards' clocks and
    fencing epochs (0 = fencing off) in the same order."""
    shards = shard_checkpoints(directory)
    if sorted(shards) != list(range(len(shards))):
        raise ValueError(f"shard checkpoints {sorted(shards)} do not cover "
                         f"ranges 0..{len(shards) - 1}")
    w = np.concatenate([arrays["w"] for _meta, arrays in shards.values()])
    clocks = [int(meta["clock"]) for meta, _a in shards.values()]
    epochs = [int(meta.get("epoch", 0)) for meta, _a in shards.values()]
    return w, clocks, epochs


# ------------------------------------------------------------ fitted models
#: each fitted model's fields, the same names and host layout in both
#: packages' ``ml`` modules (each one its class's constructor's keyword
#: arguments): numpy arrays, Python scalars, and the weight trajectory as
#: ``[(ms, w)]``
LINEAR_MODEL = ("weights", "intercept", "loss_history", "weight_history")
KMEANS_MODEL = ("centers", "cost", "iterations")
ALS_MODEL = ("user_factors", "item_factors", "rank")
PCA_MODEL = ("components", "explained_variance", "mean")
WORD2VEC_MODEL = ("vocab", "vectors")
LDA_MODEL = ("topics", "doc_topics", "alpha", "log_perplexity_history")


def _host(value):
    """A field as a host value: an array copied (the two models share no
    buffer), a list or tuple element by element, anything else as it is."""
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, (list, tuple)):
        return type(value)(_host(v) for v in value)
    return value


def _fields(model, names) -> dict:
    return {name: _host(getattr(model, name)) for name in names}


def linear_model_from_reference(model):
    """A JAX package's fitted linear model (``LinearModel``,
    ``LogisticRegressionModel`` or ``SVMModel``) as the port's class of
    the same name."""
    from asyncframework_tpu_torch.ml import models

    return getattr(models, type(model).__name__)(**_fields(model,
                                                           LINEAR_MODEL))


def linear_model_to_reference(model) -> dict:
    """The port's fitted linear model as the JAX package's constructor
    arguments (``LogisticRegressionModel(**fields)``, ...)."""
    return _fields(model, LINEAR_MODEL)


def kmeans_model_from_reference(model):
    """A JAX package's ``KMeansModel`` as the port's."""
    from asyncframework_tpu_torch.ml.clustering import KMeansModel

    return KMeansModel(**_fields(model, KMEANS_MODEL))


def kmeans_model_to_reference(model) -> dict:
    """The port's ``KMeansModel`` as the JAX package's constructor
    arguments."""
    return _fields(model, KMEANS_MODEL)


def als_model_from_reference(model):
    """A JAX package's ``ALSModel`` (its factors) as the port's."""
    from asyncframework_tpu_torch.ml.recommendation import ALSModel

    return ALSModel(**_fields(model, ALS_MODEL))


def als_model_to_reference(model) -> dict:
    """The port's ``ALSModel`` as the JAX package's constructor
    arguments."""
    return _fields(model, ALS_MODEL)


def pca_model_from_reference(model):
    """A JAX package's ``PCAModel`` as the port's."""
    from asyncframework_tpu_torch.ml.decomposition import PCAModel

    return PCAModel(**_fields(model, PCA_MODEL))


def pca_model_to_reference(model) -> dict:
    """The port's ``PCAModel`` as the JAX package's constructor
    arguments."""
    return _fields(model, PCA_MODEL)


def word2vec_model_from_reference(model):
    """A JAX package's ``Word2VecModel`` (vocabulary and vectors) as the
    port's."""
    from asyncframework_tpu_torch.ml.word2vec import Word2VecModel

    return Word2VecModel(**_fields(model, WORD2VEC_MODEL))


def word2vec_model_to_reference(model) -> dict:
    """The port's ``Word2VecModel`` as the JAX package's constructor
    arguments."""
    return _fields(model, WORD2VEC_MODEL)


def lda_model_from_reference(model):
    """A JAX package's ``LDAModel`` (its topics) as the port's."""
    from asyncframework_tpu_torch.ml.lda import LDAModel

    return LDAModel(**_fields(model, LDA_MODEL))


def lda_model_to_reference(model) -> dict:
    """The port's ``LDAModel`` as the JAX package's constructor
    arguments."""
    return _fields(model, LDA_MODEL)
