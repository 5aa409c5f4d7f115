"""Model persistence: save/load for every model family.

Counterpart of ``asyncframework_tpu/ml/persistence.py`` (parity: each
MLlib model implements ``Saveable``/``Loader`` -- models round-trip through
a storage path with a format tag and validation on load).

The format is the JAX package's, key for key: one ``.npz`` per model
(array fields as arrays, scalars/str as 0-d arrays, nested lists of models
flattened with indexed keys) plus a ``__class__`` tag, the model's class
name, checked on load.  A file saved by either package loads in the
other.  Array-only on purpose -- the same no-code-execution trust posture
as the checkpoint and WAL formats.

A model is recognised by the names of its class and its bases, so the
JAX package's fitted models serialise here too (``convert.py`` carries
them across this way).  ``load_model`` puts the tensors a model holds (a
naive Bayes model's, an IDF model's) on ``device`` (the CUDA device by
default; raises without one); models of host arrays load as host arrays,
and a loaded transformer transforms on ``device``.

``SVDPlusPlusModel`` (``graph/algorithms.py``) is a model of host arrays:
its file holds the same five fields in both packages.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

from asyncframework_tpu_torch.graph.algorithms import SVDPlusPlusModel
from asyncframework_tpu_torch.ml.bayes import NaiveBayesModel
from asyncframework_tpu_torch.ml.boosting import GradientBoostedTreesModel
from asyncframework_tpu_torch.ml.clustering import KMeansModel
from asyncframework_tpu_torch.ml.decomposition import PCAModel
from asyncframework_tpu_torch.ml.feature import host_array
from asyncframework_tpu_torch.ml.forest import RandomForestModel
from asyncframework_tpu_torch.ml.isotonic import IsotonicRegressionModel
from asyncframework_tpu_torch.ml.lda import LDAModel
from asyncframework_tpu_torch.ml.mixture import GaussianMixtureModel
from asyncframework_tpu_torch.ml.models import (
    LinearModel,
    LogisticRegressionModel,
    SoftmaxRegressionModel,
    SVMModel,
)
from asyncframework_tpu_torch.ml.pipeline import PipelineModel
from asyncframework_tpu_torch.ml.recommendation import ALSModel
from asyncframework_tpu_torch.ml.stat import on_device
from asyncframework_tpu_torch.ml.tree import DecisionTreeModel
from asyncframework_tpu_torch.ml.word2vec import Word2VecModel
from asyncframework_tpu_torch.utils.devices import resolve_devices


def _kinds(model: Any) -> set:
    """The names of ``model``'s class and its bases (either package's)."""
    return {c.__name__ for c in type(model).__mro__}


def _tree_payload(t: Any, prefix: str) -> Dict[str, np.ndarray]:
    return {
        f"{prefix}feature": np.asarray(t.feature),
        f"{prefix}threshold": np.asarray(t.threshold),
        f"{prefix}prediction": np.asarray(t.prediction),
        f"{prefix}depth": np.int64(t.depth),
        f"{prefix}task": np.str_(t.task),
    }


def _tree_restore(z, prefix: str) -> DecisionTreeModel:
    return DecisionTreeModel(
        feature=np.asarray(z[f"{prefix}feature"]),
        threshold=np.asarray(z[f"{prefix}threshold"]),
        prediction=np.asarray(z[f"{prefix}prediction"]),
        depth=int(z[f"{prefix}depth"]),
        task=str(z[f"{prefix}task"]),
    )


def model_payload(model: Any) -> Dict[str, Any]:
    """The ``.npz`` entries of ``model`` (the JAX package's layout)."""
    kinds = _kinds(model)
    payload: Dict[str, Any] = {"__class__": np.str_(type(model).__name__)}

    if "PipelineModel" in kinds:
        payload["n_tf"] = np.int64(len(model.transformers))
        for i, t in enumerate(model.transformers):
            payload.update(transformer_payload(t, f"tf{i}_"))
        for k, v in model_payload(model.model).items():
            payload[f"inner_{k}"] = v
    elif "DecisionTreeModel" in kinds:
        payload.update(_tree_payload(model, "t_"))
    elif kinds & {"RandomForestModel", "GradientBoostedTreesModel"}:
        payload["n_trees"] = np.int64(len(model.trees))
        payload["task"] = np.str_(model.task)
        for i, t in enumerate(model.trees):
            payload.update(_tree_payload(t, f"tree{i}_"))
        if "RandomForestModel" in kinds:
            payload["num_classes"] = np.int64(model.num_classes)
        else:
            payload["learning_rate"] = np.float64(model.learning_rate)
            payload["init_value"] = np.float64(model.init_value)
    elif "NaiveBayesModel" in kinds:
        payload["model_type"] = np.str_(model.model_type)
        payload["log_pi"] = host_array(model.log_pi)
        if model.model_type == "gaussian":
            mean, var = model._gauss
            payload["mean"] = host_array(mean)
            payload["var"] = host_array(var)
        else:
            payload["log_theta"] = host_array(model.log_theta)
    elif "IsotonicRegressionModel" in kinds:
        payload["boundaries"] = model.boundaries
        payload["predictions"] = model.predictions
        payload["increasing"] = np.bool_(model.increasing)
    elif "KMeansModel" in kinds:
        payload["centers"] = np.asarray(model.centers)
        payload["cost"] = np.float64(model.cost)
        payload["iterations"] = np.int64(model.iterations)
    elif "PCAModel" in kinds:
        payload["components"] = model.components
        payload["explained_variance"] = model.explained_variance
        payload["mean"] = model.mean
    elif "GaussianMixtureModel" in kinds:
        payload["weights"] = model.weights
        payload["means"] = model.means
        payload["covariances"] = model.covariances
        payload["log_likelihood"] = np.float64(model.log_likelihood)
    elif "LDAModel" in kinds:
        payload["topics"] = model.topics
        payload["doc_topics"] = model.doc_topics
        payload["alpha"] = np.float64(model.alpha)
        payload["hist"] = model.log_perplexity_history
    elif "ALSModel" in kinds:
        payload["user_factors"] = model.user_factors
        payload["item_factors"] = model.item_factors
        payload["rank"] = np.int64(model.rank)
    elif "Word2VecModel" in kinds:
        payload["vocab"] = np.asarray(model.vocab, dtype=np.str_)
        payload["vectors"] = np.asarray(model.vectors)
    elif "SVDPlusPlusModel" in kinds:
        payload["user_vectors"] = np.asarray(model.user_vectors)
        payload["item_vectors"] = np.asarray(model.item_vectors)
        payload["user_bias"] = np.asarray(model.user_bias)
        payload["item_bias"] = np.asarray(model.item_bias)
        payload["mean"] = np.float64(model.mean)
    elif "SoftmaxRegressionModel" in kinds:
        payload["W"] = model.W
        payload["b"] = model.b
        payload["loss_history"] = model.loss_history
    elif "LinearModel" in kinds:  # covers logistic/SVM subclasses
        payload["weights"] = np.asarray(model.weights)
        payload["intercept"] = np.float64(model.intercept)
        payload["loss_history"] = np.asarray(model.loss_history)
        # the Warray-parity trajectory round-trips as indexed pairs
        payload["n_wh"] = np.int64(len(model.weight_history))
        for i, (t, w) in enumerate(model.weight_history):
            payload[f"wh_t_{i}"] = np.float64(t)
            payload[f"wh_w_{i}"] = np.asarray(w)
    else:
        raise TypeError(f"no persistence for {type(model).__name__}")
    return payload


def save_model(model: Any, path: Union[str, Path]) -> Path:
    """Persist a model to ``path`` (``.npz`` appended when absent)."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    payload = model_payload(model)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:  # direct handle: no double-buffered archive
        np.savez(f, **payload)
    return path


_TRANSFORMER_FIELDS = {
    "StandardScaler": ("mean_", "std_", "with_mean", "with_std"),
    "MinMaxScaler": ("min_", "max_", "lo", "hi"),
    "Normalizer": ("p",),
    "IDFModel": ("idf",),
}


def transformer_payload(t: Any, prefix: str) -> Dict[str, Any]:
    """The entries of a pipeline's fitted transformer stage under
    ``prefix``."""
    name = type(t).__name__
    if name not in _TRANSFORMER_FIELDS:
        raise TypeError(f"no persistence for pipeline stage {name}")
    out: Dict[str, Any] = {f"{prefix}__class__": np.str_(name)}
    for field in _TRANSFORMER_FIELDS[name]:
        out[f"{prefix}{field}"] = host_array(getattr(t, field))
    return out


def transformer_restore(z, prefix: str, device=None) -> Any:
    """The transformer stage saved under ``prefix``; it transforms on
    ``device`` (the CUDA device when None)."""
    from asyncframework_tpu_torch.ml.feature import (
        IDFModel,
        MinMaxScaler,
        Normalizer,
        StandardScaler,
    )

    name = str(z[f"{prefix}__class__"])
    if name == "StandardScaler":
        t = StandardScaler(
            with_mean=bool(z[f"{prefix}with_mean"]),
            with_std=bool(z[f"{prefix}with_std"]),
            device=device,
        )
        t.mean_ = np.array(z[f"{prefix}mean_"])
        t.std_ = np.array(z[f"{prefix}std_"])
        return t
    if name == "MinMaxScaler":
        t = MinMaxScaler(lo=float(z[f"{prefix}lo"]), hi=float(z[f"{prefix}hi"]),
                         device=device)
        t.min_ = np.array(z[f"{prefix}min_"])
        t.max_ = np.array(z[f"{prefix}max_"])
        return t
    if name == "Normalizer":
        return Normalizer(p=float(z[f"{prefix}p"]), device=device)
    if name == "IDFModel":
        return IDFModel(on_device(np.array(z[f"{prefix}idf"]), device))
    raise ValueError(f"unknown transformer tag {name}")


def load_model(path: Union[str, Path], device=None) -> Any:
    """The model saved at ``path`` (by either package); its tensors on
    ``device``."""
    path = Path(path)
    if not path.exists() and path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    with np.load(path, allow_pickle=False) as z:
        return model_restore({k: z[k] for k in z.files}, device)


def model_restore(z: Dict[str, Any], device=None) -> Any:
    """The model of a payload (``model_payload``'s, or a loaded file's
    entries); its tensors on ``device`` (the CUDA device when None)."""
    cls = str(z["__class__"])
    if cls == "PipelineModel":
        tfs = [
            transformer_restore(z, f"tf{i}_", device)
            for i in range(int(z["n_tf"]))
        ]
        inner = {
            k[len("inner_"):]: v
            for k, v in z.items() if k.startswith("inner_")
        }
        return PipelineModel(
            transformers=tfs, model=model_restore(inner, device)
        )
    if cls == "DecisionTreeModel":
        return _tree_restore(z, "t_")
    if cls in ("RandomForestModel", "GradientBoostedTreesModel"):
        trees = [
            _tree_restore(z, f"tree{i}_")
            for i in range(int(z["n_trees"]))
        ]
        if cls == "RandomForestModel":
            return RandomForestModel(
                trees=trees, task=str(z["task"]),
                num_classes=int(z["num_classes"]),
            )
        return GradientBoostedTreesModel(
            trees=trees, task=str(z["task"]),
            learning_rate=float(z["learning_rate"]),
            init_value=float(z["init_value"]),
        )
    if cls == "NaiveBayesModel":
        dev = resolve_devices(None if device is None else [device])[0]

        def t(key: str) -> torch.Tensor:
            return on_device(np.array(z[key]), dev)

        mtype = str(z["model_type"])
        if mtype == "gaussian":
            return NaiveBayesModel(t("log_pi"), None, "gaussian",
                                   (t("mean"), t("var")))
        return NaiveBayesModel(t("log_pi"), t("log_theta"), mtype)
    if cls == "IsotonicRegressionModel":
        return IsotonicRegressionModel(
            boundaries=np.asarray(z["boundaries"]),
            predictions=np.asarray(z["predictions"]),
            increasing=bool(z["increasing"]),
        )
    if cls == "KMeansModel":
        return KMeansModel(
            centers=np.asarray(z["centers"]), cost=float(z["cost"]),
            iterations=int(z["iterations"]),
        )
    if cls == "PCAModel":
        return PCAModel(
            components=np.asarray(z["components"]),
            explained_variance=np.asarray(z["explained_variance"]),
            mean=np.asarray(z["mean"]),
        )
    if cls == "GaussianMixtureModel":
        return GaussianMixtureModel(
            weights=np.asarray(z["weights"]),
            means=np.asarray(z["means"]),
            covariances=np.asarray(z["covariances"]),
            log_likelihood=float(z["log_likelihood"]),
        )
    if cls == "LDAModel":
        return LDAModel(
            topics=np.asarray(z["topics"]),
            doc_topics=np.asarray(z["doc_topics"]),
            alpha=float(z["alpha"]),
            log_perplexity_history=np.asarray(z["hist"]),
        )
    if cls == "ALSModel":
        return ALSModel(
            user_factors=np.asarray(z["user_factors"]),
            item_factors=np.asarray(z["item_factors"]),
            rank=int(z["rank"]),
        )
    if cls == "Word2VecModel":
        return Word2VecModel(
            vocab=[str(w) for w in z["vocab"]],
            vectors=np.asarray(z["vectors"]),
        )
    if cls == "SVDPlusPlusModel":
        return SVDPlusPlusModel(
            user_vectors=np.asarray(z["user_vectors"]),
            item_vectors=np.asarray(z["item_vectors"]),
            user_bias=np.asarray(z["user_bias"]),
            item_bias=np.asarray(z["item_bias"]),
            mean=float(z["mean"]),
        )
    if cls == "SoftmaxRegressionModel":
        return SoftmaxRegressionModel(
            W=np.asarray(z["W"]), b=np.asarray(z["b"]),
            loss_history=np.asarray(z["loss_history"]),
        )
    if cls in ("LinearModel", "LogisticRegressionModel", "SVMModel"):
        klass = {
            "LinearModel": LinearModel,
            "LogisticRegressionModel": LogisticRegressionModel,
            "SVMModel": SVMModel,
        }[cls]
        wh = [
            (float(z[f"wh_t_{i}"]), np.asarray(z[f"wh_w_{i}"]))
            for i in range(int(z["n_wh"])) if f"wh_t_{i}" in z
        ] if "n_wh" in z else []
        return klass(
            weights=np.asarray(z["weights"]),
            intercept=float(z["intercept"]),
            loss_history=np.asarray(z["loss_history"]),
            weight_history=wh,
        )
    raise ValueError(f"unknown model class tag {cls!r}")


def save_as_libsvm_file(X, y, path: Union[str, Path]) -> Path:
    """``MLUtils.saveAsLibSVMFile`` parity (1-based indices, zeros skipped);
    ``X``/``y`` host arrays or tensors."""
    X = host_array(X)
    y = host_array(y)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for i in range(X.shape[0]):
            row = X[i]
            nz = np.nonzero(row)[0]
            feats = " ".join(f"{j + 1}:{row[j]:.9g}" for j in nz)
            f.write(f"{y[i]:.9g} {feats}\n".rstrip() + "\n")
    return path
