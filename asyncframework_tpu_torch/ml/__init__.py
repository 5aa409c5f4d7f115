"""ML library layer: optimization primitives, models, statistics,
decompositions, distributed matrices, clustering, recommendation and
embeddings.

Counterpart of ``asyncframework_tpu/ml/`` -- the slice of MLlib the
reference's experiments stand on (``mllib/.../optimization/``:
``GradientDescent.scala``, ``LBFGS.scala``, ``Gradient.scala``,
``Updater.scala``; the model wrappers in ``regression/`` and
``classification/``; ``stat/``; PCA and the distributed matrices;
k-means, ALS, Word2Vec and LDA).  Each SGD or L-BFGS evaluation of a
linear model is one launch of kernel B1 a rank
(``ops/masked_grad.py``); every estimator runs on the CUDA device unless
it is given a CPU mesh or device, and raises without a card.

Not ported yet (ROADMAP A9): ``feature``, ``bayes``, ``evaluation``,
``tree``, ``forest``, ``boosting``, ``isotonic``, ``fpm``, ``mixture``,
``pipeline``, ``persistence`` and ``streaming_models``.
"""

from asyncframework_tpu_torch.ml.gradient import (
    Gradient,
    HingeGradient,
    LeastSquaresGradient,
    LogisticGradient,
)
from asyncframework_tpu_torch.ml.updater import (
    L1Updater,
    SimpleUpdater,
    SquaredL2Updater,
    Updater,
)
from asyncframework_tpu_torch.ml.optimization import LBFGS, GradientDescent
from asyncframework_tpu_torch.ml.models import (
    LinearModel,
    LinearRegression,
    LinearSVM,
    LogisticRegression,
    LogisticRegressionModel,
    Lasso,
    RidgeRegression,
    SoftmaxRegression,
    SoftmaxRegressionModel,
    SVMModel,
)
from asyncframework_tpu_torch.ml.stat import (
    ChiSqTestResult,
    ColStats,
    KernelDensity,
    KSTestResult,
    chi_sq_test,
    chi_sq_test_matrix,
    col_stats,
    corr,
    ks_test,
)
from asyncframework_tpu_torch.ml.decomposition import PCA, PCAModel, svd
from asyncframework_tpu_torch.ml.linalg_distributed import (
    BlockMatrix,
    CoordinateMatrix,
    IndexedRowMatrix,
    RowMatrix,
)
from asyncframework_tpu_torch.ml.clustering import (
    BisectingKMeans,
    KMeans,
    KMeansModel,
    PowerIterationClustering,
    StreamingKMeans,
)
from asyncframework_tpu_torch.ml.recommendation import ALS, ALSModel
from asyncframework_tpu_torch.ml.word2vec import Word2Vec, Word2VecModel
from asyncframework_tpu_torch.ml.lda import LDA, LDAModel

__all__ = [
    "ALS",
    "ALSModel",
    "BisectingKMeans",
    "BlockMatrix",
    "ChiSqTestResult",
    "ColStats",
    "CoordinateMatrix",
    "Gradient",
    "GradientDescent",
    "HingeGradient",
    "IndexedRowMatrix",
    "KMeans",
    "KMeansModel",
    "KSTestResult",
    "KernelDensity",
    "L1Updater",
    "LBFGS",
    "LDA",
    "LDAModel",
    "Lasso",
    "LeastSquaresGradient",
    "LinearModel",
    "LinearRegression",
    "LinearSVM",
    "LogisticGradient",
    "LogisticRegression",
    "LogisticRegressionModel",
    "PCA",
    "PCAModel",
    "PowerIterationClustering",
    "RidgeRegression",
    "RowMatrix",
    "SVMModel",
    "SimpleUpdater",
    "SoftmaxRegression",
    "SoftmaxRegressionModel",
    "SquaredL2Updater",
    "StreamingKMeans",
    "Updater",
    "Word2Vec",
    "Word2VecModel",
    "chi_sq_test",
    "chi_sq_test_matrix",
    "col_stats",
    "corr",
    "ks_test",
    "svd",
]
