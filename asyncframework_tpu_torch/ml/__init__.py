"""ML library layer: optimization primitives, models, statistics,
decompositions, distributed matrices, clustering, recommendation,
embeddings, feature transforms, evaluation, naive Bayes, trees and their
ensembles, isotonic regression, frequent patterns, mixtures, pipelines and
persistence.

Counterpart of ``asyncframework_tpu/ml/`` -- the slice of MLlib the
reference's experiments stand on (``mllib/.../optimization/``:
``GradientDescent.scala``, ``LBFGS.scala``, ``Gradient.scala``,
``Updater.scala``; the model wrappers in ``regression/`` and
``classification/``; ``stat/``; PCA and the distributed matrices;
k-means, ALS, Word2Vec and LDA; ``feature/``, ``evaluation/``,
``NaiveBayes``, the histogram trees, forests and boosting, isotonic
regression, FP-growth and PrefixSpan, Gaussian mixtures; spark.ml's
pipelines and cross-validation; ``Saveable``/``Loader`` in the JAX
package's ``.npz`` format).  Each SGD or L-BFGS evaluation of a linear
model is one launch of kernel B1 a rank (``ops/masked_grad.py``), in a
pipeline too; every estimator runs on the CUDA device unless it is given a
CPU mesh or device, and raises without a card.

Not ported yet: ``streaming_models`` (ROADMAP A10: it trains on
DStreams).
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
from asyncframework_tpu_torch.ml.feature import (
    IDF,
    ChiSqSelector,
    ChiSqSelectorModel,
    ElementwiseProduct,
    HashingTF,
    IDFModel,
    MinMaxScaler,
    Normalizer,
    StandardScaler,
)
from asyncframework_tpu_torch.ml.evaluation import (
    BinaryClassificationMetrics,
    MulticlassMetrics,
    MultilabelMetrics,
    RankingMetrics,
    RegressionMetrics,
)
from asyncframework_tpu_torch.ml.bayes import NaiveBayes, NaiveBayesModel
from asyncframework_tpu_torch.ml.isotonic import (
    IsotonicRegression,
    IsotonicRegressionModel,
)
from asyncframework_tpu_torch.ml.tree import DecisionTree, DecisionTreeModel
from asyncframework_tpu_torch.ml.forest import RandomForest, RandomForestModel
from asyncframework_tpu_torch.ml.boosting import (
    GradientBoostedTrees,
    GradientBoostedTreesModel,
)
from asyncframework_tpu_torch.ml.mixture import (
    GaussianMixture,
    GaussianMixtureModel,
)
from asyncframework_tpu_torch.ml.fpm import (
    AssociationRules,
    FPGrowth,
    FPGrowthModel,
    FreqSequence,
    PrefixSpan,
    Rule,
)
from asyncframework_tpu_torch.ml.pipeline import (
    CrossValidator,
    CrossValidatorModel,
    Pipeline,
    PipelineModel,
    accuracy_scorer,
    r2_scorer,
    train_test_split,
)
from asyncframework_tpu_torch.ml.persistence import (
    load_model,
    save_as_libsvm_file,
    save_model,
)

__all__ = [
    "ALS",
    "ALSModel",
    "AssociationRules",
    "BinaryClassificationMetrics",
    "BisectingKMeans",
    "BlockMatrix",
    "ChiSqSelector",
    "ChiSqSelectorModel",
    "ChiSqTestResult",
    "ColStats",
    "CoordinateMatrix",
    "CrossValidator",
    "CrossValidatorModel",
    "DecisionTree",
    "DecisionTreeModel",
    "ElementwiseProduct",
    "FPGrowth",
    "FPGrowthModel",
    "FreqSequence",
    "GaussianMixture",
    "GaussianMixtureModel",
    "Gradient",
    "GradientBoostedTrees",
    "GradientBoostedTreesModel",
    "GradientDescent",
    "HashingTF",
    "HingeGradient",
    "IDF",
    "IDFModel",
    "IndexedRowMatrix",
    "IsotonicRegression",
    "IsotonicRegressionModel",
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
    "MinMaxScaler",
    "MulticlassMetrics",
    "MultilabelMetrics",
    "NaiveBayes",
    "NaiveBayesModel",
    "Normalizer",
    "PCA",
    "PCAModel",
    "Pipeline",
    "PipelineModel",
    "PowerIterationClustering",
    "PrefixSpan",
    "RandomForest",
    "RandomForestModel",
    "RankingMetrics",
    "RegressionMetrics",
    "RidgeRegression",
    "RowMatrix",
    "Rule",
    "SVMModel",
    "SimpleUpdater",
    "SoftmaxRegression",
    "SoftmaxRegressionModel",
    "SquaredL2Updater",
    "StandardScaler",
    "StreamingKMeans",
    "Updater",
    "Word2Vec",
    "Word2VecModel",
    "accuracy_scorer",
    "chi_sq_test",
    "chi_sq_test_matrix",
    "col_stats",
    "corr",
    "ks_test",
    "load_model",
    "r2_scorer",
    "save_as_libsvm_file",
    "save_model",
    "svd",
    "train_test_split",
]
