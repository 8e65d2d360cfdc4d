"""PyTorch/CUDA port of ``metrics_tpu``.

The same metrics with the same ``update``/``compute``/``forward`` semantics
and state layouts, on PyTorch tensors. Metrics run on CUDA unless the caller
passes ``device="cpu"``; the kernels that the JAX package wrote in Pallas for
the TPU are CUDA kernels for Hopper here (``csrc/``), built on first use.
This package imports neither JAX nor ``metrics_tpu``.
"""
from metrics_tpu_torch.aggregation import BaseAggregator, CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.classification.accuracy import Accuracy
from metrics_tpu_torch.classification.auc import AUC
from metrics_tpu_torch.classification.auroc import AUROC
from metrics_tpu_torch.classification.avg_precision import AveragePrecision
from metrics_tpu_torch.classification.binned_precision_recall import (
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.calibration_error import CalibrationError
from metrics_tpu_torch.classification.cohen_kappa import CohenKappa
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.classification.dice import Dice
from metrics_tpu_torch.classification.f_beta import F1Score, FBetaScore
from metrics_tpu_torch.classification.hamming import HammingDistance
from metrics_tpu_torch.classification.hinge import HingeLoss
from metrics_tpu_torch.classification.jaccard import JaccardIndex
from metrics_tpu_torch.classification.kl_divergence import KLDivergence
from metrics_tpu_torch.classification.matthews_corrcoef import MatthewsCorrCoef
from metrics_tpu_torch.classification.precision_recall import Precision, Recall
from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve
from metrics_tpu_torch.classification.ranking import CoverageError, LabelRankingAveragePrecision, LabelRankingLoss
from metrics_tpu_torch.classification.roc import ROC
from metrics_tpu_torch.classification.specificity import Specificity
from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.image import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    UniversalImageQualityIndex,
)
from metrics_tpu_torch.metric import CompositionalMetric, Metric
from metrics_tpu_torch.parallel.async_sync import AsyncSyncScheduler
from metrics_tpu_torch.pure import (
    MetricDef,
    OverlappedDef,
    bootstrap_functionalize,
    functionalize,
    overlapped_functionalize,
    sliced_functionalize,
)
from metrics_tpu_torch.regression import (
    CosineSimilarity,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
)
from metrics_tpu_torch.retrieval import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
    RetrievalRPrecision,
)
from metrics_tpu_torch.sliced import SlicedMetric, SlicedValue, slices_max_labels
from metrics_tpu_torch.utilities.guard import FAULT_CLASSES, FaultCounters
from metrics_tpu_torch.streaming import (
    CountMinSketch,
    CountMinState,
    DecayedMetric,
    HllState,
    HyperLogLog,
    QuantileSketch,
    QuantileSketchState,
    WindowedMetric,
)
from metrics_tpu_torch.resilience.health import health_report
from metrics_tpu_torch.serving import ServeLoop, Warmup
from metrics_tpu_torch.wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
)

__all__ = [
    "AUC",
    "AsyncSyncScheduler",
    "BaseAggregator",
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FAULT_CLASSES",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "BootStrapper",
    "CalibrationError",
    "CatMetric",
    "ClasswiseWrapper",
    "CohenKappa",
    "CompositionalMetric",
    "ConfusionMatrix",
    "CosineSimilarity",
    "CountMinSketch",
    "CountMinState",
    "CoverageError",
    "DecayedMetric",
    "Dice",
    "ExplainedVariance",
    "F1Score",
    "FBetaScore",
    "FaultCounters",
    "FrechetInceptionDistance",
    "HammingDistance",
    "HingeLoss",
    "HllState",
    "HyperLogLog",
    "InceptionScore",
    "JaccardIndex",
    "KernelInceptionDistance",
    "KLDivergence",
    "LabelRankingAveragePrecision",
    "LabelRankingLoss",
    "LearnedPerceptualImagePatchSimilarity",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanMetric",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "Metric",
    "MetricCollection",
    "MetricDef",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MultioutputWrapper",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "OverlappedDef",
    "PeakSignalNoiseRatio",
    "PearsonCorrCoef",
    "Precision",
    "PrecisionRecallCurve",
    "QuantileSketch",
    "QuantileSketchState",
    "R2Score",
    "ROC",
    "Recall",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "ServeLoop",
    "SlicedMetric",
    "SlicedValue",
    "SpearmanCorrCoef",
    "Specificity",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StatScores",
    "StructuralSimilarityIndexMeasure",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "UniversalImageQualityIndex",
    "WeightedMeanAbsolutePercentageError",
    "Warmup",
    "WindowedMetric",
    "bootstrap_functionalize",
    "functionalize",
    "health_report",
    "overlapped_functionalize",
    "sliced_functionalize",
    "slices_max_labels",
]
