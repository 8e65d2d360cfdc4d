"""PyTorch/CUDA port of ``metrics_tpu``.

The same metrics with the same ``update``/``compute``/``forward`` semantics
and state layouts, on PyTorch tensors. Metrics run on CUDA unless the caller
passes ``device="cpu"``; the kernels that the JAX package wrote in Pallas for
the TPU are CUDA kernels for Hopper here (``csrc/``), built on first use.
This package imports neither JAX nor ``metrics_tpu``.

Importing it never initialises CUDA, and the ``METRICS_TPU_FORCE_CPU``
escape hatch is honoured first, before anything else is imported
(``utilities/backend.py``).
"""
__version__ = "0.1.0"

# the escape hatch first: it records `forced_cpu` and touches no device
from metrics_tpu_torch.utilities.backend import apply_force_cpu_escape_hatch as _apply_force_cpu  # noqa: E402

_apply_force_cpu()

from metrics_tpu_torch import obs  # noqa: E402  (the tracer, self-telemetry, exporters, drift)
from metrics_tpu_torch import detection  # noqa: E402,F401  (subpackage namespace, as in the JAX package)
from metrics_tpu_torch.obs.drift import DriftMonitor, ReferenceWindow  # noqa: E402
from metrics_tpu_torch.resilience import SnapshotManager  # noqa: E402
from metrics_tpu_torch.utilities.backend import ensure_backend  # noqa: E402
from metrics_tpu_torch.aggregation import BaseAggregator, CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric  # noqa: E402
from metrics_tpu_torch.classification.accuracy import Accuracy  # noqa: E402
from metrics_tpu_torch.classification.auc import AUC  # noqa: E402
from metrics_tpu_torch.classification.auroc import AUROC  # noqa: E402
from metrics_tpu_torch.classification.avg_precision import AveragePrecision  # noqa: E402
from metrics_tpu_torch.classification.binned_precision_recall import (  # noqa: E402
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
)
from metrics_tpu_torch.classification.calibration_error import CalibrationError  # noqa: E402
from metrics_tpu_torch.classification.cohen_kappa import CohenKappa  # noqa: E402
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix  # noqa: E402
from metrics_tpu_torch.classification.dice import Dice  # noqa: E402
from metrics_tpu_torch.classification.f_beta import F1Score, FBetaScore  # noqa: E402
from metrics_tpu_torch.classification.hamming import HammingDistance  # noqa: E402
from metrics_tpu_torch.classification.hinge import HingeLoss  # noqa: E402
from metrics_tpu_torch.classification.jaccard import JaccardIndex  # noqa: E402
from metrics_tpu_torch.classification.kl_divergence import KLDivergence  # noqa: E402
from metrics_tpu_torch.classification.matthews_corrcoef import MatthewsCorrCoef  # noqa: E402
from metrics_tpu_torch.classification.precision_recall import Precision, Recall  # noqa: E402
from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve  # noqa: E402
from metrics_tpu_torch.classification.ranking import CoverageError, LabelRankingAveragePrecision, LabelRankingLoss  # noqa: E402
from metrics_tpu_torch.classification.roc import ROC  # noqa: E402
from metrics_tpu_torch.classification.specificity import Specificity  # noqa: E402
from metrics_tpu_torch.classification.stat_scores import StatScores  # noqa: E402
from metrics_tpu_torch.collections import MetricCollection  # noqa: E402
from metrics_tpu_torch.image import (  # noqa: E402
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
from metrics_tpu_torch.metric import CompositionalMetric, Metric  # noqa: E402
from metrics_tpu_torch.parallel.async_sync import AsyncSyncScheduler  # noqa: E402
from metrics_tpu_torch.pure import (  # noqa: E402
    MetricDef,
    OverlappedDef,
    bootstrap_functionalize,
    functionalize,
    overlapped_functionalize,
    sliced_functionalize,
)
from metrics_tpu_torch.regression import (  # noqa: E402
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
from metrics_tpu_torch.retrieval import (  # noqa: E402
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
from metrics_tpu_torch.sliced import SlicedMetric, SlicedValue, slices_max_labels  # noqa: E402
from metrics_tpu_torch.utilities.guard import FAULT_CLASSES, FaultCounters  # noqa: E402
from metrics_tpu_torch.streaming import (  # noqa: E402
    CountMinSketch,
    CountMinState,
    DecayedMetric,
    HllState,
    HyperLogLog,
    QuantileSketch,
    QuantileSketchState,
    WindowedMetric,
)
from metrics_tpu_torch.resilience.health import health_report  # noqa: E402
from metrics_tpu_torch.serving import ServeLoop, Warmup  # noqa: E402
from metrics_tpu_torch.text import (  # noqa: E402
    BERTScore,
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    ExtendedEditDistance,
    MatchErrorRate,
    ROUGEScore,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from metrics_tpu_torch.wrappers import (  # noqa: E402
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
    "DriftMonitor",
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
    "ReferenceWindow",
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
    "SnapshotManager",
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
    "ensure_backend",
    "functionalize",
    "health_report",
    "obs",
    "overlapped_functionalize",
    "sliced_functionalize",
    "slices_max_labels",
    "BERTScore",
    "BLEUScore",
    "CharErrorRate",
    "CHRFScore",
    "ExtendedEditDistance",
    "MatchErrorRate",
    "ROUGEScore",
    "SacreBLEUScore",
    "SQuAD",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
