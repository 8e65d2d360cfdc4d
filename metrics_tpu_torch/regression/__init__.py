"""Regression metrics (counterpart of ``metrics_tpu/regression/__init__.py``)."""
from metrics_tpu_torch.regression.basic import (  # noqa: F401
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    SymmetricMeanAbsolutePercentageError,
    WeightedMeanAbsolutePercentageError,
)
from metrics_tpu_torch.regression.cosine_similarity import CosineSimilarity  # noqa: F401
from metrics_tpu_torch.regression.explained_variance import ExplainedVariance  # noqa: F401
from metrics_tpu_torch.regression.pearson import PearsonCorrCoef  # noqa: F401
from metrics_tpu_torch.regression.r2 import R2Score  # noqa: F401
from metrics_tpu_torch.regression.spearman import SpearmanCorrCoef  # noqa: F401
from metrics_tpu_torch.regression.tweedie_deviance import TweedieDevianceScore  # noqa: F401
