"""Image metrics (counterpart of ``metrics_tpu/image/__init__.py``)."""
from metrics_tpu_torch.image.extractor import TinyImageEncoder, perceptual_distance  # noqa: F401
from metrics_tpu_torch.image.fid import FrechetInceptionDistance  # noqa: F401
from metrics_tpu_torch.image.inception import InceptionScore  # noqa: F401
from metrics_tpu_torch.image.kid import KernelInceptionDistance  # noqa: F401
from metrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity  # noqa: F401
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio  # noqa: F401
from metrics_tpu_torch.image.simple import (  # noqa: F401
    ErrorRelativeGlobalDimensionlessSynthesis,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    UniversalImageQualityIndex,
)
from metrics_tpu_torch.image.ssim import (  # noqa: F401
    MultiScaleStructuralSimilarityIndexMeasure,
    StructuralSimilarityIndexMeasure,
)

_NET_EXPORTS = (
    "InceptionV3Extractor",
    "LPIPSNet",
    "load_inception_torch_state_dict",
    "load_lpips_torch_state_dict",
)


def __getattr__(name: str):
    # lazy, as the nets package: importing the metrics builds no net
    if name in _NET_EXPORTS:
        import metrics_tpu_torch.nets as nets

        return getattr(nets, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
