"""Functional image metrics (counterpart of ``metrics_tpu/functional/image/__init__.py``)."""
from metrics_tpu_torch.functional.image.d_lambda import spectral_distortion_index  # noqa: F401
from metrics_tpu_torch.functional.image.ergas import error_relative_global_dimensionless_synthesis  # noqa: F401
from metrics_tpu_torch.functional.image.gradients import image_gradients  # noqa: F401
from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio  # noqa: F401
from metrics_tpu_torch.functional.image.sam import spectral_angle_mapper  # noqa: F401
from metrics_tpu_torch.functional.image.ssim import (  # noqa: F401
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from metrics_tpu_torch.functional.image.uqi import universal_image_quality_index  # noqa: F401
