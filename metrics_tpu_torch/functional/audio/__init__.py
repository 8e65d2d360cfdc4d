"""Functional audio metrics (counterpart of ``metrics_tpu/functional/audio/__init__.py``)."""
from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training, pit_permutate  # noqa: F401
from metrics_tpu_torch.functional.audio.sdr import (  # noqa: F401
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
)
from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio  # noqa: F401
from metrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality  # noqa: F401
from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility  # noqa: F401
from metrics_tpu_torch.functional.audio.stoi_native import stoi_on_device  # noqa: F401
