"""Audio metrics (counterpart of ``metrics_tpu/audio/__init__.py``)."""
from metrics_tpu_torch.audio.pit import PermutationInvariantTraining  # noqa: F401
from metrics_tpu_torch.audio.sdr import ScaleInvariantSignalDistortionRatio, SignalDistortionRatio  # noqa: F401
from metrics_tpu_torch.audio.snr import ScaleInvariantSignalNoiseRatio, SignalNoiseRatio  # noqa: F401
from metrics_tpu_torch.audio.pesq import PerceptualEvaluationSpeechQuality  # noqa: F401
from metrics_tpu_torch.audio.stoi import ShortTimeObjectiveIntelligibility  # noqa: F401
