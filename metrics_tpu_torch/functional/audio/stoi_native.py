"""On-device STOI (counterpart of ``metrics_tpu/functional/audio/stoi_native.py``).

The published algorithm (Taal, Hendriks, Heusdens, Jensen, "An Algorithm
for Intelligibility Prediction of Time-Frequency Weighted Noisy Speech",
IEEE TASLP 2011; the extended variant of Jensen and Taal 2016), as the JAX
package implements it:

- the spectral core (framing, FFT, third-octave band grouping, segment
  normalization and clipping, correlation) runs in torch on the caller's
  device and is differentiable; its band matmul runs in full float32
  (D46), as JAX names ``Precision.HIGHEST`` there;
- silent-frame removal (a data-dependent number of frames) runs on the
  host in numpy, as pystoi's ``remove_silent_frames`` does, and can be
  turned off for pre-voiced segments;
- any other rate than 10 kHz is resampled on the host with scipy's
  ``resample_poly`` first, imported when it is needed.

So a call reads its inputs back to the host: by design, as in JAX. Constants
follow the spec: 10 kHz, 256-sample frames with 50 % overlap, a 512-point
FFT, 15 one-third octave bands from 150 Hz, 30-frame (384 ms) segments,
-15 dB clipping.
"""
from typing import Dict, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.utilities.compute import full_float32
from metrics_tpu_torch.utilities.data import _host_float32

Tensor = torch.Tensor

FS = 10_000
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
SEG_LEN = 30  # frames per segment (384 ms)
BETA = -15.0  # clipping threshold, dB
DYN_RANGE = 40.0  # VAD dynamic range, dB
_EPS = float(np.finfo(np.float32).eps)

# the band matrix and the window on each device, made at their first use
_CONSTANTS: Dict[torch.device, Tuple[Tensor, Tensor]] = {}


def _hann(framelen: int) -> np.ndarray:
    # the spec's window: hanning without the zero endpoints
    return np.hanning(framelen + 2)[1:-1].astype(np.float32)


def third_octave_matrix(
    fs: int = FS, nfft: int = NFFT, num_bands: int = NUM_BANDS, min_freq: float = MIN_FREQ
) -> np.ndarray:
    """``(num_bands, nfft//2 + 1)`` 0/1 matrix grouping FFT bins into
    one-third octave bands with nearest-bin edges."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    cf = (2.0 ** (k / 3.0)) * min_freq
    freq_low = cf / (2.0 ** (1.0 / 6.0))
    freq_high = cf * (2.0 ** (1.0 / 6.0))
    obm = np.zeros((num_bands, f.size), np.float32)
    for i in range(num_bands):
        lo = int(np.argmin((f - freq_low[i]) ** 2))
        hi = int(np.argmin((f - freq_high[i]) ** 2))
        obm[i, lo:hi] = 1.0
    return obm


def remove_silent_frames(
    x: np.ndarray, y: np.ndarray, dyn_range: float = DYN_RANGE, framelen: int = N_FRAME, hop: int = N_FRAME // 2
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop the frames of the clean signal ``x`` more than ``dyn_range`` dB
    below its loudest frame, the same frames of ``y``, and overlap-add the
    kept windowed frames back into time series (host numpy)."""
    w = _hann(framelen)
    starts = range(0, max(len(x) - framelen + 1, 0), hop)
    x_frames = np.stack([w * x[i : i + framelen] for i in starts]) if len(x) >= framelen else np.zeros((0, framelen))
    y_frames = np.stack([w * y[i : i + framelen] for i in starts]) if len(y) >= framelen else np.zeros((0, framelen))
    energies = 20.0 * np.log10(np.linalg.norm(x_frames, axis=1) + _EPS)
    mask = energies > energies.max(initial=-np.inf) - dyn_range
    x_frames, y_frames = x_frames[mask], y_frames[mask]
    n_kept = x_frames.shape[0]
    out_len = (n_kept - 1) * hop + framelen if n_kept else 0
    x_sil = np.zeros(out_len, np.float32)
    y_sil = np.zeros(out_len, np.float32)
    for i in range(n_kept):  # overlap-add (50 % hann overlap sums to about 1)
        x_sil[i * hop : i * hop + framelen] += x_frames[i]
        y_sil[i * hop : i * hop + framelen] += y_frames[i]
    return x_sil, y_sil


def _constants(device: torch.device) -> Tuple[Tensor, Tensor]:
    """The band matrix and the window on ``device``."""
    key = torch.device(device)
    consts = _CONSTANTS.get(key)
    if consts is None:
        consts = (torch.from_numpy(third_octave_matrix()).to(key), torch.from_numpy(_hann(N_FRAME)).to(key))
        consts = _CONSTANTS.setdefault(key, consts)
    return consts


def _band_spectrogram(sig: Tensor, obm: Tensor) -> Tensor:
    """``(num_bands, frames)`` third-octave band magnitudes of a 1-d signal."""
    frames = sig.unfold(-1, N_FRAME, N_FRAME // 2) * _constants(sig.device)[1]
    spec = torch.fft.rfft(frames, NFFT, dim=-1)  # (frames, nfft//2+1)
    power = torch.abs(spec) ** 2
    with full_float32():
        bands = torch.matmul(power, obm.T)
    return torch.sqrt(bands.T + _EPS)  # (bands, frames)


def _segments(bands: Tensor) -> Tensor:
    """Sliding ``SEG_LEN``-frame segments: ``(n_segs, num_bands, SEG_LEN)``."""
    return bands.unfold(-1, SEG_LEN, 1).movedim(1, 0)


def _stoi_from_bands(x_bands: Tensor, y_bands: Tensor) -> Tensor:
    """Classic STOI: per-band segment normalization, clipping, correlation."""
    x = _segments(x_bands)  # (M, J, N): M segments, J bands, N frames
    y = _segments(y_bands)
    norm_x = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    norm_y = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    y_n = y * (norm_x / (norm_y + _EPS))
    clip = 10.0 ** (-BETA / 20.0)
    y_c = torch.minimum(y_n, x * (1.0 + clip))
    xm = x - x.mean(-1, keepdim=True)
    ym = y_c - y_c.mean(-1, keepdim=True)
    corr = (xm * ym).sum(-1) / (torch.linalg.vector_norm(xm, dim=-1) * torch.linalg.vector_norm(ym, dim=-1) + _EPS)
    return corr.mean()


def _estoi_from_bands(x_bands: Tensor, y_bands: Tensor) -> Tensor:
    """Extended STOI: row- then column-normalized segment correlation."""
    x = _segments(x_bands)
    y = _segments(y_bands)

    def _rowcol_normalize(s: Tensor) -> Tensor:
        s = s - s.mean(-1, keepdim=True)
        s = s / (torch.linalg.vector_norm(s, dim=-1, keepdim=True) + _EPS)
        s = s - s.mean(-2, keepdim=True)
        return s / (torch.linalg.vector_norm(s, dim=-2, keepdim=True) + _EPS)

    xn = _rowcol_normalize(x)
    yn = _rowcol_normalize(y)
    return (xn * yn).sum((-2, -1)).mean() / SEG_LEN


def stoi_core(target: Tensor, preds: Tensor, extended: bool = False) -> Tensor:
    """Differentiable STOI of a (voiced) 10 kHz signal pair, on their
    device, in float32."""
    target = torch.as_tensor(target).to(torch.float32)
    preds = torch.as_tensor(preds).to(device=target.device, dtype=torch.float32)
    obm = _constants(target.device)[0]
    x_bands = _band_spectrogram(target, obm)
    y_bands = _band_spectrogram(preds, obm)
    return (_estoi_from_bands if extended else _stoi_from_bands)(x_bands, y_bands)


def stoi_on_device(
    preds: Union[Tensor, np.ndarray],
    target: Union[Tensor, np.ndarray],
    fs: int = FS,
    extended: bool = False,
    vad: bool = True,
    device: Union[str, torch.device, None] = None,
) -> Tensor:
    """STOI per clip, the spectral core on ``device`` (CUDA unless the
    caller asks for the CPU).

    Args:
        preds: degraded or processed signal ``[..., time]`` (a tensor or a
            numpy array).
        target: clean reference signal ``[..., time]``.
        fs: input sample rate; any other than 10 kHz is resampled on the host
            (scipy's ``resample_poly``) first, as pystoi does.
        extended: the extended (ESTOI) variant.
        vad: silent-frame removal (host numpy).
        device: where the core runs and the scores are returned.

    Returns:
        float32 scores of shape ``preds.shape[:-1]``; a clip with fewer than
        one segment of voiced frames scores ``1e-5``, as in JAX.
    """
    device = resolve_device(device)
    preds_np = _host_float32(preds)
    target_np = _host_float32(target)
    if preds_np.shape != target_np.shape:
        raise ValueError(
            f"`preds` and `target` must have the same shape, got {preds_np.shape} vs {target_np.shape}"
        )
    if fs != FS:
        from scipy.signal import resample_poly

        g = int(np.gcd(int(fs), FS))
        preds_np = resample_poly(preds_np, FS // g, fs // g, axis=-1).astype(np.float32)
        target_np = resample_poly(target_np, FS // g, fs // g, axis=-1).astype(np.float32)

    flat_p = preds_np.reshape(-1, preds_np.shape[-1])
    flat_t = target_np.reshape(-1, target_np.shape[-1])
    scores = []
    for t, p in zip(flat_t, flat_p):
        if vad:
            t, p = remove_silent_frames(t, p)
        n_frames = (len(t) - N_FRAME) // (N_FRAME // 2) + 1 if len(t) >= N_FRAME else 0
        if n_frames < SEG_LEN:
            # the algorithm is undefined on less than one segment of voiced
            # audio: pystoi's tiny-score convention
            scores.append(torch.tensor(1e-5, dtype=torch.float32, device=device))
            continue
        pair = torch.from_numpy(np.stack([t, p])).to(device)
        scores.append(stoi_core(pair[0], pair[1], extended=extended))
    if not scores:
        return torch.zeros(preds_np.shape[:-1], dtype=torch.float32, device=device)
    return torch.stack(scores).reshape(preds_np.shape[:-1])

