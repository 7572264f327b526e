"""EMG signal processing of the corpus preparation, on the device.

Counterpart of ``ste_gan_tpu/etl/emg_dsp.py`` (the reference's
``ste_gan/utils/emg_utils.py``), with the same semantics on torch tensors:
notches at 60 Hz and its harmonics and a 3rd-order Butterworth drift
high-pass at the source rate (1 kHz) with the neighbouring utterances as
context, linear resampling to 800 Hz, framewise time-domain features and a
Hilbert-envelope feature at 100 Hz.

Signals are ``[T]`` or ``[T, C]`` (time first, as the JAX functions take
one channel and ``apply_to_all`` stacks channels on axis 1), f64 on any
device; every filter of a call runs through one launch of
``filtfilt_kernel`` on the card (``ops/iir.py``), its plain version on the
CPU. :func:`get_emg_features` returns f32, as the JAX package does.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ste_gan_torch.etl import filters
from ste_gan_torch.ops.iir import filtfilt_cascade


def _filter(signal: torch.Tensor, designs: List[Tuple]) -> torch.Tensor:
    """The zero-phase stages ``designs`` along the time axis (0) of a
    ``[T]`` or ``[T, C]`` signal, every channel in one cascade."""
    rows = signal.reshape(signal.shape[0], -1).T.contiguous()
    out = filtfilt_cascade(rows, [rows.shape[1]] * rows.shape[0], designs)
    return out.T.reshape(signal.shape)


def subsample(signal: torch.Tensor, new_freq: float,
              old_freq: float) -> torch.Tensor:
    """Linear-interpolation resampling along axis 0 (``np.interp`` at
    ``np.arange(0, times[-1], 1 / new_freq)``, float end point included)."""
    n = signal.shape[0]
    times = torch.arange(n, dtype=torch.float64, device=signal.device) / old_freq
    step = 1 / new_freq
    stop = (n - 1) / old_freq
    count = max(0, math.ceil(stop / step))
    sample_times = torch.arange(count, dtype=torch.float64,
                                device=signal.device) * step
    j = (torch.searchsorted(times, sample_times, right=True) - 1).clamp(
        0, max(n - 2, 0))
    x0, x1 = times[j], times[j + 1]
    shape = (-1,) + (1,) * (signal.dim() - 1)
    f0, f1 = signal[j], signal[j + 1]
    slope = (f1 - f0) / (x1 - x0).reshape(shape)
    return slope * (sample_times - x0).reshape(shape) + f0


def notch_designs(freq: float, sample_frequency: float,
                  harmonics: int = 7) -> List[Tuple]:
    return [filters.iirnotch(freq * h, 30, sample_frequency)
            for h in range(1, harmonics + 1)]


def drift_design(fs: float) -> Tuple:
    return filters.butter(3, 2, "highpass", fs=fs)


def notch(signal: torch.Tensor, freq: float,
          sample_frequency: float) -> torch.Tensor:
    return _filter(signal, [filters.iirnotch(freq, 30, sample_frequency)])


def notch_harmonics(signal: torch.Tensor, freq: float,
                    sample_frequency: float) -> torch.Tensor:
    """Notch out a frequency and its first 7 harmonics."""
    return _filter(signal, notch_designs(freq, sample_frequency))


def remove_drift(signal: torch.Tensor, fs: float) -> torch.Tensor:
    return _filter(signal, [drift_design(fs)])


def bandpass_signal(signal: torch.Tensor, fs: float) -> torch.Tensor:
    """2-400 Hz band-pass."""
    return _filter(signal, [filters.butter(2, (2, 400), "bandpass", fs=fs)])


def lowpass_after_bandpass(signal: torch.Tensor, fs: float) -> torch.Tensor:
    """10 Hz low-pass."""
    return _filter(signal, [filters.butter(2, 10, "lowpass", fs=fs)])


def average_by_points(signal: torch.Tensor, points: int) -> torch.Tensor:
    """Centered moving average along axis 0 (``np.convolve(x, ones(points)
    / points, "same")``)."""
    rows = signal.reshape(signal.shape[0], -1).T[:, None, :]
    taps = torch.full((1, 1, points), 1.0 / float(points), dtype=signal.dtype,
                      device=signal.device)
    full = F.conv1d(rows, taps, padding=points - 1)
    start = (points - 1) // 2
    out = full[:, 0, start:start + signal.shape[0]]
    return out.T.reshape(signal.shape)


def double_average(x: torch.Tensor) -> torch.Tensor:
    return average_by_points(average_by_points(x, 9), 9)


def pre_process_emg_signal(raw_emg: torch.Tensor, raw_emg_before: torch.Tensor,
                           raw_emg_after: torch.Tensor,
                           emg_raw_target_sample_rate: int = 800,
                           emg_source_sample_rate: int = 1000) -> torch.Tensor:
    """Filter with the neighbouring utterances as context (notch harmonics,
    then drift removal: one cascade of eight stages over every channel),
    strip the context, then resample to the target rate. ``[T, C]`` f64."""
    x = torch.cat([raw_emg_before, raw_emg, raw_emg_after], 0)
    x = _filter(x, notch_designs(60, emg_source_sample_rate)
                + [drift_design(emg_source_sample_rate)])
    x = x[raw_emg_before.shape[0]: x.shape[0] - raw_emg_after.shape[0]]
    return subsample(x, emg_raw_target_sample_rate, emg_source_sample_rate)


# ---------------------------------------------------------------------------
# Framewise features (librosa semantics)
# ---------------------------------------------------------------------------


def _frame(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """``[T, ...]`` -> ``[frame_length, num_frames, ...]`` sliding windows
    (no padding, trailing remainder dropped)."""
    frames = x.unfold(0, frame_length, hop_length)  # [F, ..., L]
    return frames.movedim(-1, 0)


def _frame_rms(x: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    frames = _frame(x, frame_length, hop_length)
    return torch.sqrt(torch.mean(torch.square(frames), dim=0))


def _frame_zcr(x: torch.Tensor, frame_length: int, hop_length: int,
               threshold: float = 1e-10) -> torch.Tensor:
    """Zero-crossing rate per frame: values within +-threshold snap to +0,
    crossings are sign-bit changes inside the frame (its first sample
    counts none)."""
    frames = _frame(x, frame_length, hop_length)
    frames = torch.where(frames.abs() <= threshold, 0.0, frames)
    sign = ~torch.signbit(frames)
    crossings = torch.zeros_like(sign)
    crossings[1:] = sign[1:] != sign[:-1]
    return crossings.to(x.dtype).mean(dim=0)


def calculate_hilbert_envelope(x: torch.Tensor) -> torch.Tensor:
    """``|hilbert(x)|`` along axis 0."""
    return filters.hilbert(x.movedim(0, -1)).abs().movedim(-1, 0)


def calculate_hilbert_transform_feats(
        x: torch.Tensor, input_emg_sample_rate: int = 800,
        target_feat_sample_rate: int = 100, lowpass_filter_hz: int = 20,
        max_num_frames: int = -1) -> torch.Tensor:
    """Hilbert envelope -> 4th-order 20 Hz low-pass (one cascade over every
    channel) -> FFT resampling to 100 Hz, along axis 0."""
    envelope = calculate_hilbert_envelope(x)
    design = filters.butter(4, lowpass_filter_hz, fs=input_emg_sample_rate,
                            btype="low")
    envelope = _filter(envelope, [design])
    factor = input_emg_sample_rate / target_feat_sample_rate
    num_expected = int(len(envelope) / factor)
    envelope = filters.resample(envelope.movedim(0, -1),
                                num_expected).movedim(-1, 0)
    if max_num_frames >= 0:
        envelope = envelope[:max_num_frames]
    return envelope


def get_emg_features(emg_data_input: torch.Tensor, frame_length_samples: int = 26,
                     hop_length_samples: int = 8, add_hilbert: bool = True,
                     emg_sr: int = 800, pad: bool = False,
                     subtract_mean: bool = True) -> torch.Tensor:
    """Per-channel framewise TD features at ~100 Hz of ``[T, C]`` f64:
    ``[num_frames, C, 5 or 6]`` f32 stacking mean(low), rms(low),
    rms(rect high), zcr(high), mean(rect high) [, hilbert envelope]. The
    Hilbert feature is computed on the input as given (unpadded, mean
    kept)."""
    if pad:
        padding = (frame_length_samples - hop_length_samples) // 2
        emg_data = F.pad(emg_data_input.T[None], (padding, padding),
                         mode="reflect")[0].T
    else:
        emg_data = emg_data_input
    xs = (emg_data - emg_data.mean(dim=0, keepdim=True) if subtract_mean
          else emg_data)
    fl, hop = frame_length_samples, hop_length_samples
    w = double_average(xs)
    p = xs - w
    r = p.abs()
    w_h = _frame(w, fl, hop).mean(dim=0)
    feats = [w_h, _frame_rms(w, fl, hop), _frame_rms(r, fl, hop),
             _frame_zcr(p, fl, hop), _frame(r, fl, hop).mean(dim=0)]
    if add_hilbert:
        feats.append(calculate_hilbert_transform_feats(
            emg_data_input, max_num_frames=w_h.shape[0],
            input_emg_sample_rate=emg_sr))
    return torch.stack(feats, dim=-1).float()


def cut_emg_to_hubert_units(emg, num_units: int, emg_sr: int = 800,
                            hubert_sr: int = 50):
    expected = num_units * (emg_sr // hubert_sr)
    if expected > len(emg):
        raise ValueError(f"{num_units} units need {expected} EMG samples; "
                         f"the signal has {len(emg)}")
    return emg[:expected]


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A numpy signal as an f64 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(array, np.float64)).to(device)
