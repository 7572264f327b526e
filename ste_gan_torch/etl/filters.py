"""Filter design and spectral helpers of the ETL, with ``scipy.signal``'s
semantics, so that the port needs no scipy.

The designs (:func:`iirnotch`, :func:`butter`, :func:`lfilter_zi`,
:func:`firwin_kaiser_lowpass`) are a few coefficients each and run in numpy
f64 on the host, step for step as scipy computes them: the analog
Butterworth prototype, pre-warped corners, the ``lp2lp``/``lp2hp``/``lp2bp``
transforms in zero-pole-gain form, the bilinear transform and
``zpk2tf``. :func:`filtfilt_stage` turns a design into what one zero-phase
stage of ``ops/iir.py`` needs (scipy's ``filtfilt`` defaults: odd
extension, ``padlen = 3 * max(len(a), len(b))``).

The signal functions (:func:`hilbert`, :func:`resample`,
:func:`resample_poly`) take torch tensors and run as torch FFTs and
convolutions on the tensor's device, along the last axis.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Coeffs = Tuple[np.ndarray, np.ndarray]


# ---------------------------------------------------------------------------
# IIR design (numpy f64)
# ---------------------------------------------------------------------------


def iirnotch(w0: float, Q: float = 30.0, fs: float = 2.0) -> Coeffs:
    """Second-order notch at ``w0`` Hz with quality ``Q`` (scipy's
    ``iirnotch``: -3 dB bandwidth ``w0 / Q``)."""
    w0 = 2.0 * float(w0) / fs
    if not 0.0 <= w0 <= 1.0:
        raise ValueError("w0 should be such that 0 < w0 < 1")
    bw = w0 / float(Q)
    bw = bw * np.pi
    w0 = w0 * np.pi
    beta = math.tan(bw / 2.0)
    gain = 1.0 / (1.0 + beta)
    b = gain * np.asarray([1.0, -2.0 * math.cos(w0), 1.0])
    a = np.asarray([1.0, -2.0 * gain * math.cos(w0), (2.0 * gain - 1.0)])
    return b, a


def _buttap(n: int):
    m = np.arange(-n + 1, n, 2, dtype=np.float64)
    return np.asarray([], np.float64), -np.exp(1j * np.pi * m / (2 * n)), 1.0


def _lp2lp_zpk(z, p, k, wo):
    degree = len(p) - len(z)
    return wo * z, wo * p, k * wo ** degree


def _lp2hp_zpk(z, p, k, wo):
    degree = len(p) - len(z)
    z_hp = np.concatenate((wo / z, np.zeros(degree)))
    return z_hp, wo / p, k * np.real(np.prod(-z) / np.prod(-p))


def _lp2bp_zpk(z, p, k, wo, bw):
    degree = len(p) - len(z)
    z_lp = (z * bw / 2).astype(np.complex128)
    p_lp = (p * bw / 2).astype(np.complex128)
    z_bp = np.concatenate((z_lp + np.sqrt(z_lp ** 2 - wo ** 2),
                           z_lp - np.sqrt(z_lp ** 2 - wo ** 2)))
    p_bp = np.concatenate((p_lp + np.sqrt(p_lp ** 2 - wo ** 2),
                           p_lp - np.sqrt(p_lp ** 2 - wo ** 2)))
    return np.concatenate((z_bp, np.zeros(degree))), p_bp, k * bw ** degree


def _bilinear_zpk(z, p, k, fs):
    degree = len(p) - len(z)
    fs2 = 2.0 * fs
    z_z = np.concatenate(((fs2 + z) / (fs2 - z), -np.ones(degree)))
    p_z = (fs2 + p) / (fs2 - p)
    return z_z, p_z, k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))


def _zpk2tf(z, p, k) -> Coeffs:
    # np.poly returns real coefficients for conjugate-paired roots, which
    # every filter designed here has.
    return (np.atleast_1d(np.real(k * np.poly(z))).astype(np.float64),
            np.atleast_1d(np.real(np.poly(p))).astype(np.float64))


_BTYPES = {"low": "lowpass", "lowpass": "lowpass", "high": "highpass",
           "highpass": "highpass", "band": "bandpass", "bandpass": "bandpass"}


def butter(N: int, Wn: Union[float, Sequence[float]], btype: str = "low",
           fs: float = None) -> Coeffs:
    """Digital Butterworth filter ``(b, a)`` of order ``N`` (scipy's
    ``butter(..., output="ba")``): low, high or band pass, corners in Hz
    when ``fs`` is given, else relative to Nyquist."""
    wn = np.asarray(Wn, dtype=np.float64)
    if fs is not None:
        wn = wn / (fs / 2)
    if np.any(wn <= 0) or np.any(wn >= 1):
        raise ValueError("digital filter critical frequencies must be "
                         "0 < Wn < fs/2")
    kind = _BTYPES.get(btype.lower())
    if kind is None:
        raise ValueError(f"'{btype}' is not a supported band type")
    z, p, k = _buttap(N)
    warped = 2 * 2.0 * np.tan(np.pi * wn / 2.0)
    if kind == "lowpass":
        z, p, k = _lp2lp_zpk(z, p, k, float(warped))
    elif kind == "highpass":
        z, p, k = _lp2hp_zpk(z, p, k, float(warped))
    else:
        if wn.size != 2 or not wn[0] < wn[1]:
            raise ValueError("a band pass needs Wn = (low, high), low < high")
        bw = float(warped[1] - warped[0])
        wo = float(np.sqrt(warped[0] * warped[1]))
        z, p, k = _lp2bp_zpk(z, p, k, wo, bw)
    return _zpk2tf(*_bilinear_zpk(z, p, k, 2.0))


def _normalize(b, a) -> Coeffs:
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    while len(a) > 1 and a[0] == 0.0:
        a = a[1:]
    if a[0] != 1.0:
        b, a = b / a[0], a / a[0]
    n = max(len(a), len(b))
    return (np.concatenate((b, np.zeros(n - len(b)))),
            np.concatenate((a, np.zeros(n - len(a)))))


def lfilter_zi(b, a) -> np.ndarray:
    """Initial state of ``lfilter``'s transposed direct form II for the
    steady state of a unit step (scipy's ``lfilter_zi``)."""
    b, a = _normalize(b, a)
    n = len(a)
    companion = np.zeros((n - 1, n - 1))
    companion[0, :] = -a[1:] / a[0]
    companion[np.arange(1, n - 1), np.arange(0, n - 2)] = 1.0
    i_minus_a = np.eye(n - 1) - companion.T
    return np.linalg.solve(i_minus_a, b[1:] - a[1:] * b[0])


def filtfilt_stage(b, a):
    """One zero-phase stage as ``ops/iir.py`` runs it: ``(b, a, zi,
    padlen)`` with ``a[0] == 1`` and ``b``/``a`` of one length, and scipy's
    default ``padlen = 3 * max(len(a), len(b))`` (taken before the leading
    zeros of ``a`` are dropped, as scipy does)."""
    padlen = 3 * max(len(np.atleast_1d(a)), len(np.atleast_1d(b)))
    bn, an = _normalize(b, a)
    return bn, an, lfilter_zi(bn, an), padlen


def firwin_kaiser_lowpass(numtaps: int, cutoff: float,
                          beta: float) -> np.ndarray:
    """Kaiser-windowed low-pass FIR, ``cutoff`` relative to Nyquist
    (scipy's ``firwin(numtaps, cutoff, window=("kaiser", beta))``, scaled to
    unit gain at DC)."""
    alpha = 0.5 * (numtaps - 1)
    m = np.arange(0, numtaps, dtype=np.float64) - alpha
    h = cutoff * np.sinc(cutoff * m)
    n = np.arange(0, numtaps, dtype=np.float64)
    w_alpha = (numtaps - 1) / 2.0
    win = (np.i0(beta * np.sqrt(1 - ((n - w_alpha) / w_alpha) ** 2.0))
           / np.i0(np.float64(beta)))
    h = h * win
    return h / np.sum(h)


# ---------------------------------------------------------------------------
# Spectral helpers (torch, on the tensor's device, last axis)
# ---------------------------------------------------------------------------


def hilbert(x: torch.Tensor) -> torch.Tensor:
    """Analytic signal of real ``x`` along the last axis (scipy's
    ``hilbert``: FFT, the ``h`` vector that doubles the positive
    frequencies and zeroes the negative ones, inverse FFT)."""
    n = x.shape[-1]
    spec = torch.fft.fft(x, dim=-1)
    h = torch.zeros(n, dtype=x.dtype, device=x.device)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    return torch.fft.ifft(spec * h, dim=-1)


def resample(x: torch.Tensor, num: int) -> torch.Tensor:
    """FFT resampling of real ``x`` to ``num`` samples along the last axis
    (scipy's ``resample`` with no window): keep the lowest ``min(num, n)``
    bins; for an even count the unpaired bin at ``m // 2`` is doubled when
    downsampling and halved when upsampling."""
    n = x.shape[-1]
    s_fac = n / num
    m = min(num, n)
    m2 = m // 2 + 1
    spec = torch.fft.rfft(x, dim=-1)[..., :m2].clone()
    if m % 2 == 0 and num != n:
        spec[..., m // 2] *= 2 if num < n else 0.5
    spec = spec / s_fac
    # pocketfft's inverse ignores the imaginary parts of the DC and Nyquist
    # bins; cuFFT's does not promise to, so they are dropped here.
    spec[..., 0].imag.zero_()
    if num % 2 == 0 and spec.shape[-1] == num // 2 + 1:
        spec[..., num // 2].imag.zero_()
    return torch.fft.irfft(spec, n=num, dim=-1)


def _upfirdn_len(len_h: int, n_in: int, up: int, down: int) -> int:
    return ((n_in - 1) * up + len_h - 1) // down + 1


def resample_poly(x: torch.Tensor, up: int, down: int,
                  beta: float = 5.0) -> torch.Tensor:
    """Polyphase resampling by ``up / down`` along the last axis (scipy's
    ``resample_poly`` with its default Kaiser window, beta 5.0, and zero
    padding): upsample by zero insertion, the ``firwin`` low-pass times
    ``up``, downsample, and cut the filter's delay; computed in polyphase
    form, so no zero-stuffed signal is built."""
    g = math.gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    if up == down == 1:
        return x.clone()
    n_in = x.shape[-1]
    n_out = n_in * up
    n_out = n_out // down + bool(n_out % down)
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin_kaiser_lowpass(2 * half_len + 1, 1.0 / max_rate, beta) * up
    n_pre_pad = down - half_len % down
    n_post_pad = 0
    n_pre_remove = (half_len + n_pre_pad) // down
    while (_upfirdn_len(len(h) + n_pre_pad + n_post_pad, n_in, up, down)
           < n_out + n_pre_remove):
        n_post_pad += 1
    h = np.concatenate((np.zeros(n_pre_pad), h, np.zeros(n_post_pad)))

    # Polyphase form of upsample-filter-downsample: output k reads the
    # filter's phase (k * down) % up against the input before
    # (k * down) // up, one gather and one weighted sum for every output.
    taps = np.concatenate((h, np.zeros(-len(h) % up))).reshape(-1, up)
    k = np.arange(n_pre_remove, n_pre_remove + n_out)
    base, phase = (k * down) // up, (k * down) % up
    idx = base[:, None] - np.arange(taps.shape[0])[None, :]
    valid = (idx >= 0) & (idx < n_in)
    weights = np.where(valid, taps[:, phase].T, 0.0)
    gather = torch.from_numpy(np.clip(idx, 0, n_in - 1)).to(x.device)
    w = torch.from_numpy(weights).to(x.device, x.dtype)
    return (x[..., gather] * w).sum(-1)
