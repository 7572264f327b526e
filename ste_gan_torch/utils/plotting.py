"""Real-vs-fake EMG envelope plots (host-side matplotlib).

Counterpart of ``ste_gan_tpu/utils/plotting.py`` (the reference's
ste_gan/utils/plot_utils.py): the envelope is a 40-point moving average of
the rectified signal; a figure shows per-channel signal and envelope of real
and generated EMG and goes to the run's :class:`MetricLogger`.

matplotlib is imported inside the plot functions, not with this module, so
the port imports where matplotlib is not installed;
:func:`matplotlib_available` says whether the plots can run.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np


def matplotlib_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def get_envelope(emg_signal: np.ndarray, num_points: int = 40) -> np.ndarray:
    """|x| smoothed with a centred moving average (reflect padded)."""
    pad = num_points // 2
    rect = np.abs(emg_signal)
    padded = np.pad(rect, ((pad, pad - 1 + num_points % 2), (0, 0)),
                    mode="reflect")
    kernel = np.ones(num_points) / num_points
    return np.stack([
        np.convolve(padded[:, c], kernel, mode="valid")
        for c in range(rect.shape[1])], axis=1)


def plot_emg_signal_with_envelope(
    emg_signal: np.ndarray,
    ax=None,
    title: str = "EMG Signal",
    ylim: Tuple[float, float] = (-1.0, 1.0),
    channels: Sequence[int] = (0, 1, 2, 3, 4),
    emg_sig_alpha: float = 0.3,
):
    plt = _pyplot()
    if ax is None:
        _, ax = plt.subplots()
    envelope = get_envelope(emg_signal)
    n = min(len(envelope), len(emg_signal))
    ticks = np.arange(n)
    cmap = plt.get_cmap("tab10")
    for ch in channels:
        color = cmap(ch)
        ax.plot(ticks, emg_signal[:n, ch], alpha=emg_sig_alpha, color=color)
        ax.plot(ticks, envelope[:n, ch], color=color)
    ax.set_title(title)
    ax.set_ylim(*ylim)
    ax.set_xlabel("Sample")
    ax.set_ylabel("Amplitude")
    return ax


def plot_real_vs_fake_emg_signal_with_envelope(
    real_emg_signal: np.ndarray,
    fake_emg_signal: np.ndarray,
    file_id: str,
    save_as: Optional[Path] = None,
    metric_logger=None,
    tag_prefix: str = "val/envelopes_emg_real_vs_fake",
    global_step: int = 0,
):
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(2)
    fig.suptitle(f"Real vs. fake EMG signal ({file_id})")
    plot_emg_signal_with_envelope(real_emg_signal, ax1, title="Real EMG signal")
    plot_emg_signal_with_envelope(fake_emg_signal, ax2, title="Fake EMG signal")
    fig.tight_layout()
    if save_as:
        fig.savefig(save_as)
    if metric_logger is not None:
        metric_logger.figure(f"{tag_prefix}_{file_id}", fig, global_step)
    plt.close(fig)
    return fig
