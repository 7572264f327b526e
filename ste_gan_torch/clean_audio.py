"""Offline audio cleaning for the Gaddy & Klein corpus, on the card.

    python -m ste_gan_torch.clean_audio --source_data_dir raw_data/emg_data \\
        [--overwrite] [--device cpu]

Counterpart of ``scripts/clean_audio.py``: per session directory, take the
noise profile from the silence clip ``0_audio.flac``, denoise every
``*_audio.flac`` and write ``*_audio_clean.flac`` (``.wav`` without
soundfile), volume-normalised.

Denoising backends, best available first, behind the same import guards:
1. ``noisereduce`` (2.x signature, else 1.x), then speechbrain's
   MetricGAN+ enhancement, when they import (the reference's stack; the
   enhancer is loaded once per cleaner, not per file);
2. the built-in spectral gate (:func:`spectral_gate_denoise`): per-band
   thresholds from the silence clip's STFT, on the card as ``torch.stft`` /
   ``torch.istft`` arranged to equal ``scipy.signal.stft``/``istft``.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises. The log says which backend cleaned each directory.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ste_gan_torch.device import resolve_device
from ste_gan_torch.etl.audio_dsp import (
    find_audio_file, normalize_volume, read_audio_file, write_audio_file)

LOG = logging.getLogger(__name__)
SAMPLE_RATE = 16_000


def _stft(x: torch.Tensor, window: torch.Tensor, n_fft: int,
          hop: int) -> torch.Tensor:
    """``scipy.signal.stft`` defaults: zeros of ``n_fft // 2`` at both ends
    (``boundary="zeros"``), zeros at the end up to a whole frame
    (``padded=True``), no centering beyond that, ``1 / window.sum()``
    scaling. ``[freqs, frames]`` complex."""
    x = F.pad(x, (n_fft // 2, n_fft // 2))
    x = F.pad(x, (0, (-(x.shape[-1] - n_fft) % hop) % n_fft))
    spec = torch.stft(x, n_fft=n_fft, hop_length=hop, win_length=n_fft,
                      window=window, center=False, return_complex=True)
    return spec / window.sum()


def _istft(spec: torch.Tensor, window: torch.Tensor, n_fft: int,
           hop: int) -> torch.Tensor:
    """``scipy.signal.istft`` defaults: inverse FFT of each frame times the
    window, overlap-added, divided by the summed squared window and trimmed
    by ``n_fft // 2`` at both ends (``center=True`` trims exactly that; the
    trimmed span has no window-envelope zero)."""
    return torch.istft(spec * window.sum(), n_fft=n_fft, hop_length=hop,
                       win_length=n_fft, window=window, center=True)


def spectral_gate_denoise(audio: torch.Tensor, noise_clip: torch.Tensor,
                          n_fft: int = 512, hop: int = 128,
                          gain_floor: float = 0.1,
                          threshold_scale: float = 1.5) -> torch.Tensor:
    """STFT spectral gating on the audio's device: bands whose magnitude
    falls below ``threshold_scale`` x the noise profile are attenuated to
    ``gain_floor``, the gain smoothed over five frames."""
    window = torch.from_numpy(np.hanning(n_fft)).to(audio.device, audio.dtype)
    noise_profile = _stft(noise_clip.to(audio), window, n_fft, hop).abs().mean(
        dim=1, keepdim=True)
    spec = _stft(audio, window, n_fft, hop)
    gate = spec.abs() > threshold_scale * noise_profile
    gain = torch.where(gate, 1.0, gain_floor).to(audio.dtype)
    # Smooth the gain over time (np.convolve "same" with a 5-frame box).
    kernel = torch.full((1, 1, 5), 1.0 / 5.0, dtype=audio.dtype,
                        device=audio.device)
    gain = F.conv1d(gain[:, None, :], kernel, padding=2)[:, 0]
    return _istft(spec * gain, window, n_fft, hop)[: len(audio)]


class AudioCleaner:
    """The cleaning backends for one run on ``device``; the MetricGAN+
    enhancer, when it imports, is loaded at first use and reused."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.enhancer = None

    def denoise(self, audio: np.ndarray, noise_clip: np.ndarray
                ) -> Tuple[np.ndarray, str]:
        """(denoised audio f64, backend name)."""
        try:
            import noisereduce

            try:
                # noisereduce >= 2.x signature.
                out = noisereduce.reduce_noise(y=audio, y_noise=noise_clip,
                                               sr=SAMPLE_RATE)
            except TypeError:
                # 1.x signature, the version the reference used.
                out = noisereduce.reduce_noise(audio_clip=audio,
                                               noise_clip=noise_clip)
            return np.asarray(out, np.float64), "noisereduce"
        except (ImportError, AttributeError):
            pass
        except TypeError as exc:
            # Both noisereduce signatures rejected the call: an input error,
            # not a missing package; say so before falling back.
            print(f"noisereduce rejected the call ({exc}); using the built-in "
                  "spectral-gate fallback", file=sys.stderr)
        out = spectral_gate_denoise(
            torch.from_numpy(audio).to(self.device),
            torch.from_numpy(noise_clip).to(self.device))
        return out.cpu().numpy(), "spectral gate"

    def maybe_enhance(self, audio: np.ndarray) -> Tuple[np.ndarray, bool]:
        """speechbrain MetricGAN+ enhancement when it imports; the audio
        unchanged otherwise. Returns (audio, enhanced)."""
        try:
            from speechbrain.pretrained import SpectralMaskEnhancement

            if self.enhancer is None:
                self.enhancer = SpectralMaskEnhancement.from_hparams(
                    source="speechbrain/metricgan-plus-voicebank",
                    savedir="pretrained_models/metricgan-plus-voicebank")
            noisy = torch.from_numpy(audio[None]).float()
            enhanced = self.enhancer.enhance_batch(noisy,
                                                   lengths=torch.tensor([1.0]))
            return enhanced.squeeze(0).numpy(), True
        except (ImportError, AttributeError):
            return audio, False

    def clean(self, audio: np.ndarray, noise_clip: np.ndarray
              ) -> Tuple[np.ndarray, str]:
        cleaned, backend = self.denoise(audio, noise_clip)
        cleaned, enhanced = self.maybe_enhance(cleaned)
        if enhanced:
            backend += " + MetricGAN+"
        out = normalize_volume(torch.from_numpy(
            np.asarray(cleaned, np.float64)).to(self.device))
        return out.cpu().numpy(), backend


def clean_directory(session_dir: Path, cleaner: Optional[AudioCleaner] = None,
                    overwrite: bool = False) -> int:
    """Clean every ``*_audio`` file of one session; returns how many were
    written."""
    cleaner = cleaner or AudioCleaner()
    try:
        noise_path = find_audio_file(session_dir / "0_audio.flac")
    except FileNotFoundError:
        print(f"skipping {session_dir}: no 0_audio noise profile")
        return 0
    noise_clip, _ = read_audio_file(noise_path)

    count, backends = 0, set()
    audio_paths = sorted(list(session_dir.glob("*_audio.flac"))
                         + list(session_dir.glob("*_audio.wav")))
    for audio_path in audio_paths:
        if audio_path.stem.endswith("_clean"):
            continue
        out_path = audio_path.with_name(
            audio_path.stem + "_clean" + audio_path.suffix)
        if _written(out_path) and not overwrite:
            continue
        audio, sr = read_audio_file(audio_path)
        if sr != SAMPLE_RATE:
            raise ValueError(f"{audio_path}: {sr} Hz, want {SAMPLE_RATE}")
        cleaned, backend = cleaner.clean(audio, noise_clip)
        backends.add(backend)
        write_audio_file(out_path, cleaned, SAMPLE_RATE)
        count += 1
    if count:
        LOG.info("%s: %d files cleaned with %s on %s", session_dir, count,
                 ", ".join(sorted(backends)), cleaner.device)
    return count


def _written(path: Path) -> bool:
    """Whether a cleaned file exists under ``path`` or its .flac/.wav
    sibling (without soundfile a .flac name is written as .wav)."""
    try:
        find_audio_file(path)
        return True
    except FileNotFoundError:
        return False


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source_data_dir", type=Path,
                        default=Path("raw_data/emg_data/"))
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to clean on (default cuda; 'cpu' runs "
                             "the gate on the CPU).")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cleaner = AudioCleaner(args.device)

    total = 0
    for sub in ("silent_parallel_data", "voiced_parallel_data",
                "nonparallel_data"):
        base = Path(args.source_data_dir) / sub
        if not base.exists():
            continue
        for session_dir in sorted(base.iterdir()):
            if session_dir.is_dir():
                total += clean_directory(session_dir, cleaner,
                                         overwrite=args.overwrite)
    print(f"cleaned {total} audio files")
    return total


if __name__ == "__main__":
    main()
