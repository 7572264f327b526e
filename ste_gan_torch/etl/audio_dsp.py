"""Audio frontend of the corpus preparation: loading and normalisation,
TextGrid phoneme alignment and the MFCC extractor, on the device.

Counterpart of ``ste_gan_tpu/etl/audio_dsp.py`` (the reference's
``ste_gan/utils/audio_utils.py``): RMS-peak volume normalisation to 0.2,
phoneme id sequences at the 50 Hz speech-unit rate from forced-alignment
TextGrids, audio trimmed to whole speech-unit frames, and the
25-coefficient MFCC frontend (16 kHz, 512-sample window, 160-sample hop ->
100 Hz, 80 HTK mels, power to dB with a global 80 dB floor, orthonormal
DCT-II, reflect pre-padding), as torch ops in f32.

Audio I/O reads and writes with ``soundfile`` when it imports, as the JAX
package does; without it, RIFF/WAVE files are read and written here in
numpy (PCM int16/int32 scaled by the type's maximum, IEEE float32/64 as
they are; float32 written, as ``scipy.io.wavfile`` writes it), and
``.flac`` names map to ``.wav``.
"""
from __future__ import annotations

import contextlib
import math
import re
import string
import struct
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ste_gan_torch.constants import PHONEME_INVENTORY
from ste_gan_torch.device import resolve_device
from ste_gan_torch.etl import filters


# ---------------------------------------------------------------------------
# Loading / normalisation
# ---------------------------------------------------------------------------


def _frame_rms_centered(audio: torch.Tensor, frame_length: int = 2048,
                        hop_length: int = 512) -> torch.Tensor:
    """librosa.feature.rms semantics (center=True zero padding)."""
    pad = frame_length // 2
    x = F.pad(audio, (pad, pad))
    frames = x.unfold(0, frame_length, hop_length)
    return torch.sqrt(torch.mean(torch.square(frames), dim=1))


def normalize_volume(audio: torch.Tensor, target_rms: float = 0.2) -> torch.Tensor:
    """Scale so the max frame RMS hits ``target_rms``; then down to a peak
    of 1 if it overshoots."""
    max_rms = _frame_rms_centered(audio).max() + 0.01
    audio = audio * (target_rms / max_rms)
    max_val = audio.abs().max()
    return torch.where(max_val > 1.0, audio / max_val, audio)


_WAVE_FORMAT_PCM, _WAVE_FORMAT_FLOAT, _WAVE_FORMAT_EXTENSIBLE = 1, 3, 0xFFFE
_WAV_DTYPES = {(_WAVE_FORMAT_PCM, 16): "<i2", (_WAVE_FORMAT_PCM, 32): "<i4",
               (_WAVE_FORMAT_PCM, 8): "u1", (_WAVE_FORMAT_FLOAT, 32): "<f4",
               (_WAVE_FORMAT_FLOAT, 64): "<f8"}


def read_wav(path: Path) -> Tuple[np.ndarray, int]:
    """Samples (``[N]`` mono, ``[N, C]`` otherwise, in the file's type)
    and rate of a RIFF/WAVE file."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path} is not a RIFF/WAVE file")
    pos, fmt, samples = 12, None, None
    while pos + 8 <= len(data):
        chunk, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk == b"fmt ":
            tag, channels, rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
            if tag == _WAVE_FORMAT_EXTENSIBLE:
                tag = struct.unpack("<H", body[24:26])[0]
            fmt = (tag, channels, rate, bits)
        elif chunk == b"data":
            samples = body
        pos += 8 + size + (size & 1)
    if fmt is None or samples is None:
        raise ValueError(f"{path}: no fmt or data chunk")
    tag, channels, rate, bits = fmt
    dtype = _WAV_DTYPES.get((tag, bits))
    if dtype is None:
        raise ValueError(f"{path}: unsupported WAV format {tag} with {bits} "
                         f"bits per sample")
    audio = np.frombuffer(samples[:len(samples) - len(samples) % (
        channels * bits // 8)], dtype).astype(np.dtype(dtype).newbyteorder("="))
    return (audio.reshape(-1, channels) if channels > 1 else audio), int(rate)


def write_wav(path: Path, audio: np.ndarray, sample_rate: int) -> None:
    """IEEE-float32 RIFF/WAVE (format tag 3, a ``fact`` chunk), the layout
    ``scipy.io.wavfile.write`` gives a float32 array."""
    audio = np.asarray(audio, np.float32)
    channels = 1 if audio.ndim == 1 else audio.shape[1]
    payload = audio.astype("<f4").tobytes()
    fmt = struct.pack("<HHIIHH", _WAVE_FORMAT_FLOAT, channels, sample_rate,
                      sample_rate * 4 * channels, 4 * channels, 32) + b"\x00\x00"
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"fact"
            + struct.pack("<II", 4, audio.shape[0]) + b"data"
            + struct.pack("<I", len(payload)) + payload)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def read_audio_file(path: Path):
    """(audio float64, sample_rate). soundfile when available (flac + wav);
    the WAV reader of this module otherwise."""
    try:
        import soundfile as sf

        # hasattr guards against stub modules installed by oracle loaders.
        audio, sr = sf.read(str(path))
        return np.asarray(audio, np.float64), int(sr)
    except (ImportError, AttributeError):
        audio, sr = read_wav(path)
        if audio.dtype.kind == "i":
            audio = audio.astype(np.float64) / np.iinfo(audio.dtype).max
        return audio.astype(np.float64), int(sr)


def write_audio_file(path: Path, audio, sample_rate: int) -> Path:
    """Write mono audio. Without soundfile, flac targets are written as wav
    next to the requested name (the readers try both extensions)."""
    path = Path(path)
    audio = (audio.detach().cpu().numpy() if torch.is_tensor(audio)
             else np.asarray(audio))
    try:
        import soundfile as sf

        sf.write(str(path), audio, samplerate=sample_rate)
        return path
    except (ImportError, AttributeError):
        path = path.with_suffix(".wav")
        write_wav(path, audio, sample_rate)
        return path


def find_audio_file(path: Path) -> Path:
    """Resolve an audio artifact that may be .flac (soundfile present at
    write time) or .wav (fallback)."""
    path = Path(path)
    if path.exists():
        return path
    alt = path.with_suffix(".wav" if path.suffix == ".flac" else ".flac")
    if alt.exists():
        return alt
    raise FileNotFoundError(f"no audio file at {path} (or {alt.name})")


def load_audio(audio_file_path: Path, sampling_rate: int = 16_000,
               normalize: bool = True, device=None) -> torch.Tensor:
    """Mono audio as an f64 tensor on ``device`` (default cuda): resampled
    by ``resample_poly`` when its rate differs, first channel, then
    volume-normalised."""
    dev = resolve_device(device)
    audio, sr = read_audio_file(find_audio_file(audio_file_path))
    audio = torch.from_numpy(np.ascontiguousarray(audio)).to(dev)
    if sr != sampling_rate:
        audio = filters.resample_poly(audio.movedim(0, -1), sampling_rate,
                                      sr).movedim(-1, 0)
    if audio.dim() > 1:
        audio = audio[:, 0]
    if normalize:
        audio = normalize_volume(audio)
    return audio


def cut_audio_to_soft_speech_match_unit_frame_rate(
        audio, sample_rate: int = 16_000, speech_unit_frequency: int = 50):
    """Trim to a whole number of speech-unit frames."""
    downsample_rate = sample_rate // speech_unit_frequency
    num_units = len(audio) // downsample_rate
    return audio[: num_units * downsample_rate]


# ---------------------------------------------------------------------------
# TextGrid phoneme alignment (minimal long-format parser)
# ---------------------------------------------------------------------------


_INTERVAL_RE = re.compile(
    r'intervals\s*\[\d+\]:\s*xmin\s*=\s*([\d.eE+-]+)\s*'
    r'xmax\s*=\s*([\d.eE+-]+)\s*text\s*=\s*"([^"]*)"', re.S)
_ITEM_RE = re.compile(r'item\s*\[\d+\]:(.*?)(?=item\s*\[\d+\]:|\Z)', re.S)
_NAME_RE = re.compile(r'name\s*=\s*"([^"]*)"')


def parse_textgrid_tier(path: Path, tier: str = "phones"
                        ) -> List[Tuple[float, float, str]]:
    """(xmin, xmax, text) intervals of one tier of a long-format TextGrid."""
    text = Path(path).read_text(errors="replace")
    for item in _ITEM_RE.findall(text):
        name = _NAME_RE.search(item)
        if name and name.group(1) == tier:
            return [(float(a), float(b), t)
                    for a, b, t in _INTERVAL_RE.findall(item)]
    raise ValueError(f"tier '{tier}' not found in {path}")


def read_phonemes(textgrid_fname: Path, max_len: Optional[int] = None,
                  coeff: float = 50.0) -> np.ndarray:
    """Forced-alignment TextGrid -> 50 Hz phoneme-id sequence (int64)."""
    intervals = parse_textgrid_tier(textgrid_fname, "phones")
    phone_ids = np.full(int(intervals[-1][1] * coeff) + 1, -1, dtype=np.int64)
    phone_ids[-1] = PHONEME_INVENTORY.index("sil")
    for xmin, xmax, phone in intervals:
        phone = phone.lower()
        if phone in ("", "sp", "spn"):
            phone = "sil"
        if phone and phone[-1] in string.digits:
            phone = phone[:-1]
        ph_id = PHONEME_INVENTORY.index(phone)
        phone_ids[int(xmin * coeff): int(xmax * coeff)] = ph_id
    if not (phone_ids >= 0).all():
        raise ValueError(f"{textgrid_fname}: missing aligned phones")
    if max_len is not None:
        phone_ids = phone_ids[:max_len]
        if phone_ids.shape[0] != max_len:
            raise ValueError(f"{textgrid_fname}: {phone_ids.shape[0]} phones "
                             f"for {max_len} units")
    return phone_ids


# ---------------------------------------------------------------------------
# MFCC (torch, f32, on the device)
# ---------------------------------------------------------------------------


def hz_to_mel_htk(freq):
    return 2595.0 * np.log10(1.0 + freq / 700.0)


def mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: Optional[float] = None) -> np.ndarray:
    """torchaudio ``melscale_fbanks(htk, norm=None)`` semantics: triangular
    filters on the HTK mel scale; ``[n_freqs, n_mels]`` f32."""
    f_max = f_max or sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def _dct_ortho(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis ``[n_mels, n_mfcc]`` f32 (torchaudio
    ``create_dct``)."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)
    basis = np.cos(math.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    basis *= math.sqrt(2.0 / n_mels)
    basis[:, 0] *= 1.0 / math.sqrt(2.0)
    return basis.astype(np.float32)


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matrix products in full f32 (no TF32) inside the block, whatever
    the process set; restored after. The MFCC's dB floor (max - 80 dB)
    magnifies relative error in small mel energies."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def mfcc(audio: torch.Tensor, n_mfcc: int = 25, win_length: int = 512,
         hop_length: int = 160, sample_rate: int = 16_000, n_mels: int = 80,
         top_db: float = 80.0) -> torch.Tensor:
    """``[T_audio]`` -> ``[n_frames, n_mfcc]`` f32 at 100 Hz on the
    audio's device: reflect pad by (win - hop) / 2, framed periodic-Hann
    STFT (no centering), power spectrum, HTK mel filterbank, power to dB
    with the signal's ``max - top_db`` floor, orthonormal DCT-II."""
    dev = audio.device
    padding = (win_length - hop_length) // 2
    x = F.pad(audio.float()[None, None], (padding, padding), mode="reflect")[0, 0]
    frames = x.unfold(0, win_length, hop_length)  # [n_frames, win]
    window = torch.from_numpy(
        np.hanning(win_length + 1)[:-1].astype(np.float32)).to(dev)
    spec = torch.fft.rfft(frames * window, n=win_length, dim=-1)
    power = torch.square(torch.abs(spec))
    fbank = torch.from_numpy(mel_filterbank(win_length // 2 + 1, n_mels,
                                            sample_rate)).to(dev)
    dct = torch.from_numpy(_dct_ortho(n_mfcc, n_mels)).to(dev)
    with full_f32_matmul():
        mel = power @ fbank
        db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
        db = torch.maximum(db, db.max() - top_db)
        return db @ dct


class MFCCsCalculator:
    """The MFCC frontend on ``device`` (default cuda; raises without a card
    unless ``device="cpu"``)."""

    def __init__(self, n_mfcc: int = 25, win_length: int = 512,
                 hop_length: int = 160, sample_rate: int = 16_000,
                 device=None):
        self.device = resolve_device(device)
        self.n_mfcc = n_mfcc
        self.win_length = win_length
        self.hop_length = hop_length
        self.sample_rate = sample_rate

    def __call__(self, audio: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        audio = torch.as_tensor(audio).to(self.device)
        return mfcc(audio, n_mfcc=self.n_mfcc, win_length=self.win_length,
                    hop_length=self.hop_length, sample_rate=self.sample_rate)

    def from_audio_path(self, audio_path: Path) -> torch.Tensor:
        audio = load_audio(audio_path, device=self.device)
        audio = cut_audio_to_soft_speech_match_unit_frame_rate(audio)
        return self(audio)


def align_speech_units_and_mfccs(speech_units, mfccs):
    """Trim so MFCC frames are exactly 2x the speech-unit frames."""
    if len(mfccs) % 2 == 1:
        mfccs = mfccs[:-1]
    speech_units = speech_units[: len(mfccs) // 2]
    mfccs = mfccs[: 2 * len(speech_units)]
    return speech_units, mfccs
