"""Distribution-level realism metrics for generated EMG.

Counterpart of ``ste_gan_tpu/realism.py``. Every training loss compares a
generated chunk with its own ground truth; these metrics ask whether the
*population* of generated signals is distributed like real EMG, from
quantities no training loss touches directly:

* **FED, Fréchet Encoder Distance**: the Gaussian Fréchet distance between
  the frozen encoder's pre-head frame embeddings
  (``EMGEncoderTransformer.embed``) of real and generated EMG;
* **TD-feature Wasserstein**: 1-D Wasserstein-1 distances between the
  pooled distributions of the four framed time-domain features per channel
  (``losses/td_loss.py`` ``time_domain_features``);
* **LSD, log-spectral distance**: the mean absolute dB difference between
  the length-weighted average per-channel Welch spectra;

plus per-utterance statistics and a paired utterance bootstrap of the FED
and LSD differences between two systems.

The port's own choices, where the JAX package uses scipy (which the port
does not import):

* Welch's PSD is numpy (:func:`welch_psd`) with ``scipy.signal.welch``'s
  defaults: periodic Hann window, 50 % overlap, constant detrend, one-sided
  density scaling (DC and Nyquist not doubled), mean over segments.
* The Fréchet trace ``Tr sqrtm(C1 C2)`` is ``sum(sqrt(max(l, 0)))`` over
  the eigenvalues ``l`` of the symmetric ``C1^1/2 C2 C1^1/2`` (``eigh``).
  It equals scipy's ``sqrtm`` for well-conditioned covariances, that is
  with many more frames than embedding dimensions; with few frames the
  product is near singular and scipy's ``sqrtm`` of the non-symmetric
  product is itself unreliable.
* One length filter: :func:`realism_from_signals` keeps the utterance pairs
  of at least ``max(hop, nperseg)`` samples and feeds every statistic from
  that list. The JAX package drops the shorter utterances from its PSD
  path only, so its FED and LSD can see different utterances.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ste_gan_torch import constants as C
from ste_gan_torch.device import resolve_device
from ste_gan_torch.infer import round_up
from ste_gan_torch.losses.td_loss import time_domain_features

#: Feature names of the TD stack, in time_domain_features' channel order.
TD_FEATURE_NAMES = ("low_mean", "low_power", "high_power", "high_rect_mean")
#: Welch segment length of the LSD path.
NPERSEG = 256


# ---------------------------------------------------------------------------
# Fréchet distance over frozen-encoder embeddings
# ---------------------------------------------------------------------------


def gaussian_stats(frames: np.ndarray):
    """Mean vector and covariance of ``[N, D]`` frames."""
    frames = np.asarray(frames, np.float64)
    mu = frames.mean(axis=0)
    cov = np.cov(frames, rowvar=False)
    return mu, np.atleast_2d(cov)


def _sqrt_psd(cov: np.ndarray) -> np.ndarray:
    """Symmetric square root of a positive semi-definite matrix."""
    w, v = np.linalg.eigh(cov)
    return (v * np.sqrt(np.maximum(w, 0.0))) @ v.T


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray,
                     mu2: np.ndarray, cov2: np.ndarray) -> float:
    """Fréchet distance between two Gaussians (the FID formula):
    ``|mu1-mu2|^2 + Tr(C1) + Tr(C2) - 2 Tr sqrtm(C1 C2)``, the last trace
    from the eigenvalues of ``C1^1/2 C2 C1^1/2`` (module docstring)."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64)
    cov2 = np.asarray(cov2, np.float64)
    diff = mu1 - mu2
    root1 = _sqrt_psd(cov1)
    eig = np.linalg.eigvalsh(root1 @ cov2 @ root1)
    tr_covmean = float(np.sum(np.sqrt(np.maximum(eig, 0.0))))
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * tr_covmean)


def frechet_from_frames(real_frames: np.ndarray,
                        fake_frames: np.ndarray) -> float:
    mu_r, cov_r = gaussian_stats(real_frames)
    mu_f, cov_f = gaussian_stats(fake_frames)
    return frechet_distance(mu_r, cov_r, mu_f, cov_f)


# ---------------------------------------------------------------------------
# Pooled TD-feature Wasserstein distances
# ---------------------------------------------------------------------------


def pooled_td_features(emg_list: Sequence[np.ndarray], window: int = 80,
                       stride: int = 16, device=None) -> np.ndarray:
    """Framed TD features of every utterance, concatenated: ``[F_total, C,
    4]``, at the TD loss's coarsest window, pooled across frames and
    utterances (a distribution, not a paired target). Computed on
    ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    feats = []
    with torch.inference_mode():
        for emg in emg_list:
            x = torch.from_numpy(np.asarray(emg, np.float32)[None]).to(dev)
            feats.append(time_domain_features(x, window, stride)[0]
                         .cpu().numpy())
    return np.concatenate(feats, axis=0)


def wasserstein1(a: np.ndarray, b: np.ndarray,
                 num_quantiles: int = 256) -> float:
    """1-D Wasserstein-1 distance via quantile functions."""
    q = (np.arange(num_quantiles) + 0.5) / num_quantiles
    return float(np.mean(np.abs(np.quantile(np.asarray(a, np.float64), q)
                                - np.quantile(np.asarray(b, np.float64), q))))


def td_wasserstein_report(real_feats: np.ndarray,
                          fake_feats: np.ndarray) -> Dict:
    """Per-feature (averaged over channels) and overall W1 distances
    between pooled TD-feature distributions ``[F, C, 4]``."""
    num_channels = real_feats.shape[1]
    per_feature = {}
    for k, name in enumerate(TD_FEATURE_NAMES):
        dists = [wasserstein1(real_feats[:, c, k], fake_feats[:, c, k])
                 for c in range(num_channels)]
        per_feature[name] = float(np.mean(dists))
    per_feature["mean"] = float(np.mean(list(per_feature.values())))
    return per_feature


# ---------------------------------------------------------------------------
# Log-spectral distance
# ---------------------------------------------------------------------------


def welch_psd(x: np.ndarray, fs: float = C.EMG_SAMPLE_RATE,
              nperseg: int = NPERSEG) -> np.ndarray:
    """Welch's power spectral density of ``x [T, C]`` along axis 0
    (``T >= nperseg``), ``[nperseg//2 + 1, C]``: periodic Hann window,
    segments overlapping by ``nperseg // 2``, each segment's mean removed,
    one-sided density, mean over segments (``scipy.signal.welch``'s
    defaults)."""
    x = np.asarray(x, np.float64)
    if len(x) < nperseg:
        raise ValueError(f"welch_psd needs at least nperseg={nperseg} "
                         f"samples, got {len(x)}")
    step = nperseg - nperseg // 2
    n_seg = (len(x) - nperseg) // step + 1
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(nperseg) / nperseg)
    idx = np.arange(n_seg)[:, None] * step + np.arange(nperseg)[None, :]
    seg = x[idx]                                   # [S, nperseg, C]
    seg = seg - seg.mean(axis=1, keepdims=True)
    spec = np.fft.rfft(seg * window[None, :, None], axis=1)
    psd = (spec.real ** 2 + spec.imag ** 2) / (fs * np.sum(window ** 2))
    last = -1 if nperseg % 2 == 0 else None        # Nyquist not doubled
    psd[:, 1:last] *= 2.0
    return psd.mean(axis=0)


def average_psd(emg_list: Sequence[np.ndarray], fs: int = C.EMG_SAMPLE_RATE,
                nperseg: int = NPERSEG) -> np.ndarray:
    """Length-weighted average Welch PSD per channel ``[nperseg//2+1, C]``
    over the utterances of at least ``nperseg`` samples."""
    total = None
    weight = 0.0
    for emg in emg_list:
        if len(emg) < nperseg:
            continue
        psd = welch_psd(emg, fs, nperseg)
        w = float(len(emg))
        total = psd * w if total is None else total + psd * w
        weight += w
    if total is None:
        raise ValueError(f"no utterance reached nperseg={nperseg} samples")
    return total / weight


def log_spectral_distance(real_psd: np.ndarray, fake_psd: np.ndarray,
                          floor: float = 1e-12) -> Dict:
    """Mean |dB| difference between average PSDs, per channel + overall."""
    r = 10.0 * np.log10(np.maximum(np.asarray(real_psd), floor))
    f = 10.0 * np.log10(np.maximum(np.asarray(fake_psd), floor))
    per_channel = np.mean(np.abs(r - f), axis=0)
    return {"per_channel_db": [round(float(v), 4) for v in per_channel],
            "mean_db": float(np.mean(per_channel))}


# ---------------------------------------------------------------------------
# Per-utterance statistics and the paired utterance bootstrap
# ---------------------------------------------------------------------------


def _valid_frame_embeddings(embed_fn: Callable,
                            emg_list: Sequence[np.ndarray],
                            bucket_frames: int, hop: int):
    """Per utterance of at least one frame: ``embed_fn`` of the utterance
    zero padded to a multiple of ``bucket_frames`` frames, its valid frames
    ``[frames, D]`` kept."""
    for emg in emg_list:
        emg = np.asarray(emg, np.float32)
        frames = len(emg) // hop
        if frames == 0:
            continue
        padded = np.zeros((1, round_up(frames, bucket_frames) * hop,
                           emg.shape[1]), np.float32)
        padded[0, : frames * hop] = emg[: frames * hop]
        yield embed_fn(padded)[0, :frames]


def embedding_moment_stats(embed_fn: Callable, emg_list: Sequence[np.ndarray],
                           bucket_frames: int = 64,
                           hop: int = C.HOPSIZE) -> List[tuple]:
    """Per-utterance sufficient statistics of the frame embeddings,
    ``[(n_i, sum_i [D], scatter_i [D, D]), ...]``, from which any subset's
    Gaussian (and its Fréchet distance) aggregates in O(D^2) per
    utterance. ``embed_fn([1, T, C] numpy) -> [1, T/hop, D]`` numpy."""
    stats = []
    for emb in _valid_frame_embeddings(embed_fn, emg_list, bucket_frames, hop):
        emb = np.asarray(emb, np.float64)
        stats.append((emb.shape[0], emb.sum(axis=0), emb.T @ emb))
    return stats


def _gaussian_from_moments(stats: Sequence[tuple],
                           idx: Optional[np.ndarray] = None):
    """(mu, cov) of the pooled frames of the selected utterances (all when
    ``idx`` is None). Unbiased covariance, matching ``np.cov``."""
    chosen = stats if idx is None else [stats[i] for i in idx]
    n = sum(s[0] for s in chosen)
    total = np.sum([s[1] for s in chosen], axis=0)
    scatter = np.sum([s[2] for s in chosen], axis=0)
    mu = total / n
    cov = (scatter - n * np.outer(mu, mu)) / (n - 1)
    return mu, cov


def fed_from_moments(stats_real: Sequence[tuple], stats_fake: Sequence[tuple],
                     idx: Optional[np.ndarray] = None) -> float:
    mu_r, cov_r = _gaussian_from_moments(stats_real, idx)
    mu_f, cov_f = _gaussian_from_moments(stats_fake, idx)
    return frechet_distance(mu_r, cov_r, mu_f, cov_f)


def per_utterance_psds(emg_list: Sequence[np.ndarray],
                       fs: int = C.EMG_SAMPLE_RATE, nperseg: int = NPERSEG):
    """Per-utterance Welch PSDs and length weights, ``([U, F, C], [U])``,
    over the utterances of at least ``nperseg`` samples. The weighted
    average over any subset equals :func:`average_psd` of that subset."""
    psds, weights = [], []
    for emg in emg_list:
        if len(emg) < nperseg:
            continue
        psds.append(welch_psd(emg, fs, nperseg))
        weights.append(float(len(emg)))
    return np.stack(psds), np.asarray(weights)


def lsd_from_psds(real_psds, fake_psds, weights,
                  idx: Optional[np.ndarray] = None) -> float:
    """Overall LSD (mean |dB|) between length-weighted average PSDs of the
    selected utterances."""
    if idx is None:
        idx = np.arange(len(weights))
    w = weights[idx][:, None, None]
    real = (real_psds[idx] * w).sum(axis=0) / w.sum()
    fake = (fake_psds[idx] * w).sum(axis=0) / w.sum()
    return log_spectral_distance(real, fake)["mean_db"]


def bootstrap_paired_realism_delta(
    real_moments: Sequence[tuple],
    fake_a_moments: Sequence[tuple],
    fake_b_moments: Sequence[tuple],
    real_psds: np.ndarray,
    fake_a_psds: np.ndarray,
    fake_b_psds: np.ndarray,
    psd_weights: np.ndarray,
    n_boot: int = 200,
    seed: int = 0,
) -> Dict:
    """Paired utterance-level bootstrap of the FED and LSD differences
    between two systems A and B scored on the same utterances. Each
    resample draws utterance indices with replacement
    (``np.random.default_rng(seed)``) and applies them to real, A and B
    alike, then recomputes ``FED_A - FED_B`` and ``LSD_A - LSD_B``.
    Returns point estimates, percentile CIs and the fraction of resamples
    favouring A (delta < 0). The moments and PSDs must describe the same
    utterances (:func:`comparable_pairs`)."""
    num = len(real_moments)
    if not (len(fake_a_moments) == len(fake_b_moments) == num
            == len(psd_weights)):
        raise ValueError("the moment and PSD statistics must describe the "
                         "same utterances")
    rng = np.random.default_rng(seed)
    fed_deltas = np.empty(n_boot)
    lsd_deltas = np.empty(n_boot)
    for i in range(n_boot):
        idx = rng.integers(0, num, size=num)
        fed_deltas[i] = (fed_from_moments(real_moments, fake_a_moments, idx)
                         - fed_from_moments(real_moments, fake_b_moments, idx))
        lsd_deltas[i] = (lsd_from_psds(real_psds, fake_a_psds, psd_weights, idx)
                         - lsd_from_psds(real_psds, fake_b_psds, psd_weights,
                                         idx))

    def summary(point, deltas):
        lo, hi = np.percentile(deltas, [2.5, 97.5])
        return {"delta": round(float(point), 4),
                "boot_mean": round(float(deltas.mean()), 4),
                "ci95": [round(float(lo), 4), round(float(hi), 4)],
                "frac_a_better": round(float((deltas < 0).mean()), 4)}

    return {
        "n_utterances": num,
        "n_boot": n_boot,
        "fed": summary(fed_from_moments(real_moments, fake_a_moments)
                       - fed_from_moments(real_moments, fake_b_moments),
                       fed_deltas),
        "lsd_db": summary(
            lsd_from_psds(real_psds, fake_a_psds, psd_weights)
            - lsd_from_psds(real_psds, fake_b_psds, psd_weights),
            lsd_deltas),
    }


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def comparable_pairs(real_list: Sequence[np.ndarray],
                     fake_list: Sequence[np.ndarray],
                     hop: int = C.HOPSIZE, nperseg: int = NPERSEG
                     ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """The (real, fake) utterance pairs whose both signals hold at least
    ``max(hop, nperseg)`` samples: the one length filter of every
    statistic (the embedding path needs a frame, the PSD path a Welch
    segment)."""
    least = max(hop, nperseg)
    kept = [(r, f) for r, f in zip(real_list, fake_list)
            if len(r) >= least and len(f) >= least]
    if len(kept) < len(real_list):
        logging.info("realism: %d of %d utterances are shorter than %d "
                     "samples and are left out of every statistic",
                     len(real_list) - len(kept), len(real_list), least)
    return [r for r, _ in kept], [f for _, f in kept]


def encoder_frame_embeddings(embed_fn: Callable, emg_list: Sequence[np.ndarray],
                             bucket_frames: int = 64,
                             hop: int = C.HOPSIZE) -> np.ndarray:
    """Valid 50 Hz frame embeddings of every utterance, concatenated:
    ``[N_frames, model_size]``. Utterances are zero padded to bucket
    multiples and only the valid frames are kept."""
    return np.concatenate([np.asarray(emb) for emb in _valid_frame_embeddings(
        embed_fn, emg_list, bucket_frames, hop)], axis=0)


def encoder_embed_fn(encoder: torch.nn.Module) -> Callable:
    """``[1, T, C]`` numpy -> ``[1, T/16, model_size]`` numpy f32 through
    ``encoder.embed`` (eval mode) on the encoder's device."""
    dev = next(encoder.parameters()).device

    @torch.inference_mode()
    def embed(emg: np.ndarray) -> np.ndarray:
        return encoder.embed(torch.from_numpy(emg).to(dev)).cpu().numpy()

    return embed


def realism_from_signals(real_list: Sequence[np.ndarray],
                         fake_list: Sequence[np.ndarray],
                         embed_fn: Optional[Callable] = None,
                         bucket_frames: int = 64, device=None) -> Dict:
    """All three metric families between paired real and generated
    signals, over the pairs :func:`comparable_pairs` keeps. Without
    ``embed_fn`` the FED entry is left out. The TD features run on
    ``device`` (``cuda`` unless given)."""
    real_list, fake_list = comparable_pairs(real_list, fake_list)
    report: Dict = {
        "num_real": len(real_list), "num_generated": len(fake_list),
        "td_wasserstein": td_wasserstein_report(
            pooled_td_features(real_list, device=device),
            pooled_td_features(fake_list, device=device)),
        "log_spectral_distance": log_spectral_distance(
            average_psd(real_list), average_psd(fake_list)),
    }
    if embed_fn is not None:
        report["fed"] = frechet_from_frames(
            encoder_frame_embeddings(embed_fn, real_list, bucket_frames),
            encoder_frame_embeddings(embed_fn, fake_list, bucket_frames))
    return report


def synthesize_real_fake_pairs(cfg, gen_state_dict, dataset,
                               bucket_frames: int = 64,
                               max_utterances: Optional[int] = None,
                               device=None) -> tuple:
    """Every utterance of ``dataset`` through the bucketed f32 synthesizer
    with the weights of ``gen_state_dict``; returns aligned ``(real_list,
    fake_list)`` trimmed to equal per-utterance lengths, in dataset
    order."""
    from ste_gan_torch.infer import EMGSynthesizer

    synth = EMGSynthesizer.from_config(cfg, gen_state_dict,
                                       bucket=bucket_frames, device=device)
    feature_key = cfg.model.speech_feature_type
    real_list: List[np.ndarray] = []
    fake_list: List[np.ndarray] = []
    n = len(dataset) if max_utterances is None else min(len(dataset),
                                                        max_utterances)
    for idx in range(n):
        sample = dataset[idx]
        fake = synth.synthesize(np.asarray(sample[feature_key]),
                                int(sample[C.DataType.SESSION_INDEX]),
                                int(sample[C.DataType.SPEAKING_MODE_INDEX]))
        real = np.asarray(sample[C.DataType.REAL_EMG], np.float32)
        # The generated track is exactly upsample*frames long; the real
        # one can be a few samples longer.
        t = min(len(real), len(fake))
        real_list.append(real[:t])
        fake_list.append(np.asarray(fake[:t], np.float32))
    return real_list, fake_list


def realism_report(cfg, models, state, dataset, bucket_frames: int = 64,
                   max_utterances: Optional[int] = None) -> Dict:
    """Synthesise every utterance of ``dataset`` with the EMA weights and
    score generated against real EMG with the full metric family
    (``evaluate gan --realism``), on the models' device."""
    from ste_gan_torch.train.gan import eval_generator_state_dict

    dev = next(models.generator.parameters()).device
    real_list, fake_list = synthesize_real_fake_pairs(
        cfg, eval_generator_state_dict(models, state), dataset,
        bucket_frames=bucket_frames, max_utterances=max_utterances,
        device=dev)
    report = realism_from_signals(real_list, fake_list,
                                  embed_fn=encoder_embed_fn(models.encoder),
                                  bucket_frames=bucket_frames, device=dev)
    report["num_utterances"] = report["num_real"]
    return report
