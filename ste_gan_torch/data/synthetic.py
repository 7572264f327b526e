"""Synthetic mini-corpus generator with a LEARNABLE cross-modal mapping.

The reference never ships data (the Gaddy & Klein corpus must be downloaded
and preprocessed), and it has no test fixtures at all. This module creates a
structurally faithful synthetic corpus with the exact invariants the real
ETL guarantees (reference: scripts/prep_data_gaddy_and_klein.py:398-407):

* ``len(emg) == 16 * len(units) == 16 * len(phonemes)`` (800 Hz vs 50 Hz),
* ``len(mfccs) == 2 * len(units)`` (100 Hz vs 50 Hz),
* EMG is tanh-bounded to [-1, 1] (reference :282-284),
* utterance ids encode ``{session}__{name}__{speaking_mode}``.

The EMG <-> phoneme/speech-unit relationship is a FIXED GLOBAL mapping
(round-3 redesign; the round-2 corpus drew fresh per-utterance anchor
matrices, which made the cross-utterance mapping pure noise and capped
encoder phoneme accuracy at chance):

* every phoneme has a deterministic speech-unit anchor vector, a per-EMG-
  channel amplitude signature in [0.15, 0.85], and a per-channel band-
  limited carrier frequency in [30, 180] Hz;
* an utterance's EMG channel c is ``gain[session, c] * A[p(t), c] *
  sin(phase_c(t))`` with the carrier phase integrated through time (no
  discontinuities at phoneme boundaries) plus small noise, tanh-squashed;
* speech units are the phoneme anchors plus smoothed low-amplitude noise;
  MFCCs are a fixed linear projection of the units at 2x the frame rate;
* sessions differ by a deterministic per-channel gain in [0.75, 1.25]
  (what the generator's session embedding must learn to compensate).

So: an EMG encoder can decode phonemes/units from the amplitude+frequency
signatures (well above chance), and a generator can synthesise EMG whose
signatures the frozen encoder recognises — the full perceptual-loss
pathway has real structure to learn, and validation metrics move the way
the reference protocol expects (ste_gan/train.py:292-378).

Artifacts are written as ``.npy`` under the reference's directory layout
(``{split}/{emg,units,phonemes,mfccs,emg_feats}/{utt_id}.npy`` plus
``transcriptions/{utt_id}.txt``).

This is the port's own copy of ``ste_gan_tpu/data/synthetic.py`` (the port
imports nothing of the JAX package): for the same arguments and seed it
writes byte-identical files.

    python -m ste_gan_torch.data.synthetic --root data/synthetic
"""
from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Dict

import numpy as np

from ste_gan_torch import constants as C

#: Seed namespace for the global (corpus-wide) phoneme/session mappings.
#: Distinct from the per-utterance content seed so regenerating a corpus
#: with a different ``seed`` keeps the SAME underlying mapping.
MAP_SEED = 7321


@lru_cache(maxsize=4)
def global_maps(map_seed: int = MAP_SEED, num_channels: int = C.NUM_EMG_CHANNELS):
    """Deterministic corpus-wide mappings (phoneme anchors/signatures,
    MFCC projection). Cached; identical across utterances and splits."""
    rng = np.random.default_rng(map_seed)
    anchors = rng.normal(0.0, 1.0,
                         size=(C.NUM_PHONEMES, C.SPEECH_UNITS_FEAT_SIZE))
    # Per-phoneme, per-channel amplitude signature and carrier frequency.
    amps = rng.uniform(0.15, 0.85, size=(C.NUM_PHONEMES, num_channels))
    freqs = rng.uniform(30.0, 180.0, size=(C.NUM_PHONEMES, num_channels))
    # 'sil' is quiet: tiny amplitude on every channel.
    sil = C.PHONEME_INVENTORY.index("sil")
    amps[sil] = 0.05
    mfcc_mix = rng.normal(size=(C.SPEECH_UNITS_FEAT_SIZE, C.NUM_MFCCS))
    mfcc_mix /= np.sqrt(C.SPEECH_UNITS_FEAT_SIZE)
    return anchors, amps, freqs, mfcc_mix


def session_gains(session_idx: int, num_channels: int = C.NUM_EMG_CHANNELS,
                  map_seed: int = MAP_SEED) -> np.ndarray:
    """Deterministic per-channel gain for a recording session."""
    rng = np.random.default_rng((map_seed, 77, session_idx))
    return rng.uniform(0.75, 1.25, size=num_channels)


def _smooth(x: np.ndarray, window: int) -> np.ndarray:
    kernel = np.ones(window) / window
    return np.apply_along_axis(
        lambda s: np.convolve(s, kernel, mode="same"), 0, x)


def synth_utterance(rng: np.random.Generator, num_frames: int,
                    session_idx: int, num_channels: int = C.NUM_EMG_CHANNELS,
                    silent: bool = False) -> Dict[str, np.ndarray]:
    """Generate one utterance worth of aligned artifacts.

    ``silent=True`` mimics the real corpus: the unit/phoneme/MFCC targets
    come from a "parallel voiced recording" with a DIFFERENT frame count
    (reference prep stores parallel_speech_units for silent utterances;
    scripts/prep_data_gaddy_and_klein.py:372-379), while the EMG keeps its
    own length — so ``len(emg) != 16 * len(units)`` for silent samples,
    exactly like real silent data. The EMG is built from a time-warped
    version of the target trajectory, so DTW alignment has real structure.
    """
    anchors, amps, freqs, mfcc_mix = global_maps(num_channels=num_channels)
    hop = C.HOPSIZE
    num_emg = num_frames * hop
    if silent:
        num_target_frames = max(8, int(round(
            num_frames * rng.uniform(0.75, 1.25))))
    else:
        num_target_frames = num_frames

    # Phoneme segments: random lengths of 4-20 frames.
    phonemes = np.zeros(num_target_frames, dtype=np.int64)
    pos = 0
    while pos < num_target_frames:
        seg = int(rng.integers(4, 20))
        phonemes[pos:pos + seg] = int(rng.integers(0, C.NUM_PHONEMES))
        pos += seg

    # Speech units: GLOBAL per-phoneme anchors + smoothed low noise.
    units = anchors[phonemes] + 0.15 * rng.normal(
        size=(num_target_frames, C.SPEECH_UNITS_FEAT_SIZE))
    units = _smooth(units, 3).astype(np.float32)

    # MFCCs at 2x the unit rate via the fixed projection.
    mfccs = np.repeat(units @ mfcc_mix, 2, axis=0).astype(np.float32)
    mfccs += 0.1 * rng.normal(size=mfccs.shape).astype(np.float32)

    # EMG trajectory at the utterance's own frame count (linear time-warp of
    # the target trajectory for silent utterances; identity for voiced).
    warp_idx = np.round(np.linspace(0, num_target_frames - 1,
                                    num_frames)).astype(np.int64)
    warped_phonemes = phonemes[warp_idx]

    # EMG: per-channel phoneme signature carriers with continuous phase.
    ph_per_sample = np.repeat(warped_phonemes, hop)          # [num_emg]
    amp = amps[ph_per_sample]                                # [num_emg, C]
    inst_freq = freqs[ph_per_sample]                         # [num_emg, C]
    phase0 = rng.uniform(0, 2 * np.pi, size=num_channels)
    phase = phase0[None, :] + (2 * np.pi / C.EMG_SAMPLE_RATE) * np.cumsum(
        inst_freq, axis=0)
    gain = session_gains(session_idx, num_channels)
    noise = rng.normal(0.0, 0.05, size=(num_emg, num_channels))
    emg = np.tanh(1.2 * gain[None, :] * amp * np.sin(phase)
                  + noise).astype(np.float32)

    # Frame-level EMG features at 100 Hz (placeholder statistics with the
    # right shape: [frames_100hz, channels, 6]).
    n100 = num_frames * 2
    emg_feats = emg[: n100 * (hop // 2)].reshape(n100, hop // 2, num_channels)
    emg_feats = np.stack([
        emg_feats.mean(1), np.square(emg_feats).sum(1),
        np.square(np.abs(emg_feats)).sum(1), np.abs(emg_feats).mean(1),
        (np.diff(np.signbit(emg_feats), axis=1) != 0).mean(1).astype(np.float32),
        np.abs(emg_feats).max(1),
    ], axis=-1).astype(np.float32)

    return {
        "emg": emg,
        "units": units,
        "phonemes": phonemes,
        "mfccs": mfccs,
        "emg_feats": emg_feats,
        "transcription": "synthetic utterance " + " ".join(
            C.PHONEME_INVENTORY[p] for p in phonemes[::16][:8]),
    }


# ---------------------------------------------------------------------------
# HARD corpus variant (VERDICT r4 #4): de-saturate the quality benchmark.
#
# The base corpus above is deterministically invertible by construction —
# global per-phoneme anchors + small noise — so trained models pin phoneme
# accuracy at 99.9% and val SU at ~1.7, and optimized metrics stop
# discriminating. The hard variant keeps every structural invariant (lengths,
# tanh bound, layout, same speech-unit anchors) but makes the phoneme->EMG
# direction genuinely harder, stressing the feature structure of real EMG
# (reference: ste_gan/utils/emg_utils.py:176-230):
#
# * MANY-TO-ONE with context dependence: phoneme pairs (2p, 2p+1) share one
#   EMG amplitude/frequency signature; a coarse context class of the
#   PREVIOUS phoneme modulates it (learnable from context), and the true
#   phoneme identity only enters through a weak +-8% modulation — EMG no
#   longer determines the phoneme, so encoder accuracy has a real ceiling
#   below 100% and model differences show up in the optimized metrics.
# * SESSION-DEPENDENT TEMPORAL DYNAMICS: each session scales the carrier
#   frequencies and smooths the amplitude envelope with its own
#   attack/decay window, beyond the base per-channel gains.
# * INTER-CHANNEL CROSSTALK: a session-dependent mixing matrix
#   (I + strength * offdiag) blends the source channels before the
#   nonlinearity, like surface electrodes picking up neighbouring muscles.
# * AMPLITUDE DRIFT: a slow per-channel multiplicative sinusoid with
#   random per-utterance frequency/phase — unpredictable from the speech
#   features, so paired losses keep an irreducible floor.
# ---------------------------------------------------------------------------

#: Seed namespace for the hard variant's corpus-wide mappings.
HARD_MAP_SEED = 9173
#: Coarse context classes (the previous phoneme's class modulates the
#: current signature).
NUM_CONTEXT_CLASSES = 4


@lru_cache(maxsize=4)
def hard_maps(map_seed: int = HARD_MAP_SEED,
              num_channels: int = C.NUM_EMG_CHANNELS):
    """Corpus-wide mappings of the hard variant. Speech-unit anchors and
    the MFCC projection reuse the base corpus maps (same generator input
    distribution); the EMG-side signature tables are many-to-one."""
    anchors, _, _, mfcc_mix = global_maps(num_channels=num_channels)
    rng = np.random.default_rng(map_seed)
    # One signature per phoneme PAIR: EMG cannot fully determine phonemes.
    num_groups = (C.NUM_PHONEMES + 1) // 2
    group = np.arange(C.NUM_PHONEMES) // 2
    g_amps = rng.uniform(0.15, 0.85, size=(num_groups, num_channels))
    g_freqs = rng.uniform(30.0, 180.0, size=(num_groups, num_channels))
    amps = g_amps[group]
    freqs = g_freqs[group]
    # Weak true-phoneme modulation (+-8%): partial within-pair evidence.
    phoneme_mod = rng.uniform(0.92, 1.08, size=(C.NUM_PHONEMES, num_channels))
    # Context: the previous phoneme's coarse class scales amp/freq.
    ctx_class = rng.integers(0, NUM_CONTEXT_CLASSES, size=C.NUM_PHONEMES)
    ctx_gain = rng.uniform(0.6, 1.4, size=(NUM_CONTEXT_CLASSES, num_channels))
    ctx_freq = rng.uniform(0.85, 1.15,
                           size=(NUM_CONTEXT_CLASSES, num_channels))
    # Crosstalk template: fixed direction, session-dependent strength.
    mix = rng.normal(size=(num_channels, num_channels))
    np.fill_diagonal(mix, 0.0)
    mix /= np.abs(mix).sum(axis=1, keepdims=True)
    sil = C.PHONEME_INVENTORY.index("sil")
    amps[sil] = 0.05
    phoneme_mod[sil] = 1.0
    return anchors, amps, freqs, phoneme_mod, ctx_class, ctx_gain, ctx_freq, \
        mix, mfcc_mix


def hard_session_dynamics(session_idx: int,
                          num_channels: int = C.NUM_EMG_CHANNELS,
                          map_seed: int = HARD_MAP_SEED):
    """Session-dependent dynamics: per-channel gain, carrier-frequency
    scale, crosstalk strength, and envelope attack/decay window."""
    rng = np.random.default_rng((map_seed, 55, session_idx))
    gain = rng.uniform(0.75, 1.25, size=num_channels)
    freq_scale = float(rng.uniform(0.85, 1.2))
    crosstalk = float(rng.uniform(0.15, 0.35))
    env_window = int(rng.integers(9, 33))
    return gain, freq_scale, crosstalk, env_window


def _segment_context_classes(phonemes: np.ndarray,
                             ctx_class: np.ndarray) -> np.ndarray:
    """Per-frame coarse class of the PREVIOUS phoneme segment (the first
    segment sees the silence class)."""
    sil = C.PHONEME_INVENTORY.index("sil")
    boundaries = np.flatnonzero(np.diff(phonemes)) + 1
    ctx = np.empty_like(phonemes)
    prev = sil
    start = 0
    for b in list(boundaries) + [len(phonemes)]:
        ctx[start:b] = ctx_class[prev]
        prev = phonemes[b - 1] if b <= len(phonemes) else prev
        start = b
    return ctx


def synth_utterance_hard(rng: np.random.Generator, num_frames: int,
                         session_idx: int,
                         num_channels: int = C.NUM_EMG_CHANNELS,
                         silent: bool = False) -> Dict[str, np.ndarray]:
    """Hard-variant utterance: same artifact shapes/invariants as
    :func:`synth_utterance`, EMG built through the many-to-one
    context/crosstalk/drift chain documented above."""
    (anchors, amps, freqs, phoneme_mod, ctx_class, ctx_gain, ctx_freq,
     mix, mfcc_mix) = hard_maps(num_channels=num_channels)
    hop = C.HOPSIZE
    num_emg = num_frames * hop
    if silent:
        num_target_frames = max(8, int(round(
            num_frames * rng.uniform(0.75, 1.25))))
    else:
        num_target_frames = num_frames

    phonemes = np.zeros(num_target_frames, dtype=np.int64)
    pos = 0
    while pos < num_target_frames:
        seg = int(rng.integers(4, 20))
        phonemes[pos:pos + seg] = int(rng.integers(0, C.NUM_PHONEMES))
        pos += seg

    # Speech-feature side: unchanged from the base corpus (full per-phoneme
    # anchors — the GENERATOR's input keeps complete information; only the
    # EMG observation is many-to-one).
    units = anchors[phonemes] + 0.15 * rng.normal(
        size=(num_target_frames, C.SPEECH_UNITS_FEAT_SIZE))
    units = _smooth(units, 3).astype(np.float32)
    mfccs = np.repeat(units @ mfcc_mix, 2, axis=0).astype(np.float32)
    mfccs += 0.1 * rng.normal(size=mfccs.shape).astype(np.float32)

    warp_idx = np.round(np.linspace(0, num_target_frames - 1,
                                    num_frames)).astype(np.int64)
    warped_phonemes = phonemes[warp_idx]
    warped_ctx = _segment_context_classes(phonemes, ctx_class)[warp_idx]

    gain, freq_scale, crosstalk, env_window = hard_session_dynamics(
        session_idx, num_channels)

    ph = np.repeat(warped_phonemes, hop)                     # [num_emg]
    ctx = np.repeat(warped_ctx, hop)                         # [num_emg]
    amp = amps[ph] * phoneme_mod[ph] * ctx_gain[ctx]         # [num_emg, C]
    # Session envelope dynamics: attack/decay smoothing of the amplitude.
    amp = _smooth(amp, env_window)
    inst_freq = freqs[ph] * ctx_freq[ctx] * freq_scale
    phase0 = rng.uniform(0, 2 * np.pi, size=num_channels)
    phase = phase0[None, :] + (2 * np.pi / C.EMG_SAMPLE_RATE) * np.cumsum(
        inst_freq, axis=0)
    # Slow per-channel amplitude drift, unpredictable from the features.
    drift_freq = rng.uniform(0.1, 0.5, size=num_channels)    # Hz
    drift_phase = rng.uniform(0, 2 * np.pi, size=num_channels)
    tt = np.arange(num_emg)[:, None] / C.EMG_SAMPLE_RATE
    drift = 1.0 + 0.25 * np.sin(2 * np.pi * drift_freq[None, :] * tt
                                + drift_phase[None, :])
    sources = gain[None, :] * amp * drift * np.sin(phase)
    observed = sources + crosstalk * (sources @ mix.T)
    noise = rng.normal(0.0, 0.08, size=(num_emg, num_channels))
    emg = np.tanh(1.2 * observed + noise).astype(np.float32)

    n100 = num_frames * 2
    emg_feats = emg[: n100 * (hop // 2)].reshape(n100, hop // 2, num_channels)
    emg_feats = np.stack([
        emg_feats.mean(1), np.square(emg_feats).sum(1),
        np.square(np.abs(emg_feats)).sum(1), np.abs(emg_feats).mean(1),
        (np.diff(np.signbit(emg_feats), axis=1) != 0).mean(1).astype(np.float32),
        np.abs(emg_feats).max(1),
    ], axis=-1).astype(np.float32)

    return {
        "emg": emg,
        "units": units,
        "phonemes": phonemes,
        "mfccs": mfccs,
        "emg_feats": emg_feats,
        "transcription": "synthetic utterance " + " ".join(
            C.PHONEME_INVENTORY[p] for p in phonemes[::16][:8]),
    }


def generate_synthetic_corpus(
    root: Path,
    num_train: int = 24,
    num_valid: int = 6,
    num_test: int = 4,
    num_sessions: int = 4,
    min_frames: int = 130,
    max_frames: int = 260,
    seed: int = 0,
    silent_fraction: float = 0.0,
    num_channels: int = C.NUM_EMG_CHANNELS,
    hard: bool = False,
) -> Path:
    """Write a synthetic corpus under ``root`` and return it.

    ``hard=True`` selects the de-saturated variant (many-to-one
    context-dependent phoneme->EMG mapping, session dynamics, crosstalk,
    amplitude drift — see :func:`synth_utterance_hard`)."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    synth = synth_utterance_hard if hard else synth_utterance
    counts = {"train": num_train, "valid": num_valid, "test": num_test}
    utt_counter = 0
    for split, count in counts.items():
        dirs = {}
        for sub in (C.DataDir.EMG, C.DataDir.SPEECH_UNITS, C.DataDir.PHONEMES,
                    C.DataDir.MFCCS, C.DataDir.EMG_FEATS, C.DataDir.TRANSCRIPTIONS):
            dirs[sub] = root / split / sub
            dirs[sub].mkdir(parents=True, exist_ok=True)
        for _ in range(count):
            session_idx = int(rng.integers(0, num_sessions))
            silent = bool(rng.random() < silent_fraction)
            mode = C.SpeakingMode.SILENT if silent else C.SpeakingMode.NORMAL
            num_frames = int(rng.integers(min_frames, max_frames))
            utt = synth(rng, num_frames, session_idx,
                        num_channels=num_channels, silent=silent)
            utt_id = f"sess{session_idx:02d}__utt{utt_counter:05d}__{mode}"
            utt_counter += 1
            np.save(dirs[C.DataDir.EMG] / f"{utt_id}.npy", utt["emg"])
            np.save(dirs[C.DataDir.SPEECH_UNITS] / f"{utt_id}.npy", utt["units"])
            np.save(dirs[C.DataDir.PHONEMES] / f"{utt_id}.npy", utt["phonemes"])
            np.save(dirs[C.DataDir.MFCCS] / f"{utt_id}.npy", utt["mfccs"])
            np.save(dirs[C.DataDir.EMG_FEATS] / f"{utt_id}.npy", utt["emg_feats"])
            (dirs[C.DataDir.TRANSCRIPTIONS] / f"{utt_id}.txt").write_text(
                utt["transcription"])
    return root


def main(argv=None) -> None:
    """CLI: (re)generate the development corpus (data/ is gitignored —
    regenerate after a fresh checkout; deterministic for a given seed)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default="data/synthetic")
    ap.add_argument("--num_train", type=int, default=96)
    ap.add_argument("--num_valid", type=int, default=24)
    ap.add_argument("--num_test", type=int, default=16)
    ap.add_argument("--num_sessions", type=int, default=4)
    ap.add_argument("--min_frames", type=int, default=130)
    ap.add_argument("--max_frames", type=int, default=260)
    ap.add_argument("--silent_fraction", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hard", action="store_true",
                    help="de-saturated variant: many-to-one context-"
                         "dependent phoneme->EMG signatures, session "
                         "dynamics, channel crosstalk, amplitude drift")
    args = ap.parse_args(argv)
    # Regeneration must start clean: utterance ids encode the (seeded)
    # session assignment, so a parameter change would otherwise leave
    # stale files from the previous corpus mixed in.
    root = Path(args.root)
    if root.exists():
        import shutil

        shutil.rmtree(root)
    root = generate_synthetic_corpus(
        Path(args.root), num_train=args.num_train, num_valid=args.num_valid,
        num_test=args.num_test, num_sessions=args.num_sessions,
        min_frames=args.min_frames, max_frames=args.max_frames,
        seed=args.seed, silent_fraction=args.silent_fraction,
        hard=args.hard)
    print(f"synthetic corpus written to {root}")


if __name__ == "__main__":
    main()
