"""Project-wide constants of the PyTorch port of STE-GAN (a copy of
ste_gan_tpu/constants.py, kept separate so the port imports nothing of the
JAX package).

Single source of truth for signal rates, feature sizes, loss weights, logging
intervals, and string keys — the TPU-native equivalent of the reference's
constants module (reference: ste_gan/constants.py:1-239).

Values are kept numerically identical to the reference so that configs,
artifacts, and checkpoints remain semantically interchangeable.
"""
from __future__ import annotations

import enum

# ---------------------------------------------------------------------------
# Signal rates and shapes (reference: ste_gan/constants.py:11-66)
# ---------------------------------------------------------------------------

#: EMG output sample rate in Hz.
EMG_SAMPLE_RATE = 800

#: Default per-step batch size (global; sharded over the data mesh axis).
BATCH_SIZE = 32

#: Training chunk size in EMG samples (2.56 s at 800 Hz).
CHUNK_SIZE = 2048

#: Maximum utterance length in EMG samples.
MAX_LENGTH = 10 * EMG_SAMPLE_RATE

#: Dimensionality of Soft Speech Units (Soft-VC HuBERT).
SPEECH_UNITS_FEAT_SIZE = 256

#: Number of MFCC coefficients for the MFCC input variant.
NUM_MFCCS = 25

#: Size of session / speaking-mode embeddings.
EMBEDDING_DIM_SIZE = 64

#: Number of EMG channels in the Gaddy & Klein corpus.
NUM_EMG_CHANNELS = 8

#: Number of recording sessions in the Gaddy & Klein corpus.
NUM_EMG_SESSIONS = 17

#: Soft speech units run at 50 Hz -> 20 ms hop.
SPEECH_UNIT_HOPSIZE_SECONDS = 0.02

#: EMG samples per speech-unit frame (800 Hz / 50 Hz = 16).
HOPSIZE = int(EMG_SAMPLE_RATE * SPEECH_UNIT_HOPSIZE_SECONDS)

#: Number of generator input features (speech-unit variant).
NUM_FEATURES = SPEECH_UNITS_FEAT_SIZE

#: Number of discriminator input channels.
NUM_DISCRIM_FEATURES = NUM_EMG_CHANNELS

#: EMG samples per training example.
TRAIN_EMG_LENGTH = CHUNK_SIZE

#: Speech-unit frames per training example (128).
TRAIN_FEATURE_LENGTH = TRAIN_EMG_LENGTH // HOPSIZE

#: Global random seed default.
RANDOM_SEED = 0

# ---------------------------------------------------------------------------
# Optimizer defaults (reference: ste_gan/constants.py:57)
# ---------------------------------------------------------------------------

OPTIMIZER_LR = 2e-4
OPTIMIZER_BETAS = (0.8, 0.99)
#: Per-epoch exponential LR decay factor (reference: ste_gan/train.py:98-104).
LR_DECAY_GAMMA = 0.999

# ---------------------------------------------------------------------------
# Loss configuration defaults (reference: ste_gan/constants.py:72-107)
# ---------------------------------------------------------------------------

LOSS_ADVERSARIAL = "mse"
LOSS_FEAT_MATCH = True
LOSS_FEAT_MATCH_WEIGHT = 7.0
LOSS_MULTI_TD_ERROR = True
LOSS_MULTI_TD_ERROR_WEIGHT = 15.0
LOSS_SPEECH_UNIT_ERROR = True
LOSS_SPEECH_UNIT_WEIGHT = 1.0
LOSS_PHONEMES_ERROR = True
LOSS_PHONEMES_WEIGHT = 1.0
LOSS_WAVEFORM_ERROR = False
LOSS_WAVEFORM_ERROR_WEIGHT = 1.0

# ---------------------------------------------------------------------------
# Logging / eval cadence (reference: ste_gan/constants.py:114-138)
# ---------------------------------------------------------------------------

INTERVAL_LOG = 50
INTERVAL_SAMPLE = 1_000
INTERVAL_SAVE = 25_000
INTERVAL_VALID = 500
INTERVAL_WAVEFORM = 500
INTERVAL_PLOT = 1_000
NUM_TEST_SAMPLES = 10
MAX_STEPS = 50_000

# ---------------------------------------------------------------------------
# Phoneme inventory (ARPABet + silence; reference: ste_gan/constants.py:166-173)
# ---------------------------------------------------------------------------

PHONEME_INVENTORY = [
    "aa", "ae", "ah", "ao", "aw", "ax", "axr", "ay", "b", "ch", "d", "dh",
    "dx", "eh", "el", "em", "en", "er", "ey", "f", "g", "hh", "hv", "ih",
    "iy", "jh", "k", "l", "m", "n", "nx", "ng", "ow", "oy", "p", "r", "s",
    "sh", "t", "th", "uh", "uw", "v", "w", "y", "z", "zh", "sil",
]

NUM_PHONEMES = len(PHONEME_INVENTORY)
SILENCE_PHONEME_INDEX = PHONEME_INVENTORY.index("sil")

#: Names of the six frame-level EMG time-domain features produced by the ETL.
EMG_TD_FEAT_NAMES = [
    "mean_low", "power_low", "power_high_rect", "zcr_high", "mean_high_rect",
    "hilbert_env",
]

#: Global debug default (mirrors reference behaviour; CLI flag can override).
DEBUG = False


# ---------------------------------------------------------------------------
# Artifact directory / data-key vocabularies
# ---------------------------------------------------------------------------

class DataDir:
    """Sub-directory names of the on-disk corpus layout (per split)."""

    EMG = "emg"
    TRANSCRIPTIONS = "transcriptions"
    PHONEMES = "phonemes"
    SPEECH_UNITS = "units"
    MFCCS = "mfccs"
    EMG_FEATS = "emg_feats"
    ACOUSTIC_FEATS = "acoustic_feats"
    AUDIO = "audio"


class SpeakingMode:
    SILENT = "silent"
    NORMAL = "normal"


class DataType:
    """String keys used in per-utterance data dictionaries and batches."""

    UTT_ID = "UTT_ID"
    REAL_EMG = "REAL_EMG"
    EMG_FEATURES = "EMG_FEATS"
    MFCCS = "MFCCS"
    TRANSCRIPTION = "TRANSCRIPTION"
    PHONEMES = "PHONEMES"
    SPEECH_UNITS = "SPEECH_UNITS"
    SESSION_INDEX = "SESSION_INDEX"
    SESSION_ID = "SESSION_ID"
    SPEAKING_MODE_ID = "SPEAKING_MODE"
    SPEAKING_MODE_INDEX = "SPEAKING_MODE_IDX"
    FAKE_EMG = "FAKE_EMG"
    PRED_PHONEMES = "PRED_PHONEMES"
    PRED_SPEECH_UNITS = "PRED_SPEECH_UNITS"
    PRED_TRANSCRIPT = "PRED_TRANSCRIPT"
    PRED_AUDIO_SYNTH = "PRED_SYNTH_AUDIO"


class Partition(str, enum.Enum):
    TRAIN = "train"
    VALID = "valid"
    TEST = "test"

    @classmethod
    def check(cls, partition: str) -> str:
        if partition not in {p.value for p in cls}:
            raise ValueError('Partition must be one of ["train", "valid", "test"]')
        return partition
