"""Hyperparameters for EMG-encoder pre-training.

The port's own copy of ``ste_gan_tpu/emg_encoder_constants.py`` (the
reference's encoder constants, ste_gan/emg_encoder/constants.py:1-35).
Values identical.
"""
from __future__ import annotations

#: Speech-unit frames per folded training window.
SEQ_LEN = 200

#: Utterances per eval batch.
BATCH_SIZE = 16

LEARNING_RATE = 3e-4

#: EMG samples per speech-unit frame.
EMG_SIGNAL_TO_SPEECH_UNITS = 16

#: ReduceLROnPlateau patience (epochs).
LEARNING_RATE_PATIENCE = 5

#: Linear warmup steps up to LEARNING_RATE.
LEARNING_RATE_WARMUP = 500

WEIGHT_DECAY = 1e-5

#: Maximum total EMG samples per packed batch.
TRAIN_BATCH_MAX_LEN = 128_000

NUM_EPOCHS = 160

#: Early-stop after this many epochs without validation improvement.
EARLY_STOP_PATIENCE = 10

LOSS_WEIGHT_SPEECH_UNITS = 0.5
LOSS_WEIGHT_PHONEMES = 0.5

#: Norm order of the speech-unit distance loss.
SU_LOSS_NORM = 2.0

DEBUG = False
