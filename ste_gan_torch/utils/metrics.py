"""Scalar metric helpers (reference: ste_gan/train_utils.py:94-104); the
port's own copy of ``ste_gan_tpu/utils/metrics.py``."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def mean_error(errors: Sequence[float]) -> float:
    return float(np.asarray(errors, dtype=np.float64).mean(0)) if len(errors) else math.nan


def phoneme_accuracy(num_phones: int, num_correct: int) -> float:
    return 100.0 * (num_correct / num_phones) if num_phones > 0 else math.nan


def phoneme_accuracy_no_silence(num_phones_total: int, num_correct_no_silence: int,
                                num_silence: int) -> float:
    return phoneme_accuracy(num_phones_total - num_silence, num_correct_no_silence)
