"""Perceptual losses through the frozen EMG encoder, and phoneme counters
(counterpart of ``ste_gan_tpu/losses/encoder_loss.py``).

The speech-unit loss is the mean euclidean distance between target and
predicted unit vectors over all (batch, time) positions, with
``pairwise_distance``'s eps 1e-6 added to the difference; the phoneme loss
is the mean cross-entropy over all frames. The counters are int32 tensors
on the device: nothing in the step waits for the host.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from ste_gan_torch import constants as C

PAIRWISE_EPS = 1e-6


def speech_unit_distance(target: torch.Tensor,
                         pred: torch.Tensor) -> torch.Tensor:
    """Mean euclidean distance between unit vectors over all (b, t)."""
    diff = target.float() - pred.float() + PAIRWISE_EPS
    return torch.mean(torch.sqrt(torch.sum(torch.square(diff), dim=-1)))


def phoneme_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over all frames; logits ``[B, T, P]``, targets ``[B, T]``."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return torch.mean(nll)


def phoneme_count_metrics(logits: torch.Tensor,
                          targets: torch.Tensor) -> Dict[str, torch.Tensor]:
    pred = torch.argmax(logits, dim=-1)
    correct = pred == targets
    silence = targets == C.SILENCE_PHONEME_INDEX
    return {
        "num_phones": torch.full((), targets.numel(), dtype=torch.int32,
                                 device=targets.device),
        "num_correct": correct.sum().to(torch.int32),
        "num_silence": silence.sum().to(torch.int32),
        "num_correct_no_silence": (correct & ~silence).sum().to(torch.int32),
    }


def emg_encoder_loss(
        encoder_apply: Callable, emg_signal: torch.Tensor,
        target_speech_units: torch.Tensor, target_phonemes: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(speech-unit loss, phoneme loss, counters) of ``encoder_apply(emg)``."""
    su_pred, phoneme_logits = encoder_apply(emg_signal)
    su_loss = speech_unit_distance(target_speech_units, su_pred)
    ph_loss = phoneme_cross_entropy(phoneme_logits, target_phonemes)
    metrics = phoneme_count_metrics(phoneme_logits, target_phonemes)
    return su_loss, ph_loss, metrics
