"""EMG-encoder pre-training (EMG -> soft speech units + phonemes) and its CLI.

    python -m ste_gan_torch.train.encoder --data configs/data/synthetic.yaml \\
        [--include_silent] [--num_epochs N] [--max_batch_len N] [--device cpu]

Counterpart of ``ste_gan_tpu/train/encoder.py`` (the reference's
``ste_gan/emg_encoder/train.py:37-360``), with the same semantics and run-dir
protocol:

* size-aware packed batches (<= 128k EMG samples) folded into 1600-sample
  windows, the train split on the card (``train/encoder_data.py``);
* voiced loss = 0.5 * mean speech-unit distance + 0.5 * phoneme CE per
  sample, summed over voiced samples / batch size; with ``--include_silent``
  the silent samples add their DTW-aligned loss (the alignment runs in the
  hand-written ``dtw_align_kernel``, ``ops/dtw.py``);
* AdamW(wd 1e-5) through the port's one-launch AdamW kernel, a 500-step
  linear warmup to 3e-4 and ReduceLROnPlateau(0.5, patience 5) on the
  validation loss; early stop after 10 epochs without improvement;
* best weights snapshotted on the device at every improvement and, with the
  last weights, flushed every ``--save_interval_epochs`` and at the end, as
  reference-layout state dicts ``best_val_loss_model.pt`` and
  ``last_model.pt``: the port's GAN trainer loads them with
  ``--emg_enc_ckpt``, strictly.

The random shift is drawn on the host from the train state's own numpy
generator and dropout from its own ``torch.Generator`` on the device, so a
step never waits for the card. Metrics stay on the card until the end of
the epoch. Runs on ``cuda`` unless ``--device cpu`` is given; without a card
it raises.

Over N ranks, one process each (``torchrun --nproc_per_node N -m
ste_gan_torch.train.encoder ...``; ``--data_parallel``, when above 0, must
equal N): every rank holds the split on its device, folds the same global
batch and runs its ``n_win / N`` windows (N must divide the fold's window
count), and the step computes the JAX mesh's global quantities
(:func:`make_encoder_train_step`). Validation splits the dev batches over
the ranks and sums the results; rank 0 alone writes the logs and
checkpoints.

``--model_parallel P`` splits the ranks into ``(data, model) = (ranks / P,
P)`` (``parallel/tensor_parallel.py``): each model rank keeps its
output-channel slabs of the encoder (BatchNorm statistics per slab) and of
its AdamW moments, the fold's windows and the gradient sum go over the
data ranks, and the checkpoints are gathered to the reference layout
first. An MoE block's experts split over the model ranks instead
(``parallel/expert_parallel.py``'s rule).

``--pipeline_stages S`` splits the ranks into ``(data, stage) = (ranks /
S, S)`` (``parallel/pipeline_parallel.py``): each stage rank holds its
``layers / S`` transformer layers (and their AdamW moments) and the
replicated frontend and heads; a data rank runs its slice of each of
``--pipeline_microbatches`` microbatches (default: one window per data
rank each) through the stage ring; validation passes each dev batch
through the ring whole; checkpoints gather every stage's layers. As in
JAX, ``--pipeline_stages`` above 1 with ``--model_parallel`` above 1, or
with an MoE encoder, raises.

An MoE encoder over data ranks routes the global batch's tokens: its
capacity and token dropping are world 1's (``models/moe.py``). Not
ported: the host-fold training path (``--no-device_resident_data``
raises).

``--emg_enc_cfg configs/emg_encoder/conv_transformer_moe.yaml`` trains the
mixture-of-experts encoder: the step adds ``MOE_AUX_WEIGHT`` (0.01) times
the sum of the blocks' load-balancing losses to the loss it differentiates
and logs, as the JAX step does.

``--emg_enc_cfg configs/emg_encoder/lfm2_8b_a1b.yaml`` trains the encoder
with LFM2-8B-A1B's block stack (``EMGEncoderLFM2``, no JAX counterpart) on
one device: f32 parameters and AdamW state, bf16 products
(``models/lfm2.py`` ``COMPUTE_DTYPE``), and after each update the dropless sparse blocks'
expert biases move by their loads; there is no auxiliary loss.
``--emg_enc_cfg configs/emg_encoder/kanana_2_30b_a3b.yaml`` trains the
encoder with kanana-2-30b-a3b's DeepSeek-V3 block stack
(``EMGEncoderDeepseekV3``: multi-head latent attention, 128 routed and 2
shared experts) the same way.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ste_gan_torch import constants as C
from ste_gan_torch import emg_encoder_constants as EC
from ste_gan_torch.config import Config, load_config
from ste_gan_torch.data.dataset import EMGDataset
from ste_gan_torch.data.loader import Prefetcher, to_device
from ste_gan_torch.device import resolve_device
from ste_gan_torch.losses.encoder_loss import PAIRWISE_EPS
from ste_gan_torch.models.emg_encoder import (
    EMGEncoderTransformer, SparseBlockEncoder, init_emg_encoder)
from ste_gan_torch.ops import kernel_launches
from ste_gan_torch.ops.dtw import dtw_alignment_batched
from ste_gan_torch.ops.fused_adamw import (
    AdamWState, adamw_init, fused_adamw_, set_learning_rate)
from ste_gan_torch.parallel import mesh
from ste_gan_torch.parallel import pipeline_parallel as pp
from ste_gan_torch.parallel import tensor_parallel as tp
from ste_gan_torch.train.encoder_data import (
    EncoderDeviceCorpus, SizeAwareSampler, fold_encoder_batch,
    windows_needed)
from ste_gan_torch.utils.logging_utils import MetricLogger, setup_run_logging
from ste_gan_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class EncoderTrainState:
    """Step count, AdamW state and the step's two random streams. The
    parameters and BatchNorm statistics live in the model and update in
    place."""

    step: int
    opt: AdamWState
    #: Host stream of the per-step random shift.
    shift_rng: np.random.Generator
    #: Device stream of the dropout masks.
    dropout_rng: torch.Generator


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def voiced_batch_loss(su_pred_flat, ph_pred_flat, batch: Batch,
                      max_samples: int):
    """The reference's per-sample voiced loss loop
    (ste_gan/emg_encoder/train.py:99-118,146) over a folded batch: per-frame
    speech-unit distances and CE -> per-sample means by indexed sums -> the
    0.5/0.5 mix -> sum over voiced samples / total samples. Returns (loss,
    counters, confusion ``[pred, target]``), all device tensors."""
    sample_id = batch["frame_sample_id"].long()
    valid = sample_id >= 0
    seg = torch.where(valid, sample_id, 0)

    su_t = batch["su_targets"].float()
    diff = su_t - su_pred_flat.float() + PAIRWISE_EPS
    dists = torch.sqrt(torch.sum(torch.square(diff), dim=-1))

    logp = F.log_softmax(ph_pred_flat.float(), dim=-1)
    ph_t = batch["ph_targets"].long()
    ce = -torch.gather(logp, 1, ph_t[:, None])[:, 0]

    weights = valid.float()
    zeros = weights.new_zeros(max_samples)
    counts = zeros.index_add(0, seg, weights).clamp(min=1)
    su_mean = zeros.index_add(0, seg, dists * weights) / counts
    ce_mean = zeros.index_add(0, seg, ce * weights) / counts

    num = batch["num_samples"]
    is_real = torch.arange(max_samples, device=num.device) < num
    is_voiced = is_real & ~batch["silent"]
    per_sample = (EC.LOSS_WEIGHT_SPEECH_UNITS * su_mean
                  + EC.LOSS_WEIGHT_PHONEMES * ce_mean)
    loss = (torch.sum(torch.where(is_voiced, per_sample, 0.0))
            / num.float().clamp(min=1))

    # Phoneme accuracy counters and confusion over voiced frames.
    frame_voiced = valid & ~batch["silent"][seg]
    pred = torch.argmax(ph_pred_flat, dim=-1)
    correct = (pred == ph_t) & frame_voiced
    counters = {"num_correct": correct.sum().to(torch.int32),
                "num_frames": frame_voiced.sum().to(torch.int32)}
    confusion = torch.zeros((C.NUM_PHONEMES, C.NUM_PHONEMES),
                            dtype=torch.int32, device=pred.device)
    confusion.index_put_((pred, ph_t), frame_voiced.to(torch.int32),
                         accumulate=True)
    return loss, counters, confusion


def _dtw_costs(su_p, ph_p, su_t, ph_t):
    """Silent costs ``[S, T_pred, T_target]`` = 0.5 * euclidean distance +
    0.5 * (-log p(target phoneme)), and the log-probabilities, as the JAX
    loss computes them (difference, square, sum, +1e-12, square root)."""
    dists = torch.sqrt(torch.sum(torch.square(
        su_p[:, :, None, :] - su_t[:, None, :, :].float()), dim=-1) + 1e-12)
    logp = F.log_softmax(ph_p, dim=-1)
    idx = ph_t.long()[:, None, :].expand(-1, ph_p.shape[1], -1)
    phone_lp = torch.gather(logp, 2, idx)
    costs = (EC.LOSS_WEIGHT_SPEECH_UNITS * dists
             + EC.LOSS_WEIGHT_PHONEMES * (-phone_lp))
    return costs, logp


def silent_batch_loss(su_pred_flat, ph_pred_flat, batch: Batch,
                      silent_pred_frames: int,
                      confusion: Optional[torch.Tensor] = None):
    """DTW-aligned loss over a folded batch's silent slots (reference silent
    branch of speech_unit_loss_combined; ste_gan/emg_encoder/train.py:
    120-144), batched over slots: each slot gathers its ``silent_pred_frames``
    prediction frames from the flat 50 Hz axis, builds its padded cost
    matrix, and one ``dtw_alignment_batched`` call aligns every slot from
    its own end cell. Gradients flow through the gathered costs.

    Returns (sum of the silent samples' losses, aligned-phoneme counters).
    ``confusion [pred, target]`` (int, on the device), when given, gains the
    aligned silent frames."""
    t_pred = silent_pred_frames
    # Pad the flat frame axis so the fixed-size slices never run off it.
    su_flat = F.pad(su_pred_flat.float(), (0, 0, 0, t_pred))
    ph_flat = F.pad(ph_pred_flat.float(), (0, 0, 0, t_pred))
    start = batch["silent_pred_start"].long()
    rows = start[:, None] + torch.arange(t_pred, device=start.device)
    su_t, ph_t = batch["silent_su_targets"], batch["silent_ph_targets"].long()
    lt = batch["silent_target_len"]
    lp = batch["silent_pred_len"]

    costs, logp = _dtw_costs(su_flat[rows], ph_flat[rows], su_t, ph_t)
    ends = torch.stack([lt - 1, lp - 1], dim=1).to(torch.int32)
    alignment = dtw_alignment_batched(costs.transpose(1, 2), ends).long()
    picked = torch.gather(costs, 1, alignment[:, None, :])[:, 0]  # [S, Tt]
    mask = torch.arange(ph_t.shape[1], device=lt.device)[None, :] < lt[:, None]
    losses = (torch.sum(torch.where(mask, picked, 0.0), dim=1)
              / lt.float().clamp(min=1))
    pred_phone = torch.gather(torch.argmax(logp, dim=-1), 1, alignment)
    correct = ((pred_phone == ph_t) & mask).sum(dim=1)
    active = lt > 0
    loss_sum = torch.sum(torch.where(active, losses, 0.0))
    counters = {
        "num_correct_silent": torch.where(active, correct, 0).sum().to(torch.int32),
        "num_frames_silent": torch.where(active, mask.sum(dim=1), 0).sum().to(torch.int32),
    }
    if confusion is not None:
        confusion.index_put_((pred_phone.flatten(), ph_t.flatten()),
                             mask.flatten().to(confusion.dtype),
                             accumulate=True)
    return loss_sum, counters


# ---------------------------------------------------------------------------
# Train/eval steps
# ---------------------------------------------------------------------------


def make_optimizer(params) -> AdamWState:
    """``optax.adamw(3e-4, weight_decay=1e-5)`` (b1 0.9, b2 0.999, eps 1e-8)
    as the port's one-launch AdamW; the learning rate is set per step with
    ``set_learning_rate``."""
    return adamw_init(list(params), lr=EC.LEARNING_RATE,
                      weight_decay=EC.WEIGHT_DECAY)


def init_train_state(model: EMGEncoderTransformer,
                     seed: int = C.RANDOM_SEED,
                     params=None) -> EncoderTrainState:
    """Optimizer state for the model's current weights (call after the model
    is on its device: the AdamW tables hold the parameters' addresses) and
    the two random streams, seeded. ``params``: the parameters this rank
    updates (default all; a pipeline stage's: ``stage_parameters``)."""
    device = next(model.parameters()).device
    return EncoderTrainState(
        step=0, opt=make_optimizer(model.parameters() if params is None
                                   else params),
        shift_rng=np.random.default_rng(seed),
        dropout_rng=torch.Generator(device=device).manual_seed(seed))


def random_shift(rng: np.random.Generator) -> int:
    """The per-batch left shift, uniform in [0, 8) (reference
    ste_gan/models/emg_encoder.py:71-75), drawn on the host."""
    return int(rng.integers(0, 8))


#: Weight of the MoE blocks' load-balancing losses in the train loss (the
#: JAX step's ``moe_aux_weight`` default, which no caller changes).
MOE_AUX_WEIGHT = 0.01


def make_encoder_train_step(model: EMGEncoderTransformer, max_samples: int,
                            silent_pred_frames: int = 0,
                            group=None, pipeline=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: a train-mode
    forward (shift, batch statistics, dropout), the voiced loss plus, when
    ``silent_pred_frames > 0``, the silent DTW loss over
    ``max(num_samples, 1)`` (the reference's per-sample normalisation,
    ste_gan/emg_encoder/train.py:146), plus ``MOE_AUX_WEIGHT`` times the
    MoE blocks' load-balancing losses (an MoE encoder only), gradients and
    one AdamW launch. The batch must carry the silent slot fields on the
    mixed path.

    ``group``: every rank passes the same folded global batch and runs the
    forward on its equal share of the windows (BatchNorm statistics
    global, dropout masks sliced from global ones, the shift shared). The
    predictions are all-gathered, so every rank computes the unchanged
    global loss (windows of one utterance may lie on two ranks, and the
    segment sums, per-sample normalisers and DTW need them all); the
    gather's backward keeps the rank's own rows, so the parameter gradients
    are summed over the ranks. An MoE block routes the global batch's
    tokens (``models/moe.py``).

    ``pipeline = (mesh, num_microbatches)``: the transformer stack runs as
    a GPipe pipeline over the stage ranks of ``mesh``
    (``EMGEncoderTransformer.pipelined``, ``parallel/pipeline_parallel.py``)
    on this data rank's slice of every microbatch; the predictions are
    gathered over ``mesh.data``, the last stage's loss alone is
    differentiated (``last_stage_only``), and the gradients are summed as
    ``allreduce_stage_grads_`` says. The step updates this rank's set:
    ``stage_parameters`` (``group`` is unused).

    A ``SparseBlockEncoder`` (``EMGEncoderLFM2``, ``EMGEncoderDeepseekV3``;
    one device only) moves its expert biases after the AdamW update, from
    the loads of the step's forward.

    Spans (``utils/profiling.py``): ``enc/forward``, ``enc/loss`` (with
    ``dtw`` inside) and ``enc/backward`` around the unpipelined step's
    phases, ``adamw`` inside the update, ``enc/moe/bias`` after it."""
    biased = isinstance(model, SparseBlockEncoder)
    if biased and (pipeline is not None or group is not None):
        raise NotImplementedError(
            f"{type(model).__name__} trains on one device: its routing, "
            "expert biases and loads over data ranks or pipeline stages are "
            "not written")
    if pipeline is not None:
        return _pipelined_train_step(model, max_samples, silent_pred_frames,
                                     *pipeline)
    params = list(model.parameters())
    rank, size = mesh.rank_and_size(group)

    def train_step(state: EncoderTrainState, batch: Batch
                   ) -> Tuple[EncoderTrainState, Dict[str, torch.Tensor]]:
        shift = random_shift(state.shift_rng)
        with span("enc/forward"):
            windows = mesh.constrain_batch({"w": batch["emg_windows"]}, rank,
                                           size)["w"]
            su, ph = model(windows, train=True, shift=shift,
                           generator=state.dropout_rng, group=group)
            su, ph = mesh.gather_rows(su, group), mesh.gather_rows(ph, group)
        with span("enc/loss"):
            loss, counters = _train_loss(model, su, ph, batch, max_samples,
                                         silent_pred_frames)
        with span("enc/backward"):
            grads = mesh.allreduce_grads_(torch.autograd.grad(loss, params),
                                          group, average=False)
        fused_adamw_(state.opt, grads)
        if biased:
            with span("enc/moe/bias"):
                model.update_expert_bias()
        state.step += 1
        return state, {"loss": loss.detach(), **counters}

    return train_step


def _train_loss(model, su, ph, batch: Batch, max_samples: int,
                silent_pred_frames: int):
    """The step's loss and counters from the global batch's predictions."""
    n, f, d = su.shape
    su_flat, ph_flat = su.reshape(n * f, d), ph.reshape(n * f, -1)
    loss, counters, _ = voiced_batch_loss(su_flat, ph_flat, batch,
                                          max_samples)
    if silent_pred_frames > 0:
        silent_sum, _ = silent_batch_loss(su_flat, ph_flat, batch,
                                          silent_pred_frames)
        loss = loss + silent_sum / batch["num_samples"].float().clamp(min=1)
    aux = model.pop_moe_aux_loss()
    if aux is not None:
        loss = loss + MOE_AUX_WEIGHT * aux
    return loss, counters


def _pipelined_train_step(model: EMGEncoderTransformer, max_samples: int,
                          silent_pred_frames: int, stages,
                          num_microbatches: int) -> Callable:
    replicated, own = pp.stage_parameters(model, stages)
    params = replicated + own

    def train_step(state: EncoderTrainState, batch: Batch
                   ) -> Tuple[EncoderTrainState, Dict[str, torch.Tensor]]:
        shift = random_shift(state.shift_rng)
        windows = pp.microbatch_rows(batch["emg_windows"], num_microbatches,
                                     stages)
        su, ph = model.pipelined(windows, stages, num_microbatches,
                                 train=True, shift=shift,
                                 generator=state.dropout_rng)
        su = pp.gather_microbatch_rows(su, num_microbatches, stages)
        ph = pp.gather_microbatch_rows(ph, num_microbatches, stages)
        loss, counters = _train_loss(model, su, ph, batch, max_samples,
                                     silent_pred_frames)
        grads = list(torch.autograd.grad(pp.last_stage_only(loss, stages),
                                         params, materialize_grads=True))
        pp.allreduce_stage_grads_(grads[:len(replicated)],
                                  grads[len(replicated):], stages)
        fused_adamw_(state.opt, grads)
        state.step += 1
        return state, {"loss": loss.detach(), **counters}

    return train_step


def make_encoder_eval_step(model: EMGEncoderTransformer,
                           max_samples: int, stages=None) -> Callable:
    """Returns ``eval_step(batch) -> (metrics, (su_flat, ph_flat))``: the
    eval-mode forward, the voiced loss, counters and confusion, and the flat
    predictions for the silent path. ``stages`` (a ``StageMesh``): the
    whole batch passes the stage ranks as one microbatch, so each layer
    sees one device's shapes."""

    @torch.no_grad()
    def eval_step(batch: Batch):
        if stages is None:
            su, ph = model(batch["emg_windows"])
        else:
            su, ph = model.pipelined(batch["emg_windows"], stages, 1)
        n, f, d = su.shape
        su_flat, ph_flat = su.reshape(n * f, d), ph.reshape(n * f, -1)
        loss, counters, confusion = voiced_batch_loss(su_flat, ph_flat, batch,
                                                      max_samples)
        return {"loss": loss, **counters, "confusion": confusion}, (
            su_flat, ph_flat)

    return eval_step


# ---------------------------------------------------------------------------
# LR schedule (warmup + plateau)
# ---------------------------------------------------------------------------


class ReduceLROnPlateau:
    """torch-semantics plateau scheduler (mode=min, rel threshold 1e-4)."""

    def __init__(self, factor: float = 0.5, patience: int = EC.LEARNING_RATE_PATIENCE,
                 threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.multiplier = 1.0
        self.best = float("inf")
        self.num_bad = 0

    def step(self, value: float) -> None:
        if value < self.best * (1.0 - self.threshold):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.multiplier *= self.factor
                self.num_bad = 0


def warmup_lr(batch_idx: int, target: float = EC.LEARNING_RATE,
              warmup: int = EC.LEARNING_RATE_WARMUP) -> float:
    """Linear warmup over the first ``warmup`` batches
    (reference schedule_lr; ste_gan/emg_encoder/train.py:177-180)."""
    iteration = batch_idx + 1
    if iteration <= warmup:
        return iteration * target / warmup
    return target


# ---------------------------------------------------------------------------
# Training loop
# ---------------------------------------------------------------------------


def _silent_dims(dataset: EMGDataset, indices) -> Dict[str, int]:
    """Fold arguments for the silent DTW slots of ``indices``: slot count
    and the longest target and prediction tracks (no slots: empty)."""
    silent = [i for i in indices
              if dataset.speaking_mode_ids[i] != C.SpeakingMode.NORMAL]
    if not silent:
        return {}
    return {"max_silent": len(silent),
            "silent_target_frames": max(
                len(dataset[i][C.DataType.SPEECH_UNITS]) for i in silent),
            "silent_pred_frames": max(
                dataset.emg_lengths[i] // EC.EMG_SIGNAL_TO_SPEECH_UNITS
                for i in silent)}


def evaluate(eval_step: Callable, dataset: EMGDataset, n_win: int,
             max_samples: int, device: torch.device,
             batch_size: int = EC.BATCH_SIZE, group=None
             ) -> Tuple[float, float, np.ndarray]:
    """Mean loss + phoneme accuracy + confusion over the dev set (reference
    test(); ste_gan/emg_encoder/train.py:37-63). Voiced samples take the
    voiced loss; the silent ones of a batch take the DTW-aligned loss on the
    predictions' device (the JAX package aligns them on the host), combined
    as the reference does: sum over samples / samples in the batch.

    ``group``: whole batches round robin over the ranks
    (``mesh.round_robin``); one all-reduce of the per-batch results and one
    of the confusion give every rank the single-device numbers."""
    starts = range(0, len(dataset), batch_size)
    table = torch.zeros((len(starts), 3), dtype=torch.float64, device=device)
    confusion = torch.zeros((C.NUM_PHONEMES, C.NUM_PHONEMES),
                            dtype=torch.int64, device=device)
    for b in mesh.round_robin(len(starts), group):
        start = starts[b]
        indices = range(start, min(start + batch_size, len(dataset)))
        items = [dataset[i] for i in indices]
        silent = _silent_dims(dataset, indices)
        batch = to_device(fold_encoder_batch(
            items, n_win=n_win, max_samples=max_samples, **silent).as_dict(),
            device)
        out, (su_flat, ph_flat) = eval_step(batch)
        confusion += out["confusion"]
        loss, correct, total = out["loss"], out["num_correct"], out["num_frames"]
        if silent:
            with torch.no_grad():
                s_loss, s_counts = silent_batch_loss(
                    su_flat, ph_flat, batch, silent["silent_pred_frames"],
                    confusion=confusion)
            loss = loss + s_loss / len(items)
            correct = correct + s_counts["num_correct_silent"]
            total = total + s_counts["num_frames_silent"]
        table[b] = torch.stack([loss.double(), correct.double(),
                                total.double()])
    if group is not None:
        torch.distributed.all_reduce(table, group=group)
        torch.distributed.all_reduce(confusion, group=group)
    losses, correct, total = table.cpu().numpy().T
    acc = float(correct.sum()) / max(float(total.sum()), 1.0)
    return float(np.mean(losses)), acc, confusion.cpu().numpy()


def _save_state_dict(state_dict: Dict[str, torch.Tensor], path: Path) -> None:
    """``torch.save`` of a state dict on the host, written to a temporary
    file and renamed, so a reader never sees half a file."""
    tmp = path.with_suffix(".pt.tmp")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def _check_parallel(data_parallel: int, model_parallel: int,
                    pipeline_stages: int, pipeline_microbatches: int = 0,
                    size: int = 1) -> Tuple[int, int]:
    """Raise for what the port cannot run over ``size`` launched ranks;
    returns ``(data, model)`` (with pipeline stages, ``(data, 1)``)."""
    stages = int(pipeline_stages)
    if stages > 1 and int(model_parallel) > 1:
        raise ValueError("pipeline_stages and model_parallel are mutually "
                         "exclusive (as in the JAX trainer)")
    if stages > 1:
        data = (int(data_parallel) if int(data_parallel) > 0
                else max(1, size // stages))
        if data * stages != size:
            raise ValueError(
                f"data_parallel {data} x pipeline_stages {stages} needs "
                f"{data * stages} ranks, but {size} rank(s) were launched "
                f"(parallel/pipeline_parallel.py): launch data x stages "
                f"ranks (torchrun --nproc_per_node {data * stages})")
        return data, 1
    if int(pipeline_microbatches) > 0:
        raise ValueError(
            f"pipeline_microbatches={pipeline_microbatches} needs "
            f"pipeline_stages above 1 (parallel/pipeline_parallel.py)")
    return tp.mesh_shape(size, data_parallel, max(1, int(model_parallel)))


def train_encoder_model(cfg: Config, trainset: EMGDataset, devset: EMGDataset,
                        output_directory: Path, debug: bool = False,
                        max_len: int = EC.TRAIN_BATCH_MAX_LEN,
                        num_epochs: int = EC.NUM_EPOCHS,
                        warmup_steps: int = EC.LEARNING_RATE_WARMUP,
                        save_interval_epochs: int = 1,
                        transfer_dtype: str = "float16",
                        data_parallel: int = -1,
                        model_parallel: int = 1,
                        pipeline_stages: int = 1,
                        pipeline_microbatches: int = 0,
                        device=None, group=None,
                        ) -> Tuple[EMGEncoderTransformer, EncoderTrainState]:
    """Train the encoder; returns the model (last weights) and its state.

    The train split lives on the device (``EncoderDeviceCorpus``, stored at
    ``transfer_dtype``, "float16" | "float32") and each batch folds there
    from ``{rows, num_samples}`` descriptors; validation folds on the host
    and runs in f32. ``group``: the ranks of a multi-rank run (see the
    module docstring)."""
    rank, size = mesh.rank_and_size(group)
    lead = rank == 0
    data_size, model_size = _check_parallel(
        data_parallel, model_parallel, pipeline_stages,
        pipeline_microbatches, size=size)
    stages = max(1, int(pipeline_stages))
    dev = resolve_device(device)
    output_directory = Path(output_directory)
    if len(trainset) == 0 or len(devset) == 0:
        # An empty partition would spin through epochs with no batches.
        raise ValueError(
            f"empty dataset: train={len(trainset)} dev={len(devset)} "
            "utterances. If this is the synthetic development corpus, "
            "(re)generate it with: python -m ste_gan_torch.data.synthetic "
            "--root data/synthetic")
    model = init_emg_encoder(
        cfg, torch.float32,
        torch.Generator().manual_seed(C.RANDOM_SEED)).to(dev)
    if isinstance(model, SparseBlockEncoder) and size > 1:
        raise NotImplementedError(
            f"{type(model).__name__} trains on one device "
            "(models/emg_encoder.py)")
    if stages > 1:
        if model.moe_experts > 0:
            raise NotImplementedError(
                "pipelined execution of MoE layers is unsupported — use "
                "expert parallelism (parallel/expert_parallel.py) instead")
        pp.stage_range(len(model.transformer.layers), 0, stages)
    mesh.replicate_module(model, group)
    stage_mesh = None
    if stages > 1:
        stage_mesh = pp.create_stage_mesh_2d(data_size, stages, group)
        pp.shard_stages_(model, stage_mesh)
        layout = tp.Mesh2D(None, stage_mesh.data, None,
                           stage_mesh.data_rank, stage_mesh.data_size)
    else:
        layout = (tp.create_mesh_2d(data_parallel, model_size, group)
                  if group is not None else tp.Mesh2D(None, None, None))
        tp.shard_module_(model, layout)
    data_group = layout.data

    def full_state_dict(sd: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """``sd`` (this rank's slabs or stage) in the reference layout:
        gathered over the model or stage ranks (a collective)."""
        if stage_mesh is not None:
            return pp.gather_stage_state_dict(model, stage_mesh, sd)
        if layout.model_size == 1:
            return sd
        return tp.gather_state_dict(model, layout, sd)

    window = EC.SEQ_LEN * 8
    n_win = max(1, -(-max_len // window))
    pipeline = None
    if stage_mesh is not None:
        # One window per microbatch by default: the smallest bubble,
        # M / (M + S - 1) of the ticks busy.
        microbatches = (int(pipeline_microbatches)
                        if int(pipeline_microbatches) > 0
                        else max(1, n_win // layout.data_size))
        if n_win % microbatches or (n_win // microbatches) % layout.data_size:
            raise ValueError(
                f"pipeline_microbatches {microbatches} must divide the "
                f"fold's window count {n_win} into microbatches divisible "
                f"by the data axis ({layout.data_size})")
        pipeline = (stage_mesh, microbatches)
        logging.info("Pipeline: stage %d of %d, data rank %d of %d, %d "
                     "microbatches of %d windows", stage_mesh.stage_rank,
                     stages, layout.data_rank, layout.data_size,
                     microbatches, n_win // microbatches)
    else:
        mesh.check_divides(n_win, layout.data_size, "fold's window count")
    # Eval batches can need more windows than the training budget.
    eval_lengths = sorted(devset.emg_lengths, reverse=True)[:EC.BATCH_SIZE]
    n_win_eval = max(n_win, windows_needed(eval_lengths, EC.SEQ_LEN))
    max_samples = max(64, 2 * n_win, EC.BATCH_SIZE)

    # Mixed-batch (silent) training: fixed DTW dimensions from the train
    # split's silent utterances (ste_gan/emg_encoder/train.py:120-146).
    silent_idx = [i for i, m in enumerate(trainset.speaking_mode_ids)
                  if m != C.SpeakingMode.NORMAL]
    silent = _silent_dims(trainset, range(len(trainset)))
    if silent:
        min_silent_emg = min(trainset.emg_lengths[i] for i in silent_idx)
        silent["max_silent"] = min(len(silent_idx),
                                   max_len // max(min_silent_emg, 1) + 1)
        logging.info(
            "Mixed training: %d silent utterances (<=%d per batch, "
            "pred<=%d frames, target<=%d frames)", len(silent_idx),
            silent["max_silent"], silent["silent_pred_frames"],
            silent["silent_target_frames"])
    silent_pred_frames = silent.get("silent_pred_frames", 0)
    corpus_silent = {k: v for k, v in silent.items()
                     if k != "silent_pred_frames"}

    params = (sum(pp.stage_parameters(model, stage_mesh), [])
              if stage_mesh is not None else None)
    state = init_train_state(model, params=params)
    train_step = make_encoder_train_step(model, max_samples,
                                         silent_pred_frames=silent_pred_frames,
                                         group=data_group, pipeline=pipeline)
    writer = MetricLogger(output_directory) if lead else None
    eval_step = make_encoder_eval_step(model, max_samples, stage_mesh)
    device_corpus = EncoderDeviceCorpus(
        trainset, float_dtype=(torch.float16 if transfer_dtype == "float16"
                               else torch.float32), device=dev)
    logging.info(
        "Device-resident corpus: %d utterances, %.1f MB on %s — "
        "per-batch copies reduced to {rows, num_samples}",
        len(trainset), device_corpus.nbytes / 2**20, dev)

    sampler = SizeAwareSampler(trainset.emg_lengths, max_len,
                               seed=C.RANDOM_SEED)
    plateau = ReduceLROnPlateau()
    best_val_loss = float("inf")
    num_no_improvement = 0
    batch_idx = 0

    # Best weights are snapshotted on the device at each improvement and
    # written only every ``save_interval_epochs`` epochs and at the end.
    best_snapshot: Optional[Dict[str, torch.Tensor]] = None
    best_dirty = last_dirty = False

    def flush_checkpoints(force: bool = False) -> None:
        """Every rank calls it (the gather over the model ranks is a
        collective); rank 0 writes."""
        nonlocal best_dirty, last_dirty
        if best_dirty:
            sd = full_state_dict(best_snapshot)
            if lead:
                _save_state_dict(sd,
                                 output_directory / "best_val_loss_model.pt")
            best_dirty = False
        if last_dirty and (force or save_interval_epochs > 0):
            sd = full_state_dict(model.state_dict())
            if lead:
                _save_state_dict(sd, output_directory / "last_model.pt")
            last_dirty = False

    def batches():
        # The descriptors and their copy to the device run in the prefetch
        # thread, so batch k+1 overlaps step k.
        for index_batch in sampler:
            rows = np.zeros(max_samples, np.int32)
            rows[:len(index_batch)] = index_batch
            yield to_device({"rows": rows, "num_samples": np.asarray(
                len(index_batch), np.int32)}, dev)

    try:
        for epoch_idx in range(num_epochs):
            logging.info("Starting encoder epoch %d", epoch_idx + 1)
            epoch_start = time.time()
            pending = []
            for batch in Prefetcher(batches, 2):
                batch = device_corpus.fold(
                    batch["rows"], batch["num_samples"], n_win=n_win,
                    max_samples=max_samples, **corpus_silent)
                lr = warmup_lr(batch_idx, warmup=warmup_steps) * plateau.multiplier
                set_learning_rate(state.opt, lr)
                state, metrics = train_step(state, batch)
                pending.append(torch.stack([metrics["loss"].double(),
                                            metrics["num_correct"].double(),
                                            metrics["num_frames"].double()]))
                batch_idx += 1
                if debug:
                    logging.warning("debug: breaking train loop after one batch")
                    break

            # One copy from the device per epoch.
            losses = []
            if pending:
                for i, (loss_val, n_correct, n_frames) in enumerate(
                        torch.stack(pending).tolist()):
                    step_i = batch_idx - len(pending) + i + 1
                    losses.append(loss_val)
                    if lead:
                        writer.scalar("train/loss", loss_val, step_i)
                        writer.scalar("train_loss/phon_acc",
                                      n_correct / max(n_frames, 1), step_i)
            train_s = time.time() - epoch_start

            val_start = time.time()
            val, phoneme_acc, _ = evaluate(eval_step, devset, n_win_eval,
                                           max_samples, dev, group=data_group)
            val_s = time.time() - val_start
            if lead:
                writer.scalar("val/loss", val, batch_idx)
                writer.scalar("val/phon_acc", phoneme_acc, batch_idx)
            plateau.step(val)

            if val < best_val_loss:
                logging.info("Snapshotting best encoder (val loss improved)")
                best_snapshot = {k: v.detach().clone()
                                 for k, v in model.state_dict().items()}
                best_dirty = True
                best_val_loss = float(val)
                num_no_improvement = 0
            else:
                num_no_improvement += 1
            last_dirty = True

            save_start = time.time()
            if (save_interval_epochs > 0
                    and (epoch_idx + 1) % save_interval_epochs == 0):
                flush_checkpoints()
            save_s = time.time() - save_start
            if lead:
                writer.scalars({"perf/epoch_train_s": train_s,
                                "perf/validation_s": val_s,
                                "perf/save_s": save_s}, batch_idx)
            logging.info(
                "epoch %d: train loss %.4f | val loss %.4f | val phon acc "
                "%.2f%% (train %.1fs, validation %.1fs, save %.1fs)",
                epoch_idx + 1, float(np.mean(losses)) if losses else
                float("nan"), val, phoneme_acc * 100, train_s, val_s, save_s)

            if debug:
                logging.warning("debug: breaking epoch loop")
                break
            if num_no_improvement > EC.EARLY_STOP_PATIENCE:
                logging.warning("early stop: no improvement for %d epochs",
                                num_no_improvement)
                break

        flush_checkpoints(force=True)
        held = sum(t.numel() * t.element_size() for t in (
            *state.opt.params, *state.opt.exp_avg, *state.opt.exp_avg_sq,
            *model.buffers()))
        comm = stage_mesh.comm if stage_mesh is not None else layout.comm
        logging.info("Train state held by this rank: %.1f MB; parallel "
                     "messages over %d steps: %d, %.1f MB", held / 2**20,
                     batch_idx, comm.calls, comm.bytes / 2**20)
    finally:
        if writer is not None:
            writer.close()
        logging.info("Hand-kernel launches in this process: %s",
                     json.dumps(kernel_launches()))
    return model, state


def init_voiced_datasets(emg_dataset_root: Path):
    """Voiced-only train/dev/test datasets with train-derived vocabularies
    (reference init_voiced_datasets_emg_encoder_training;
    ste_gan/emg_encoder/utils.py:118-146)."""
    return _init_datasets(emg_dataset_root, only_include_voiced=True)


def init_mixed_datasets(emg_dataset_root: Path):
    """Voiced + silent train/dev/test datasets for mixed-batch training (the
    working counterpart of the reference's broken
    init_datasets_for_emg_encoder_train, ste_gan/emg_encoder/utils.py:
    149-180)."""
    return _init_datasets(emg_dataset_root, only_include_voiced=False)


def _init_datasets(root: Path, only_include_voiced: bool):
    kw = dict(filter_by_length=False, return_mfccs=False,
              return_emg_feats=False, only_include_voiced=only_include_voiced)
    trainset = EMGDataset(root, partition="train", **kw)

    def eval_set(partition):
        return EMGDataset(
            root, partition, session_id_to_idx=trainset.session_id_to_idx,
            speaking_mode_id_to_idx=trainset.speaking_mode_id_to_idx, **kw)

    devset, testset = eval_set("valid"), eval_set("test")
    EMGDataset.check_no_data_overlap([trainset, devset, testset])
    return trainset, devset, testset


def create_output_dir_name(data_root: Path, emg_enc_name: str,
                           seq_len: int = EC.SEQ_LEN, debug: bool = False) -> str:
    debug_str = "DEBUG_" if debug else ""
    return f"{debug_str}{emg_enc_name}__seq_len__{seq_len}__data_{Path(data_root).name}"


def main(args: argparse.Namespace) -> None:
    if not args.device_resident_data:
        raise ValueError("--no-device_resident_data: the port trains from "
                         "the split on the device; the host-fold training "
                         "path is not ported")
    rank, group, created = mesh.init_ranks(
        args.dist_backend, args.dist_timeout_s, args.device,
        args.dist_init_method)
    lead = rank == 0
    try:
        _check_parallel(args.data_parallel, args.model_parallel,
                        args.pipeline_stages, args.pipeline_microbatches,
                        size=mesh.rank_and_size(group)[1])
        cfg = load_config(args=args, override_with_eval_args=False)
        emg_dataset_root = Path(cfg.data.dataset_root)
        mode_name = "_mixed" if args.include_silent else "_voiced_only"
        output_directory = Path(args.exp_dir) / create_output_dir_name(
            emg_dataset_root, cfg.emg_encoder.type + mode_name,
            debug=args.debug)
        done_file = output_directory / ".done"
        finished = done_file.exists()
        mesh.barrier(group)  # every rank has looked before rank 0 writes
        if lead:
            output_directory.mkdir(exist_ok=True, parents=True)
            print(f"Output directory: {output_directory}")
        if finished:
            logging.warning("Exiting: '.done' exists: %s", done_file.resolve())
            sys.exit()

        handler = setup_run_logging(output_directory) if lead else None
        try:
            config_file = output_directory / "config.yaml"
            if lead and not config_file.exists():
                cfg.save(config_file)
            init_fn = (init_mixed_datasets if args.include_silent
                       else init_voiced_datasets)
            trainset, devset, _ = init_fn(emg_dataset_root)
            logging.info("train/dev: %d / %d utterances", len(trainset),
                         len(devset))
            train_encoder_model(cfg, trainset, devset, output_directory,
                                debug=args.debug, max_len=args.max_batch_len,
                                num_epochs=args.num_epochs,
                                warmup_steps=args.warmup_steps,
                                save_interval_epochs=args.save_interval_epochs,
                                transfer_dtype=args.transfer_dtype,
                                data_parallel=args.data_parallel,
                                model_parallel=args.model_parallel,
                                pipeline_stages=args.pipeline_stages,
                                pipeline_microbatches=(
                                    args.pipeline_microbatches),
                                device=args.device, group=group)
            if lead:
                done_file.write_text("Done training.\n")
        finally:
            if handler is not None:
                logging.getLogger().removeHandler(handler)
                handler.close()
    finally:
        if created and group is not None:
            torch.distributed.destroy_process_group()


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default="configs/ste_gan_base_gantts.yaml")
    parser.add_argument("--exp_dir", type=Path, default=Path("exp/emg_encoder"))
    parser.add_argument("--data", type=str, default="configs/data/gaddy_and_klein_corpus.yaml")
    parser.add_argument("--emg_enc_cfg", type=str,
                        default="configs/emg_encoder/conv_transformer.yaml")
    parser.add_argument("--debug", action="store_true", default=False)
    parser.add_argument("--include_silent", action="store_true", default=False,
                        help="Train on mixed voiced+silent batches (silent "
                             "samples use the DTW-aligned loss).")
    parser.add_argument("--num_epochs", type=int, default=EC.NUM_EPOCHS)
    parser.add_argument("--max_batch_len", type=int, default=EC.TRAIN_BATCH_MAX_LEN,
                        help="Total EMG samples per packed batch.")
    parser.add_argument("--warmup_steps", type=int,
                        default=EC.LEARNING_RATE_WARMUP,
                        help="Linear LR warmup batches (reference: 500; "
                             "emg_encoder/constants.py:20).")
    parser.add_argument("--device_resident_data",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="The train split lives on the device and "
                             "batches fold there from {rows, num_samples} "
                             "descriptors; the port refuses "
                             "--no-device_resident_data.")
    parser.add_argument("--transfer_dtype", type=str, default="float16",
                        choices=("float16", "float32"),
                        help="Storage precision of the train split on the "
                             "device.")
    parser.add_argument("--data_parallel", type=int, default=-1,
                        help="Data-parallel rank count; when above 0, it "
                             "times --model_parallel must equal the ranks "
                             "launched (torchrun --nproc_per_node N).")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="Tensor-parallel size: the ranks form (ranks / "
                             "P, P) and each model rank holds output-channel "
                             "slabs of the encoder "
                             "(parallel/tensor_parallel.py).")
    parser.add_argument("--pipeline_stages", type=int, default=1,
                        help="Pipeline depth S: the transformer layers split "
                             "into S stages, one per rank of each data "
                             "replica ((ranks / S, S) ranks; "
                             "parallel/pipeline_parallel.py). Exclusive "
                             "with --model_parallel.")
    parser.add_argument("--pipeline_microbatches", type=int, default=0,
                        help="Microbatches per pipelined step (0: one "
                             "window per data rank each); must divide the "
                             "fold's windows into parts the data axis "
                             "divides. Needs --pipeline_stages above 1.")
    parser.add_argument("--save_interval_epochs", type=int, default=1,
                        help="Write the best/last checkpoints every N epochs "
                             "(best weights are snapshotted on the device at "
                             "each improvement; the end of training always "
                             "writes).")
    parser.add_argument("--device", type=str, default=None,
                        help="Device to train on (default cuda; 'cpu' runs "
                             "the kernels' plain versions).")
    parser.add_argument("--dist_backend", type=str, default=None,
                        help="Backend of a multi-rank run: nccl (default on "
                             "cuda) or gloo (ranks may share a card).")
    parser.add_argument("--dist_init_method", type=str, default=None,
                        help="Rendezvous URL of a multi-rank run (default "
                             "env://: MASTER_ADDR / MASTER_PORT).")
    parser.add_argument("--dist_timeout_s", type=float,
                        default=mesh.DEFAULT_TIMEOUT_S,
                        help="Seconds a collective may wait before the run "
                             "fails.")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
