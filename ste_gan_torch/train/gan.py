"""The fused adversarial train step, its accumulating and rematerialising
forms, and the eval step (counterpart of ``ste_gan_tpu/train/gan.py``).

Per step, in the reference's order: the generator forward runs once; the
discriminator takes an AdamW step on the detached fake; the generator loss
(adversarial + 15x multi-TD + speech-unit + phoneme + 7x feature matching
[+ waveform]) runs through the *updated* discriminator; the generator takes
an AdamW step; the generator EMA follows with the ramped decay
``min(d, (1+t)/(10+t))``. The spectral-norm power iteration advances in all
four discriminator passes (two paired passes). Generator gradients come from
``torch.autograd.grad(loss_g, generator params)`` with the discriminator's
parameters frozen, so no gradient reaches the discriminator and its grouped
convs skip their weight gradient. Metrics are device tensors: the step never
waits for the host.

``train.grad_accum = K > 1`` splits the batch into K equal microbatches with
one dual AdamW update per step, as the JAX ``lax.scan`` does: the D phase
re-runs the generator forward per microbatch and averages the gradients, the
G phase goes through the updated D; loss terms are averaged and ``count/*``
values summed. Every microbatch of a phase starts from the phase's incoming
spectral-norm state and the last microbatch's state is kept.

``train.remat`` wraps the generator forward, the D loss and the G loss in
``torch.utils.checkpoint``: identical values, activations recomputed in the
backward. The spectral-norm state at a block's entry is restored before its
recompute, so the power iteration gives the same vectors and ends where the
forward left it.

Precision: f32 parameters and optimizer state; modules compute in bf16 when
``train.mixed_precision``; losses reduce in f32. Parameters, moments and the
EMA update in place.

On the card the grouped convs and both AdamW updates run the hand-written
kernels (``ops/grouped_conv.py``, ``ops/fused_adamw.py``) whatever
``grouped_conv_impl``/``fused_optimizer``/``flat_optimizer`` say: the three
JAX optimizer flavours share one update rule, and the port has one.
"""
from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ste_gan_torch import constants as C
from ste_gan_torch.config import Config, load_config, train_setting
from ste_gan_torch.device import resolve_device
from ste_gan_torch.losses.encoder_loss import emg_encoder_loss
from ste_gan_torch.losses.gan_loss import (
    discriminator_loss, feature_matching_loss, generator_adversarial_loss)
from ste_gan_torch.losses.td_loss import multi_time_domain_loss
from ste_gan_torch.models.discriminator import init_emg_discriminators
from ste_gan_torch.models.emg_encoder import init_emg_encoder
from ste_gan_torch.models.generator import init_emg_generator
from ste_gan_torch.ops.conv import SNConv, moving_average
from ste_gan_torch.ops.fused_adamw import (
    AdamWState, adamw_init, fused_adamw_, set_learning_rate)

__all__ = ["GANModels", "GANTrainState", "build_models", "init_state",
           "make_optimizer", "set_learning_rate", "epoch_lr",
           "eval_generator_params", "make_train_step", "make_eval_step",
           "state_tree", "load_trained_state", "synthetic_batch",
           "main_path"]

COUNT_KEYS = ("num_phones", "num_correct", "num_silence",
              "num_correct_no_silence")


@dataclasses.dataclass
class GANModels:
    """The three networks. The encoder is frozen (eval mode, no parameter
    gradients)."""

    generator: torch.nn.Module
    discriminator: torch.nn.Module
    encoder: torch.nn.Module


@dataclasses.dataclass
class GANTrainState:
    """Step count and optimizer states. The parameters live in the models
    and are updated in place; ``gen_ema`` is a list of tensors aligned with
    ``generator.parameters()``, or None when EMA is off."""

    step: int
    opt_g: AdamWState
    opt_d: AdamWState
    gen_ema: Optional[List[torch.Tensor]] = None


def build_models(cfg: Config, seed: int = 0, device=None) -> GANModels:
    """The three networks with seeded random weights, on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if cfg.train.mixed_precision else torch.float32
    gen = torch.Generator().manual_seed(seed)
    generator = init_emg_generator(cfg, dtype, gen).to(dev)
    discriminator = init_emg_discriminators(cfg, dtype, gen).to(dev)
    encoder = init_emg_encoder(cfg, dtype, gen).to(dev)
    encoder.eval().requires_grad_(False)
    return GANModels(generator.train(), discriminator.train(), encoder)


def make_optimizer(cfg: Config, params) -> AdamWState:
    """AdamW(lr, betas from the config, eps 1e-8, wd 1e-2), one pass per
    network (``ops/fused_adamw.py``). The JAX package's optax, flat and
    fused flavours compute this same update; here all three are this
    one."""
    return adamw_init(list(params), lr=cfg.train.learning_rate,
                      b1=cfg.train.adam_b1, b2=cfg.train.adam_b2, eps=1e-8,
                      weight_decay=1e-2)


def init_state(cfg: Config, models: GANModels) -> GANTrainState:
    """Optimizer states (and the EMA copy) for the models' current weights.
    Call after the models are on their device: the optimizer's kernel
    tables hold the parameters' addresses."""
    gen_params = list(models.generator.parameters())
    ema = float(train_setting(cfg.train, "generator_ema"))
    return GANTrainState(
        step=0,
        opt_g=make_optimizer(cfg, gen_params),
        opt_d=make_optimizer(cfg, models.discriminator.parameters()),
        gen_ema=[p.detach().clone() for p in gen_params] if ema > 0 else None)


def epoch_lr(cfg: Config, epoch: int) -> float:
    """lr * gamma^epoch, stepped per epoch like the reference scheduler."""
    return float(cfg.train.learning_rate) * float(cfg.train.lr_decay_gamma) ** max(0, epoch)


@contextlib.contextmanager
def eval_generator_params(models: GANModels, state: GANTrainState
                          ) -> Iterator[torch.nn.Module]:
    """Inside the block the generator holds the weights downstream consumers
    evaluate: the EMA weights when EMA training is on, the live weights
    otherwise. The live weights are copied back on exit. Both copies are in
    place, so the optimizer's tables stay valid."""
    if state.gen_ema is None:
        yield models.generator
        return
    params = list(models.generator.parameters())
    with torch.no_grad():
        live = [p.detach().clone() for p in params]
        torch._foreach_copy_(params, state.gen_ema)
    try:
        yield models.generator
    finally:
        with torch.no_grad():
            torch._foreach_copy_(params, live)


def _ema_decay(decay: float, step: int) -> np.float32:
    """``min(decay, (1+t)/(10+t))`` in f32, as the JAX step computes it."""
    t = np.float32(step)
    return np.minimum(np.float32(decay),
                      (np.float32(1.0) + t) / (np.float32(10.0) + t))


def _split(batch: Dict[str, torch.Tensor], k: int
           ) -> List[Dict[str, torch.Tensor]]:
    """``k`` equal microbatches, in row order."""
    n = next(iter(batch.values())).shape[0] // k
    return [{key: v[i * n:(i + 1) * n] for key, v in batch.items()}
            for i in range(k)]


def make_train_step(cfg: Config, models: GANModels) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the models'
    parameters and the state update in place."""
    t = cfg.train
    use_adv = bool(t.loss_adversarial)
    use_fm = bool(t.loss_feat_match_error)
    use_td = bool(t.loss_multi_td_error)
    use_su = bool(t.loss_speech_unit_error)
    use_ph = bool(t.loss_phoneme_error)
    use_wave = bool(t.loss_waveform_error)
    feature_key = cfg.model.speech_feature_type
    ema_decay = float(train_setting(t, "generator_ema"))
    remat = bool(train_setting(t, "remat"))
    accum = max(1, int(train_setting(t, "grad_accum")))
    if t.batch_size % accum:
        raise ValueError(
            f"train.grad_accum={accum} must divide train.batch_size="
            f"{t.batch_size}")
    gen, disc, enc = models.generator, models.discriminator, models.encoder
    gen_params = list(gen.parameters())
    disc_params = list(disc.parameters())
    # The spectral-norm power-iteration state: every SN conv's u and v.
    sn_buffers = [b for m in disc.modules() if isinstance(m, SNConv)
                  for b in (m.weight_u, m.weight_v)]

    def sn_save() -> List[torch.Tensor]:
        return [b.clone() for b in sn_buffers]

    def sn_load(saved: List[torch.Tensor]) -> None:
        with torch.no_grad():
            for b, s in zip(sn_buffers, saved):
                b.copy_(s)

    def rematerialised(fn: Callable, spectral: bool) -> Callable:
        """``fn`` under ``torch.utils.checkpoint`` when ``train.remat``.
        With ``spectral``, the SN state at entry is restored before the
        recompute, so it sees the vectors of the forward."""
        if not remat:
            return fn

        def wrapped(*args):
            saved = sn_save() if spectral else None

            def run(*a):
                if saved is not None:
                    sn_load(saved)
                return fn(*a)
            return checkpoint(run, *args, use_reentrant=False)
        return wrapped

    def gen_fwd(batch):
        return gen(batch[feature_key], batch[C.DataType.SESSION_INDEX],
                   batch[C.DataType.SPEAKING_MODE_INDEX])

    def d_loss_fn(fake, real):
        fmaps_fake, fmaps_real = disc(fake.detach(), pair=real)
        return discriminator_loss(fmaps_fake, fmaps_real)

    def g_loss_fn(fake, real, batch) -> Tuple[torch.Tensor, Dict]:
        loss = torch.zeros((), dtype=torch.float32, device=fake.device)
        aux: Dict[str, torch.Tensor] = {}
        if use_adv or use_fm:
            fmaps_fake, fmaps_real = disc(fake, pair=real)
        if use_adv:
            adv = generator_adversarial_loss(fmaps_fake)
            loss = loss + adv
            aux["loss/adversarial"] = adv
        if use_td:
            td = multi_time_domain_loss(real, fake)
            loss = loss + t.loss_multi_td_weight * td
            aux["loss/multi_td"] = td
        if use_su or use_ph:
            su_loss, ph_loss, counts = emg_encoder_loss(
                enc, fake, batch[C.DataType.SPEECH_UNITS],
                batch[C.DataType.PHONEMES])
            if use_su:
                loss = loss + t.loss_speech_unit_weight * su_loss
                aux["loss/speech_unit"] = su_loss
            if use_ph:
                loss = loss + t.loss_phoneme_weight * ph_loss
                aux["loss/phoneme"] = ph_loss
            aux.update({f"count/{k}": v for k, v in counts.items()})
        else:
            aux.update({f"count/{k}": torch.zeros((), dtype=torch.int32,
                                                  device=fake.device)
                        for k in COUNT_KEYS})
        if use_wave:
            wave = torch.mean(torch.square(fake - real))
            loss = loss + t.loss_waveform_weight * wave
            aux["loss/waveform"] = wave
        if use_fm:
            fm = feature_matching_loss(fmaps_fake, fmaps_real)
            loss = loss + t.loss_feat_match_weight * fm
            aux["loss/feature_matching"] = fm
        return loss, aux

    gen_fwd_nograd = torch.no_grad()(gen_fwd)
    gen_fwd = rematerialised(gen_fwd, spectral=False)
    d_loss_fn = rematerialised(d_loss_fn, spectral=True)
    g_loss_fn = rematerialised(g_loss_fn, spectral=True)

    def d_grads(fake, real):
        """D loss on the detached fake and its parameter gradients."""
        disc.requires_grad_(True)
        loss_d = d_loss_fn(fake, real)
        grads = torch.autograd.grad(loss_d, disc_params)
        disc.requires_grad_(False)
        return loss_d.detach(), grads

    def g_grads(fake, real, batch):
        """G losses through the frozen D and the generator gradients."""
        disc.requires_grad_(False)
        loss_g, aux = g_loss_fn(fake, real, batch)
        grads = torch.autograd.grad(loss_g, gen_params)
        return loss_g.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def ema_update(state: GANTrainState) -> None:
        if state.gen_ema is None:
            return
        d = _ema_decay(ema_decay, state.step)
        with torch.no_grad():
            torch._foreach_mul_(state.gen_ema, float(d))
            torch._foreach_add_(state.gen_ema, gen_params,
                                alpha=float(np.float32(1.0) - d))

    def train_step(state: GANTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        real = batch[C.DataType.REAL_EMG].float()
        metrics: Dict[str, torch.Tensor] = {}

        # ---- Generator forward, once; its graph serves the G update. ----
        fake = gen_fwd(batch)

        # ---- Discriminator update on the detached fake. ----
        if use_adv:
            loss_d, grads_d = d_grads(fake, real)
            fused_adamw_(state.opt_d, grads_d)
            metrics["loss/discriminator"] = loss_d

        # ---- Generator losses through the updated, frozen discriminator.
        loss_g, aux, grads_g = g_grads(fake, real, batch)
        fused_adamw_(state.opt_g, grads_g)

        metrics["loss/generator"] = loss_g
        metrics.update(aux)
        ema_update(state)
        state.step += 1
        return state, metrics

    def train_step_accum(state: GANTrainState, batch: Dict[str, torch.Tensor]
                         ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        micro = _split(batch, accum)
        metrics: Dict[str, torch.Tensor] = {}

        # ---- D phase: average grads over microbatches, update once. ----
        if use_adv:
            incoming = sn_save()
            loss_sum, grad_sum = None, None
            for mb in micro:
                sn_load(incoming)
                fake = gen_fwd_nograd(mb)
                loss_d, grads = d_grads(fake, mb[C.DataType.REAL_EMG].float())
                if grad_sum is None:
                    loss_sum, grad_sum = loss_d, list(grads)
                else:
                    loss_sum = loss_sum + loss_d
                    torch._foreach_add_(grad_sum, grads)
            torch._foreach_div_(grad_sum, float(accum))
            fused_adamw_(state.opt_d, grad_sum)
            metrics["loss/discriminator"] = loss_sum / accum

        # ---- G phase through the updated D: average grads, update once.
        incoming = sn_save()
        loss_sum, aux_sum, grad_sum = None, None, None
        for mb in micro:
            sn_load(incoming)
            fake = gen_fwd(mb)
            loss_g, aux, grads = g_grads(fake, mb[C.DataType.REAL_EMG].float(),
                                         mb)
            if grad_sum is None:
                loss_sum, aux_sum, grad_sum = loss_g, aux, list(grads)
            else:
                loss_sum = loss_sum + loss_g
                aux_sum = {k: aux_sum[k] + v for k, v in aux.items()}
                torch._foreach_add_(grad_sum, grads)
        torch._foreach_div_(grad_sum, float(accum))
        fused_adamw_(state.opt_g, grad_sum)

        metrics["loss/generator"] = loss_sum / accum
        # Loss terms are per-microbatch means -> average; counters are
        # totals -> keep the sums.
        metrics.update({k: (v if k.startswith("count/") else v / accum)
                        for k, v in aux_sum.items()})
        ema_update(state)
        state.step += 1
        return state, metrics

    return train_step if accum == 1 else train_step_accum


def make_eval_step(cfg: Config, models: GANModels) -> Callable:
    """Validation metrics for one batch (reference: ste_gan/train.py:311-341):
    waveform MSE, multi-TD error, speech-unit / phoneme losses and phoneme
    counters, as device tensors, with no parameter update. It evaluates the
    generator's current weights; wrap it in :func:`eval_generator_params` to
    score the EMA.

    ``val/envelope_l1`` is the phase-invariant waveform metric of the JAX
    package: the mean L1 between 40-point rectified-average envelopes."""
    feature_key = cfg.model.speech_feature_type
    gen, enc = models.generator, models.encoder

    def envelope(x):
        return moving_average(torch.abs(x).transpose(1, 2), 40)

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        real = batch[C.DataType.REAL_EMG].float()
        fake = gen(batch[feature_key], batch[C.DataType.SESSION_INDEX],
                   batch[C.DataType.SPEAKING_MODE_INDEX])
        su_loss, ph_loss, counts = emg_encoder_loss(
            enc, fake, batch[C.DataType.SPEECH_UNITS],
            batch[C.DataType.PHONEMES])
        out = {
            "val/waveform": torch.mean(torch.square(fake - real)),
            "val/envelope_l1": torch.mean(torch.abs(envelope(fake)
                                                    - envelope(real))),
            "val/multi_td": multi_time_domain_loss(real, fake),
            "val/speech_unit": su_loss,
            "val/phoneme": ph_loss,
        }
        out.update({f"count/{k}": v for k, v in counts.items()})
        return out

    return eval_step


def state_tree(models: GANModels, state: GANTrainState) -> Dict[str, Any]:
    """The train state as a tree of the live tensors (what a checkpoint
    holds): both networks' parameters and buffers (the spectral-norm u/v
    among them), both optimizers' moments, counts and hyperparameters, the
    EMA and the step. Restoring copies into these tensors, so the
    optimizer's tables stay valid; set ``state.step`` from the restored
    tree's ``"step"``."""

    def opt(o: AdamWState) -> Dict[str, Any]:
        return {"exp_avg": list(o.exp_avg), "exp_avg_sq": list(o.exp_avg_sq),
                "count": o.count, "hyper": o.hyper}

    tree: Dict[str, Any] = {
        "step": int(state.step),
        "generator": models.generator.state_dict(),
        "discriminator": models.discriminator.state_dict(),
        "opt_g": opt(state.opt_g),
        "opt_d": opt(state.opt_d),
    }
    if state.gen_ema is not None:
        tree["gen_ema"] = list(state.gen_ema)
    return tree


def load_trained_state(run_dir, tag: str = "best", device=None
                       ) -> Tuple[Config, GANModels, GANTrainState]:
    """Config snapshot + models + restored train state from a training run
    directory. ``tag``: ``best`` | ``latest`` | ``checkpoint-XXXXXXXX``."""
    from ste_gan_torch.train.checkpoint import CheckpointManager

    run_dir = Path(run_dir)
    cfg = load_config(config=run_dir / "config.yaml")
    models = build_models(cfg, seed=cfg.train.random_seed, device=device)
    state = init_state(cfg, models)
    ckpt = CheckpointManager(run_dir)
    if tag == "latest":
        restored = ckpt.restore_latest(state_tree(models, state))
        if restored is None:
            raise FileNotFoundError(f"no checkpoints in {run_dir}")
        tree, _ = restored
    else:
        tree, _ = ckpt.restore(tag, state_tree(models, state))
    state.step = int(tree["step"])
    return cfg, models, state


def synthetic_batch(cfg: Config, device, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """A random training batch shaped like the bench's (``bench.py``),
    made with numpy from ``seed``: tanh-squashed EMG, normal speech units,
    uniform phonemes and sessions, speaking mode 0."""
    rng = np.random.default_rng(seed)
    b, chunk = cfg.train.batch_size, cfg.train.chunk_size
    frames = chunk // C.HOPSIZE
    arrays = {
        C.DataType.REAL_EMG: np.tanh(rng.normal(
            0, 0.4, (b, chunk, cfg.data.num_emg_channels))).astype(np.float32),
        C.DataType.SPEECH_UNITS: rng.normal(
            size=(b, frames, C.SPEECH_UNITS_FEAT_SIZE)).astype(np.float32),
        C.DataType.PHONEMES: rng.integers(0, C.NUM_PHONEMES, (b, frames)),
        C.DataType.SESSION_INDEX: rng.integers(0, cfg.data.num_emg_sessions,
                                               (b,)),
        C.DataType.SPEAKING_MODE_INDEX: np.zeros((b,), np.int64),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def main_path(seed: int = 0, device=None
              ) -> Tuple[Config, GANModels, GANTrainState, Callable,
                         Dict[str, torch.Tensor]]:
    """The full-width main path that ``chip_smoke.py`` times and
    ``profile_step`` traces: ``Config()`` (the bench's configuration) with
    ``generator_ema=0.999`` as ``configs/ste_gan_base_gantts.yaml`` ships
    it, seeded random weights and the synthetic batch. Returns
    ``(cfg, models, state, train_step, batch)``."""
    cfg = Config()
    cfg.train.generator_ema = 0.999
    dev = resolve_device(device)
    models = build_models(cfg, seed=seed, device=dev)
    return (cfg, models, init_state(cfg, models), make_train_step(cfg, models),
            synthetic_batch(cfg, dev, seed=seed))
