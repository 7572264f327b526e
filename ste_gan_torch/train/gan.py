"""The fused adversarial train step (counterpart of
``ste_gan_tpu/train/gan.py``, without gradient accumulation, remat or the
eval step).

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

Precision: f32 parameters and optimizer state; modules compute in bf16 when
``train.mixed_precision``; losses reduce in f32. Parameters, moments and the
EMA update in place.

On the card the grouped convs and both AdamW updates run the hand-written
kernels (``ops/grouped_conv.py``, ``ops/fused_adamw.py``) whatever
``grouped_conv_impl``/``fused_optimizer`` say.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ste_gan_torch import constants as C
from ste_gan_torch.config import Config, train_setting
from ste_gan_torch.device import resolve_device
from ste_gan_torch.losses.encoder_loss import emg_encoder_loss
from ste_gan_torch.losses.gan_loss import (
    discriminator_loss, feature_matching_loss, generator_adversarial_loss)
from ste_gan_torch.losses.td_loss import multi_time_domain_loss
from ste_gan_torch.models.discriminator import init_emg_discriminators
from ste_gan_torch.models.emg_encoder import init_emg_encoder
from ste_gan_torch.models.generator import init_emg_generator
from ste_gan_torch.ops.fused_adamw import (
    AdamWState, adamw_init, fused_adamw_, set_learning_rate)

__all__ = ["GANModels", "GANTrainState", "build_models", "init_state",
           "make_optimizer", "set_learning_rate", "epoch_lr",
           "make_train_step", "synthetic_batch", "main_path"]


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
    network (``ops/fused_adamw.py``)."""
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


def _ema_decay(decay: float, step: int) -> np.float32:
    """``min(decay, (1+t)/(10+t))`` in f32, as the JAX step computes it."""
    t = np.float32(step)
    return np.minimum(np.float32(decay),
                      (np.float32(1.0) + t) / (np.float32(10.0) + t))


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
    gen, disc, enc = models.generator, models.discriminator, models.encoder
    gen_params = list(gen.parameters())
    disc_params = list(disc.parameters())

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
                        for k in ("num_phones", "num_correct", "num_silence",
                                  "num_correct_no_silence")})
        if use_wave:
            wave = torch.mean(torch.square(fake - real))
            loss = loss + t.loss_waveform_weight * wave
            aux["loss/waveform"] = wave
        if use_fm:
            fm = feature_matching_loss(fmaps_fake, fmaps_real)
            loss = loss + t.loss_feat_match_weight * fm
            aux["loss/feature_matching"] = fm
        return loss, aux

    def train_step(state: GANTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        real = batch[C.DataType.REAL_EMG].float()
        metrics: Dict[str, torch.Tensor] = {}

        # ---- Generator forward, once; its graph serves the G update. ----
        fake = gen(batch[feature_key], batch[C.DataType.SESSION_INDEX],
                   batch[C.DataType.SPEAKING_MODE_INDEX])

        # ---- Discriminator update on the detached fake. ----
        if use_adv:
            disc.requires_grad_(True)
            fmaps_fake, fmaps_real = disc(fake.detach(), pair=real)
            loss_d = discriminator_loss(fmaps_fake, fmaps_real)
            grads_d = torch.autograd.grad(loss_d, disc_params)
            fused_adamw_(state.opt_d, grads_d)
            metrics["loss/discriminator"] = loss_d.detach()

        # ---- Generator losses through the updated, frozen discriminator.
        disc.requires_grad_(False)
        loss_g, aux = g_loss_fn(fake, real, batch)
        grads_g = torch.autograd.grad(loss_g, gen_params)
        fused_adamw_(state.opt_g, grads_g)

        metrics["loss/generator"] = loss_g.detach()
        metrics.update({k: v.detach() for k, v in aux.items()})
        if state.gen_ema is not None:
            d = _ema_decay(ema_decay, state.step)
            with torch.no_grad():
                torch._foreach_mul_(state.gen_ema, float(d))
                torch._foreach_add_(state.gen_ema, gen_params,
                                    alpha=float(np.float32(1.0) - d))
        state.step += 1
        return state, metrics

    return train_step


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
