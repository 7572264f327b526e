"""Carry the JAX package's parameter trees (nested dicts of numpy arrays)
into the port.

The state-dict layout logic is a copy of
``ste_gan_tpu/interop/torch_export.py`` (the port imports nothing of the JAX
package): weight-normed convs become ``weight_v``/``weight_g``, spectral-normed
convs ``weight_orig``/``weight_u``/``weight_v``, the encoder's BatchNorm
statistics ``running_mean``/``running_var``. The port's module paths follow
the same layout, so :func:`load_generator`, :func:`load_discriminator` and
:func:`load_encoder` load these dicts with ``strict=True``.

:func:`train_state_from_jax` carries a whole JAX train state (parameters,
spectral state, optax AdamW moments, EMA, step) into the port's models and
state, in place.

Spectral ``v``: the exported state dict recomputes ``v = normalize(Wᵀu)``,
as the JAX exporter does. :func:`load_discriminator` instead carries the JAX
state's own ``v``, permuted from JAX's ``(*k, in)`` flatten order to the
torch weight's ``(in, *k)`` order, so an eval forward matches JAX exactly.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ste_gan_torch.models.discriminator import PRIME_PERIODS
from ste_gan_torch.models.generator import gblock_spec


def _t_conv(w) -> np.ndarray:
    """JAX ``[*k, in, out]`` -> torch ``[out, in, *k]``."""
    w = np.asarray(w, np.float32)
    return np.moveaxis(w, (-1, -2), (0, 1)).copy()


def _wn(sd: Dict, prefix: str, p: Dict) -> None:
    v = _t_conv(p["v"])
    sd[f"{prefix}.weight_v"] = v
    sd[f"{prefix}.weight_g"] = np.asarray(p["g"], np.float32).reshape(
        (-1,) + (1,) * (v.ndim - 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)


def _sn(sd: Dict, prefix: str, p: Dict, s: Dict, carry_v: bool) -> None:
    w = _t_conv(p["kernel"])
    sd[f"{prefix}.weight_orig"] = w
    u = np.asarray(s["u"], np.float32)
    if carry_v:
        kshape = np.asarray(p["kernel"]).shape[:-1]  # (*k, in)
        v = np.moveaxis(np.asarray(s["v"], np.float32).reshape(kshape),
                        -1, 0).reshape(-1)
    else:
        v = w.reshape(w.shape[0], -1).T @ u
        v /= (np.linalg.norm(v) + 1e-12)
    sd[f"{prefix}.weight_u"] = u
    sd[f"{prefix}.weight_v"] = v.astype(np.float32)
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)


def _plain_conv(sd: Dict, prefix: str, p: Dict) -> None:
    sd[f"{prefix}.weight"] = _t_conv(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)


def _linear(sd: Dict, prefix: str, p: Dict) -> None:
    sd[f"{prefix}.weight"] = np.ascontiguousarray(
        np.asarray(p["kernel"], np.float32).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)


def _batch_norm(sd: Dict, prefix: str, p: Dict, stats: Dict) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["scale"], np.float32)
    sd[f"{prefix}.bias"] = np.asarray(p["bias"], np.float32)
    sd[f"{prefix}.running_mean"] = np.asarray(stats["mean"], np.float32)
    sd[f"{prefix}.running_var"] = np.asarray(stats["var"], np.float32)
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def generator_params_to_state_dict(params: Mapping, speech_feature_type: str
                                   ) -> Dict[str, np.ndarray]:
    """JAX generator params -> reference-layout state dict."""
    sd: Dict[str, np.ndarray] = {}
    if "session_embeddings" in params:
        sd["session_embeddings.weight"] = np.asarray(
            params["session_embeddings"]["embedding"], np.float32)
    if "speaking_mode_embeddings" in params:
        sd["speaking_mode_embeddings.weight"] = np.asarray(
            params["speaking_mode_embeddings"]["embedding"], np.float32)
    _wn(sd, "gblocks.0", params["input_conv"])
    for i, (_, up) in enumerate(gblock_spec(speech_feature_type)):
        p = params[f"gblock_{i}"]
        prefix = f"gblocks.{i + 1}"
        off = 1 if up > 1 else 0  # the optional nn.Upsample shifts indices
        _wn(sd, f"{prefix}.conv1.{1 + off}", p["conv1_a"])
        _wn(sd, f"{prefix}.conv1.{3 + off}", p["conv1_b"])
        _wn(sd, f"{prefix}.res1.{off}", p["res1"])
        _wn(sd, f"{prefix}.conv2.1", p["conv2_a"])
        _wn(sd, f"{prefix}.conv2.3", p["conv2_b"])
    _wn(sd, "last_conv.1", params["out_conv"])
    return sd


def discriminator_params_to_state_dict(params: Mapping, spectral: Mapping,
                                       carry_v: bool = False
                                       ) -> Dict[str, np.ndarray]:
    """JAX ensemble (params, spectral) -> reference-layout state dict.
    ``carry_v`` keeps JAX's stored ``v`` (permuted) instead of recomputing
    it from ``u``."""
    sd: Dict[str, np.ndarray] = {}

    def emit(sub_params, sub_spectral, prefix):
        for name, p in sub_params.items():
            conv_prefix = (f"{prefix}.output" if name == "output"
                           else f"{prefix}.layers.{name.split('_')[1]}")
            if name in sub_spectral:
                _sn(sd, conv_prefix, p, sub_spectral[name], carry_v)
            else:
                _wn(sd, conv_prefix, p)

    for name, sub in params.items():
        kind, idx = name.rsplit("_", 1)
        if kind == "period":
            i = PRIME_PERIODS.index(int(idx))
            emit(sub, spectral.get(name, {}), f"multi_pooled_disc.{i}")
        elif kind == "scale":
            emit(sub, spectral.get(name, {}), f"multi_scale_disc.{int(idx)}")
        else:
            raise ValueError(f"unexpected discriminator entry: {name}")
    return sd


def encoder_variables_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """JAX encoder {"params", "batch_stats"} -> reference-layout state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        if name.startswith("res_block_"):
            prefix = f"conv_blocks.{int(name.split('_')[-1])}"
            s = stats.get(name, {})
            _plain_conv(sd, f"{prefix}.conv1", p["conv1"])
            _plain_conv(sd, f"{prefix}.conv2", p["conv2"])
            _batch_norm(sd, f"{prefix}.bn1", p["bn1"], s["bn1"])
            _batch_norm(sd, f"{prefix}.bn2", p["bn2"], s["bn2"])
            if "residual" in p:
                _plain_conv(sd, f"{prefix}.residual_path", p["residual"])
                _batch_norm(sd, f"{prefix}.res_norm", p["res_norm"],
                            s["res_norm"])
        elif name.startswith("transformer_"):
            prefix = f"transformer.layers.{int(name.split('_')[-1])}"
            attn = p["self_attn"]
            for w in ("w_q", "w_k", "w_v", "w_o"):
                sd[f"{prefix}.self_attn.{w}"] = np.asarray(attn[w], np.float32)
            if "relative_positional" in attn:
                sd[f"{prefix}.self_attn.relative_positional.embeddings"] = (
                    np.asarray(attn["relative_positional"]["embeddings"],
                               np.float32)[..., None])
            _linear(sd, f"{prefix}.linear1", p["linear1"])
            _linear(sd, f"{prefix}.linear2", p["linear2"])
            for norm in ("norm1", "norm2"):
                sd[f"{prefix}.{norm}.weight"] = np.asarray(
                    p[norm]["scale"], np.float32)
                sd[f"{prefix}.{norm}.bias"] = np.asarray(
                    p[norm]["bias"], np.float32)
        elif name in ("w_raw_in", "w_out", "w_aux"):
            _linear(sd, name, p)
        else:
            raise ValueError(f"unexpected encoder entry: {name}")
    return sd


def to_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def load_generator(model: torch.nn.Module, params: Mapping,
                   speech_feature_type: str) -> None:
    model.load_state_dict(to_torch(generator_params_to_state_dict(
        params, speech_feature_type)), strict=True)


def load_discriminator(model: torch.nn.Module, params: Mapping,
                       spectral: Mapping) -> None:
    model.load_state_dict(to_torch(discriminator_params_to_state_dict(
        params, spectral, carry_v=True)), strict=True)


def load_encoder(model: torch.nn.Module, variables: Mapping) -> None:
    model.load_state_dict(to_torch(encoder_variables_to_state_dict(variables)),
                          strict=True)


def _adam_inner(opt_state):
    """(mu, nu, count, learning rate) of optax's
    ``inject_hyperparams(adamw)`` state (moments in ``inner_state[0]``)."""
    inner = opt_state.inner_state[0]
    return (inner.mu, inner.nu, int(np.asarray(inner.count)),
            float(np.asarray(opt_state.hyperparams["learning_rate"])))


def _copy_by_name(tensors, names, sd: Mapping) -> None:
    with torch.no_grad():
        for t, name in zip(tensors, names):
            t.copy_(torch.tensor(np.asarray(sd[name])).reshape(t.shape))


def train_state_from_jax(jstate, models, state) -> None:
    """Carry a JAX ``GANTrainState`` into the port's models and state, in
    place: generator and discriminator parameters, the spectral-norm u/v,
    both AdamW states (moments, count, learning rate), the EMA and the
    step."""
    sft = models.generator.speech_feature_type
    load_generator(models.generator, jstate.gen_params, sft)
    load_discriminator(models.discriminator, jstate.disc_params,
                       jstate.disc_spectral)
    gen_names = [n for n, _ in models.generator.named_parameters()]
    disc_names = [n for n, _ in models.discriminator.named_parameters()]
    for opt, jopt, names, to_sd in (
            (state.opt_g, jstate.opt_g, gen_names,
             lambda tree: generator_params_to_state_dict(tree, sft)),
            (state.opt_d, jstate.opt_d, disc_names,
             lambda tree: discriminator_params_to_state_dict(
                 tree, jstate.disc_spectral))):
        mu, nu, count, lr = _adam_inner(jopt)
        _copy_by_name(opt.exp_avg, names, to_sd(mu))
        _copy_by_name(opt.exp_avg_sq, names, to_sd(nu))
        opt.count.fill_(count)
        opt.hyper[0].fill_(lr)
    if (jstate.gen_ema is None) != (state.gen_ema is None):
        raise ValueError("the JAX state and the port's state disagree on "
                         "train.generator_ema")
    if state.gen_ema is not None:
        _copy_by_name(state.gen_ema, gen_names,
                      generator_params_to_state_dict(jstate.gen_ema, sft))
    state.step = int(np.asarray(jstate.step))


def spectral_to_jax(model: torch.nn.Module) -> Dict[str, Dict]:
    """The port discriminator's power-iteration state in the JAX layout:
    ``{"scale_i": {"layer_j": {"u", "v"}}}`` with ``v`` in JAX's order."""
    out: Dict[str, Dict] = {}
    for i, disc in enumerate(model.multi_scale_disc):
        for j, layer in enumerate(disc.layers):
            if not hasattr(layer, "weight_u"):
                continue
            w = layer.weight_orig
            v = layer.weight_v.detach().cpu().numpy().reshape(w.shape[1:])
            out.setdefault(f"scale_{i}", {})[f"layer_{j}"] = {
                "u": layer.weight_u.detach().cpu().numpy(),
                "v": np.moveaxis(v, 0, -1).reshape(-1),
            }
    return out
