"""Weight-only int8 quantisation for deployment artifacts.

Counterpart of ``ste_gan_tpu/quant.py``, on the reference-layout state dicts
that the port's modules load:

* **Weight norm is folded first.** A ``weight_v``/``weight_g`` pair becomes
  the effective kernel ``w = v * g / ||v||`` (``ops/conv.py`` ``WNConv``),
  quantised per output channel and stored as ``<prefix>.weight_v__q`` and
  ``<prefix>.weight_v__scale``; ``weight_g`` disappears. Dequantisation hands
  back ``weight_v = w'`` and ``weight_g = ||w'||``, which reproduces ``w'``
  through the unmodified module.
* **Symmetric per-channel scales**: ``scale = max|w| / 127`` (1 where a
  channel is all zero), ``q = clip(round(w / scale), -127, 127)`` with
  round half to even. Embedding tables (``*embeddings.weight``) are
  quantised per row. Biases stay f32.
* **The encoder rule** (``generic=True``) quantises the plain weights. The
  JAX package takes the trailing axis of its own layouts; the port's tensors
  are laid out differently, so each channel axis is mapped: conv ``weight``
  ``[out, in, k]`` and ``nn.Linear.weight`` ``[out, in]`` on axis 0,
  ``w_q``/``w_k``/``w_v`` ``[H, D, Dh]`` and ``w_o`` ``[H, Dh, D]`` on axis
  2, the relative-position ``embeddings`` ``[H, 2d-1, Dh, 1]`` on axis 2
  (not on the trailing singleton). BatchNorm and LayerNorm tensors pass
  through in f32. A quantised entry ``k`` is stored as ``k__q`` and
  ``k__scale``.

:func:`export_generator_quantized` and :func:`export_emg_encoder_quantized`
export programs that hold the int8 tensors and their scales, and
dequantise inside the program; the artifact holds no f32 copy of the
weights. XLA constant-folds the JAX package's dequantisation at compile
time; an eager ``ExportedProgram`` runs it on every call.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from ste_gan_torch.ops.conv import norm_per_out_channel

Q_SUFFIX = "__q"
SCALE_SUFFIX = "__scale"

#: Encoder-rule leaf names and the channel axis of their port layout.
_GENERIC_AXES = {"w_q": 2, "w_k": 2, "w_v": 2, "w_o": 2, "embeddings": 2}


def quantize_tensor(w: torch.Tensor, channel_axis: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8: ``(q int8, scale f32)``, ``scale`` shaped
    to broadcast against ``w`` along ``channel_axis``; ``w ~ q * scale``."""
    w = w.float()
    reduce = tuple(a for a in range(w.dim()) if a != channel_axis % w.dim())
    amax = w.abs().amax(dim=reduce, keepdim=True)
    # A tensor divisor: CUDA divides by a host scalar as a product with its
    # reciprocal, which can move a scale by one ulp and flip a rounding
    # tie, so the card would quantise otherwise than the CPU and JAX.
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _per_channel_shape(w: torch.Tensor):
    return (-1,) + (1,) * (w.dim() - 1)


def _channel_axis(key: str, value: torch.Tensor, generic: bool
                  ) -> Optional[int]:
    """The channel axis along which ``key`` is quantised, or None when it
    passes through in f32."""
    if not value.is_floating_point() or value.dim() < 2:
        return None
    if key.endswith("embeddings.weight"):
        return 0
    if not generic:
        return None
    name = key.rsplit(".", 1)[-1]
    if name in _GENERIC_AXES:
        return _GENERIC_AXES[name]
    return 0 if name == "weight" else None


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor],
                        generic: bool = False) -> Dict[str, torch.Tensor]:
    """Reference-layout state dict -> quantised dict (module docstring).
    Weight-normed pairs are always folded; ``generic=True`` also quantises
    the encoder's plain weights. Round-trips through
    :func:`dequantize_state_dict`."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if key.endswith(".weight_g") and key[:-1] + "v" in state_dict:
            continue  # folded into its weight_v
        if key.endswith(".weight_v") and key[:-1] + "g" in state_dict:
            v = value.float()
            g = state_dict[key[:-1] + "g"].float().reshape(-1)
            w = v * (g / norm_per_out_channel(v)).view(_per_channel_shape(v))
            q, scale = quantize_tensor(w, 0)
            out[key + Q_SUFFIX], out[key + SCALE_SUFFIX] = q, scale
            continue
        axis = _channel_axis(key, value, generic)
        if axis is None:
            out[key] = value
        else:
            out[key + Q_SUFFIX], out[key + SCALE_SUFFIX] = quantize_tensor(
                value, axis)
    return out


def dequantize_state_dict(qstate: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """Quantised dict -> reference-layout state dict that the unmodified
    modules load (``weight_g = ||weight_v||`` for folded pairs)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in qstate.items():
        if key.endswith(SCALE_SUFFIX):
            continue
        if not key.endswith(Q_SUFFIX):
            out[key] = value
            continue
        base = key[: -len(Q_SUFFIX)]
        w = dequantize_tensor(value, qstate[base + SCALE_SUFFIX])
        out[base] = w
        if base.endswith(".weight_v"):
            out[base[:-1] + "g"] = norm_per_out_channel(w).view(
                _per_channel_shape(w))
    return out


def quantized_param_bytes(state_dict: Mapping[str, torch.Tensor]) -> int:
    """Total bytes of a (possibly quantised) state dict."""
    return int(sum(t.numel() * t.element_size()
                   for t in state_dict.values()))


def export_generator_quantized(generator, feature_dim: int,
                               serving: bool = False):
    """Like :func:`ste_gan_torch.export.export_generator`, but the program
    holds the generator's weights as int8 tensors and f32 scales
    (:func:`quantize_state_dict`) and dequantises them on every call."""
    from ste_gan_torch.export import export_generator

    return export_generator(generator, feature_dim, serving=serving,
                            quantized=quantize_state_dict(
                                generator.state_dict()))


def export_emg_encoder_quantized(encoder, num_emg_channels: int):
    """int8 variant of :func:`ste_gan_torch.export.export_emg_encoder`:
    conv and linear weights, attention projections and relative-position
    tables as per-channel int8 (the encoder rule); BatchNorm statistics and
    affines and LayerNorms stay f32. Same signature and minimum length;
    an MoE or sparse-block (LFM2, DeepSeek-V3) encoder raises, as in the
    unquantised export."""
    from ste_gan_torch.export import check_exportable_encoder, export_emg_encoder

    check_exportable_encoder(encoder)
    return export_emg_encoder(encoder, num_emg_channels,
                              quantized=quantize_state_dict(
                                  encoder.state_dict(), generic=True))
