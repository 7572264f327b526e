"""Deployment artifacts: ``torch.export`` programs of the trained generator
and EMG encoder.

Counterpart of ``ste_gan_tpu/export.py``, with ``torch.export`` in place of
StableHLO. :func:`export_generator` traces the generator with its weights
into an ``ExportedProgram`` with a symbolic batch ``b`` and length ``t``;
:func:`save_exported` writes it as a ``.pt2`` file (``torch.export.save``)
with a ``<path>.meta.json`` beside it, and the file loads and runs with
``torch`` alone (no ``ste_gan_torch``, no config, no checkpoint):

    program = torch.export.load(path).module()
    emg = program(speech_features, session_ids)   # any (b, t)

Signatures: the minimal ``(feats [b, t, D] f32, session [b] int64)`` and
the serving ``(feats, session, speaking_mode [b], num_valid_frames [b])``,
whose per-row valid-length masks make padded rows exact (the micro-batcher's
contract, ``EMGSynthesizer.synthesize_padded``). The encoder's is
``emg [b, 16*t, C] f32 -> (units [b, t, 256], phoneme logits [b, t, 48])``
with ``t >= relative_positional_distance + 1``, the windowed regime of the
relative-position attention (the JAX package's ``t >= D+1`` constraint).
Index inputs are int64.

**Device.** A JAX export is multi-platform; an ``ExportedProgram`` is
specialised to the device it was traced on (``valid_mask`` bakes the
input's device into its ``arange``). The meta file records the program's
device, and :func:`load_exported` moves the program to the requested device
(``cuda`` unless the caller asks otherwise) with
``torch.export.passes.move_to_device_pass``. A program that cannot be moved
raises: it never carries on on the CPU, and never falls back to the
in-framework modules.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch.export import Dim

from ste_gan_torch import constants as C
from ste_gan_torch.device import resolve_device
from ste_gan_torch.quant import dequantize_state_dict

#: Example shapes the programs are traced at (neither 0 nor 1, which
#: torch.export would specialise).
_EXAMPLE_BATCH, _EXAMPLE_FRAMES = 2, 20


def speech_feature_dim(cfg) -> int:
    """Generator input width from the run config (256 soft speech units at
    50 Hz, or 25 MFCCs at 100 Hz); raises on unknown feature types."""
    return cfg.speech_input_dim


def encoder_min_frames(encoder) -> int:
    """The least frame count an encoder artifact takes: the relative-position
    distance + 1 (the windowed attention regime)."""
    attn = encoder.transformer.layers[0].self_attn
    return int(attn.relative_positional.max_distance) + 1


class _Program(torch.nn.Module):
    """A model's forward under one exported signature.

    Without ``quantized`` the model is a submodule, so its f32 tensors
    become the program's state. With it, the quantised state dict is held
    as buffers, dequantised inside the forward and bound by
    ``torch.func.functional_call`` to a weightless copy of the model on the
    meta device, kept out of the module tree: the program owns no f32 copy
    of the weights."""

    def __init__(self, model: torch.nn.Module,
                 quantized: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__()
        self._keys = None
        if quantized is None:
            self.model = model
            return
        self._skeleton = (copy.deepcopy(model).to("meta"),)
        self._keys = list(quantized)
        for i, tensor in enumerate(quantized.values()):
            self.register_buffer(f"w{i}", tensor)

    def run(self, *args, **kwargs):
        if self._keys is None:
            return self.model(*args, **kwargs)
        weights = dequantize_state_dict(
            {key: getattr(self, f"w{i}") for i, key in enumerate(self._keys)})
        return torch.func.functional_call(self._skeleton[0], weights, args,
                                          kwargs)


class _MinimalGenerator(_Program):
    def forward(self, speech_features, session_ids):
        return self.run(speech_features, session_ids)


class _ServingGenerator(_Program):
    def forward(self, speech_features, session_ids, speaking_mode_ids,
                num_valid_frames):
        return self.run(speech_features, session_ids, speaking_mode_ids,
                        num_valid_frames=num_valid_frames)


class _Encoder(_Program):
    def forward(self, emg):
        return self.run(emg)


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def export_generator(generator, feature_dim: int, serving: bool = False,
                     quantized: Optional[Mapping[str, torch.Tensor]] = None):
    """Export ``generator`` (which holds the weights; eval mode) on the
    device it lives on.

    Args:
      generator: the port's ``EMGGeneratorGanTTS``; its compute dtype is
        traced into the program.
      feature_dim: speech-feature width (:func:`speech_feature_dim`).
      serving: the micro-batching signature ``(feats, session,
        speaking_mode, num_valid_frames)`` with per-row valid-length masks;
        otherwise the minimal ``(feats, session)``.
      quantized: a :func:`ste_gan_torch.quant.quantize_state_dict` of the
        generator's weights, held by the program in place of its f32
        tensors (``quant.export_generator_quantized``).

    Returns an ``ExportedProgram`` giving ``[b, upsample*t, channels]``.
    """
    generator = generator.eval()
    dev = _device_of(generator)
    b, t = Dim("b"), Dim("t")
    feats = torch.zeros((_EXAMPLE_BATCH, _EXAMPLE_FRAMES, feature_dim),
                        device=dev)
    ids = torch.zeros((_EXAMPLE_BATCH,), dtype=torch.long, device=dev)
    if serving:
        program = _ServingGenerator(generator, quantized)
        valid = torch.tensor([_EXAMPLE_FRAMES, _EXAMPLE_FRAMES // 2],
                             device=dev)
        args = (feats, ids, ids.clone(), valid)
        shapes = ({0: b, 1: t}, {0: b}, {0: b}, {0: b})
    else:
        program = _MinimalGenerator(generator, quantized)
        args = (feats, ids)
        shapes = ({0: b, 1: t}, {0: b})
    with torch.no_grad():
        return torch.export.export(program, args, dynamic_shapes=shapes)


def check_exportable_encoder(encoder) -> None:
    """Raise for an encoder the export does not take.

    * A ``SparseBlockEncoder`` (``EMGEncoderLFM2``, LFM2's block stack;
      ``EMGEncoderDeepseekV3``, DeepSeek-V3's): the artifact's signature
      and minimum length are those of the relative-position transformer
      (the windowed attention regime), which it does not have, and its
      dropless routing's grouped products have not been traced with a
      symbolic token count; the JAX package has no such encoder.
    * A mixture-of-experts encoder: its expert capacity ``ceil(
      capacity_factor * k * S / E)`` is a function of the token count
      ``S``, which an export with a symbolic batch and length leaves
      symbolic; the JAX package's ``export_emg_encoder`` and
      ``quant.export_emg_encoder_quantized`` fail on it too (a
      concretisation error), so neither package exports one."""
    from ste_gan_torch.models.emg_encoder import SparseBlockEncoder

    if isinstance(encoder, SparseBlockEncoder):
        raise NotImplementedError(
            f"a sparse-block encoder ({type(encoder).__name__}) cannot be "
            "exported: the export is written for the relative-position "
            "transformer encoder, and the stack's dropless expert routing "
            "is not traced with a symbolic token count")
    if getattr(encoder, "moe_experts", 0):
        raise NotImplementedError(
            "a mixture-of-experts encoder cannot be exported: its expert "
            "capacity depends on the symbolic number of tokens (the JAX "
            "package's export refuses it as well)")


def export_emg_encoder(encoder, num_emg_channels: int,
                       quantized: Optional[Mapping[str, torch.Tensor]] = None):
    """Export the EMG encoder (eval mode: running statistics, no dropout),
    the silent-speech decoding direction, on the device it lives on.

    Signature ``emg [b, 16*t, C] f32 -> (units [b, t, 256], phoneme_logits
    [b, t, 48])`` with ``t >= min_frames`` (:func:`encoder_min_frames`);
    pad shorter inputs up to the minimum. ``quantized`` as in
    :func:`export_generator`.

    The trace runs on the CPU and the program is then moved to the
    encoder's device: on a card, ATen's batch norm picks cuDNN only for
    batches of at most 65,535 rows, so a trace there pins the batch to a
    range (one that excluded a batch of 1 on the H100)."""
    from torch.export.passes import move_to_device_pass

    check_exportable_encoder(encoder)
    dev = _device_of(encoder)
    cpu = torch.device("cpu")
    if dev != cpu:
        encoder = copy.deepcopy(encoder).to(cpu)
        if quantized is not None:
            quantized = {k: v.to(cpu) for k, v in quantized.items()}
    encoder = encoder.eval()
    min_frames = encoder_min_frames(encoder)
    t = Dim("t", min=min_frames)
    emg = torch.zeros((_EXAMPLE_BATCH, C.HOPSIZE * (min_frames + 3),
                       num_emg_channels))
    with torch.no_grad():
        exported = torch.export.export(
            _Encoder(encoder, quantized), (emg,),
            dynamic_shapes=({0: Dim("b"), 1: C.HOPSIZE * t},))
    return exported if dev == cpu else move_to_device_pass(exported,
                                                            str(dev))


def _meta_path(path: Path) -> Path:
    return Path(str(path) + ".meta.json")


def _program_devices(exported) -> set:
    tensors = list(exported.state_dict.values()) + [
        v for v in exported.constants.values() if isinstance(v, torch.Tensor)]
    return {str(v.device) for v in tensors}


def save_exported(exported, path: Path, meta: Optional[Dict] = None) -> int:
    """Write ``exported`` to ``path`` (``torch.export.save``) and
    ``<path>.meta.json``: ``meta`` (the geometry a deployment needs to size
    its buffers) plus the trace ``device``. Returns the artifact's bytes."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    devices = _program_devices(exported)
    if len(devices) != 1:
        raise ValueError(f"the program's tensors lie on {sorted(devices)}; "
                         "export on one device")
    torch.export.save(exported, str(path))
    _meta_path(path).write_text(json.dumps(
        dict(meta or {}, device=devices.pop()), indent=1))
    return path.stat().st_size


def generator_meta(generator, feature_dim: int, serving: bool) -> Dict:
    """Geometry sidecar for :func:`save_exported`."""
    return {
        "feature_dim": int(feature_dim),
        "upsample": generator.upsample_factor,
        "num_emg_channels": generator.num_emg_channels,
        # The index ranges a server checks before a request reaches the
        # embedding tables (None: no table, the index is ignored).
        "num_sessions": generator.num_sessions,
        "num_speaking_modes": generator.num_speaking_modes,
        "serving": bool(serving),
    }


def read_meta(path: Path) -> Dict:
    """The meta file beside an artifact; raises when it is missing."""
    meta_path = _meta_path(path)
    if not meta_path.exists():
        raise FileNotFoundError(
            f"{meta_path} is missing: re-export with python -m "
            "ste_gan_torch.export_generator or export_emg_encoder (they "
            "write it)")
    return json.loads(meta_path.read_text())


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def load_exported(path: Path, device=None):
    """Load an artifact of :func:`save_exported` onto ``device`` (``cuda``
    unless the caller asks for another one; raises without a card). A
    program traced on another device is moved with ``move_to_device_pass``;
    if the move fails, or leaves a tensor elsewhere, this raises."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    traced = read_meta(path)["device"]
    exported = torch.export.load(str(path))
    if not _same_device(traced, dev):
        exported = move_to_device_pass(exported, str(dev))
        left = [d for d in _program_devices(exported)
                if not _same_device(d, dev)]
        if left:
            raise RuntimeError(f"{path}: moving the program to {dev} left "
                               f"tensors on {sorted(left)}")
    return exported


def _as_tensor(values, device: torch.device, dtype) -> torch.Tensor:
    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(np.asarray(values))
    return values.to(device, dtype)


class ExportedSynthesizer:
    """Synthesizer backed by a *serving* artifact: the micro-batching
    server (:mod:`ste_gan_torch.serve`) runs from the artifact and its
    vocabulary JSONs alone, with no checkpoint, module or config.

    Implements the part of :class:`ste_gan_torch.infer.EMGSynthesizer` that
    the :class:`~ste_gan_torch.serve.SynthesisService` needs
    (``synthesize_padded``, ``upsample``, ``generator.speech_input_dim``,
    ``num_emg_channels``, ``num_sessions``, ``num_speaking_modes``). The
    program does not check its indices: one out of range trips a
    device-side assert, so callers check them against the meta file's
    ranges (the service does). Streaming needs the in-framework
    generator's windowing, so :meth:`synthesize_streaming` raises
    ``NotImplementedError`` (HTTP 501)."""

    def __init__(self, path: Path, device=None):
        path = Path(path)
        meta = read_meta(path)
        if not meta.get("serving"):
            raise ValueError(
                f"{path} is a minimal (feats, session) export; serving "
                "needs the per-row valid-mask signature: re-export with "
                "--serving")
        self.device = resolve_device(device)
        self._program = load_exported(path, self.device).module()
        self.upsample = int(meta["upsample"])
        self.generator = SimpleNamespace(
            speech_input_dim=int(meta["feature_dim"]),
            num_emg_channels=int(meta["num_emg_channels"]),
            num_sessions=meta["num_sessions"],
            num_speaking_modes=meta["num_speaking_modes"])

    def synthesize_padded(self, feats, session_idx, mode_idx,
                          num_valid) -> torch.Tensor:
        """Same contract as ``EMGSynthesizer.synthesize_padded``: ``[B,
        Tpad, D]`` + valid ``[B]`` -> ``[B, upsample*Tpad, C]`` on the
        device, row ``b`` exact up to ``upsample*valid[b]``."""
        idx = [_as_tensor(v, self.device, torch.long)
               for v in (session_idx, mode_idx, num_valid)]
        with torch.no_grad():
            return self._program(_as_tensor(feats, self.device,
                                            torch.float32), *idx)

    def synthesize_streaming(self, *args, **kwargs):
        raise NotImplementedError(
            "streaming synthesis needs the in-framework generator "
            "(receptive-field windowing); serve from --run_dir for the "
            "streaming endpoint")
