"""Export a trained EMG encoder as a self-contained ``torch.export``
artifact.

    python -m ste_gan_torch.export_emg_encoder \\
        --ckpt <enc_run>/best_val_loss_model.pt \\
        [--config <enc_run>/config.yaml] [--quantize int8] \\
        [--out <path>.pt2] [--verify] [--device cpu]

Counterpart of ``scripts/export_emg_encoder.py``. The encoder is the
silent-speech decoding direction (EMG -> soft speech units + phoneme
logits). Reads the encoder trainer's reference-layout ``.pt`` and the run's
``config.yaml`` (the architecture), traces the encoder in eval mode on the
device (``cuda`` unless ``--device`` says otherwise) with a symbolic batch
and length (a multiple of 16 samples, at least ``16 * min_frames``), and
writes ``<ckpt stem>[-int8].pt2`` beside the checkpoint with a
``.meta.json`` holding ``min_frames`` and the channel count. ``--verify``
holds one call to the in-framework encoder within 1e-4 (cuDNN's TF32 off);
an int8 artifact is held to the encoder with its dequantised weights, and
that encoder's deviation from the f32 one (units, phoneme argmax agreement)
is printed.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

TOL = 1e-4


def main(argv=None) -> Dict:
    from ste_gan_torch import constants as C
    from ste_gan_torch.config import load_config
    from ste_gan_torch.device import resolve_device
    from ste_gan_torch.export import (check_exportable_encoder,
                                      encoder_min_frames, export_emg_encoder,
                                      load_exported, save_exported)
    from ste_gan_torch.export_generator import tf32_off
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.quant import (dequantize_state_dict,
                                     export_emg_encoder_quantized,
                                     quantize_state_dict)

    parser = argparse.ArgumentParser(
        prog="python -m ste_gan_torch.export_emg_encoder",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--ckpt", type=Path, required=True,
                        help="the encoder trainer's reference-layout state "
                             "dict (<enc_run>/best_val_loss_model.pt)")
    parser.add_argument("--config", type=Path, default=None,
                        help="config.yaml with the emg_encoder params "
                             "(default: next to the checkpoint)")
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="device to trace and verify on (default cuda)")
    parser.add_argument("--quantize", type=str, default="none",
                        choices=("none", "int8"),
                        help="int8: per-channel weight-only quantisation of "
                             "the conv and linear weights, attention "
                             "projections and relative-position tables "
                             "(ste_gan_torch/quant.py)")
    parser.add_argument("--verify", action="store_true")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = load_config(config=args.config or args.ckpt.parent / "config.yaml")
    channels = cfg.data.num_emg_channels
    weights = torch.load(args.ckpt, map_location="cpu", weights_only=True)

    def encoder_with(state_dict):
        model = init_emg_encoder(cfg, torch.float32)
        model.load_state_dict(state_dict, strict=True)
        return model.to(dev).eval()

    encoder = encoder_with(weights)
    check_exportable_encoder(encoder)
    min_frames = encoder_min_frames(encoder)
    start = time.perf_counter()
    if args.quantize == "int8":
        exported = export_emg_encoder_quantized(encoder, channels)
    else:
        exported = export_emg_encoder(encoder, channels)
    export_s = time.perf_counter() - start
    suffix = "" if args.quantize == "none" else f"-{args.quantize}"
    out = Path(args.out or args.ckpt.with_name(
        f"{args.ckpt.stem}{suffix}.pt2"))
    meta = {"kind": "emg_encoder", "num_emg_channels": channels,
            "min_frames": min_frames, "quantize": args.quantize}
    n_bytes = save_exported(exported, out, meta=meta)
    print(f"wrote {out} ({n_bytes / 1e6:.1f} MB, device {dev}, min_frames "
          f"{min_frames}, export {export_s:.1f} s)")
    report = {"out": str(out), "bytes": n_bytes, "export_s": export_s,
              "device": str(dev), "meta": meta}

    if args.verify:
        program = load_exported(out, dev).module()
        rng = np.random.default_rng(0)
        probe = max(128, min_frames)
        emg = torch.from_numpy((rng.normal(size=(1, C.HOPSIZE * probe,
                                                 channels)) * 0.1)
                               .astype(np.float32)).to(dev)
        ref = encoder
        if args.quantize == "int8":
            ref = encoder_with(dequantize_state_dict(
                quantize_state_dict(encoder.state_dict(), generic=True)))
        with tf32_off(), torch.no_grad():
            start = time.perf_counter()
            units, ph = program(emg)
            first_s = time.perf_counter() - start
            units_ref, ph_ref = ref(emg)
            diff = max(float((units - units_ref).abs().max()),
                       float((ph - ph_ref).abs().max()))
            if args.quantize == "int8":
                units_f32, ph_f32 = encoder(emg)
                dev_units = float((units_ref - units_f32).abs().max())
                agree = float((ph_ref.argmax(-1) == ph_f32.argmax(-1))
                              .float().mean())
                report.update(int8_units_max_abs_deviation=dev_units,
                              int8_phoneme_argmax_agreement=agree)
                print(f"int8 deviation vs f32 weights: units max "
                      f"{dev_units:.2e}, phoneme argmax agreement "
                      f"{agree:.4f}")
        report["verify"] = {"max_abs_diff": diff, "tol": TOL,
                            "first_call_s": first_s}
        print(f"verify: units {tuple(units.shape)}, phonemes "
              f"{tuple(ph.shape)}, max diff {diff:.2e} (tol {TOL:g}, first "
              f"call {first_s:.2f} s)")
        if not diff <= TOL:
            raise SystemExit("verification FAILED")
    return report


if __name__ == "__main__":
    main()
