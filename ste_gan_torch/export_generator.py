"""Export a trained run's generator as a self-contained ``torch.export``
artifact.

    python -m ste_gan_torch.export_generator --run_dir exp/ste-gan/<run> \\
        [--tag best] [--serving] [--quantize int8] [--dtype bfloat16] \\
        [--out <path>.pt2] [--verify] [--device cpu]

Counterpart of ``scripts/export_generator.py``. Reads a run directory of the
port's GAN trainer (``config.yaml`` and a checkpoint tag; the EMA weights
when EMA training is on), traces the generator with its weights on the
device (``cuda`` unless ``--device`` says otherwise; the JAX CLI's
``--platforms``), and writes ``<run_dir>/export/generator-<tag>[-serving]
[-int8].pt2`` with its ``.meta.json`` and the run's session and
speaking-mode vocabulary JSONs beside it. ``--verify`` loads the artifact
back and holds one call to the in-framework generator (f32 to 1e-4, bf16
to 5e-2; cuDNN's TF32 off for the comparison); an int8 artifact is held to
the generator with its dequantised weights, and the deviation of those
from the f32 weights is printed.
"""
from __future__ import annotations

import argparse
import contextlib
import shutil
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


@contextlib.contextmanager
def tf32_off():
    """cuDNN convs and matrix products in full f32 (the verification's
    setting); the previous settings are restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def main(argv=None) -> Dict:
    from ste_gan_torch.device import resolve_device
    from ste_gan_torch.export import (export_generator, generator_meta,
                                      load_exported, save_exported,
                                      speech_feature_dim)
    from ste_gan_torch.models.generator import init_emg_generator
    from ste_gan_torch.quant import (dequantize_state_dict,
                                     export_generator_quantized,
                                     quantize_state_dict)
    from ste_gan_torch.train.gan import (eval_generator_state_dict,
                                         load_trained_state)

    parser = argparse.ArgumentParser(
        prog="python -m ste_gan_torch.export_generator", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--run_dir", type=Path, required=True)
    parser.add_argument("--tag", type=str, default="best",
                        help="checkpoint tag: best | latest | "
                             "checkpoint-XXXXXXXX")
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--serving", action="store_true",
                        help="export the micro-batching signature (feats, "
                             "session, mode, num_valid) with per-row "
                             "valid-length masks; the artifact can back "
                             "python -m ste_gan_torch.serve --artifact")
    parser.add_argument("--verify", action="store_true",
                        help="reload the artifact and diff one call against "
                             "the in-framework generator")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="compute dtype traced into the artifact "
                             "(float32 whatever the training config says; "
                             "the weights are f32 either way)")
    parser.add_argument("--device", type=str, default=None,
                        help="device to trace and verify on (default cuda)")
    parser.add_argument("--quantize", type=str, default="none",
                        choices=("none", "int8"),
                        help="int8: per-output-channel symmetric int8 "
                             "weights, dequantised inside the program on "
                             "every call (ste_gan_torch/quant.py)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    run_dir = Path(args.run_dir)
    cfg, models, state = load_trained_state(run_dir, args.tag, device=dev)
    weights = eval_generator_state_dict(models, state)
    del models, state
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    feature_dim = speech_feature_dim(cfg)

    def generator_with(state_dict):
        gen = init_emg_generator(cfg, dtype, torch.Generator().manual_seed(0))
        gen.load_state_dict(state_dict, strict=True)
        return gen.to(dev).eval()

    generator = generator_with(weights)
    start = time.perf_counter()
    if args.quantize == "int8":
        exported = export_generator_quantized(generator, feature_dim,
                                              serving=args.serving)
    else:
        exported = export_generator(generator, feature_dim,
                                    serving=args.serving)
    export_s = time.perf_counter() - start

    suffix = ("-serving" if args.serving else "") + (
        "" if args.quantize == "none" else f"-{args.quantize}")
    out = Path(args.out or
               run_dir / "export" / f"generator-{args.tag}{suffix}.pt2")
    meta = generator_meta(generator, feature_dim, args.serving)
    meta.update(quantize=args.quantize, dtype=args.dtype)
    n_bytes = save_exported(exported, out, meta=meta)
    for vocab in ("session_idx_to_id.json", "speaking_mode_idx_to_id.json"):
        if (run_dir / vocab).exists():
            shutil.copy2(run_dir / vocab, out.parent / vocab)
    print(f"wrote {out} ({n_bytes / 1e6:.1f} MB, device {dev}, feature_dim "
          f"{feature_dim}, export {export_s:.1f} s)")
    report = {"out": str(out), "bytes": n_bytes, "export_s": export_s,
              "device": str(dev), "meta": meta}

    if args.verify:
        program = load_exported(out, dev).module()
        rng = np.random.default_rng(0)
        feats = torch.from_numpy(rng.normal(size=(1, 64, feature_dim))
                                 .astype(np.float32)).to(dev)
        ids = torch.zeros((1,), dtype=torch.long, device=dev)
        valid = torch.full((1,), 64, device=dev)

        def call(fn):
            if args.serving:
                return fn(feats, ids, ids, valid)
            return fn(feats, ids)

        ref = generator
        if args.quantize == "int8":
            ref = generator_with(dequantize_state_dict(
                quantize_state_dict(weights)))
        with tf32_off(), torch.no_grad():
            start = time.perf_counter()
            got = call(program)
            first_s = time.perf_counter() - start
            diff = float((got - call(ref)).abs().max())
            if args.quantize == "int8":
                qdev = float((call(ref) - call(generator)).abs().max())
                report["int8_max_abs_deviation"] = qdev
                print(f"int8 quantisation output deviation vs f32 weights: "
                      f"max {qdev:.2e} (tanh-bounded outputs)")
        tol = TOL[args.dtype]
        report["verify"] = {"max_abs_diff": diff, "tol": tol,
                            "first_call_s": first_s}
        print(f"verify: out {tuple(got.shape)}, max |artifact - framework| "
              f"= {diff:.2e} (tol {tol:g}, first call {first_s:.2f} s)")
        if not diff <= tol:
            raise SystemExit("verification FAILED")
    return report


if __name__ == "__main__":
    main()
