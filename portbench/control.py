"""The readings that limits are set from, for a cell at its own size.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up (the program's first
steps, or one synthesis pass) and the numbers the program gives against
the reference; then the same numbers with stand-ins in the program's place:

* each entry of the config file's ``control`` for the cell's kind: the
  reference in a precision below the configuration's. ``control`` itself
  is the step below everywhere (fp8 operands for a bf16 step; for the
  encoder, bf16 convolutions where they run in TF32 and TF32 products
  where they run in f32); further entries round one part alone (the
  encoder's products in bf16 or TF32, its convolutions as configured);
* ``half_batch`` (training cells): the reference over the first half of
  each batch's rows, its mean taken over them.

A step that returns its state unchanged reads 1 by ``change_gap``'s
measure and needs no run. No measured window runs. ``--program-only``
reads the program's numbers alone (the lower readings over many seeds).
One JSON line per seed and stand-in.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import compare, spec
from portbench.reference.precision import Precision
from portbench.run import Run

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def precision(entry) -> Precision:
    """A ``Precision`` from a config file's entry (``dtype``, default
    float32; ``fp8``; ``tf32``; ``products``, an entry of its own)."""
    products = entry.get("products")
    return Precision(DTYPES[entry.get("dtype", "float32")],
                     fp8=bool(entry.get("fp8")), tf32=bool(entry.get("tf32")),
                     products=precision(products) if products else None)


def _half_gan(batches):
    return [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]


def _half_enc(batches):
    return [list(b[:max(1, len(b) // 2)]) for b in batches]


def training(run, drv, program_only: bool = False) -> dict:
    drv.setup(run)
    drv.release(run)
    torch.cuda.empty_cache()
    ref = drv.reference_summary(run)
    out = {"program": compare.training_numbers(run.stash["prog"], ref,
                                               detail=True)}
    if program_only:
        return out
    batches = drv.reference_batches(run)
    half = _half_gan if run.cell.driver == "gan_train" else _half_enc
    for name, entry in run.config["control"]["train"].items():
        out[name] = compare.training_numbers(
            drv.reference_summary(run, precision(entry), batches), ref,
            detail=True)
    out["half_batch"] = compare.training_numbers(
        drv.reference_summary(run, batches=half(batches)), ref, detail=True)
    return out


def synthesis(run, drv, program_only: bool = False) -> dict:
    from portbench.drivers import generate

    generate.setup(run)
    results = run.stash["one_pass"]()
    generate.release(run)
    outputs = {i: [res["FAKE_EMG"]] for i, res in enumerate(results)}
    out = {"program": {"emg_gap": generate.emg_gap(run, outputs)}}
    if program_only:
        return out
    for name, entry in run.config["control"]["synthesis"].items():
        stand_in = generate.reference_outputs(run, list(outputs),
                                              precision(entry))
        out[name] = {"emg_gap": generate.emg_gap(
            run, {i: [v] for i, v in stand_in.items()})}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        sys.exit(2)
    cell = spec.load_cell(args.workload)
    drv = spec.driver(cell.driver)
    for seed in args.seeds:
        run = Run(cell, seed, 0.0, torch.device("cuda"))
        fn = training if cell.driver in ("gan_train", "enc_train") else synthesis
        readings = fn(run, drv, args.program_only)
        for stand_in, numbers in readings.items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "stand_in": stand_in, **numbers}), flush=True)
        del run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
