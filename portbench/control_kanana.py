"""The readings that the kanana encoder cell's limits are set from.

    python3 -m portbench.control_kanana --seeds <n> [<n> ...]
        [--program-only] [--out <file>]

For each seed, in one process: the cell's set-up (the program's check
steps on the trainer's path) and the numbers that decide ``correct``
against the f32 reference; then, unless ``--program-only``, the same
numbers with stand-ins in the program's place, each the reference with
one fault, against the same f32 reference:

* ``stated``: the reference at the configuration's precision (bf16
  products, the front end's convolutions in TF32), the program's own
  rounding without its kernels;
* each other entry of the config file's ``control``, on top of
  ``stated``: every product in fp8 (``precision``, one step below the
  stated precision), the experts' products alone in fp8, RoPE without the
  interleaved pairs, the latent norm left out, the router in bf16, the
  bias left out of the choice; for these the block numbers
  (``mla_out_gap``, ``moe_out_gap``, ``pick_gap``, ``bias_gap``) are the
  reference's block with the stand-in against the reference's block at
  the stated precision, on the program's recorded inputs;
* ``half_batch``: the f32 reference over the first half of each batch's
  utterances (the training numbers only).

A step that leaves its state unchanged reads 1 by ``change_gap``'s
measure and needs no run. No measured window runs. One JSON line per seed
and stand-in.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import compare, spec
from portbench.control import precision
from portbench.drivers import enc_train
from portbench.drivers import enc_train_kanana as drv
from portbench.reference import kanana as ref_kanana
from portbench.run import Run

CELL = "enc_kanana.train_mixed"


def stand_in(entry, base):
    """``(precision, variant)`` of a config file's ``control`` entry: its
    own ``precision`` or ``base``, and the reference's ``Variant``."""
    prec = precision(entry["precision"]) if "precision" in entry else base
    return prec, ref_kanana.Variant(
        scores=entry.get("scores", "sigmoid"),
        use_bias=bool(entry.get("use_bias", True)),
        router=precision(entry["router"]) if "router" in entry else None,
        experts=precision(entry["experts"]) if "experts" in entry else None,
        rope_interleave=bool(entry.get("rope_interleave", True)),
        latent_norm=bool(entry.get("latent_norm", True)))


def one_seed(cell, seed: int, program_only: bool, device="cuda"):
    """``(stand-in, numbers)`` of one seed, the program's first."""
    run = Run(cell, seed, 0.0, torch.device(device))
    drv.setup(run)
    drv.release(run)
    if run.cuda:
        torch.cuda.empty_cache()
    ref = drv.reference_summary(run)
    yield "program", drv.numbers(run, ref)
    if program_only:
        return
    base = drv.stated(run.config)
    yield "stated", compare.training_numbers(
        drv.reference_summary(run, base), ref)
    for name, entry in run.config["control"].items():
        if name == "stated":
            continue
        prec, variant = stand_in(entry, base)
        out = compare.training_numbers(
            drv.reference_summary(run, prec, variant), ref)
        out.update(drv.sparse_numbers(run, variant, prec))
        out.update(drv.mla_numbers(run, variant, prec))
        yield name, out
    half = [list(b[:max(1, len(b) // 2)])
            for b in enc_train.reference_batches(run)]
    yield "half_batch", compare.training_numbers(
        drv.reference_summary(run, batches=half), ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-only", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control_kanana: needs a card", file=sys.stderr)
        return 2
    from portbench import run as run_mod

    run_mod._cache_env()
    cell = spec.load_cell(CELL)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            for name, numbers in one_seed(cell, seed, args.program_only):
                line = json.dumps({"seed": seed, "stand_in": name,
                                   "numbers": numbers})
                print(line, flush=True)
                if out is not None:
                    out.write(line + "\n")
                    out.flush()
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
