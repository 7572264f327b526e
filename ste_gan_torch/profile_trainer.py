"""Where the trainer's time goes beyond the bare train step, on the card.

    python -m ste_gan_torch.profile_trainer [--steps 20]

Builds the port's synthetic corpus (CLI defaults) under ``build/`` and the
shipped configuration (``configs/ste_gan_base_gantts.yaml`` with
``configs/data/synthetic.yaml``: corpus on the card, f16), then times the
per-step paths of the trainer one layer at a time, each over ``--steps``
steps with the host clock around ``synchronize``, in the order
A0 A B C D D C B A A0:

* ``A0`` the bare step on the bench's batch (f32 features, int64 indices),
  as ``chip_smoke.py``'s ``[step]`` phase;
* ``A``  the bare step on one gathered corpus batch (f16, int32);
* ``B``  + the corpus gather of each step's crops from fixed descriptors;
* ``C``  + the on-card phoneme-counter accumulation;
* ``D``  + the index loader behind the prefetch thread, with its copies of
  the descriptors to the card: the trainer's step without logging,
  validation or checkpoints.

Then traces ``--steps`` steps of ``A`` and of ``D`` with ``torch.profiler``
and prints the device time per step of each, and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from ste_gan_torch.config import load_config
from ste_gan_torch.data import synthetic
from ste_gan_torch.data.device_corpus import DeviceCorpus, IndexLoader
from ste_gan_torch.data.loader import Prefetcher, loaders_via_config, to_device
from ste_gan_torch.device import card_line, resolve_device
from ste_gan_torch.profile_step import _device_us
from ste_gan_torch.train import gan as tgan

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)
    n = args.steps

    card = card_line()
    dev = resolve_device()
    work = ROOT / "build" / "profile_trainer"
    shutil.rmtree(work, ignore_errors=True)
    synthetic.main(["--root", str(work / "synthetic")])
    cfg = load_config(str(ROOT / "configs" / "ste_gan_base_gantts.yaml"),
                      str(ROOT / "configs" / "data" / "synthetic.yaml"))
    cfg.data.dataset_root = str(work / "synthetic")
    models = tgan.build_models(cfg, seed=cfg.train.random_seed, device=dev)
    state = tgan.init_state(cfg, models)
    step = tgan.make_train_step(cfg, models)
    train_loader, _, _ = loaders_via_config(cfg)
    corpus = DeviceCorpus.from_dataset(train_loader.dataset,
                                       cfg.train.chunk_size, device=dev)
    index_loader = IndexLoader(train_loader, corpus.unit_lengths)
    first = to_device(next(iter(index_loader)), dev)
    gathered = corpus.gather(first["rows"], first["starts"])
    bench = tgan.synthetic_batch(cfg, dev)
    acc = {k: torch.zeros((), dtype=torch.int32, device=dev)
           for k in tgan.COUNT_KEYS}

    def endless():
        while True:
            for batch in index_loader:
                yield to_device(batch, dev)

    prefetched = iter(Prefetcher(endless, cfg.train.prefetch))

    def run(variant: str) -> None:
        nonlocal state
        if variant == "A0":
            state, _ = step(state, bench)
            return
        if variant == "A":
            state, _ = step(state, gathered)
            return
        idx = next(prefetched) if variant == "D" else first
        state, metrics = step(state, corpus.gather(idx["rows"],
                                                   idx["starts"]))
        if variant in ("C", "D"):
            for k in tgan.COUNT_KEYS:
                acc[k].add_(metrics[f"count/{k}"])

    def timed(variant: str) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run(variant)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    for variant in ("A0", "A", "B", "C", "D"):  # warm-up
        for _ in range(3):
            run(variant)
    order = ["A0", "A", "B", "C", "D", "D", "C", "B", "A", "A0"]
    times = {v: [] for v in order}
    for variant in order:
        times[variant].append(timed(variant))

    device_ms = {}
    for variant in ("A", "D"):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                run(variant)
            torch.cuda.synchronize()
        device_ms[variant] = sum(
            _device_us(e) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n

    lines = [f"card: {card}",
             f"ms/step over {n} steps, host clock (two runs each, in the "
             f"order {' '.join(order)}):"]
    labels = {"A0": "bare step, bench batch (f32, int64)",
              "A": "bare step, one corpus batch (f16, int32)",
              "B": "+ corpus gather per step",
              "C": "+ phoneme-counter accumulation",
              "D": "+ index loader, prefetch thread, descriptor copies"}
    for variant, label in labels.items():
        vals = times[variant]
        lines.append(f"  {variant:2s} {np.mean(vals):8.2f}  "
                     f"({', '.join(f'{v:.2f}' for v in vals)})  {label}")
    lines.append(f"device time per step (torch.profiler, {n} steps): "
                 f"A {device_ms['A']:.2f} ms, D {device_ms['D']:.2f} ms")
    print("\n".join(lines))
    prefetched.close()
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
