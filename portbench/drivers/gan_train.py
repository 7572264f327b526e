"""GAN training: the trainer's per-step path.

Set-up builds the program's three networks (the configuration's classes,
the seeded weights loaded strictly), its train state and the step from
``train.gan.make_train_step``, and a device-resident corpus drawn from the
seed (``data.device_corpus.DeviceCorpus``; utterance lengths spread evenly
over the mix's range, shuffled; EMG tanh(0.4 N(0, 1)), units N(0, 1),
phonemes and sessions uniform, all f16 or int32 as the trainer stores
them). Crop descriptors come from ``IndexLoader`` behind ``Prefetcher``;
each step gathers its crops on the card, steps and adds the phoneme
counters, as the trainer does between its logs.

The first ``check_steps`` steps go through that same feed and step; their
losses, the first step's generator output, the first gradient (from
AdamW's first moment), the change of every parameter and of the generator
EMA, and the spectral norm's vectors are kept for the check, which runs
the reference over the same crops from the same weights after the
window.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import compare
from portbench.drivers import common
from portbench.reference import nets
from portbench.reference import train as ref_train
from portbench.reference.precision import F32, Precision


class _Split:
    """A split of ``n`` utterances as the loader sees it: only its size."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n


def build_program(run, cfg, states):
    from ste_gan_torch.models.discriminator import init_emg_discriminators
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.models.generator import init_emg_generator
    from ste_gan_torch.train import gan as tgan

    dtype = torch.bfloat16 if cfg.train.mixed_precision else torch.float32
    with torch.device("meta"):
        gen = init_emg_generator(cfg, dtype, torch.Generator())
        disc = init_emg_discriminators(cfg, dtype, torch.Generator())
        enc = init_emg_encoder(cfg, dtype, torch.Generator())
    for module, key in ((gen, "g"), (disc, "d"), (enc, "e")):
        common.materialise(module, states[key], run.device)
    enc.eval().requires_grad_(False)
    return tgan.GANModels(gen.train(), disc.train(), enc)


def make_corpus(run):
    """The device-resident corpus drawn from the seed."""
    from ste_gan_torch.data.device_corpus import DeviceCorpus

    t = run.traffic
    n, hop = int(t["corpus_utterances"]), 16
    lengths = common.spread_lengths(n, t["frames_min"], t["frames_max"])
    lengths = common.rng(run.seed, common.ORDER).permutation(lengths)
    lmax = int(lengths.max())
    g = common.torch_gen(run.seed, common.DATA, run.device)
    dev = run.device
    f16 = torch.float16
    units = torch.randn((n, lmax, nets.UNIT_DIM),
                        generator=g, device=dev, dtype=f16)
    emg = torch.tanh(0.4 * torch.randn((n, hop * lmax, 8), generator=g,
                                       device=dev, dtype=f16))
    phonemes = torch.randint(0, nets.PHONEMES, (n, lmax), generator=g,
                             device=dev, dtype=torch.int32)
    sessions = torch.randint(0, common.sizes(run.config)["g"]["num_sessions"],
                             (n,), generator=g, device=dev, dtype=torch.int32)
    modes = torch.zeros((n,), dtype=torch.int32, device=dev)
    chunk = common.batch_shape(run.config)[1]
    return DeviceCorpus(emg, units, phonemes, None, sessions, modes, chunk,
                        hop, lengths)


def setup(run) -> None:
    from ste_gan_torch.data.device_corpus import IndexLoader
    from ste_gan_torch.data.loader import DataLoader, Prefetcher, to_device
    from ste_gan_torch.train import gan as tgan

    cfg = common.program_config(run)
    states = common.seeded_weights(run.config, "gde", run.seed, run.device)
    models = build_program(run, cfg, states)
    del states
    state = tgan.init_state(cfg, models)
    step = tgan.make_train_step(cfg, models)
    run.mark("program")
    corpus = make_corpus(run)
    run.mark("corpus")
    loader = DataLoader(_Split(len(corpus.unit_lengths)),
                        cfg.train.batch_size, "train", shuffle=True,
                        emg_train_length=cfg.train.chunk_size,
                        seed=run.seed, drop_last=True)
    index_loader = IndexLoader(loader, corpus.unit_lengths)
    drawn: List[Dict[str, np.ndarray]] = []
    keep = int(run.traffic["check_steps"])

    def endless():
        while True:
            for batch in index_loader:
                with run.span("draw"):
                    if len(drawn) < keep:
                        drawn.append({k: v.copy() for k, v in batch.items()})
                    item = to_device(batch, run.device)
                yield item

    feed = iter(Prefetcher(endless, cfg.train.prefetch))
    counts = {k: torch.zeros((), dtype=torch.int32, device=run.device)
              for k in tgan.COUNT_KEYS}

    def one_step():
        nonlocal state
        idx = next(feed)
        with run.span("gather"):
            batch = corpus.gather(idx["rows"], idx["starts"])
        with run.span("step"):
            state, metrics = step(state, batch)
        for k in tgan.COUNT_KEYS:
            counts[k].add_(metrics[f"count/{k}"])
        return metrics

    gen, disc = models.generator, models.discriminator
    names = {"g": [n for n, _ in gen.named_parameters()],
             "d": [n for n, _ in disc.named_parameters()]}
    before = {"g": {n: p.detach().clone() for n, p in gen.named_parameters()},
              "d": {n: p.detach().clone()
                    for n, p in disc.named_parameters()}}
    losses, grads = [], {}
    b1 = float(np.float32(1) - np.float32(cfg.train.adam_b1))
    first = compare.FirstOutputs(gen, ("fake",))
    for i in range(keep):
        metrics = one_step()
        losses.append({"d": metrics["loss/discriminator"],
                       "g": metrics["loss/generator"]})
        if i == 0:
            for net, opt in (("g", state.opt_g), ("d", state.opt_d)):
                vals = torch.stack([m.norm() for m in opt.exp_avg]) / b1
                grads[net] = dict(zip(names[net], vals.cpu().tolist()))
    after = {"g": dict(gen.named_parameters()),
             "d": dict(disc.named_parameters())}
    ema = compare.change_norms({"g": dict(zip(names["g"], state.gen_ema))},
                               before)["g"]
    run.stash["prog"] = compare.Summary(
        [{k: float(v) for k, v in step_losses.items()}
         for step_losses in losses],
        grads, compare.change_norms(after, before), outputs=first.outputs,
        ema=ema, sn=compare.sn_vectors(disc))
    del before, after
    run.mark("first steps")
    for _ in range(int(run.traffic["warmup_steps"])):
        one_step()
    run.mark("warm-up")
    run.stash.update(models=models, feed=feed, one_step=one_step,
                     corpus=corpus, drawn=drawn, cfg=cfg)


def window(run) -> Dict[str, float]:
    import time

    one_step = run.stash["one_step"]
    cfg = run.stash["cfg"]
    run.sync()
    t0 = time.perf_counter()
    n = 0
    while True:
        one_step()
        n += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    seconds = time.perf_counter() - t0
    run.window = {"units": n, "seconds": seconds, "attempted": n,
                  "failed": 0}
    samples = n * cfg.train.batch_size * cfg.train.chunk_size
    return {"gan_train_samples_per_s": samples / seconds}


def traced(run) -> float:
    n = int(run.traffic["trace_steps"])
    for _ in range(n):
        run.stash["one_step"]()
    return n


def release(run) -> None:
    run.stash.pop("feed").close()
    for key in ("models", "one_step"):
        run.stash.pop(key)


def reference_batches(run) -> List[Dict[str, torch.Tensor]]:
    """The crops of the recorded descriptors, gathered from the corpus by
    plain indexing."""
    corpus = run.stash["corpus"]
    chunk = common.batch_shape(run.config)[1]
    frames = chunk // 16
    out = []
    for d in run.stash["drawn"]:
        rows = torch.as_tensor(d["rows"], device=run.device).long()
        starts = torch.as_tensor(d["starts"], device=run.device).long()
        t = starts[:, None] + torch.arange(frames, device=run.device)
        te = starts[:, None] * 16 + torch.arange(chunk, device=run.device)
        units = corpus.speech_units[rows[:, None], t].float()
        out.append({"feats": units, "units": units,
                    "phonemes": corpus.phonemes[rows[:, None], t],
                    "real": corpus.emg[rows[:, None], te].float(),
                    "session": corpus.session_index[rows]})
    return out


def hyper(run) -> ref_train.GanHyper:
    """The reference's settings, read from the config file's ``program``
    part (the one copy the program is built from)."""
    t = run.config["program"]["train"]
    return ref_train.GanHyper(
        lr=t["learning_rate"], b1=t["adam_b1"], b2=t["adam_b2"],
        ema=t["generator_ema"], td=t["loss_multi_td_weight"],
        su=t["loss_speech_unit_weight"], ph=t["loss_phoneme_weight"],
        fm=t["loss_feat_match_weight"])


def reference_summary(run, precision: Precision = F32,
                      batches=None) -> compare.Summary:
    """The reference's first steps over the recorded crops, from the
    run's seeded weights, in ``precision``."""
    nets_, states = common.reference_nets(run.config, "gde", run.seed,
                                          run.device)
    rec = ref_train.gan_steps(nets_["g"], nets_["d"], nets_["e"],
                              batches or reference_batches(run), hyper(run),
                              precision)
    changes = compare.change_norms({"g": rec.params["g"],
                                    "d": rec.params["d"]}, states)
    ema = compare.change_norms({"g": rec.ema}, states)["g"]
    return compare.Summary(rec.losses, rec.grads, changes,
                           outputs=rec.outputs, ema=ema, sn=rec.sn)


def check(run):
    numbers = compare.training_numbers(run.stash["prog"],
                                       reference_summary(run))
    run.stash["numbers"] = numbers
    return compare.held(numbers, run.cell.limits)
