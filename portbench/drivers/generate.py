"""Corpus-scale synthesis: ``infer.convert_dataset`` over a split, pass
after pass.

Set-up builds the program's synthesizer as ``generate_emg`` does
(``EMGSynthesizer.from_config`` with the seeded generator weights, the
mix's bucket, the configuration's synthesis precision) and a split drawn
from the seed: the mix's log-normal lengths (the same quantiles for every
seed, in a seeded order), sessions uniform, units N(0, 1). One pass runs
in set-up; the window replays the split until ``--seconds`` have passed,
and counts the seconds of valid EMG returned to the host.

The check compares every utterance of the last pass with the reference
generator run over it whole, unpadded, in f32 with TF32 off.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.drivers import common
from portbench.reference import nets
from portbench.reference.precision import F32, Precision

EMG_RATE = 800.0


def make_split(run) -> List[Dict]:
    """The split's items as ``convert_dataset`` reads them (host numpy)."""
    t = run.traffic
    n = int(t["utterances"])
    lengths = common.rng(run.seed, common.ORDER).permutation(
        common.lognormal_lengths(n, t["median_frames"], t["sigma"],
                                 t["frames_min"], t["frames_max"]))
    g = common.torch_gen(run.seed, common.DATA, run.device)
    feats = torch.randn((int(lengths.sum()), nets.UNIT_DIM), generator=g,
                        device=run.device).cpu().numpy()
    sessions = torch.randint(0, common.sizes(run.config)["g"]["num_sessions"],
                             (n,),
                             generator=g, device=run.device).cpu().numpy()
    items, offset = [], 0
    for i, length in enumerate(lengths):
        items.append({"UTT_ID": f"u{i:05d}", "SESSION_ID": f"s{sessions[i]}",
                      "SESSION_INDEX": int(sessions[i]),
                      "SPEAKING_MODE_IDX": 0,
                      "SPEECH_UNITS": feats[offset:offset + length]})
        offset += int(length)
    return items


def synthesizer(run, cfg, bucket: int):
    from ste_gan_torch.infer import EMGSynthesizer

    state = common.seeded_weights(run.config, "g", run.seed, run.device)["g"]
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        run.config["synthesis_dtype"]]
    return EMGSynthesizer.from_config(cfg, state, bucket=bucket, dtype=dtype,
                                      device=run.device)


def setup(run) -> None:
    from ste_gan_torch.infer import convert_dataset

    cfg = common.program_config(run)
    t = run.traffic
    synth = synthesizer(run, cfg, int(t["bucket"]))
    run.mark("program")
    split = make_split(run)
    run.mark("split")

    def one_pass():
        with run.span("convert"):
            out = convert_dataset(synth, split, feature_key="SPEECH_UNITS",
                                  bucket=int(t["bucket"]),
                                  max_batch=int(t["max_batch"]))
        return out

    one_pass()
    run.mark("warm pass")
    run.stash.update(synth=synth, split=split, one_pass=one_pass)


def _valid(split, results) -> tuple:
    """(valid samples returned, utterances missing or of the wrong
    length)."""
    samples, bad = 0, 0
    for item, res in zip(split, results):
        emg = None if res is None else res.get("FAKE_EMG")
        if emg is None or emg.shape[0] != 16 * len(item["SPEECH_UNITS"]):
            bad += 1
        else:
            samples += emg.shape[0]
    return samples, bad


def window(run) -> Dict[str, float]:
    import time

    split, one_pass = run.stash["split"], run.stash["one_pass"]
    run.sync()
    t0 = time.perf_counter()
    samples = frames = attempted = failed = 0
    while True:
        results = one_pass()
        s, bad = _valid(split, results)
        samples += s
        frames += s // 16
        attempted += len(split)
        failed += bad
        if time.perf_counter() - t0 >= run.seconds:
            break
    seconds = time.perf_counter() - t0
    run.stash["last"] = results
    run.window = {"units": frames, "seconds": seconds,
                  "attempted": attempted, "failed": failed}
    return {"synth_emg_s_per_s": samples / EMG_RATE / seconds}


def traced(run) -> float:
    frames = 0
    for _ in range(int(run.traffic["trace_passes"])):
        frames += _valid(run.stash["split"], run.stash["one_pass"]())[0] // 16
    return frames


def release(run) -> None:
    for key in ("synth", "one_pass"):
        run.stash.pop(key)


def reference_outputs(run, indices, precision: Precision = F32,
                      rows: int = 32) -> Dict[int, np.ndarray]:
    """The reference generator's EMG for each utterance of ``indices``,
    each whole and unpadded (utterances of one length share a batch)."""
    gen = common.reference_nets(run.config, "g", run.seed, run.device)[0]["g"]
    split = run.stash["split"]
    by_length: Dict[int, List[int]] = {}
    for i in indices:
        by_length.setdefault(len(split[i]["SPEECH_UNITS"]), []).append(i)
    out = {}
    with precision.active(), torch.no_grad():
        for group in by_length.values():
            for start in range(0, len(group), rows):
                part = group[start:start + rows]
                feats = torch.as_tensor(np.stack(
                    [split[i]["SPEECH_UNITS"] for i in part]),
                    device=run.device)
                sess = torch.tensor([split[i]["SESSION_INDEX"] for i in part],
                                    device=run.device)
                emg = gen(feats, sess, precision).float().cpu().numpy()
                out.update(zip(part, emg))
    return out


def emg_gap(run, outputs: Dict[int, List[np.ndarray]]) -> float:
    """The largest absolute gap between ``outputs`` (answers by utterance
    index) and the reference's EMG in f32; an answer of the wrong shape
    counts as 2, the widest gap two tanh outputs can have."""
    want = reference_outputs(run, list(outputs))
    worst = 0.0
    for i, answers in outputs.items():
        for emg in answers:
            if emg is None or emg.shape != want[i].shape:
                return 2.0
            worst = max(worst,
                        float(np.abs(emg.astype(np.float32) - want[i]).max()))
    return worst


def check(run):
    outputs = {i: [None if res is None else res["FAKE_EMG"]]
               for i, res in enumerate(run.stash["last"])}
    value = emg_gap(run, outputs)
    run.stash["numbers"] = {"emg_gap": value}
    return [("emg_gap", value, float(run.cell.limits["emg_gap"]))]
