"""Batched speech -> EMG synthesis of a dataset split from a trained run.

    python -m ste_gan_torch.generate_emg --run_dir exp/ste-gan/<run> \\
        [--partition test] [--tag best] [--out_dir DIR] [--bucket 64] \\
        [--device cpu]

Counterpart of ``scripts/generate_emg.py``. Reads a run directory of the
port's GAN trainer (``config.yaml``, the vocabulary JSONs, a checkpoint
tag), builds the synthesizer from the EMA weights at the trained model's
compute dtype, converts the split twice with
:func:`ste_gan_torch.infer.convert_dataset` (a cold pass, then a warm one
that is timed), prints the real-time factor with the warm pass's padding
share and host milliseconds a batch (the pass less its ``synth/fetch``
waits, from the counters of ``utils/profiling.py``), and writes
``<run_dir>/emg_synth/<partition>/<utt_id>.npy``. Runs on ``cuda`` unless
``--device`` says otherwise; without a card it raises.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ste_gan_torch import constants as C
from ste_gan_torch.device import resolve_device
from ste_gan_torch.utils import profiling


def pass_readout(counts: Dict, seconds: float) -> Tuple[float, float]:
    """(padding %, host ms a batch) of a ``convert_dataset`` pass of
    ``seconds`` from its counters: 100 less the valid frames' share of
    the frames computed, and the pass less its ``synth/fetch`` waits over
    its batches (NaN for a pass of no batch)."""
    def total(name):
        return counts.get(name, (0.0, 0))[0]

    batches = total("synth/batches")
    if not batches:
        return float("nan"), float("nan")
    return (100.0 * (1.0 - total("synth/valid_frames")
                     / total("synth/computed_frames")),
            1e3 * (seconds - total("synth/fetch")) / batches)


def main(argv=None) -> Dict:
    from ste_gan_torch.data.dataset import EMGDataset
    from ste_gan_torch.evaluate import _vocab_from_run_dir
    from ste_gan_torch.infer import EMGSynthesizer, convert_dataset
    from ste_gan_torch.train.gan import (eval_generator_state_dict,
                                         load_trained_state)

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--run_dir", type=Path, required=True)
    parser.add_argument("--partition", type=str, default="test")
    parser.add_argument("--tag", type=str, default="best",
                        help="checkpoint tag: best | latest | "
                             "checkpoint-XXXXXXXX")
    parser.add_argument("--out_dir", type=Path, default=None)
    parser.add_argument("--bucket", type=int, default=64)
    parser.add_argument("--device", type=str, default=None,
                        help="device to synthesise on (default cuda)")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    run_dir = Path(args.run_dir)
    cfg, models, state = load_trained_state(run_dir, args.tag, device=dev)
    session_id_to_idx, mode_id_to_idx = _vocab_from_run_dir(run_dir)
    dataset = EMGDataset(Path(cfg.data.dataset_root), args.partition,
                         session_id_to_idx=session_id_to_idx,
                         speaking_mode_id_to_idx=mode_id_to_idx,
                         filter_by_length=False)

    synth = EMGSynthesizer.from_config(
        cfg, eval_generator_state_dict(models, state), bucket=args.bucket,
        dtype=models.generator.dtype, device=dev)
    del models, state

    feature_key = cfg.model.speech_feature_type
    timings = []
    for _ in range(2):  # cold, then warm
        before = profiling.counters()
        start = time.perf_counter()
        results = convert_dataset(synth, dataset, feature_key=feature_key,
                                  bucket=args.bucket)
        timings.append(time.perf_counter() - start)
    cold, warm = timings
    padding_pct, host_ms_per_batch = pass_readout(profiling.since(before),
                                                  warm)

    total_emg_samples = sum(len(r[C.DataType.FAKE_EMG]) for r in results)
    audio_seconds = total_emg_samples / C.EMG_SAMPLE_RATE
    rtf = warm / max(audio_seconds, 1e-9)
    print(f"converted {len(results)} utterances ({audio_seconds:.1f}s of "
          f"EMG) on {dev} at {str(synth.generator.dtype).split('.')[-1]}; "
          f"cold {cold:.2f}s, warm {warm:.2f}s -> RTF {rtf:.5f}; warm pass: "
          f"padding {padding_pct:.2f} %, host {host_ms_per_batch:.3f} ms a "
          f"batch")

    out_dir = args.out_dir or (run_dir / "emg_synth" / args.partition)
    out_dir.mkdir(parents=True, exist_ok=True)
    for res in results:
        np.save(out_dir / f"{res[C.DataType.UTT_ID]}.npy",
                res[C.DataType.FAKE_EMG])
    print(f"wrote {len(results)} files to {out_dir}")
    return {"num_utterances": len(results), "emg_seconds": audio_seconds,
            "cold_s": cold, "warm_s": warm, "rtf": rtf,
            "padding_pct": padding_pct,
            "host_ms_per_batch": host_ms_per_batch,
            "dtype": str(synth.generator.dtype), "out_dir": str(out_dir)}


if __name__ == "__main__":
    main()
