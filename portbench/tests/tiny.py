"""Sizes the CPU holds, overlaid on each cell's files in the tests. Only
widths and counts shrink; every layer kind stays."""
import copy

_GAN = {
    "program": {"model": {"params": {"channels": 32}},
                "emg_encoder": {"params": {"model_size": 32,
                                           "num_transformer_layers": 1,
                                           "num_heads": 2,
                                           "dim_feedforward": 64}},
                "train": {"batch_size": 4, "chunk_size": 256}},
}
_ENC = {
    "program": {"emg_encoder": {"params": {"model_size": 32,
                                           "num_transformer_layers": 1,
                                           "num_heads": 2,
                                           "dim_feedforward": 64}}},
}
_SYN = {"program": {"model": {"params": {"channels": 32}}}}

TINY = {
    "gan_su.train": {"config": _GAN, "traffic": {
        "corpus_utterances": 12, "frames_min": 16, "frames_max": 24,
        "trace_steps": 2}},
    "enc.train_mixed": {"config": _ENC, "traffic": {
        "corpus_utterances": 40, "frames_min": 20, "frames_max": 40,
        "max_len": 3200, "trace_steps": 2}},
    "gan_su.generate": {"config": _SYN, "traffic": {
        "utterances": 30, "median_frames": 40, "frames_min": 5,
        "frames_max": 130, "bucket": 16, "max_batch": 4}}
}


def tiny(cell: str, f32: bool = False) -> dict:
    """The overrides of ``cell``; ``f32`` runs the GAN step's networks in
    f32 (the program's path without mixed precision)."""
    out = copy.deepcopy(TINY[cell])
    if f32:
        out["config"]["program"]["train"]["mixed_precision"] = False
    return out


def execute(cell: str, seed: int, trace: int = 0, seconds: float = 1.0,
            f32: bool = False):
    """A whole run of ``cell`` on the CPU at its tiny size."""
    from portbench import run

    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)])
    return run.execute(args, overrides=tiny(cell, f32), device="cpu")
