"""Sequence-parallel (time-sharded) generator synthesis.

Counterpart of ``ste_gan_tpu/parallel/sequence_parallel.py``. For a long
utterance the 50 Hz feature axis is split over the ranks of a process
group: each rank keeps one block, exchanges receptive-field halos with its
neighbours over ring hops (``dist.batch_isend_irecv``), runs the full
generator on its window and keeps the interior. The result equals
one-device synthesis because

* the halos cover the generator's receptive field
  (``infer.GENERATOR_RECEPTIVE_FIELD_FRAMES``), over several hops when a
  block is shorter than the context, and
* frames outside ``[0, T)`` (the ring's wrap-around and the round-up
  padding) are masked inside the generator (``num_valid_frames`` /
  ``valid_start_frames``), which equals the conv stack's zero padding at
  the utterance's edges.

Parameters stay replicated; only activations are split. Every rank gets
the whole ``[upsample * T, C]`` result (one all-gather).

    python -m ste_gan_torch.parallel.sequence_parallel --cases 2:500 \\
        2:1500 4:200 --out DIR [--device cuda|cpu] [--dist_backend gloo]

runs each case ``ranks:frames`` over the first ``ranks`` launched ranks
(the others wait) on the shipped generator with seeded random weights
(f32, TF32 off) and seeded features (:func:`seeded_case`), timed per call,
and writes ``DIR/sp_{ranks}x{frames}.npy`` and ``DIR/sp_stats.json`` from
rank 0.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ste_gan_torch.infer import GENERATOR_RECEPTIVE_FIELD_FRAMES
from ste_gan_torch.parallel.mesh import ProcessGroup, rank_and_size


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _ring_blocks(local: torch.Tensor, hops: int, rank: int, n: int,
                 group: ProcessGroup):
    """The blocks of ranks ``rank - hops .. rank - 1`` (left, in order) and
    ``rank + 1 .. rank + hops`` (right), modulo ``n``: hop ``h`` moves
    every block ``h`` ranks to the right and ``h`` to the left. gloo's
    send and receive read and write host memory only, so over gloo the
    blocks travel through host copies (the generator still runs on the
    card)."""
    device = local.device
    if dist.get_backend(group) == "gloo":
        local = local.cpu()
    left, right = [], []
    for hop in range(1, hops + 1):
        from_left, from_right = torch.empty_like(local), torch.empty_like(local)
        to_r = dist.get_global_rank(group, (rank + hop) % n)
        to_l = dist.get_global_rank(group, (rank - hop) % n)
        ops = [dist.P2POp(dist.isend, local, to_r, group, tag=2 * hop),
               dist.P2POp(dist.irecv, from_left, to_l, group, tag=2 * hop),
               dist.P2POp(dist.isend, local, to_l, group, tag=2 * hop + 1),
               dist.P2POp(dist.irecv, from_right, to_r, group,
                          tag=2 * hop + 1)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        left.insert(0, from_left.to(device))
        right.append(from_right.to(device))
    return left, right


@torch.no_grad()
def synthesize_time_sharded(generator, feats, session_idx: int,
                            mode_idx: int = 0, group: ProcessGroup = None,
                            context: int = GENERATOR_RECEPTIVE_FIELD_FRAMES
                            ) -> np.ndarray:
    """``[T, D]`` features -> ``[upsample * T, C]`` EMG (numpy f32, on every
    rank), with ``T`` split over the ranks of ``group`` (one device when
    None). Every rank passes the same ``feats``; the generator's weights
    are replicated. Equal to one-device synthesis; needs ``T >= 1``."""
    rank, n = rank_and_size(group)
    dev = next(generator.parameters()).device
    feats = torch.as_tensor(np.asarray(feats, np.float32))
    t, dim = feats.shape
    up = generator.upsample_factor
    local_t = _round_up(t, n) // n
    padded = torch.zeros((local_t * n, dim), dtype=torch.float32)
    padded[:t] = feats
    local = padded[rank * local_t:(rank + 1) * local_t].to(dev)

    # A halo may span several blocks when local_t < context.
    hops = min(-(-context // local_t), n - 1) if n > 1 else 0
    zeros = torch.zeros((context, dim), dtype=local.dtype, device=dev)
    if hops:
        left, right = _ring_blocks(local, hops, rank, n, group)
        left_halo = torch.cat(left)[-context:]
        right_halo = torch.cat(right)[:context]
        # hops * local_t < context: the far positions lie outside [0, t)
        # and are masked; pad on the far side to keep the window aligned.
        short = context - left_halo.shape[0]
        if short:
            left_halo = torch.cat([zeros[:short], left_halo])
            right_halo = torch.cat([right_halo, zeros[:short]])
    else:
        left_halo = right_halo = zeros
    window = torch.cat([left_halo, local, right_halo])

    # Validity in global terms: positions < 0 (the left wrap-around) and
    # >= t (the right wrap-around and the padding) are masked.
    start = rank * local_t - context
    num_valid = int(np.clip(t - start, 0, window.shape[0]))
    valid_start = int(np.clip(-start, 0, window.shape[0]))
    ids = torch.tensor([session_idx], device=dev)
    modes = torch.tensor([mode_idx], device=dev)
    emg = generator(window[None], ids, modes, num_valid_frames=num_valid,
                    valid_start_frames=valid_start)[0]
    interior = emg[context * up:(context + local_t) * up].float().contiguous()
    if n > 1:
        out = interior.new_empty((n * interior.shape[0], interior.shape[1]))
        dist.all_gather_into_tensor(out, interior, group=group)
    else:
        out = interior
    return out[:up * t].cpu().numpy()


#: Timed calls of each CLI case (after one untimed warm-up call).
REPS = 3


def seeded_case(frames: int):
    """``(feats [frames, 256] f32, session)`` of the CLI's case, made with
    numpy from the seed ``(0, frames)``."""
    from ste_gan_torch import constants as C

    rng = np.random.default_rng((0, frames))
    feats = rng.normal(size=(frames, C.SPEECH_UNITS_FEAT_SIZE)).astype(
        np.float32)
    return feats, int(rng.integers(0, C.NUM_EMG_SESSIONS))


def shipped_generator(device):
    """The shipped configuration's generator, random f32 weights from seed
    0, in eval mode on ``device``."""
    from ste_gan_torch.config import Config
    from ste_gan_torch.models.generator import init_emg_generator

    cfg = Config()
    gen = init_emg_generator(cfg, torch.float32,
                             torch.Generator().manual_seed(0))
    return cfg, gen.to(device).eval()


def _time_ms(fn, device) -> float:
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return 1e3 * (time.perf_counter() - t0) / REPS


def main(argv=None) -> None:
    from ste_gan_torch.device import resolve_device
    from ste_gan_torch.parallel.mesh import DEFAULT_TIMEOUT_S, init_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=["1:500"],
                    help="ranks:frames, each over the first `ranks` ranks")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dist_backend", type=str, default=None)
    ap.add_argument("--init_method", type=str, default=None)
    ap.add_argument("--timeout_s", type=float, default=DEFAULT_TIMEOUT_S)
    args = ap.parse_args(argv)
    cases = [tuple(int(v) for v in c.split(":")) for c in args.cases]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world, _ = init_ranks(args.dist_backend, args.timeout_s,
                                args.device, args.init_method)
    try:
        size = rank_and_size(world)[1]
        if any(ranks > size for ranks, _ in cases):
            raise ValueError(f"a case asks for more than the {size} ranks "
                             f"launched: {args.cases}")
        dev = resolve_device(args.device)
        if dev.type == "cuda" and world is not None:
            dev = torch.device("cuda", torch.cuda.current_device())
        _, gen = shipped_generator(dev)
        # Every rank creates every group, in the same order.
        groups = {ranks: (world if ranks == size else
                          dist.new_group(list(range(ranks))))
                  for ranks in sorted({r for r, _ in cases}) if ranks > 1}
        stats = {}
        for ranks, frames in cases:
            if rank < ranks:
                group = groups.get(ranks)
                feats, sess = seeded_case(frames)
                out = synthesize_time_sharded(gen, feats, sess, group=group)
                ms = _time_ms(lambda: synthesize_time_sharded(
                    gen, feats, sess, group=group), dev)
                stats[f"{ranks}x{frames}"] = {"ranks": ranks,
                                              "frames": frames,
                                              "session": sess, "ms": ms}
                if rank == 0:
                    args.out.mkdir(parents=True, exist_ok=True)
                    np.save(args.out / f"sp_{ranks}x{frames}.npy", out)
            if world is not None:
                dist.barrier(group=world)
        if rank == 0:
            (args.out / "sp_stats.json").write_text(json.dumps(stats))
            print(f"sequence_parallel: {stats}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
