"""The worker that one rank of a fleet runs: the fused GAN train step over
the ranks, on seeded batches, with recovery checkpoints.

Counterpart of ``ste_gan_tpu/parallel/multiprocess.py``. One process per
rank; ``python -m ste_gan_torch.parallel.launch`` (or ``torchrun``) starts
one per rank with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` set::

    python -m ste_gan_torch.parallel.multiprocess --steps N --start_step K \\
        --ckpt_every M --ckpt_dir D --out O [--fsdp] [--model_parallel P] \\
        [--device cpu|cuda] [--tiny|--full]

* The batch of step ``i`` is a pure function of ``(seed, i)``; every rank
  makes the same global batch and takes its rows, so a run restarted at
  ``K`` sees the batches the uninterrupted run saw.
* Every ``--ckpt_every`` steps rank 0 writes the full train state (under
  FSDP gathered first) to ``D/step_{k}.pt`` through a temporary file,
  ``fsync`` and ``os.replace``; after a barrier it writes ``step_{k}.done``,
  the sentinel the launcher restarts from. The state has the
  single-device layout, so it restores at any rank count.
* ``STE_MP_CRASH=<step>:<rank>:<flag>`` (fault injection) ends rank
  ``<rank>`` with ``os._exit`` just before step ``<step>``, creating
  ``<flag>`` first so that a restarted fleet runs on.
* ``--model_parallel P`` splits the ranks into ``(ranks / P, P)``
  (``parallel/tensor_parallel.py``): each model rank holds output-channel
  slabs of both networks, and the batch rows, gradient all-reduce and FSDP
  shards go over the data ranks. ``--fsdp`` with it is hybrid FSDP x TP.
* Each rank writes ``O/state_p{r}.npz`` (the final full state, gathered
  over the model ranks; not with ``--no-save_state``),
  ``O/history_p{r}.json`` (per step: G and D losses, ms of the step
  itself) and ``O/stats_p{r}.json`` (kernel launches, collective ms per
  step, the state bytes this rank holds, the tensor-parallel collectives'
  calls, bytes and ms per step).
* ``--deterministic`` makes two runs of the same steps on a card agree bit
  for bit (cuDNN's deterministic algorithms, TF32 off, PyTorch's
  deterministic kernels where it has them), as crash recovery checks.

``--tiny`` (default) is the small complete setup of the JAX worker's
``tiny_setup`` in f32, with the shipped generator EMA on; ``--full`` the
shipped ``Config()`` at 32 x 2048 in bf16 with the EMA, as
``train.gan.main_path`` builds it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ste_gan_torch import constants as C
from ste_gan_torch.config import Config
from ste_gan_torch.device import resolve_device
from ste_gan_torch.ops import kernel_launches
from ste_gan_torch.parallel import tensor_parallel as tp
from ste_gan_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S, GradientAllReduce, ProcessGroup, barrier,
    init_ranks, rank_and_size, replicate_module)


def tiny_setup(device=None, seed: int = 0):
    """The JAX worker's small but complete GAN (chunk 512, global batch
    16, 4 sessions, 2+2 discriminators, f32, every loss and both
    optimizers, spectral norm), with the shipped ``generator_ema`` 0.999 so
    that the fleet's runs cover the EMA. Seeded random weights on
    ``device`` (the CPU when None)."""
    from ste_gan_torch.models.discriminator import DiscriminatorEnsemble
    from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
    from ste_gan_torch.models.generator import EMGGeneratorGanTTS
    from ste_gan_torch.train.gan import GANModels

    cfg = Config()
    cfg.train.chunk_size = 512
    cfg.train.batch_size = 16
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.model.params = {"channels": 32}
    cfg.data.num_emg_sessions = 4
    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cpu") if device is None else resolve_device(device)
    models = GANModels(
        generator=EMGGeneratorGanTTS(num_sessions=4, channels=32,
                                     generator=gen),
        discriminator=DiscriminatorEnsemble(
            num_multi_pool=2, num_multi_scale=2,
            period_spec_override=((8, 3, 1, 2), (16, 3, 3, 2)),
            scale_spec_override=((8, 15, 1, 1, 7), (16, 5, 2, 4, 2)),
            generator=gen),
        encoder=EMGEncoderTransformer(
            model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
            num_heads=4, dim_feedforward=64, dropout=0.0, generator=gen))
    for m in (models.generator, models.discriminator, models.encoder):
        m.to(dev)
    models.encoder.eval().requires_grad_(False)
    return cfg, models


def full_setup(device=None, seed: int = 0):
    """The shipped configuration of the main path (``Config()``, batch 32 x
    2048, bf16, ``generator_ema`` 0.999), seeded random weights."""
    from ste_gan_torch.train.gan import build_models

    cfg = Config()
    cfg.train.generator_ema = 0.999
    return cfg, build_models(cfg, seed=seed, device=device)


def seeded_batch(cfg: Config, seed: int, step: int) -> Dict[str, np.ndarray]:
    """The global batch of step ``step``: a pure function of
    ``(seed, step)``, drawn as the JAX worker draws it."""
    rng = np.random.default_rng((seed, step))
    b, chunk = cfg.train.batch_size, cfg.train.chunk_size
    frames = chunk // C.HOPSIZE
    return {
        C.DataType.REAL_EMG: np.tanh(rng.normal(
            0, 0.4, (b, chunk, cfg.data.num_emg_channels))).astype(np.float32),
        C.DataType.SPEECH_UNITS: rng.normal(
            size=(b, frames, C.SPEECH_UNITS_FEAT_SIZE)).astype(np.float32),
        C.DataType.PHONEMES: rng.integers(
            0, C.NUM_PHONEMES, (b, frames)).astype(np.int32),
        C.DataType.SESSION_INDEX: rng.integers(
            0, cfg.data.num_emg_sessions, (b,)).astype(np.int32),
        C.DataType.SPEAKING_MODE_INDEX: np.zeros((b,), np.int32),
    }


def _crash_plan() -> Optional[Tuple[int, int, str]]:
    """``(step, rank, flag)`` of ``STE_MP_CRASH`` while armed; None once its
    flag file exists (the dying rank creates it)."""
    spec = os.environ.get("STE_MP_CRASH", "")
    if not spec:
        return None
    step, proc, flag = spec.split(":", 2)
    if Path(flag).exists():
        return None
    return int(step), int(proc), flag


def save_recovery_point(tree: Dict, ckpt_dir: Path, step: int,
                        group: ProcessGroup) -> None:
    """Rank 0 writes ``tree`` to ``ckpt_dir/step_{step}.pt`` (temporary
    file, ``fsync``, ``os.replace``); after a barrier it marks it done."""
    from ste_gan_torch.train.checkpoint import host_copy

    rank, _ = rank_and_size(group)
    path = Path(ckpt_dir) / f"step_{step}.pt"
    if rank == 0:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".pt.tmp")
        with open(tmp, "wb") as fp:
            torch.save(host_copy(tree), fp)
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, path)
    barrier(group)
    if rank == 0:
        path.with_suffix(".done").touch()


def restore_state(path: Path, models, state) -> None:
    """Copy a full train state written by :func:`save_recovery_point` (or
    a trainer checkpoint's ``state.pt``) into ``models`` and ``state``."""
    from ste_gan_torch.train.checkpoint import copy_into
    from ste_gan_torch.train.gan import state_tree

    saved = torch.load(Path(path), map_location="cpu", weights_only=True)
    copy_into(state_tree(models, state), saved)
    state.step = int(saved["step"])


def flatten_state(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A state tree as ``{"generator/<name>": array, "opt_g/exp_avg/3":
    array, ...}`` (f32 and integer arrays on the host)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_state(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_state(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().float().cpu().numpy() \
            if tree.is_floating_point() else tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def run_steps(cfg: Config, models, n_steps: int, seed: int = 0,
              fsdp: bool = False, start_step: int = 0,
              restore_ckpt: Optional[Path] = None, ckpt_every: int = 0,
              ckpt_dir: Optional[Path] = None, group: ProcessGroup = None,
              timed: bool = False, model_parallel: int = 1
              ) -> Tuple[Dict, List[Dict], Dict]:
    """``n_steps`` fused GAN steps over the ranks of ``group`` (one
    process alone when None) from ``start_step``, on :func:`seeded_batch`
    rows. ``model_parallel > 1`` splits the ranks into ``(data, model)``
    (``tensor_parallel.create_mesh_2d``) and both networks into slabs.
    Returns ``(full state tree, history, stats)``: the tree in
    ``train.gan.state_tree``'s layout (gathered under FSDP and tensor
    parallelism: a collective), per step ``{"step", "G", "D", "ms"}``, and
    the collectives' seconds. ``timed`` synchronises the card around each
    collective to time it."""
    from ste_gan_torch.parallel.fsdp import fsdp_wrap_gan_step
    from ste_gan_torch.train.gan import init_state, make_train_step, state_tree

    rank, size = rank_and_size(group)
    mesh = (tp.create_mesh_2d(-1, model_parallel, group) if group is not None
            else tp.Mesh2D(None, None, None))
    if mesh.model_size != model_parallel:
        raise ValueError(f"model_parallel={model_parallel} needs a group of "
                         f"ranks")
    dev = next(models.generator.parameters()).device
    state = init_state(cfg, models)
    if restore_ckpt is not None:
        restore_state(restore_ckpt, models, state)
    for module in (models.generator, models.discriminator, models.encoder):
        replicate_module(module, group)
    if mesh.model_size > 1:
        tp.shard_state(models, state, mesh)
    if fsdp:
        step, sharded = fsdp_wrap_gan_step(cfg, models, state, mesh.data,
                                           timed=timed)
        local_tree = sharded.state_tree
        comm = sharded
    else:
        comm = GradientAllReduce(mesh.data, timed=timed)
        step = make_train_step(cfg, models, group=mesh.data, update=comm)
        local_tree = lambda: state_tree(models, state)  # noqa: E731
    axes = tp.gan_state_axes(models)

    def full_tree():
        return (tp.unshard_state(local_tree(), axes, mesh)
                if mesh.model_size > 1 else local_tree())

    crash = _crash_plan()
    history = []
    mesh.comm.timed = timed
    for i in range(start_step, start_step + n_steps):
        if crash is not None and i == crash[0] and rank == crash[1]:
            Path(crash[2]).touch()  # disarm before dying
            os._exit(17)
        batch = tp.shard_batch_2d(seeded_batch(cfg, seed, i), mesh, dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        history.append({"step": i, "G": float(metrics["loss/generator"]),
                        "D": float(metrics["loss/discriminator"]),
                        "ms": 1e3 * (time.perf_counter() - t0)})
        if ckpt_every and ckpt_dir is not None and (i + 1) % ckpt_every == 0:
            save_recovery_point(full_tree(), Path(ckpt_dir), i + 1, group)
    steps = max(1, n_steps)
    stats = {"ranks": size, "data_parallel": mesh.data_size,
             "model_parallel": mesh.model_size, "comm_s": comm.comm_s,
             "comm_ms_per_step": 1e3 * comm.comm_s / steps,
             "tp_calls_per_step": mesh.comm.calls / steps,
             "tp_mb_per_step": mesh.comm.bytes / steps / 2**20,
             "tp_comm_ms_per_step": 1e3 * mesh.comm.seconds / steps,
             "persistent_bytes": (sharded.persistent_bytes() if fsdp
                                  else tp.tp_state_bytes(models, state))}
    return full_tree(), history, stats


def deterministic() -> None:
    """The settings of ``--deterministic`` for this process."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--start_step", type=int, default=0,
                    help="first step: batch i is seeded by (seed, i)")
    ap.add_argument("--ckpt_every", type=int, default=0,
                    help="write a recovery point to --ckpt_dir every k "
                         "steps")
    ap.add_argument("--ckpt_dir", type=Path, default=None)
    ap.add_argument("--restore_ckpt", type=Path, default=None,
                    help="full train state to start from (a recovery "
                         "point, or a trainer checkpoint's state.pt), "
                         "written at any rank count")
    ap.add_argument("--encoder_ckpt", type=Path, default=None,
                    help="reference-layout state dict of the frozen "
                         "encoder (else its seeded random weights)")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--fsdp", action="store_true",
                    help="store the train state sharded over the (data) "
                         "ranks")
    ap.add_argument("--model_parallel", type=int, default=1,
                    help="tensor-parallel size: the ranks form (ranks / P, "
                         "P) and each model rank holds slabs of both "
                         "networks")
    ap.add_argument("--grad_accum", type=int, default=1)
    ap.add_argument("--save_state", action=argparse.BooleanOptionalAction,
                    default=True, help="write state_p{r}.npz")
    ap.add_argument("--deterministic", action="store_true",
                    help="deterministic kernels, TF32 off: reruns of the "
                         "same steps agree bit for bit")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--tiny", dest="full", action="store_false",
                      help="the small f32 setup (default)")
    size.add_argument("--full", dest="full", action="store_true",
                      help="the shipped configuration, 32 x 2048 bf16")
    ap.set_defaults(full=False)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dist_backend", type=str, default=None,
                    help="nccl (default on cuda) or gloo")
    ap.add_argument("--init_method", type=str, default=None,
                    help="rendezvous URL (default env://, from "
                         "MASTER_ADDR / MASTER_PORT)")
    ap.add_argument("--timeout_s", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds a collective may wait")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.deterministic:
        deterministic()
    t0 = time.perf_counter()
    rank, group, _ = init_ranks(args.dist_backend, args.timeout_s,
                                args.device, args.init_method)
    t_group = time.perf_counter() - t0
    try:
        dev = resolve_device(args.device)
        setup = full_setup if args.full else tiny_setup
        cfg, models = setup(dev)
        t_setup = time.perf_counter() - t0 - t_group
        cfg.train.grad_accum = args.grad_accum
        if args.encoder_ckpt is not None:
            models.encoder.load_state_dict(torch.load(
                args.encoder_ckpt, map_location="cpu", weights_only=True),
                strict=True)
        tree, history, stats = run_steps(
            cfg, models, args.steps, fsdp=args.fsdp,
            start_step=args.start_step, restore_ckpt=args.restore_ckpt,
            ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, group=group,
            timed=True, model_parallel=args.model_parallel)
        stats["launches"] = kernel_launches()
        stats["device"] = str(dev)
        stats["seconds"] = {"group": t_group, "setup": t_setup,
                            "run": time.perf_counter() - t0 - t_group
                            - t_setup}
        args.out.mkdir(parents=True, exist_ok=True)
        if args.save_state:
            np.savez(args.out / f"state_p{rank}.npz", **flatten_state(tree))
        (args.out / f"history_p{rank}.json").write_text(json.dumps(history))
        (args.out / f"stats_p{rank}.json").write_text(json.dumps(stats))
        print(f"rank {rank}/{stats['ranks']}: {args.steps} steps from "
              f"{args.start_step} OK; seconds {stats['seconds']}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
