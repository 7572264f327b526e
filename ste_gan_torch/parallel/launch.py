"""Fleet launcher: runs the multi-rank worker, detects a dead rank and
recovers the fleet from its newest recovery point.

Counterpart of ``ste_gan_tpu/parallel/launch.py``. The supervisor picks a
free port, starts one ``python -m ste_gan_torch.parallel.multiprocess``
per rank with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set, and writes
each rank's output to ``<run_dir>/attempt_{n}/log_p{r}.txt``. When a rank
exits with an error (or the attempt outlives ``--attempt_timeout``), the
survivors, which would wait in their next collective until its timeout,
are terminated, and the fleet starts again from the newest
``recovery/step_{k}.pt`` whose ``step_{k}.done`` sentinel exists (a torn
write has none). The worker's batch ``i`` is a pure function of
``(seed, i)`` and the recovery points hold the full state, so the redone
steps give the uninterrupted run's trajectory.

``--elastic`` treats a lost rank as gone for good: each failed attempt
halves the rank count (down to ``--min_processes``), and the full-state
recovery point restores onto the smaller fleet. ``--device cpu`` runs the
ranks on the CPU over gloo (JAX's ``--cpu_devices``); on ``cuda`` rank
``r`` takes card ``r % device_count``, and ``--dist_backend gloo`` lets
ranks share a card. ``--file_rendezvous`` rendezvouses each attempt
through a file in its directory instead of the TCP port.

    python -m ste_gan_torch.parallel.launch --num_processes 2 --steps 6 \\
        --ckpt_every 2 --run_dir /tmp/fleet [--device cpu] [--elastic] \\
        [--fsdp] [--model_parallel P] [--full]

``--model_parallel P`` runs the worker's tensor-parallel layout
(``(ranks / P, P)``); an elastic fleet then keeps a multiple of ``P``
ranks and never shrinks below ``P``.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

from ste_gan_torch.parallel.mesh import DEFAULT_TIMEOUT_S


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def latest_recovery_point(ckpt_dir: Path) -> Optional[Tuple[int, Path]]:
    """``(k, ckpt_dir/step_{k}.pt)`` of the newest recovery point whose
    ``.done`` sentinel exists, or None."""
    best = None
    for done in Path(ckpt_dir).glob("step_*.done"):
        step = int(done.stem.split("_")[1])
        ckpt = done.with_suffix(".pt")
        if ckpt.is_file() and (best is None or step > best[0]):
            best = (step, ckpt)
    return best


def rank_env(rank: int, world: int, master_port: int,
             master_addr: str = "localhost") -> dict:
    """The environment of rank ``rank`` of ``world`` on one host (what
    ``torchrun`` sets), over this process's own."""
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR=master_addr, MASTER_PORT=str(master_port))


def run_ranks(cmd: List[str], world: int, log_dir: Path, timeout: float,
              env: Optional[dict] = None) -> None:
    """Run ``cmd`` once per rank of ``world`` on this host, with
    :func:`rank_env` (plus ``env``) and each rank's output in
    ``log_dir/log_p{r}.txt``; wait for all. Raises RuntimeError, with the
    failed rank's log tail, when a rank fails or ``timeout`` seconds pass;
    every process has ended on return."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs, logs = [], []
    try:
        for rank in range(world):
            logs.append((log_dir / f"log_p{rank}.txt").open("w"))
            procs.append(subprocess.Popen(
                cmd, stdout=logs[-1], stderr=subprocess.STDOUT,
                env={**rank_env(rank, world, port), **(env or {})}))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = [r for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if failed:
        tail = (log_dir / f"log_p{failed[0]}.txt").read_text()[-4000:]
        raise RuntimeError(f"rank {failed[0]} of {world} failed "
                           f"(exit codes {[p.returncode for p in procs]}):\n"
                           f"{tail}")


class FleetLauncher:
    """Start, supervise and recover one fleet of worker ranks."""

    def __init__(self, args: argparse.Namespace,
                 env: Optional[dict] = None):
        """``env``: variables every rank gets beyond this process's own
        (e.g. ``STE_MP_CRASH``), without setting them here."""
        self.args = args
        self.env = dict(env or {})
        self.run_dir = Path(args.run_dir)
        self.ckpt_dir = self.run_dir / "recovery"
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.ckpt_dir.mkdir(exist_ok=True)
        # The rank count: with --elastic it shrinks on a restart (the lost
        # rank's host is gone); without, a restart starts the full fleet.
        self.world = args.num_processes
        self.elastic = bool(getattr(args, "elastic", False))
        self.model_parallel = max(1, int(getattr(args, "model_parallel", 1)))
        self.min_processes = max(int(getattr(args, "min_processes", 1)),
                                 self.model_parallel)
        if self.world % self.model_parallel:
            raise ValueError(f"--num_processes {self.world} is not a multiple "
                             f"of --model_parallel {self.model_parallel}")

    # -- one attempt ------------------------------------------------------
    def _spawn(self, attempt: int, start_step: int,
               restore: Optional[Path]) -> Tuple[list, Path]:
        a = self.args
        out = self.run_dir / f"attempt_{attempt}"
        out.mkdir(exist_ok=True)
        cmd = [sys.executable, "-m", "ste_gan_torch.parallel.multiprocess",
               "--steps", str(a.steps - start_step),
               "--start_step", str(start_step),
               "--ckpt_every", str(a.ckpt_every),
               "--ckpt_dir", str(self.ckpt_dir), "--out", str(out),
               "--timeout_s", str(a.timeout_s),
               "--full" if a.full else "--tiny"]
        if a.device:
            cmd += ["--device", a.device]
        if a.dist_backend:
            cmd += ["--dist_backend", a.dist_backend]
        if restore is not None:
            cmd += ["--restore_ckpt", str(restore)]
        if a.fsdp:
            cmd += ["--fsdp"]
        if self.model_parallel > 1:
            cmd += ["--model_parallel", str(self.model_parallel)]
        if a.deterministic:
            cmd += ["--deterministic"]
        if a.file_rendezvous:
            cmd += ["--init_method", f"file://{(out / 'rendezvous').resolve()}"]
        port = free_port()
        procs = []
        for rank in range(self.world):
            log = (out / f"log_p{rank}.txt").open("w")
            p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                 env={**rank_env(rank, self.world, port,
                                                 a.master_addr), **self.env})
            p._log_handle = log  # closed in _teardown
            procs.append(p)
        return procs, out

    def _teardown(self, procs: list) -> None:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 15
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for p in procs:
            p._log_handle.close()

    def _watch(self, procs: list) -> bool:
        """Wait until every rank exits 0 (True), or one fails or the
        attempt times out (False); every process has ended on return."""
        deadline = time.monotonic() + self.args.attempt_timeout
        while True:
            codes = [p.poll() for p in procs]
            ok = all(c == 0 for c in codes)
            if ok or any(c not in (None, 0) for c in codes) \
                    or time.monotonic() > deadline:
                self._teardown(procs)
                return ok
            time.sleep(0.25)

    # -- the supervision loop --------------------------------------------
    def run(self) -> dict:
        restarts = 0
        recovered_from: List[int] = []
        world_sizes: List[int] = [self.world]
        attempt_s: List[float] = []
        while True:
            rec = latest_recovery_point(self.ckpt_dir) if restarts else None
            start = rec[0] if rec else 0
            restore = rec[1] if rec else None
            if restarts:
                recovered_from.append(start)
                print(f"[launch] restart {restarts}: recovering from step "
                      f"{start} with {self.world} rank(s)"
                      + (f" ({restore})" if restore else " (scratch)"),
                      flush=True)
            t0 = time.monotonic()
            procs, out = self._spawn(restarts, start, restore)
            ok = self._watch(procs)
            attempt_s.append(time.monotonic() - t0)
            if ok:
                summary = {"ok": True, "steps": self.args.steps,
                           "num_processes": self.args.num_processes,
                           "world_sizes": world_sizes,
                           "restarts": restarts,
                           "recovered_from": recovered_from,
                           "attempt_s": attempt_s,
                           "final_out": str(out)}
                (self.run_dir / "summary.json").write_text(
                    json.dumps(summary, indent=1))
                print(f"[launch] fleet done: {json.dumps(summary)}",
                      flush=True)
                return summary
            restarts += 1
            if self.elastic and self.world > self.min_processes:
                # The failed rank's capacity is taken as lost: continue on
                # half the ranks from the full-state recovery point.
                half = self.world // 2 // self.model_parallel
                self.world = max(self.min_processes,
                                 half * self.model_parallel)
                print(f"[launch] elastic: shrinking to {self.world} "
                      f"rank(s)", flush=True)
            world_sizes.append(self.world)
            if restarts > self.args.max_restarts:
                summary = {"ok": False, "restarts": restarts - 1,
                           "world_sizes": world_sizes[:-1],
                           "recovered_from": recovered_from,
                           "failed_attempt": str(out)}
                (self.run_dir / "summary.json").write_text(
                    json.dumps(summary, indent=1))
                raise SystemExit(
                    f"[launch] fleet failed after {restarts - 1} restarts; "
                    f"logs in {out}")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--run_dir", type=Path, required=True,
                    help="recovery/ points, attempt_{n}/ logs and outputs, "
                         "summary.json")
    ap.add_argument("--ckpt_every", type=int, default=0,
                    help="recovery-point cadence in steps (0: a restart "
                         "starts from step 0)")
    ap.add_argument("--max_restarts", type=int, default=2)
    ap.add_argument("--attempt_timeout", type=float, default=1800,
                    help="seconds before an attempt is torn down and "
                         "restarted")
    ap.add_argument("--timeout_s", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds a worker's collective may wait")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dist_backend", type=str, default=None,
                    help="nccl (default on cuda) or gloo (ranks may share "
                         "a card)")
    ap.add_argument("--master_addr", default="localhost")
    ap.add_argument("--file_rendezvous", action="store_true",
                    help="rendezvous through a file in each attempt's "
                         "directory instead of a TCP port")
    ap.add_argument("--elastic", action="store_true",
                    help="halve the rank count on each restart (floor "
                         "--min_processes) and continue from the "
                         "full-state recovery point")
    ap.add_argument("--min_processes", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--model_parallel", type=int, default=1,
                    help="the workers' tensor-parallel size")
    ap.add_argument("--deterministic", action="store_true",
                    help="the workers' --deterministic: reruns of the same "
                         "steps on a card agree bit for bit")
    ap.add_argument("--full", action="store_true",
                    help="the shipped configuration (default: the tiny "
                         "one)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    FleetLauncher(parse_args(argv)).run()


if __name__ == "__main__":
    main()
