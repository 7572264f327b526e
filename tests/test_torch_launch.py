"""The port's fleet launcher (``python -m ste_gan_torch.parallel.launch``)
on CPU ranks over gloo: a rank is hard-killed (``os._exit``, injected
through ``STE_MP_CRASH``) mid-run; the supervisor notices, tears the
survivor down, starts the fleet again from the newest recovery point with
a ``.done`` sentinel, and the recovered run's final state equals the run
without the crash (rtol 2e-5 / atol 2e-6, as ``tests/test_launch.py``).

* Crash recovery at two ranks, under FSDP: against the uninterrupted
  two-rank run (DP, which FSDP equals bit for bit at two ranks).
* Elastic recovery 2 -> 1: rank 1 dies before step 3, the fleet goes on
  with one rank from the step-2 recovery point. Against the same schedule
  without the crash: the uninterrupted run's step-2 recovery point, run on
  to step 6 by one rank in this process.
* Elastic recovery under tensor parallelism, 4 ranks at ``(data, model)
  = (2, 2)`` -> 2 ranks at (1, 2): rank 1 dies before step 3, the fleet
  keeps a multiple of ``--model_parallel`` ranks. Against the same
  schedule without the crash: the worker at (2, 2) for steps 0-1, then at
  (1, 2) from its step-2 recovery point.
* A rank count that ``--model_parallel`` does not divide is refused.

Each attempt's ranks rendezvous through a file in the attempt's directory.
"""
import argparse
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ste_gan_torch.parallel import launch
from ste_gan_torch.parallel.launch import (
    FleetLauncher, latest_recovery_point, run_ranks)
from ste_gan_torch.parallel.multiprocess import (
    flatten_state, run_steps, tiny_setup)

ROOT = Path(__file__).resolve().parents[1]
STEPS = 6


def _args(run_dir: Path, *more) -> argparse.Namespace:
    return launch.parse_args([
        "--num_processes", "2", "--steps", str(STEPS), "--run_dir",
        str(run_dir), "--ckpt_every", "2", "--attempt_timeout", "240",
        "--timeout_s", "90", "--device", "cpu", "--file_rendezvous", *more])


def _rank_env() -> dict:
    return {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}


def _fleet(run_dir: Path, crash: str = "", *more) -> dict:
    """Run a fleet with ``STE_MP_CRASH=crash`` (none when empty) in the
    ranks' environment; returns the launcher's summary."""
    with pytest.MonkeyPatch.context() as mp:
        for key, value in _rank_env().items():
            mp.setenv(key, value)
        if crash:
            mp.setenv("STE_MP_CRASH", crash)
        else:
            mp.delenv("STE_MP_CRASH", raising=False)
        return FleetLauncher(_args(run_dir, *more)).run()


def _final(summary: dict, rank: int = 0) -> dict:
    return dict(np.load(Path(summary["final_out"]) / f"state_p{rank}.npz"))


def _assert_close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=2e-6,
                                   err_msg=f"{what}: {key}")


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("uninterrupted")
    return run_dir, _fleet(run_dir)


@pytest.fixture(scope="module")
def recovered(tmp_path_factory):
    """Rank 1 of an FSDP fleet dies just before step 5; the newest
    recovery point is step 4."""
    run_dir = tmp_path_factory.mktemp("recovered")
    flag = run_dir / "crash.flag"
    return run_dir, flag, _fleet(run_dir, f"5:1:{flag}", "--fsdp")


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("elastic")
    flag = run_dir / "crash.flag"
    return run_dir, flag, _fleet(run_dir, f"3:1:{flag}", "--elastic")


class TestFleetRecovery:
    def test_crash_was_injected_and_detected(self, recovered):
        run_dir, flag, summary = recovered
        assert flag.exists(), "fault injection never fired"
        assert summary["ok"] and summary["restarts"] == 1
        # Steps 4 and 5 were redone from the step-4 point, 0-3 were not.
        assert summary["recovered_from"] == [4]
        assert summary["world_sizes"] == [2, 2]
        assert (run_dir / "attempt_0" / "log_p1.txt").exists()
        assert latest_recovery_point(run_dir / "recovery")[0] == STEPS

    def test_recovered_state_matches_uninterrupted(self, recovered,
                                                   uninterrupted):
        _, _, summary = recovered
        _, clean = uninterrupted
        assert clean["ok"] and clean["restarts"] == 0
        _assert_close(_final(summary), _final(clean), "recovered fleet")

    def test_replicas_agree_after_recovery(self, recovered):
        _, _, summary = recovered
        p0, p1 = _final(summary, 0), _final(summary, 1)
        assert set(p0) == set(p1)
        for key in p0:
            np.testing.assert_array_equal(p0[key], p1[key], err_msg=key)


class TestElasticRecovery:
    def test_world_shrank_and_completed(self, elastic):
        run_dir, flag, summary = elastic
        assert flag.exists(), "fault injection never fired"
        assert summary["ok"] and summary["restarts"] == 1
        assert summary["world_sizes"] == [2, 1]
        assert summary["recovered_from"] == [2]
        out = Path(summary["final_out"])
        assert (out / "state_p0.npz").exists()
        assert not (out / "state_p1.npz").exists()
        assert (run_dir / "attempt_0" / "log_p1.txt").exists()

    def test_shrunk_fleet_continues_the_trajectory(self, elastic,
                                                   uninterrupted):
        """Steps 2-5 on one rank from the uninterrupted run's step-2
        recovery point, in this process, give the elastic run's state."""
        _, _, summary = elastic
        clean_dir, _ = uninterrupted
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            cfg, models = tiny_setup()
            tree, _, _ = run_steps(
                cfg, models, STEPS - 2, start_step=2,
                restore_ckpt=clean_dir / "recovery" / "step_2.pt")
        finally:
            torch.set_num_threads(threads)
        _assert_close(_final(summary), flatten_state(tree), "elastic fleet")


@pytest.fixture(scope="module")
def elastic_tp(tmp_path_factory):
    """Four ranks at (2, 2); rank 1 dies just before step 3."""
    run_dir = tmp_path_factory.mktemp("elastic_tp")
    flag = run_dir / "crash.flag"
    return run_dir, flag, _fleet(run_dir, f"3:1:{flag}", "--elastic",
                                 "--num_processes", "4",
                                 "--model_parallel", "2")


def _worker(run_dir: Path, name: str, world: int, *flags) -> Path:
    """The worker on ``world`` CPU ranks at ``--model_parallel 2``."""
    out = run_dir / name
    rendezvous = f"file://{(run_dir / f'{name}.rendezvous').resolve()}"
    run_ranks([sys.executable, "-m", "ste_gan_torch.parallel.multiprocess",
               "--device", "cpu", "--tiny", "--model_parallel", "2",
               "--timeout_s", "90", "--init_method", rendezvous, "--out",
               str(out), *flags], world, run_dir / f"{name}_logs", 240,
              env=_rank_env())
    return out


class TestElasticTensorParallel:
    def test_world_shrank_to_a_multiple_of_model_parallel(self, elastic_tp):
        run_dir, flag, summary = elastic_tp
        assert flag.exists(), "fault injection never fired"
        assert summary["ok"] and summary["restarts"] == 1
        assert summary["world_sizes"] == [4, 2]
        assert summary["recovered_from"] == [2]
        out = Path(summary["final_out"])
        assert (out / "state_p1.npz").exists()
        assert not (out / "state_p2.npz").exists()
        assert (run_dir / "attempt_0" / "log_p3.txt").exists()

    def test_shrunk_fleet_continues_the_trajectory(self, elastic_tp,
                                                   tmp_path):
        """The same schedule without the crash: (2, 2) for steps 0-1,
        then (1, 2) from that run's step-2 recovery point; both model
        ranks end with the same full state."""
        _, _, summary = elastic_tp
        ckpt = tmp_path / "recovery"
        _worker(tmp_path, "first", 4, "--steps", "2", "--ckpt_every", "2",
                "--ckpt_dir", str(ckpt))
        out = _worker(tmp_path, "rest", 2, "--steps", str(STEPS - 2),
                      "--start_step", "2", "--restore_ckpt",
                      str(ckpt / "step_2.pt"))
        want = dict(np.load(out / "state_p0.npz"))
        _assert_close(_final(summary), want, "elastic (2, 2) -> (1, 2)")
        _assert_close(_final(summary, 1), want, "its second model rank")


def test_rank_count_must_be_a_multiple_of_model_parallel(tmp_path):
    with pytest.raises(ValueError, match="not a multiple of "
                                         "--model_parallel 2"):
        FleetLauncher(_args(tmp_path, "--num_processes", "3",
                            "--model_parallel", "2"))


def test_latest_recovery_point_skips_torn_writes(tmp_path):
    assert latest_recovery_point(tmp_path) is None
    (tmp_path / "step_2.pt").write_bytes(b"x")
    (tmp_path / "step_2.done").touch()
    (tmp_path / "step_4.pt").write_bytes(b"x")     # written, not marked
    (tmp_path / "step_6.done").touch()             # marked, file missing
    assert latest_recovery_point(tmp_path) == (2, tmp_path / "step_2.pt")


def test_a_fleet_that_keeps_failing_gives_up(tmp_path):
    """Every attempt's rank 0 dies at step 0 (the flag file is a
    directory the rank cannot create, so the injection never disarms):
    the launcher stops after --max_restarts and says so."""
    flag = tmp_path / "never"
    flag.mkdir()
    with pytest.raises(SystemExit, match="failed after 1 restarts"):
        _fleet(tmp_path / "fleet", f"0:0:{flag / 'sub' / 'flag'}",
               "--max_restarts", "1")
