"""The port's GAN trainer CLI (``python -m ste_gan_torch.train.train_gan``)
over two CPU ranks (spawned gloo processes, rendezvous through a file under
``tmp_path``) at the tiny size of ``tests/test_torch_train_loop.py``: four
steps (indices 0-3), validation and checkpoints every 2 steps.

* Two ranks (DP) against one rank: every logged train and validation
  metric within rtol 1e-4 / atol 1e-6 (two half-batch means averaged where
  one rank takes one mean; validation scores whole batches round robin
  over the ranks and sums them).
* Two ranks under FSDP against two ranks DP: the same metrics and the same
  final checkpoint, bit for bit (the checkpoint is the gathered full state
  in the single-device format).
* Across rank counts: a two-rank checkpoint resumed by one rank, and a
  one-rank checkpoint resumed by two ranks under FSDP, give step 3's losses
  of the uninterrupted runs (rtol 1e-4 / atol 1e-6; the epoch's running
  phoneme accuracy restarts with the process).
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from ste_gan_torch.config import Config
from ste_gan_torch.config import create_ste_gan_model_name
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.parallel.launch import run_ranks
from ste_gan_torch.train import train_gan as ttrain

ROOT = Path(__file__).resolve().parents[1]
RANK_ENV = {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}
ENCODER = {"type": "EMGEncoderTransformer",
           "params": {"model_size": 32, "num_extra_res_blocks": 3,
                      "num_transformer_layers": 1, "num_heads": 4,
                      "dim_feedforward": 64, "dropout": 0.0}}
DISC = {"num_multi_pool": 1, "num_multi_scale": 1,
        "period_spec_override": [[8, 3, 1, 2], [16, 3, 3, 2]],
        "scale_spec_override": [[8, 15, 1, 1, 7], [16, 9, 2, 4, 4],
                                [32, 9, 2, 8, 4], [32, 5, 1, 1, 2]]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_dp")
    corpus = tmp / "corpus"
    generate_synthetic_corpus(corpus, num_train=8, num_valid=3, num_test=2,
                              num_sessions=3, min_frames=34, max_frames=40,
                              seed=0)
    cfg = Config()
    cfg.data.dataset_root = str(corpus)
    cfg.data.name = "synthetic"
    cfg.data.num_emg_sessions = 3
    t = cfg.train
    t.chunk_size, t.batch_size, t.mixed_precision = 512, 4, False
    t.max_steps, t.interval_log, t.interval_valid = 3, 1, 2
    t.interval_sample, t.interval_save = 10_000, 2
    t.save_last_epoch_interval, t.generator_ema = 1, 0.999
    cfg.model.params = {"channels": 32}
    cfg.model.discriminator_params = DISC
    base = cfg.to_dict()
    data, encoder = base.pop("data"), base.pop("emg_encoder")
    encoder.update(ENCODER)
    for name, content in (("data", data), ("encoder", encoder)):
        (tmp / f"{name}.yaml").write_text(yaml.safe_dump(content))
    return tmp, base, create_ste_gan_model_name(cfg, add_timestamp=False)


def _argv(work, name: str, *more):
    """CLI arguments of run ``name`` (its own model_base_dir)."""
    tmp, base, _ = work
    config = tmp / f"config_{name}.yaml"
    config.write_text(yaml.safe_dump(dict(base,
                                          model_base_dir=str(tmp / name))))
    return ["--config", str(config), "--data", str(tmp / "data.yaml"),
            "--emg_enc_cfg", str(tmp / "encoder.yaml"), "--device", "cpu",
            "--dist_timeout_s", "90", *more]


def _run(work, name: str, ranks: int, *more) -> Path:
    tmp, _, run_name = work
    argv = _argv(work, name, *more)
    if ranks == 1:
        ttrain.main(ttrain.parse_args(argv))
    else:
        rendezvous = (tmp / f"{name}.rendezvous").resolve()
        run_ranks([sys.executable, "-m", "ste_gan_torch.train.train_gan",
                   *argv, "--dist_init_method", f"file://{rendezvous}"],
                  ranks, tmp / f"{name}_logs", 240, env=RANK_ENV)
    return tmp / name / run_name


def _logged(run: Path) -> dict:
    out = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["tag"].startswith(("train", "val/")):
            key = (rec["tag"], rec["step"])
            assert key not in out, f"{key} logged twice"
            out[key] = rec["value"]
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: torch.as_tensor(tree)}


def _state(run: Path, tag: str) -> dict:
    return _flat(torch.load(run / tag / "state.pt", weights_only=True))


@pytest.fixture(scope="module")
def runs(work):
    return {"one": _run(work, "one", 1),
            "dp": _run(work, "dp", 2),
            "fsdp": _run(work, "fsdp", 2, "--fsdp", "1")}


def _assert_logged_close(got: dict, want: dict, keys, what: str) -> None:
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} {key}")


def test_two_ranks_log_what_one_rank_logs(runs):
    want, got = _logged(runs["one"]), _logged(runs["dp"])
    assert got.keys() == want.keys()
    assert {s for t, s in want if t == "train_loss/generator"} == {0, 1, 2, 3}
    assert {s for t, s in want if t == "val/speech_unit"} == {0, 2}
    assert ("val/phoneme_accuracy_avg", 2) in want
    _assert_logged_close(got, want, want, "two ranks vs one")


def test_fsdp_logs_and_checkpoints_what_dp_does(runs):
    assert _logged(runs["fsdp"]) == _logged(runs["dp"])
    for tag in ("checkpoint-final", "checkpoint-00000002", "best"):
        want, got = _state(runs["dp"], tag), _state(runs["fsdp"], tag)
        assert got.keys() == want.keys()
        for key, value in want.items():
            assert torch.equal(got[key], value), (tag, key)


def test_rank_zero_writes_the_run_directory(runs):
    for entry in (".done", "config.yaml", "log.txt", "metrics.jsonl",
                  "session_idx_to_id.json", "checkpoint-00000002",
                  "checkpoint-final", "checkpoint-last", "best"):
        assert (runs["dp"] / entry).exists(), entry
    one = _state(runs["one"], "checkpoint-final")
    two = _state(runs["dp"], "checkpoint-final")
    assert one.keys() == two.keys()  # the single-device format


def _resumed_step_3(work, runs, name, source, ranks, *more):
    run = _run(work, name, ranks, "--checkpoint",
               str(runs[source] / "checkpoint-00000002"), *more)
    logged = _logged(run)
    assert {s for t, s in logged if t == "train_loss/generator"} == {3}
    return logged


def test_a_two_rank_checkpoint_resumes_at_one_rank(work, runs):
    got = _resumed_step_3(work, runs, "resume_one", "dp", 1)
    want = _logged(runs["dp"])
    keys = [k for k in got if k[0].startswith("train_loss/")
            and "accuracy" not in k[0]]
    assert keys
    _assert_logged_close(got, want, keys, "two-rank checkpoint at one rank")


def test_a_one_rank_checkpoint_resumes_at_two_ranks_under_fsdp(work, runs):
    got = _resumed_step_3(work, runs, "resume_two", "one", 2, "--fsdp", "1")
    want = _logged(runs["one"])
    keys = [k for k in got if k[0].startswith("train_loss/")
            and "accuracy" not in k[0]]
    assert keys
    _assert_logged_close(got, want, keys, "one-rank checkpoint at two ranks")


def test_a_batch_the_ranks_cannot_share_raises(work):
    with pytest.raises(ValueError, match="do not divide"):
        ttrain._check_parallel(Config(), 3)
    cfg = Config()
    cfg.train.data_parallel = 2
    with pytest.raises(ValueError, match="1 rank"):
        ttrain._check_parallel(cfg, 1)
