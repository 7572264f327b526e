"""The port's encoder trainer over two CPU ranks (spawned gloo processes of
``python -m ste_gan_torch.train.encoder``, rendezvous through a file under
``tmp_path``) against the same CLI at one rank, on a mixed corpus (silent
fraction 0.4: the DTW-aligned loss runs) with dropout 0.2 on, 2 epochs.

Two ranks must compute what one computes: BatchNorm statistics over the
global batch, dropout masks sliced from the global ones, the shared shift,
the silent loss over windows that may lie on either rank. Tolerances:
* logged train and validation losses and accuracies: rtol 1e-4 /
  atol 1e-6;
* the last weights and BatchNorm statistics (``last_model.pt``): rtol 1e-4 /
  atol 1e-5, except the conv biases that feed a BatchNorm and the running
  means they shift. The BatchNorm takes the batch mean back out, so their
  true gradient is zero and what AdamW sees is rounding, which it scales to
  steps of up to the learning rate in a direction rounding picks; they are
  held to that drift ceiling, steps x 3e-4 (the JAX package's own encoder
  mesh test bounds them the same way, ``tests/test_encoder_parallel.py``).
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from ste_gan_torch import emg_encoder_constants as EC
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.models.transformer import dropout
from ste_gan_torch.parallel.launch import run_ranks
from ste_gan_torch.train import encoder as tenc

ROOT = Path(__file__).resolve().parents[1]
ENCODER = {"model_size": 32, "num_extra_res_blocks": 3,
           "num_transformer_layers": 1, "num_heads": 4,
           "dim_feedforward": 64, "dropout": 0.2}
RANK_ENV = {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}
#: Conv biases followed by a BatchNorm, and the running means they move.
BN_FED = (".conv1.bias", ".conv2.bias", ".residual_path.bias",
          ".running_mean")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(tmp: Path, root: Path, encoder: dict) -> dict:
    files = {}
    for name, content in (
            ("config", {"model_base_dir": str(tmp / "unused")}),
            ("data", {"dataset_root": str(root), "name": "synthetic",
                      "num_emg_sessions": 2, "num_emg_channels": 8}),
            ("encoder", {"type": "EMGEncoderTransformer",
                         "params": encoder})):
        files[name] = tmp / f"{name}.yaml"
        files[name].write_text(yaml.safe_dump(content))
    return files


def _argv(files: dict, exp: Path, epochs: int = 2):
    return ["--config", str(files["config"]), "--data", str(files["data"]),
            "--emg_enc_cfg", str(files["encoder"]), "--exp_dir", str(exp),
            "--include_silent", "--num_epochs", str(epochs),
            "--max_batch_len", "3200", "--warmup_steps", "5",
            "--transfer_dtype", "float32", "--device", "cpu",
            "--dist_timeout_s", "90"]


def _two_ranks(files: dict, exp: Path, epochs: int = 2, *more) -> None:
    cmd = [sys.executable, "-m", "ste_gan_torch.train.encoder",
           *_argv(files, exp, epochs), *more, "--dist_init_method",
           f"file://{(exp.parent / (exp.name + '.rendezvous')).resolve()}"]
    run_ranks(cmd, 2, exp.parent / f"{exp.name}_logs", 240, env=RANK_ENV)


def _logged(run: Path) -> dict:
    out = {}
    for line in (run / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if not rec["tag"].startswith("perf/"):
            key = (rec["tag"], rec["step"])
            assert key not in out, f"{key} logged twice"
            out[key] = rec["value"]
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("encoder_dp")
    root = tmp / "mixed"
    generate_synthetic_corpus(root, num_train=10, num_valid=3, num_test=2,
                              num_sessions=2, min_frames=30, max_frames=50,
                              seed=5, silent_fraction=0.4)
    return tmp, root, _files(tmp, root, dict(ENCODER))


@pytest.fixture(scope="module")
def runs(setup):
    tmp, _, files = setup
    tenc.main(tenc.parse_args(_argv(files, tmp / "one")))
    _two_ranks(files, tmp / "two")
    one = next((tmp / "one").iterdir())
    two = next((tmp / "two").iterdir())
    return one, two


def test_logged_losses_match_one_rank(runs):
    one, two = runs
    want, got = _logged(one), _logged(two)
    assert got.keys() == want.keys()
    tags = {tag for tag, _ in want}
    assert {"train/loss", "train_loss/phon_acc", "val/loss",
            "val/phon_acc"} <= tags
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-6,
                                   err_msg=str(key))


def test_weights_and_batch_norm_statistics_match_one_rank(runs):
    one, two = runs
    steps = max(step for tag, step in _logged(one) if tag == "train/loss")
    drift = steps * EC.LEARNING_RATE
    for name in ("last_model.pt", "best_val_loss_model.pt"):
        want = torch.load(one / name, weights_only=True)
        got = torch.load(two / name, weights_only=True)
        assert got.keys() == want.keys()
        assert any("running_var" in k for k in want)
        for key, value in want.items():
            atol = drift if key.endswith(BN_FED) else 1e-5
            np.testing.assert_allclose(got[key].double().numpy(),
                                       value.double().numpy(), rtol=1e-4,
                                       atol=atol, err_msg=f"{name} {key}")


def test_only_rank_zero_writes(runs):
    _, two = runs
    for entry in (".done", "config.yaml", "log.txt", "metrics.jsonl",
                  "best_val_loss_model.pt", "last_model.pt"):
        assert (two / entry).exists(), entry
    # One writer: every (tag, step) once (checked in _logged).
    _logged(two)


def test_an_moe_encoder_over_two_ranks_raises(setup):
    """Over two data ranks an MoE encoder trains (its routing is the global
    batch's; tests/test_torch_expert_parallel.py holds it to one rank);
    pipelined over two stage ranks it raises, as in JAX."""
    tmp, root, _ = setup
    moe = dict(ENCODER, moe_experts=4, moe_top_k=2)
    (tmp / "moe_files").mkdir()
    files = _files(tmp / "moe_files", root, moe)
    with pytest.raises(RuntimeError, match="MoE layers is unsupported"):
        _two_ranks(files, tmp / "moe", 1, "--pipeline_stages", "2")


@pytest.mark.parametrize("flag, module", [
    ("model_parallel", "tensor_parallel.py"),
    ("pipeline_stages", "pipeline_parallel.py"),
    ("pipeline_microbatches", "pipeline_parallel.py")])
def test_what_is_not_ported_raises_naming_its_module(flag, module):
    # model_parallel is ported: at one rank a (1, 2) layout cannot be
    # placed, and the error names the module that lays the ranks out.
    kwargs = dict(data_parallel=-1, model_parallel=1, pipeline_stages=1,
                  pipeline_microbatches=0)
    kwargs[flag] = 2
    with pytest.raises(ValueError, match=module):
        tenc._check_parallel(**kwargs)
    with pytest.raises(ValueError, match="2 rank"):
        tenc._check_parallel(data_parallel=4, model_parallel=1,
                             pipeline_stages=1, size=2)
    tenc._check_parallel(data_parallel=2, model_parallel=1,
                         pipeline_stages=1, size=2)


def test_dropout_rows_are_slices_of_the_global_mask():
    """A rank's dropout draws the global batch's mask and keeps its rows,
    and leaves its generator where one device's would be."""
    x = torch.randn(6, 4, 5)
    whole = dropout(x, 0.3, torch.Generator().manual_seed(7))
    for rank in range(3):
        gen = torch.Generator().manual_seed(7)
        part = dropout(x[2 * rank:2 * rank + 2], 0.3, gen, rows=(rank, 3))
        assert torch.equal(part, whole[2 * rank:2 * rank + 2])
        after = torch.Generator().manual_seed(7)
        torch.rand((6, 4, 5), generator=after)
        assert torch.equal(gen.get_state(), after.get_state())
