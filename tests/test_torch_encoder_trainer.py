"""The port's encoder trainer (``ste_gan_torch/train/encoder.py``) on the CPU
against the JAX package's, on tiny synthetic corpora (voiced, and mixed
with a silent fraction of 0.4), and its CLI's run-dir protocol.

Both trainers start from the JAX trainer's own initial weights (the port's
model factory is patched to load them through ``interop``), with the shift
pinned on both sides and dropout 0, since neither random stream can be
reproduced in the other framework. The logged ``train/loss`` (every step)
and ``val/loss`` (every epoch) over 2 epochs agree within rtol 1e-3, the
repo's model-parity tolerance; the steps they are logged at are equal.
The checkpoints are reference-layout state dicts that the port's GAN
trainer loads strictly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ste_gan_torch import constants as C
from ste_gan_torch import interop
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.models.emg_encoder import init_emg_encoder as t_init
from ste_gan_torch.train import encoder as tenc
from ste_gan_torch.train import gan as tgan
from ste_gan_torch.train.train_gan import load_frozen_encoder
from ste_gan_tpu.config import Config as JConfig
from ste_gan_tpu.models.emg_encoder import init_emg_encoder as j_init
from ste_gan_tpu.train import encoder as jenc

ENCODER = {"model_size": 32, "num_extra_res_blocks": 3,
           "num_transformer_layers": 1, "num_heads": 4,
           "dim_feedforward": 64, "dropout": 0.0}
RUN = dict(max_len=3200, num_epochs=2, warmup_steps=10)
SHIFT = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    out = {}
    for name, fraction in (("voiced", 0.0), ("mixed", 0.4)):
        root = tmp_path_factory.mktemp(name) / "synthetic"
        generate_synthetic_corpus(root, num_train=10, num_valid=3, num_test=2,
                                  num_sessions=2, min_frames=30, max_frames=50,
                                  seed=5, silent_fraction=fraction)
        out[name] = root
    return out


def _cfg(cfg):
    cfg.emg_encoder.params = dict(ENCODER)
    return cfg


def _logged(run_dir, tag):
    out = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["tag"] == tag:
            out[rec["step"]] = rec["value"]
    return out


@pytest.fixture(scope="module", params=["voiced", "mixed"])
def runs(request, corpora, tmp_path_factory):
    mixed = request.param == "mixed"
    root = corpora[request.param]
    tmp = tmp_path_factory.mktemp(f"runs_{request.param}")
    jcfg = _cfg(JConfig())

    # The JAX trainer's initial variables (train_encoder_model's init).
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    jmodel = j_init(jcfg)
    variables = jax.jit(lambda r: jmodel.init(
        r, jnp.zeros((1, 1600, 8)), train=False))(init_rng)

    def port_init(cfg, dtype, generator):
        model = t_init(cfg, dtype, generator)
        interop.load_encoder(model, variables)
        return model

    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(SHIFT, jnp.int32))
    monkeypatch.setattr(tenc, "random_shift", lambda rng: SHIFT)
    monkeypatch.setattr(tenc, "init_emg_encoder", port_init)
    try:
        init = jenc.init_mixed_datasets if mixed else jenc.init_voiced_datasets
        train, dev, _ = init(root)
        jenc.train_encoder_model(jcfg, train, dev, tmp / "jax", **RUN)
        init = tenc.init_mixed_datasets if mixed else tenc.init_voiced_datasets
        train, dev, _ = init(root)
        assert any(m != C.SpeakingMode.NORMAL
                   for m in train.speaking_mode_ids) == mixed
        model, state = tenc.train_encoder_model(
            _cfg(TConfig()), train, dev, tmp / "port", device="cpu", **RUN)
    finally:
        monkeypatch.undo()
    return tmp, model, state


def test_logged_losses_match_the_jax_trainer(runs):
    tmp, _, state = runs
    for tag in ("train/loss", "val/loss"):
        want, got = _logged(tmp / "jax", tag), _logged(tmp / "port", tag)
        assert got.keys() == want.keys() and want, tag
        for step, value in want.items():
            np.testing.assert_allclose(got[step], value, rtol=1e-3,
                                       err_msg=f"{tag} @ {step}")
    assert state.step == max(_logged(tmp / "port", "train/loss"))
    assert set(_logged(tmp / "port", "val/phon_acc")) == set(
        _logged(tmp / "jax", "val/phon_acc"))


def test_checkpoints_load_into_the_gan_trainer(runs):
    tmp, model, _ = runs
    best = tmp / "port" / "best_val_loss_model.pt"
    last = tmp / "port" / "last_model.pt"
    assert best.exists() and last.exists()
    saved = torch.load(last, weights_only=True)
    assert saved.keys() == model.state_dict().keys()
    for key, value in model.state_dict().items():
        assert torch.equal(saved[key], value), key

    cfg = _cfg(TConfig())
    cfg.train.mixed_precision = False
    models = tgan.build_models(cfg, device="cpu")
    load_frozen_encoder(models, best)  # strict
    reference = t_init(cfg, torch.float32, None)
    reference.load_state_dict(torch.load(best, weights_only=True), strict=True)
    emg = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.3, (2, 512, 8)).astype(np.float32))
    for got, want in zip(models.encoder(emg), reference(emg)):
        assert torch.equal(got, want)


def test_cli_run_dir_protocol(corpora, tmp_path):
    files = {}
    for name, content in (
            ("config", {"model_base_dir": str(tmp_path / "unused")}),
            ("data", {"dataset_root": str(corpora["mixed"]),
                      "name": "synthetic", "num_emg_sessions": 2,
                      "num_emg_channels": 8}),
            ("encoder", {"type": "EMGEncoderTransformer",
                         "params": dict(ENCODER)})):
        files[name] = tmp_path / f"{name}.yaml"
        files[name].write_text(yaml.safe_dump(content))
    argv = ["--config", str(files["config"]), "--data", str(files["data"]),
            "--emg_enc_cfg", str(files["encoder"]), "--exp_dir",
            str(tmp_path / "exp"), "--include_silent", "--num_epochs", "1",
            "--max_batch_len", "3200", "--warmup_steps", "5",
            "--transfer_dtype", "float32", "--device", "cpu"]
    tenc.main(tenc.parse_args(argv))
    name = jenc.create_output_dir_name(corpora["mixed"],
                                       "EMGEncoderTransformer_mixed")
    assert name == tenc.create_output_dir_name(
        corpora["mixed"], "EMGEncoderTransformer_mixed")
    run = tmp_path / "exp" / name
    for entry in (".done", "config.yaml", "log.txt", "metrics.jsonl",
                  "best_val_loss_model.pt", "last_model.pt"):
        assert (run / entry).exists(), entry
    tags = {json.loads(line)["tag"]
            for line in (run / "metrics.jsonl").read_text().splitlines()}
    assert {"train/loss", "train_loss/phon_acc", "val/loss", "val/phon_acc",
            "perf/epoch_train_s", "perf/validation_s", "perf/save_s"} <= tags
    assert all(np.isfinite(v) for v in _logged(run, "train/loss").values())
    with pytest.raises(SystemExit):  # a finished run is not run again
        tenc.main(tenc.parse_args(argv))


@pytest.mark.parametrize("flags, match", [
    (["--data_parallel", "2"], "data_parallel"),
    (["--pipeline_microbatches", "4"], "pipeline_microbatches"),
    (["--no-device_resident_data"], "device_resident_data")])
def test_cli_refuses_what_is_not_ported(flags, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        tenc.main(tenc.parse_args(["--exp_dir", str(tmp_path), "--device",
                                   "cpu", *flags]))
    assert not any(tmp_path.iterdir())


def test_one_device_only_and_no_silent_cpu(corpora, tmp_path, monkeypatch):
    train, dev, _ = tenc.init_voiced_datasets(corpora["voiced"])
    for name in ("data_parallel", "model_parallel", "pipeline_stages"):
        with pytest.raises(ValueError, match=name):
            tenc.train_encoder_model(_cfg(TConfig()), train, dev,
                                     tmp_path / name, device="cpu",
                                     **{name: 2})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.train_encoder_model(_cfg(TConfig()), train, dev,
                                 tmp_path / "cuda")
