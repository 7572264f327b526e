"""The port's trainer on the CPU at the tiny size of
``tests/test_train_loop.py``: the run-dir protocol of the CLI, a resume that
equals the uninterrupted run exactly, the device-resident corpus against
the host pipeline, and the logged losses against the JAX trainer's from the
same initial state and frozen encoder (rtol 1e-4, atol 1e-6)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ste_gan_torch import interop
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.config import create_ste_gan_model_name as t_name
from ste_gan_torch.train import gan as tgan
from ste_gan_torch.train import train_gan as ttrain
from ste_gan_torch.train.checkpoint import CheckpointManager as TCkpt
from ste_gan_tpu.config import Config as JConfig
from ste_gan_tpu.config import create_ste_gan_model_name as j_name
from ste_gan_tpu.config import load_config as j_load_config
from ste_gan_tpu.data.synthetic import generate_synthetic_corpus
from ste_gan_tpu.train import gan as jgan
from ste_gan_tpu.train import train_gan as jtrain
from ste_gan_tpu.train.checkpoint import CheckpointManager as JCkpt
from ste_gan_tpu.train.checkpoint import save_pytree as j_save_pytree

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
    """The models here are tiny: one intra-op thread runs them as fast as
    many, and keeps parallel test workers off each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    generate_synthetic_corpus(root, num_train=8, num_valid=2, num_test=2,
                              num_sessions=3, min_frames=34, max_frames=40,
                              seed=0)
    return root


def tiny_cfg(cfg, corpus, max_steps=3):
    """The tiny config of tests/test_train_loop.py (either package's
    Config), with the EMA on and one period and one scale discriminator."""
    cfg.data.dataset_root = str(corpus)
    cfg.data.name = "synthetic"
    cfg.data.num_emg_sessions = 3
    cfg.train.chunk_size = 512
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.train.max_steps = max_steps
    cfg.train.interval_log = 1
    cfg.train.interval_valid = 2
    cfg.train.interval_sample = 10_000
    cfg.train.interval_save = 2
    cfg.train.save_last_epoch_interval = 1
    cfg.train.generator_ema = 0.999
    cfg.train.data_parallel = 1
    cfg.model.params = {"channels": 32}
    cfg.model.discriminator_params = DISC
    cfg.emg_encoder.type = ENCODER["type"]
    cfg.emg_encoder.params = dict(ENCODER["params"])
    return cfg


def _logged(run_dir, prefix):
    """{(tag, step): value} of metrics.jsonl entries whose tag starts with
    ``prefix``."""
    out = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["tag"].startswith(prefix):
            out[(rec["tag"], rec["step"])] = rec["value"]
    return out


def test_cli_run_dir_protocol(corpus, tmp_path):
    cfg = tiny_cfg(TConfig(), corpus)
    cfg.model_base_dir = str(tmp_path / "exp")
    base = cfg.to_dict()
    data = base.pop("data")
    encoder = base.pop("emg_encoder")
    files = {}
    for name, content in (("config", base), ("data", data),
                          ("encoder", encoder)):
        files[name] = tmp_path / f"{name}.yaml"
        files[name].write_text(yaml.safe_dump(content))
    argv = ["--config", str(files["config"]), "--data", str(files["data"]),
            "--emg_enc_cfg", str(files["encoder"]), "--device", "cpu"]
    ttrain.main(ttrain.parse_args(argv))

    jcfg = j_load_config(str(files["config"]), str(files["data"]),
                         str(files["encoder"]))
    name = t_name(cfg, add_timestamp=False)
    assert name == j_name(jcfg, add_timestamp=False)
    run = tmp_path / "exp" / name
    for entry in (".done", "config.yaml", "log.txt", "metrics.jsonl",
                  "session_idx_to_id.json", "speaking_mode_idx_to_id.json",
                  "checkpoint-00000002", "checkpoint-final", "checkpoint-last",
                  "best"):
        assert (run / entry).exists(), entry
    assert TCkpt(run).latest_periodic_tag() == "checkpoint-00000002"
    assert np.isfinite(json.loads((run / "best.meta.json").read_text())[
        "su_error"])
    saved = yaml.safe_load((run / "config.yaml").read_text())
    assert saved == cfg.to_dict()
    logged = _logged(run, "train_loss/")
    assert {s for _, s in logged} == {0, 1, 2, 3}
    assert all(np.isfinite(v) for v in logged.values())
    assert {t for t, _ in _logged(run, "val/")} >= {
        "val/speech_unit", "val/envelope_l1", "val/phoneme_accuracy_avg"}
    with pytest.raises(SystemExit):  # a finished run is not run again
        ttrain.main(ttrain.parse_args(argv))


def test_resume_equals_the_uninterrupted_run(corpus, tmp_path):
    once = tmp_path / "once"
    ttrain.train(tiny_cfg(TConfig(), corpus, max_steps=4), once,
                 resume=False, debug=False, device="cpu")
    twice = tmp_path / "twice"
    ttrain.train(tiny_cfg(TConfig(), corpus, max_steps=2), twice,
                 resume=False, debug=False, device="cpu")
    (twice / ".done").unlink()
    ttrain.train(tiny_cfg(TConfig(), corpus, max_steps=4), twice,
                 resume=True, debug=False, device="cpu")
    assert (twice / ".done").exists()

    # Losses and learning rates; the epoch's running phoneme accuracy
    # restarts with the process, as in the JAX trainer.
    a, b = _logged(once, "train"), _logged(twice, "train")
    for key in ((t, s) for t, s in a if s >= 3 and "accuracy" not in t):
        assert b[key] == a[key], key
    for tag in ("checkpoint-final", "checkpoint-00000004"):
        sa = torch.load(once / tag / "state.pt", weights_only=True)
        sb = torch.load(twice / tag / "state.pt", weights_only=True)
        assert sa["step"] == sb["step"] == 5
        flat_a, flat_b = _flatten(sa), _flatten(sb)
        assert flat_a.keys() == flat_b.keys()
        for key, value in flat_a.items():
            assert torch.equal(flat_b[key], value), (tag, key)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flatten(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flatten(v, f"{prefix}/{i}").items()}
    return {prefix: torch.as_tensor(tree)}


def test_device_resident_corpus_matches_the_host_pipeline(corpus, tmp_path):
    runs = {}
    for resident in (False, True):
        cfg = tiny_cfg(TConfig(), corpus, max_steps=2)
        cfg.train.device_resident_data = resident
        run = tmp_path / f"resident_{resident}"
        ttrain.train(cfg, run, resume=False, debug=False, device="cpu")
        runs[resident] = _logged(run, "train_loss/")
    assert runs[True] == runs[False]


def test_single_device_only_and_no_silent_cpu(corpus, tmp_path, monkeypatch):
    """A tensor- or data-parallel layout that does not fit the ranks
    launched (one here) raises (tensor parallelism over several ranks is
    in tests/test_torch_tp_trainers.py); FSDP runs (its tests are in
    tests/test_torch_trainer_dp.py)."""
    for field, value in (("model_parallel", 2), ("data_parallel", 2)):
        cfg = tiny_cfg(TConfig(), corpus)
        setattr(cfg.train, field, value)
        with pytest.raises(ValueError, match=field):
            ttrain.train(cfg, tmp_path / field, resume=False, debug=False,
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(tiny_cfg(TConfig(), corpus), tmp_path / "cuda",
                     resume=False, debug=False)


def test_logged_losses_match_the_jax_trainer(corpus, tmp_path):
    """Both trainers start from one JAX initial state and one frozen
    encoder: JAX through ``init_checkpoint`` and an Orbax encoder, the port
    through a port checkpoint of ``interop.train_state_from_jax`` and the
    reference-layout encoder ``.pt``. Three steps (indices 0-2) of logged
    train losses, phoneme accuracies and validation metrics agree."""
    jcfg = tiny_cfg(JConfig(), corpus, max_steps=2)
    jmodels = jgan.build_models(jcfg)
    jstate = jgan.init_state(jcfg, jmodels, jax.random.PRNGKey(0))
    enc_vars = jax.jit(lambda r: jmodels.encoder.init(
        r, jnp.zeros((1, 512, 8)), train=False))(jax.random.PRNGKey(1))
    j_save_pytree(tmp_path / "jax_encoder", enc_vars)
    JCkpt(tmp_path / "jax_init").save("checkpoint-00000000", jstate,
                                      epoch=-1, block=True)
    jtrain.train(jcfg, tmp_path / "jax_run", resume=False, debug=False,
                 emg_enc_ckpt=tmp_path / "jax_encoder",
                 init_checkpoint=tmp_path / "jax_init" / "checkpoint-00000000")

    tcfg = tiny_cfg(TConfig(), corpus, max_steps=2)
    models = tgan.build_models(tcfg, device="cpu")
    state = tgan.init_state(tcfg, models)
    interop.train_state_from_jax(jstate, models, state)
    TCkpt(tmp_path / "port_init").save(
        "checkpoint-00000000", tgan.state_tree(models, state), epoch=-1)
    torch.save(interop.to_torch(interop.encoder_variables_to_state_dict(
        enc_vars)), tmp_path / "encoder.pt")
    ttrain.train(tcfg, tmp_path / "port_run", resume=False, debug=False,
                 emg_enc_ckpt=tmp_path / "encoder.pt",
                 init_checkpoint=tmp_path / "port_init" / "checkpoint-00000000",
                 device="cpu")

    for prefix in ("train_loss/", "val/", "train/lr"):
        want = _logged(tmp_path / "jax_run", prefix)
        got = _logged(tmp_path / "port_run", prefix)
        assert got.keys() == want.keys(), prefix
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-6,
                                       err_msg=str(key))
    assert {s for t, s in _logged(tmp_path / "port_run", "train_loss/")} == {
        0, 1, 2}
