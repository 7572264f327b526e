"""The port's offline evaluation CLI (``ste_gan_torch/evaluate.py``) against
the JAX package's (``ste_gan_tpu/evaluate.py``) on the CPU.

One JAX tiny run directory and one port tiny run directory hold the same
JAX train state (its EMA weights scaled so that they differ from the live
ones): the JAX one an Orbax checkpoint, the port one
``interop.train_state_from_jax`` saved by the port's ``CheckpointManager``,
each with ``config.yaml`` and the vocabulary JSONs; the frozen encoder is one
JAX variable tree, saved as Orbax for JAX and as a reference-layout ``.pt``
for the port. Tolerance: rtol 1e-3 / atol 2e-5 (tests/test_model_parity.py);
phone counters, frame counts and confusion matrices are integers and equal.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ste_gan_torch import constants as C
from ste_gan_torch import evaluate as tev
from ste_gan_torch import interop
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.data.dataset import EMGDataset as TDataset
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.train import gan as tgan
from ste_gan_torch.train.checkpoint import CheckpointManager as TCkpt
from ste_gan_tpu import evaluate as jev
from ste_gan_tpu.config import Config as JConfig
from ste_gan_tpu.config import load_config as j_load_config
from ste_gan_tpu.models.emg_encoder import init_emg_encoder as j_init_encoder
from ste_gan_tpu.train import gan as jgan
from ste_gan_tpu.train.checkpoint import CheckpointManager as JCkpt
from ste_gan_tpu.train.checkpoint import save_pytree as j_save_pytree

TOL = dict(rtol=1e-3, atol=2e-5)
ENCODER = {"model_size": 32, "num_extra_res_blocks": 3,
           "num_transformer_layers": 1, "num_heads": 4, "dim_feedforward": 64,
           "dropout": 0.0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cfg(cfg, corpus):
    """The tiny configuration of tests/test_evaluate.py (either package's
    Config), with the generator EMA on."""
    cfg.data.dataset_root = str(corpus)
    cfg.data.num_emg_sessions = 3
    cfg.train.chunk_size = 512
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.model.params = {"channels": 32}
    cfg.model.discriminator_params = {"num_multi_pool": 1,
                                      "num_multi_scale": 1}
    cfg.emg_encoder.params = dict(ENCODER)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"corpus", "jax": (run_dir, encoder), "port": (run_dir,
    encoder.pt)}``: the two tiny run directories of one JAX state."""
    tmp = tmp_path_factory.mktemp("runs")
    corpus = generate_synthetic_corpus(
        tmp / "corpus", num_train=6, num_valid=5, num_test=2, num_sessions=3,
        min_frames=34, max_frames=60, seed=0)
    jcfg = tiny_cfg(JConfig(), corpus)
    jmodels = jgan.build_models(jcfg)
    jstate = jgan.init_state(jcfg, jmodels, jax.random.PRNGKey(0))
    jstate = jstate.replace(gen_ema=jax.tree.map(lambda x: 0.9 * x,
                                                 jstate.gen_ema))
    enc_vars = jax.jit(lambda r: jmodels.encoder.init(
        r, jnp.zeros((1, 512, 8)), train=False))(jax.random.PRNGKey(1))

    jrun = tmp / "jax_run"
    JCkpt(jrun).save("best", jstate, epoch=0, block=True)
    jcfg.save(jrun / "config.yaml")
    j_save_pytree(tmp / "jax_encoder", enc_vars)

    tcfg = tiny_cfg(TConfig(), corpus)
    models = tgan.build_models(tcfg, device="cpu")
    state = tgan.init_state(tcfg, models)
    interop.train_state_from_jax(jstate, models, state)
    prun = tmp / "port_run"
    TCkpt(prun).save("best", tgan.state_tree(models, state))
    tcfg.save(prun / "config.yaml")
    torch.save(interop.to_torch(interop.encoder_variables_to_state_dict(
        enc_vars)), tmp / "encoder.pt")

    train = TDataset(corpus, "train", train_emg_length=512)
    for run in (jrun, prun):
        train.save_session_and_speaking_mode_mapping_json(run)
    return {"corpus": corpus, "jax": (jrun, tmp / "jax_encoder"),
            "port": (prun, tmp / "encoder.pt")}


@pytest.fixture(scope="module")
def gan_reports(runs):
    """Both packages' ``evaluate_gan`` with the full-utterance round trip."""
    kw = dict(partition="valid", full=True, bucket_frames=16)
    return (jev.evaluate_gan(*runs["jax"], **kw),
            tev.evaluate_gan(*runs["port"], device="cpu", **kw))


def test_evaluate_gan_chunked_matches_jax(gan_reports):
    want, got = (r["chunked"] for r in gan_reports)
    assert got.keys() == want.keys()
    assert got["num_batches"] == want["num_batches"] == 2
    for key in tgan.VAL_KEYS:
        np.testing.assert_allclose(got[key], want[key], **TOL, err_msg=key)
    # The accuracies are ratios of the phone counters.
    for key in ("val/phoneme_accuracy_avg", "val/phoneme_accuracy_avg_no_sil"):
        assert got[key] == want[key], key


def test_evaluate_gan_full_matches_jax(gan_reports):
    want, got = (r["full_utterance"] for r in gan_reports)
    assert got.keys() == want.keys()
    assert got["num_utterances"] == want["num_utterances"] == 5
    assert got["total_frames"] == want["total_frames"]
    assert ([u["utt"] for u in got["per_utterance"]]
            == [u["utt"] for u in want["per_utterance"]])
    np.testing.assert_allclose(got["su_l1"], want["su_l1"], **TOL)
    # Random weights give no argmax tie within the tolerance here: every
    # frame takes the same phoneme in both packages.
    assert got["confusion"] == want["confusion"]
    assert got["phoneme_accuracy"] == want["phoneme_accuracy"]
    assert got["top_confusions"] == want["top_confusions"]
    conf = np.asarray(got["confusion"])
    assert conf.sum() == got["total_frames"]
    assert abs(np.trace(conf) / conf.sum() - got["phoneme_accuracy"]) < 1e-12


def test_evaluate_gan_uses_the_ema_weights(runs, gan_reports):
    """The chunked metrics are those of the EMA weights, not the live
    ones."""
    from ste_gan_torch.train.train_gan import load_frozen_encoder

    prun, enc = runs["port"]
    cfg, models, state = tgan.load_trained_state(prun, "best", device="cpu")
    load_frozen_encoder(models, enc)
    dataset = TDataset(runs["corpus"], "valid",
                       session_id_to_idx=tev._vocab_from_run_dir(prun)[0],
                       speaking_mode_id_to_idx=tev._vocab_from_run_dir(prun)[1],
                       train_emg_length=512)
    state.gen_ema = None  # evaluate the live weights instead
    live = tev.evaluate_gan_chunked(cfg, models, state, dataset)
    ema = gan_reports[1]["chunked"]
    assert live["val/speech_unit"] != ema["val/speech_unit"]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """A mixed corpus (silent fraction 0.4; the valid split holds silent
    utterances), the encoder YAML, and one JAX encoder saved both ways."""
    tmp = tmp_path_factory.mktemp("mixed")
    corpus = generate_synthetic_corpus(
        tmp / "corpus", num_train=8, num_valid=5, num_test=2, num_sessions=2,
        min_frames=30, max_frames=60, seed=3, silent_fraction=0.4)
    yaml_path = tmp / "enc.yaml"
    yaml_path.write_text(yaml.safe_dump({"type": "EMGEncoderTransformer",
                                         "params": dict(ENCODER)}))
    model = j_init_encoder(j_load_config(emg_enc_cfg=str(yaml_path)))
    variables = jax.jit(lambda r: model.init(
        r, jnp.zeros((1, 1600, 8)), train=False))(jax.random.PRNGKey(2))
    j_save_pytree(tmp / "enc", variables)
    torch.save(interop.to_torch(interop.encoder_variables_to_state_dict(
        variables)), tmp / "enc.pt")
    return corpus, yaml_path, tmp / "enc", tmp / "enc.pt"


@pytest.mark.parametrize("include_silent", [False, True])
def test_evaluate_encoder_matches_jax(mixed, include_silent):
    corpus, yaml_path, jckpt, tckpt = mixed
    kw = dict(emg_enc_cfg=str(yaml_path), partition="valid",
              include_silent=include_silent, batch_size=2)
    want = jev.evaluate_encoder(jckpt, corpus, **kw)
    got = tev.evaluate_encoder(tckpt, corpus, device="cpu", **kw)
    assert got.keys() == want.keys()
    n_silent = sum(u.endswith(C.SpeakingMode.SILENT) for u in TDataset(
        corpus, "valid", only_include_voiced=False,
        filter_by_length=False).utt_ids)
    assert n_silent > 0
    assert got["num_utterances"] == want["num_utterances"] == (
        5 if include_silent else 5 - n_silent)
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    assert got["confusion"] == want["confusion"]
    assert got["phoneme_accuracy"] == want["phoneme_accuracy"]
    assert got["top_confusions"] == want["top_confusions"]


def test_top_confusions_labeling():
    conf = np.zeros((C.NUM_PHONEMES, C.NUM_PHONEMES), np.int64)
    conf[3, 5] = 7
    conf[2, 2] = 100  # diagonal: excluded
    conf[1, 0] = 4
    top = tev.top_confusions(conf, k=5)
    assert top == jev.top_confusions(conf, k=5)
    assert top[0] == {"predicted": C.PHONEME_INVENTORY[3],
                      "target": C.PHONEME_INVENTORY[5], "count": 7}
    assert [t["count"] for t in top] == [7, 4]


def _keys(tree):
    """Every key path of a report (list entries by their first item)."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" for k, v in tree.items() for p in _keys(v)} | {
            str(k) for k in tree}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return _keys(tree[0])
    return set()


def test_cli_writes_the_jax_reports_layout(runs, gan_reports, tmp_path):
    prun, enc = runs["port"]
    report = tev.main(["gan", "--run_dir", str(prun), "--emg_enc_ckpt",
                       str(enc), "--bucket_frames", "16", "--full",
                       "--device", "cpu"])
    on_disk = json.loads((prun / "eval_valid.json").read_text())
    assert on_disk == json.loads(json.dumps(report))
    want = json.loads(json.dumps(gan_reports[0]))
    assert _keys(on_disk) == _keys(want)
    for key in ("mode", "tag", "partition"):
        assert on_disk[key] == want[key]
    assert on_disk["chunked"] == json.loads(json.dumps(gan_reports[1]))[
        "chunked"]
