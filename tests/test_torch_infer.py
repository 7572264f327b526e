"""The port's synthesis layer (``ste_gan_torch/infer.py``, the generator's
valid-length masks, ``generate_emg``) against the JAX package on the CPU.

Weights are made by JAX from a seed and carried across by
``ste_gan_torch.interop``; inputs are numpy-seeded. Tolerances: the model
tolerance of tests/test_model_parity.py (rtol 1e-3, atol 2e-5) between the
packages; within the port, the JAX package's own tests' tolerances
(bucketed vs exact 1e-5, streaming interiors vs the full utterance 2e-4).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ste_gan_torch import constants as C
from ste_gan_torch import generate_emg, interop
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.data.dataset import EMGDataset as TDataset
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.infer import EMGSynthesizer, convert_dataset
from ste_gan_torch.models.generator import EMGGeneratorGanTTS
from ste_gan_torch.train import gan as tgan
from ste_gan_torch.train.checkpoint import CheckpointManager
from ste_gan_tpu import infer as jinfer
from ste_gan_tpu.data.dataset import EMGDataset as JDataset
from ste_gan_tpu.models import generator as jgen

TOL = dict(rtol=1e-3, atol=2e-5)
FEATURES = {"units": (C.DataType.SPEECH_UNITS, C.SPEECH_UNITS_FEAT_SIZE, 16),
            "mfccs": (C.DataType.MFCCS, C.NUM_MFCCS, 8)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gens():
    """Per feature type: the JAX module, its params (seeded) and the port's
    generator holding the same weights."""
    out = {}
    for seed, (name, (ft, dim, _)) in enumerate(FEATURES.items()):
        jm = jgen.EMGGeneratorGanTTS(speech_feature_type=ft,
                                     speech_input_dim=dim, num_sessions=4,
                                     channels=32)
        ids = jnp.zeros((1,), jnp.int32)
        params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, dim)),
                         ids, ids)["params"]
        tm = EMGGeneratorGanTTS(speech_feature_type=ft, speech_input_dim=dim,
                                num_sessions=4, channels=32)
        interop.load_generator(tm, params, ft)
        out[name] = (jm, params, tm.eval())
    return out


def _port_synth(gens, name, bucket=1):
    _, params, _ = gens[name]
    ft, dim, _ = FEATURES[name]
    tm = EMGGeneratorGanTTS(speech_feature_type=ft, speech_input_dim=dim,
                            num_sessions=4, channels=32)
    interop.load_generator(tm, params, ft)
    return EMGSynthesizer(tm, bucket=bucket, device="cpu")


def _run_port(tm, feats, sess, mode, **masks):
    with torch.no_grad():
        return tm(torch.from_numpy(feats), torch.from_numpy(sess),
                  torch.from_numpy(mode), **masks).numpy()


@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("name", list(FEATURES))
def test_masked_generator_matches_jax(gens, name, per_row):
    jm, params, tm = gens[name]
    _, dim, factor = FEATURES[name]
    rng = np.random.default_rng(1)
    b, t = 3, 24
    feats = rng.normal(size=(b, t, dim)).astype(np.float32)
    sess = np.array([0, 3, 1], np.int32)
    mode = np.zeros((b,), np.int32)
    if per_row:
        valid = np.array([24, 17, 9], np.int32)
        start = np.array([0, 3, 5], np.int32)
        masks = {"num_valid_frames": torch.from_numpy(valid),
                 "valid_start_frames": torch.from_numpy(start)}
    else:
        valid, start = 19, 2
        masks = {"num_valid_frames": valid, "valid_start_frames": start}
    want = np.asarray(jm.apply({"params": params}, feats, sess, mode,
                               num_valid_frames=valid,
                               valid_start_frames=start))
    got = _run_port(tm, feats, sess, mode, **masks)
    assert got.shape == want.shape == (b, factor * t, 8)
    np.testing.assert_allclose(got, want, **TOL)
    # Outside the valid span the output is tanh(0) = 0 exactly.
    end = factor * np.broadcast_to(valid, (b,))
    lo = factor * np.broadcast_to(start, (b,))
    for row in range(b):
        assert not got[row, end[row]:].any()
        assert not got[row, :lo[row]].any()


def _forward_without_masks(tm, feats, sess, mode):
    """The generator's forward as it was before the valid-length masks: the
    unmasked path must run these ops and give these bits."""
    x = feats.to(tm.dtype)
    b, t, _ = x.shape
    parts = [x]
    emb = tm.session_embeddings(sess).to(tm.dtype)
    parts.append(emb[:, None, :].expand(b, t, emb.shape[-1]))
    x = torch.cat(parts, dim=-1).transpose(1, 2)
    for block in tm.gblocks:
        if hasattr(block, "_names"):
            a, bb, r = block._names
            up = block.upsample
            h = torch.repeat_interleave(F.relu(x), up, dim=-1) if up > 1 \
                else F.relu(x)
            h = block.conv1[a](h)
            h = block.conv1[bb](F.relu(h))
            res_in = torch.repeat_interleave(x, up, dim=-1) if up > 1 else x
            y = h + block.res1[r](res_in)
            h2 = block.conv2["1"](F.relu(y))
            h2 = block.conv2["3"](F.relu(h2))
            x = y + h2
        else:
            x = block(x)
    x = tm.last_conv["1"](F.relu(x))
    return torch.tanh(x.float()).transpose(1, 2)


@pytest.mark.parametrize("name", list(FEATURES))
def test_unmasked_forward_is_unchanged(gens, name):
    _, _, tm = gens[name]
    _, dim, _ = FEATURES[name]
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.normal(size=(2, 20, dim)).astype(np.float32))
    sess = torch.tensor([1, 2])
    mode = torch.zeros(2, dtype=torch.long)
    with torch.no_grad():
        got = tm(feats, sess, mode)
        want = _forward_without_masks(tm, feats, sess, mode)
        # A mask over the whole length changes no bit either.
        full = tm(feats, sess, mode, num_valid_frames=20,
                  valid_start_frames=0)
    assert torch.equal(got, want)
    assert torch.equal(full, want)


def test_bucketing_is_exact(gens):
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(40, 256)).astype(np.float32)
    exact = _port_synth(gens, "units", bucket=1).synthesize(feats, 0)
    bucketed = _port_synth(gens, "units", bucket=64).synthesize(feats, 0)
    assert exact.shape == bucketed.shape == (40 * 16, 8)
    np.testing.assert_allclose(bucketed, exact, atol=1e-5, rtol=0)
    jm, params, _ = gens["units"]
    want = jinfer.EMGSynthesizer(jm, params, bucket=64).synthesize(feats, 0)
    np.testing.assert_allclose(bucketed, want, **TOL)


def test_synthesize_padded_rows_match_jax(gens):
    jm, params, _ = gens["units"]
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(4, 48, 256)).astype(np.float32)
    sess = np.array([0, 1, 2, 3], np.int32)
    mode = np.zeros((4,), np.int32)
    valid = np.array([48, 40, 17, 1], np.int32)
    got = _port_synth(gens, "units").synthesize_padded(
        feats, sess, mode, valid).numpy()
    want = np.asarray(jinfer.EMGSynthesizer(jm, params).synthesize_padded(
        jnp.asarray(feats), jnp.asarray(sess), jnp.asarray(mode),
        jnp.asarray(valid)))
    assert got.shape == want.shape == (4, 48 * 16, 8)
    for row, n in enumerate(valid):
        np.testing.assert_allclose(got[row, :16 * n], want[row, :16 * n],
                                   **TOL)


@pytest.mark.parametrize("name", list(FEATURES))
def test_streaming_interiors_equal_the_full_utterance(gens, name):
    _, dim, factor = FEATURES[name]
    synth = _port_synth(gens, name)
    assert synth.upsample == factor
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(300, dim)).astype(np.float32)
    full = synth.synthesize(feats, session_idx=1)
    chunks = list(synth.synthesize_streaming(feats, session_idx=1,
                                             chunk_frames=64))
    assert [len(c) for c in chunks] == [64 * factor] * 4 + [44 * factor]
    streamed = np.concatenate(chunks, axis=0)
    assert streamed.shape == full.shape == (300 * factor, 8)
    np.testing.assert_allclose(streamed, full, atol=2e-4, rtol=0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    generate_synthetic_corpus(root, num_train=6, num_valid=2, num_test=5,
                              num_sessions=3, min_frames=40, max_frames=140,
                              seed=0)
    return root


def test_convert_dataset_matches_jax(gens, corpus):
    jm, params, _ = gens["units"]
    datasets = {}
    for name, cls in (("port", TDataset), ("jax", JDataset)):
        train = cls(corpus, "train", filter_by_length=False)
        datasets[name] = cls(
            corpus, "test", filter_by_length=False,
            session_id_to_idx=train.session_id_to_idx,
            speaking_mode_id_to_idx=train.speaking_mode_id_to_idx)
    assert len({s for s in datasets["port"].session_ids}) == 3
    got = convert_dataset(_port_synth(gens, "units"), datasets["port"],
                          bucket=64, max_batch=2)
    want = jinfer.convert_dataset(jinfer.EMGSynthesizer(jm, params),
                                  datasets["jax"], bucket=64, max_batch=2)
    assert len(got) == len(want) == 5
    for g, w, idx in zip(got, want, range(5)):
        assert g[C.DataType.UTT_ID] == w[C.DataType.UTT_ID]
        assert g[C.DataType.SESSION_ID] == w[C.DataType.SESSION_ID]
        frames = len(datasets["port"][idx][C.DataType.SPEECH_UNITS])
        assert g[C.DataType.FAKE_EMG].shape == (16 * frames, 8)
        np.testing.assert_allclose(g[C.DataType.FAKE_EMG],
                                   np.asarray(w[C.DataType.FAKE_EMG]), **TOL)


def test_set_params_and_real_time_factor(gens):
    synth = _port_synth(gens, "units")
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(24, 256)).astype(np.float32)
    before = synth.synthesize(feats, 0)
    halved = {k: v * 0.5 for k, v in synth.generator.state_dict().items()}
    synth.set_params(halved)
    after = synth.synthesize(feats, 0)
    assert not np.allclose(before, after)
    rtf = synth.real_time_factor(num_frames=50, iters=2)
    assert isinstance(rtf, float) and rtf > 0
    # Scale-out (the JAX package's mesh=): set_params reaches every
    # replica, and two replicas synthesise what one device does.
    two = EMGSynthesizer(copy.deepcopy(synth.generator),
                         devices=["cpu", "cpu"])
    two.set_params(halved)
    np.testing.assert_allclose(two.synthesize(feats, 0), after, rtol=1e-5,
                               atol=1e-6)


def tiny_cfg(corpus) -> TConfig:
    cfg = TConfig()
    cfg.data.dataset_root = str(corpus)
    cfg.data.num_emg_sessions = 3
    cfg.train.chunk_size = 512
    cfg.train.batch_size = 4
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = 0.999
    cfg.model.params = {"channels": 32}
    cfg.model.discriminator_params = {"num_multi_pool": 1,
                                      "num_multi_scale": 1}
    cfg.emg_encoder.params = {"model_size": 32, "num_extra_res_blocks": 3,
                              "num_transformer_layers": 1, "num_heads": 4,
                              "dim_feedforward": 64, "dropout": 0.0}
    return cfg


def test_generate_emg_writes_one_file_per_utterance(corpus, tmp_path):
    run = tmp_path / "run"
    cfg = tiny_cfg(corpus)
    models = tgan.build_models(cfg, device="cpu")
    state = tgan.init_state(cfg, models)
    with torch.no_grad():  # EMA weights that differ from the live ones
        for e in state.gen_ema:
            e.mul_(0.5)
    CheckpointManager(run).save("best", tgan.state_tree(models, state))
    cfg.save(run / "config.yaml")
    TDataset(corpus, "train", filter_by_length=False
             ).save_session_and_speaking_mode_mapping_json(run)

    out = generate_emg.main(["--run_dir", str(run), "--partition", "test",
                             "--device", "cpu"])
    train = TDataset(corpus, "train", filter_by_length=False)
    test = TDataset(corpus, "test", filter_by_length=False,
                    session_id_to_idx=train.session_id_to_idx,
                    speaking_mode_id_to_idx=train.speaking_mode_id_to_idx)
    files = sorted((run / "emg_synth" / "test").glob("*.npy"))
    assert [f.stem for f in files] == sorted(test.utt_ids)
    assert out["num_utterances"] == len(test) and out["rtf"] > 0
    # The files hold the EMA generator's output.
    with tgan.eval_generator_params(models, state) as gen:
        synth = EMGSynthesizer.from_config(cfg, gen.state_dict(),
                                           device="cpu")
    for idx in range(len(test)):
        item = test[idx]
        emg = np.load(run / "emg_synth" / "test" / f"{item[C.DataType.UTT_ID]}.npy")
        want = synth.synthesize(item[C.DataType.SPEECH_UNITS],
                                int(item[C.DataType.SESSION_INDEX]))
        np.testing.assert_allclose(emg, want, atol=1e-5, rtol=0)


def test_envelope_matches_jax():
    from ste_gan_torch.utils.plotting import get_envelope
    from ste_gan_tpu.utils.plotting import get_envelope as j_get_envelope

    emg = np.random.default_rng(9).normal(size=(333, 8)).astype(np.float32)
    for points in (40, 41):
        np.testing.assert_array_equal(get_envelope(emg, points),
                                      j_get_envelope(emg, points))


@pytest.mark.parametrize("has_matplotlib", [True, False])
def test_trainer_plots_samples_with_the_ema_weights(corpus, tmp_path,
                                                    monkeypatch, caplog,
                                                    has_matplotlib):
    """At step 0 the trainer plots the first ``num_test_samples + 1``
    validation utterances, synthesised from the EMA weights; without
    matplotlib it says so once and trains on."""
    import logging

    from ste_gan_torch.train import train_gan as ttrain

    figures = []
    monkeypatch.setattr(ttrain, "matplotlib_available", lambda: has_matplotlib)
    monkeypatch.setattr(ttrain.MetricLogger, "figure",
                        lambda self, tag, fig, step: figures.append((tag,
                                                                     step)))
    synthesized = []
    real_synthesize = EMGSynthesizer.synthesize

    def synthesize(self, *args, **kwargs):
        synthesized.append({k: v.clone() for k, v in
                            self.generator.state_dict().items()})
        return real_synthesize(self, *args, **kwargs)

    monkeypatch.setattr(EMGSynthesizer, "synthesize", synthesize)
    at_plot = []
    real_weights = ttrain.eval_generator_state_dict

    def weights(models, state):
        names = [n for n, _ in models.generator.named_parameters()]
        at_plot.append(({n: p.detach().clone() for n, p in
                         models.generator.named_parameters()},
                        dict(zip(names, (e.clone() for e in state.gen_ema)))))
        return real_weights(models, state)

    monkeypatch.setattr(ttrain, "eval_generator_state_dict", weights)

    caplog.set_level(logging.INFO)
    cfg = tiny_cfg(corpus)
    cfg.train.max_steps = 1
    cfg.train.interval_sample = 10_000
    cfg.train.num_test_samples = 0
    ttrain.train(cfg, tmp_path / "run", resume=False, debug=False,
                 device="cpu")
    skipped = [m for m in caplog.messages if "sample plots are skipped" in m]
    if not has_matplotlib:
        assert not figures and not synthesized and len(skipped) == 1
        return
    assert figures == [("val/envelopes_emg_real_vs_fake_Validation sample 0",
                        0)] and not skipped
    # The plotted generator held the EMA weights, not the live ones.
    live, ema = at_plot[0]
    for key, value in ema.items():
        assert torch.equal(synthesized[0][key], value), key
    assert any(not torch.equal(live[k], ema[k]) for k in ema)
