"""Scale-out synthesis (``EMGSynthesizer(devices=...)``, the JAX package's
``mesh=``) and ``serve --data_parallel`` on the CPU: several replicas of
the generator, the batch padded to a multiple of them with masked rows and
split, against one device, within f32 rounding (rtol 1e-5 / atol 1e-6): each
real row runs the same ops on the same weights and the masked padding
rows are dropped, but a replica's convolutions see another batch size, for
which the CPU library may sum in another order (measured: up to 3e-8).

Cases: a padded batch with per-row valid lengths and a row count the
replicas do not divide, a bucketed batch, streaming, ``convert_dataset``,
``set_params`` reaching every replica, one device named twice, the service
from a run directory over two replicas and a reload there, and the
refusals: more replicas than cards, and an artifact with
``--data_parallel``.
"""
import copy

import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import serve
from ste_gan_torch.config import Config
from ste_gan_torch.data.dataset import EMGDataset
from ste_gan_torch.data.synthetic import generate_synthetic_corpus
from ste_gan_torch.infer import EMGSynthesizer, convert_dataset
from ste_gan_torch.models.generator import EMGGeneratorGanTTS
from ste_gan_torch.serve import SynthesisService


def _close(got, want) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg() -> Config:
    cfg = Config()
    cfg.model.params = {"channels": 32}
    cfg.data.num_emg_sessions = 4
    return cfg


@pytest.fixture(scope="module")
def generator():
    return EMGGeneratorGanTTS(num_sessions=4, channels=32,
                              generator=torch.Generator().manual_seed(3))


def _pair(generator, n=2, bucket=1):
    one = EMGSynthesizer(copy.deepcopy(generator), bucket=bucket,
                         device="cpu")
    many = EMGSynthesizer(copy.deepcopy(generator), bucket=bucket,
                          devices=["cpu"] * n)
    assert len(many.replicas) == n and many.device == torch.device("cpu")
    assert len({id(r) for r in many.replicas}) == n
    return one, many


@pytest.mark.parametrize("rows, n", [(5, 2), (4, 2), (7, 3), (1, 2)])
def test_padded_rows_split_over_replicas_equal_one_device(generator, rows, n):
    one, many = _pair(generator, n)
    rng = np.random.default_rng(rows)
    feats = rng.normal(size=(rows, 40, 256)).astype(np.float32)
    sess = rng.integers(0, 4, rows)
    mode = np.zeros(rows, np.int64)
    valid = rng.integers(10, 41, rows)
    want = one.synthesize_padded(feats, sess, mode, valid)
    got = many.synthesize_padded(feats, sess, mode, valid)
    assert got.shape == want.shape == (rows, 640, 8)
    _close(got, want)


def test_bucketed_batch_equals_one_device(generator):
    one, many = _pair(generator, 3, bucket=16)
    feats = np.random.default_rng(1).normal(size=(4, 37, 256)).astype(
        np.float32)
    want = one.synthesize_batch(feats, [0, 1, 2, 3])
    got = many.synthesize_batch(feats, [0, 1, 2, 3])
    assert got.shape == want.shape == (4, 37 * 16, 8)
    _close(got, want)


def test_streaming_equals_one_device(generator):
    one, many = _pair(generator)
    feats = np.random.default_rng(2).normal(size=(90, 256)).astype(
        np.float32)
    want = list(one.synthesize_streaming(feats, 1, chunk_frames=32,
                                         context_frames=16))
    got = list(many.synthesize_streaming(feats, 1, chunk_frames=32,
                                         context_frames=16))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _close(g, w)


def test_convert_dataset_equals_one_device(generator, tmp_path):
    root = tmp_path / "corpus"
    generate_synthetic_corpus(root, num_train=4, num_valid=2, num_test=5,
                              num_sessions=4, min_frames=20, max_frames=60,
                              seed=4)
    train = EMGDataset(root, partition="train")
    test = EMGDataset(root, partition="test",
                      session_id_to_idx=train.session_id_to_idx,
                      speaking_mode_id_to_idx=train.speaking_mode_id_to_idx)
    one, many = _pair(generator, 2)
    want = convert_dataset(one, test, bucket=16, max_batch=3)
    got = convert_dataset(many, test, bucket=16, max_batch=3)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g[C.DataType.UTT_ID] == w[C.DataType.UTT_ID]
        _close(g[C.DataType.FAKE_EMG], w[C.DataType.FAKE_EMG])


def test_set_params_reaches_every_replica(generator):
    one, many = _pair(generator, 3)
    halved = {k: v * 0.5 for k, v in generator.state_dict().items()}
    one.set_params(halved)
    many.set_params(halved)
    for replica in many.replicas:
        for key, value in replica.state_dict().items():
            assert torch.equal(value, halved[key]), key
    feats = np.random.default_rng(5).normal(size=(3, 20, 256)).astype(
        np.float32)
    _close(many.synthesize_batch(feats, [0, 1, 2]),
           one.synthesize_batch(feats, [0, 1, 2]))


def test_service_over_two_replicas_from_a_run_directory(generator,
                                                         monkeypatch):
    """``from_run_dir(data_parallel=2)`` (the loader replaced by the
    weights) serves what one device serves, and a reload keeps both
    replicas."""
    monkeypatch.setattr(serve, "load_served_generator",
                        lambda run_dir, tag, device: (
                            _cfg(), torch.float32, generator.state_dict()))
    service = SynthesisService.from_run_dir("unused", data_parallel=2,
                                            device="cpu", bucket=16,
                                            max_wait_ms=1.0)
    try:
        assert len(service.synthesizer.replicas) == 2
        feats = np.random.default_rng(6).normal(size=(21, 256)).astype(
            np.float32)
        want = EMGSynthesizer(copy.deepcopy(generator), bucket=16,
                              device="cpu").synthesize(feats, 2)
        _close(service.synthesize(feats, 2), want)
        service.reload()
        assert service.synthesizer.devices == [torch.device("cpu")] * 2
        _close(service.synthesize(feats, 2), want)
    finally:
        service.close()


def test_data_parallel_beyond_the_cards_present_raises(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 card"):
        serve.serving_devices(2, "cuda")
    assert serve.serving_devices(1, "cuda") is None
    assert serve.serving_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="only 1 card"):
        serve.main(["--run_dir", str(tmp_path), "--data_parallel", "2"])
    with pytest.raises(SystemExit, match="checkpoint mode"):
        serve.main(["--artifact", str(tmp_path / "x.pt2"),
                    "--data_parallel", "2", "--device", "cpu"])
