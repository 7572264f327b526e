"""The port's data pipeline against the JAX package's: the synthetic corpus,
the dataset, the loaders, the packed format, and the corpus on the device
(here on the CPU, where its gather runs the same torch ops).

Everything here is exact: the same files, the same items, the same batches,
bit for bit.
"""
import filecmp
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch.data import synthetic as tsynth
from ste_gan_torch.data.collate import ste_gan_collate as t_collate
from ste_gan_torch.data.dataset import EMGDataset as TDataset
from ste_gan_torch.data.device_corpus import DeviceCorpus as TCorpus
from ste_gan_torch.data.device_corpus import IndexLoader as TIndexLoader
from ste_gan_torch.data.loader import DataLoader as TLoader
from ste_gan_torch.data.loader import Prefetcher as TPrefetcher
from ste_gan_torch.data.loader import loaders as t_loaders
from ste_gan_torch.data.loader import to_device
from ste_gan_torch.data.packed import pack_split as t_pack_split
from ste_gan_tpu.data import synthetic as jsynth
from ste_gan_tpu.data.dataset import EMGDataset as JDataset
from ste_gan_tpu.data.device_corpus import DeviceCorpus as JCorpus
from ste_gan_tpu.data.device_corpus import IndexLoader as JIndexLoader
from ste_gan_tpu.data.loader import DataLoader as JLoader
from ste_gan_tpu.data.loader import loaders as j_loaders
from ste_gan_tpu.data.packed import pack_split as j_pack_split

CHUNK = 512  # 32 speech-unit frames
CORPUS = dict(num_train=8, num_valid=3, num_test=2, num_sessions=3,
              min_frames=34, max_frames=48, seed=0)
BATCH_KEYS = (C.DataType.REAL_EMG, C.DataType.SPEECH_UNITS,
              C.DataType.PHONEMES, C.DataType.SESSION_INDEX,
              C.DataType.SPEAKING_MODE_INDEX, C.DataType.MFCCS)


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
    jsynth.generate_synthetic_corpus(root, **CORPUS)
    return root


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only,
                                                      cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for sub in cmp.common_dirs:
        _same_tree(a / sub, b / sub)


@pytest.mark.parametrize("hard", [False, True])
def test_synthetic_corpus_is_byte_identical(tmp_path, hard):
    kw = dict(CORPUS, seed=5, silent_fraction=0.3, hard=hard)
    jsynth.generate_synthetic_corpus(tmp_path / "jax", **kw)
    tsynth.generate_synthetic_corpus(tmp_path / "port", **kw)
    _same_tree(tmp_path / "jax", tmp_path / "port")


def test_synthetic_cli_matches_the_generator(tmp_path):
    (tmp_path / "cli" / "stale").mkdir(parents=True)  # regeneration is clean
    tsynth.main(["--root", str(tmp_path / "cli"), "--num_train", "4",
                 "--num_valid", "2", "--num_test", "1", "--seed", "3"])
    jsynth.generate_synthetic_corpus(tmp_path / "jax", num_train=4,
                                     num_valid=2, num_test=1, seed=3)
    _same_tree(tmp_path / "cli", tmp_path / "jax")


def _assert_items_equal(jds, tds):
    assert tds.utt_ids == jds.utt_ids
    assert tds.emg_lengths == jds.emg_lengths
    assert tds.transcripts == jds.transcripts
    assert tds.session_id_to_idx == jds.session_id_to_idx
    assert tds.speaking_mode_id_to_idx == jds.speaking_mode_id_to_idx
    assert tds.num_emg_channels == jds.num_emg_channels
    for i in range(len(jds)):
        ji, ti = jds[i], tds[i]
        assert set(ji) == set(ti)
        for key, want in ji.items():
            got = ti[key]
            if isinstance(want, np.ndarray) or isinstance(want, np.generic):
                assert got.dtype == want.dtype, key
                np.testing.assert_array_equal(got, want, err_msg=f"{key} {i}")
            else:
                assert got == want, key


@pytest.mark.parametrize("partition", ["train", "valid", "test"])
def test_dataset_items_and_vocabularies(corpus, partition, tmp_path):
    train_kw = dict(train_emg_length=CHUNK)
    jtrain = JDataset(corpus, "train", **train_kw)
    ttrain = TDataset(corpus, "train", **train_kw)
    kw = dict(session_id_to_idx=jtrain.session_id_to_idx,
              speaking_mode_id_to_idx=jtrain.speaking_mode_id_to_idx,
              filter_by_length=partition != "test", **train_kw)
    _assert_items_equal(JDataset(corpus, partition, **kw),
                        TDataset(corpus, partition, **kw))
    for name, ds in (("j", jtrain), ("t", ttrain)):
        (tmp_path / name).mkdir()
        ds.save_session_and_speaking_mode_mapping_json(tmp_path / name)
    _same_tree(tmp_path / "j", tmp_path / "t")


def test_overlap_check_and_undersized_train_split(corpus):
    a = TDataset(corpus, "train", train_emg_length=CHUNK)
    with pytest.raises(ValueError, match="Intersecting"):
        TDataset.check_no_data_overlap([a, a])
    with pytest.raises(ValueError, match="ste_gan_torch.data.synthetic"):
        t_loaders(corpus, train_emg_length=CHUNK, batch_size=64)


def _assert_batches_equal(jb, tb):
    assert set(jb) == set(tb)
    for key, want in jb.items():
        if want is None:
            assert tb[key] is None, key
        else:
            assert tb[key].dtype == want.dtype, key
            np.testing.assert_array_equal(tb[key], want, err_msg=key)


def test_loader_batches_over_two_epochs(corpus):
    kw = dict(train_emg_length=CHUNK, batch_size=3, seed=4)
    jl = j_loaders(corpus, process_index=0, process_count=1, **kw)
    tl = t_loaders(corpus, **kw)
    for jloader, tloader in zip(jl, tl):
        assert len(tloader) == len(jloader)
        for _ in range(2):
            n = 0
            for jb, tb in zip(jloader, tloader):
                _assert_batches_equal(jb, tb)
                n += 1
            assert n == len(jloader)


def test_process_slices_match(corpus):
    ds = TDataset(corpus, "train", train_emg_length=CHUNK)
    jds = JDataset(corpus, "train", train_emg_length=CHUNK)
    for rank in range(2):
        kw = dict(batch_size=4, partition="train", shuffle=True,
                  emg_train_length=CHUNK, seed=2, drop_last=True,
                  process_index=rank, process_count=2)
        for jb, tb in zip(JLoader(jds, **kw), TLoader(ds, **kw)):
            _assert_batches_equal(jb, tb)
    with pytest.raises(ValueError):
        TLoader(ds, 4, "train", True, CHUNK, process_index=2, process_count=2,
                drop_last=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_device_corpus_gather_equals_collate(corpus, dtype):
    ds = TDataset(corpus, "train", train_emg_length=CHUNK)
    dc = TCorpus.from_dataset(ds, emg_train_length=CHUNK, device="cpu",
                              float_dtype=dtype)
    rng = np.random.default_rng(7)
    rows = rng.integers(0, len(ds), size=6)
    rows[0], rows[1] = 0, len(ds) - 1
    starts = np.asarray([rng.integers(0, 1 + dc.unit_lengths[r] - dc.frames)
                         for r in rows])
    starts[0] = 0
    starts[1] = dc.unit_lengths[rows[1]] - dc.frames  # last legal start
    host = t_collate([ds[int(r)] for r in rows], "train",
                     emg_train_length=CHUNK, starts=starts)
    got = dc.gather(torch.from_numpy(rows.astype(np.int32)),
                    torch.from_numpy(starts.astype(np.int32)))
    np_float = np.float16 if dtype == torch.float16 else np.float32
    for key in BATCH_KEYS:
        want = host[key]
        if want.dtype == np.float32:
            want = want.astype(np_float)
        np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)


def test_device_corpus_equals_jax_device_corpus(corpus):
    jds = JDataset(corpus, "train", train_emg_length=CHUNK)
    tds = TDataset(corpus, "train", train_emg_length=CHUNK)
    jdc = JCorpus.from_dataset(jds, emg_train_length=CHUNK)
    tdc = TCorpus.from_dataset(tds, emg_train_length=CHUNK, device="cpu")
    assert tdc.unit_lengths == jdc.unit_lengths
    assert tdc.nbytes == jdc.nbytes
    rows, starts = np.asarray([3, 0, 7]), np.asarray([2, 0, 5])
    jb = jdc.gather(jnp.asarray(rows), jnp.asarray(starts))
    tb = tdc.gather(torch.from_numpy(rows), torch.from_numpy(starts))
    for key in BATCH_KEYS:
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]),
                                      err_msg=key)


def test_index_loader_matches_jax(corpus):
    jds = JDataset(corpus, "train", train_emg_length=CHUNK)
    tds = TDataset(corpus, "train", train_emg_length=CHUNK)
    kw = dict(batch_size=3, partition="train", shuffle=True,
              emg_train_length=CHUNK, seed=11, drop_last=True)
    lengths = [len(tds[i][C.DataType.SPEECH_UNITS]) for i in range(len(tds))]
    jl = JIndexLoader(JLoader(jds, **kw), lengths)
    tl = TIndexLoader(TLoader(tds, **kw), lengths)
    assert len(tl) == len(jl)
    for _ in range(3):  # epoch-seeded starts must track
        for jb, tb in zip(jl, tl):
            for key in ("rows", "starts"):
                assert tb[key].dtype == jb[key].dtype == np.int32
                np.testing.assert_array_equal(tb[key], jb[key])


def test_packed_split_gives_the_same_items(corpus, tmp_path):
    """The port packs byte-identically to the JAX package, and a packed
    split (field directories removed) serves the directory layout's
    items."""
    packed = tmp_path / "packed"
    shutil.copytree(corpus, packed)
    jpacked = tmp_path / "jpacked"
    shutil.copytree(corpus, jpacked)
    for split in ("train", "valid", "test"):
        t_pack_split(packed / split)
        j_pack_split(jpacked / split)
        for name in ("packed.bin", "packed.index.json"):
            assert (packed / split / name).read_bytes() == \
                (jpacked / split / name).read_bytes()
        for sub in (C.DataDir.EMG, C.DataDir.SPEECH_UNITS, C.DataDir.PHONEMES,
                    C.DataDir.MFCCS, C.DataDir.EMG_FEATS,
                    C.DataDir.TRANSCRIPTIONS):
            shutil.rmtree(packed / split / sub)
    for partition in ("train", "valid", "test"):
        kw = dict(train_emg_length=CHUNK,
                  filter_by_length=partition != "test")
        _assert_items_equal(JDataset(corpus, partition, **kw),
                            TDataset(packed, partition, **kw))


def test_to_device_casts_floats_and_drops_none():
    batch = {"a": np.ones((2, 3), np.float32), "b": np.arange(2, dtype=np.int32),
             "c": None}
    out = to_device(batch, torch.device("cpu"), np.float16)
    assert set(out) == {"a", "b"}
    assert out["a"].dtype == torch.float16 and out["b"].dtype == torch.int32
    out = to_device(batch, torch.device("cpu"))
    assert out["a"].dtype == torch.float32


def test_prefetcher_keeps_order_propagates_errors_and_stops_early():
    assert list(TPrefetcher(lambda: iter(range(20)), depth=2)) == list(range(20))

    def failing():
        yield 1
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(TPrefetcher(failing, depth=2))

    before = threading.active_count()
    for i in TPrefetcher(lambda: iter(range(10**9)), depth=2):
        if i == 3:
            break
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
