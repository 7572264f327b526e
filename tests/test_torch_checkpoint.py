"""The port's checkpoints: exact round trips of the whole train state into
the live tensors, the JAX package's tag/meta/in-flight protocol
(``tests/test_checkpoint.py``), host snapshots for background writes, and
the EMA guard."""
import json

import numpy as np
import pytest
import torch

from ste_gan_torch.config import Config
from ste_gan_torch.train import gan as tgan
from ste_gan_torch.train.checkpoint import (
    CheckpointManager, load_pytree, restore_from_path, save_pytree)

MODEL_KW = dict(
    params={"channels": 16},
    discriminator_params={"num_multi_pool": 1, "num_multi_scale": 1,
                          "period_spec_override": ((8, 3, 1, 2),),
                          "scale_spec_override": ((8, 15, 1, 1, 7),
                                                  (16, 9, 2, 4, 4))})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast as
    many, and keeps parallel test workers off each other's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(ema=0.999) -> Config:
    cfg = Config()
    cfg.train.chunk_size, cfg.train.batch_size = 256, 2
    cfg.train.mixed_precision = False
    cfg.train.generator_ema = ema
    cfg.model.params = MODEL_KW["params"]
    cfg.model.discriminator_params = MODEL_KW["discriminator_params"]
    cfg.data.num_emg_sessions = 3
    cfg.emg_encoder.params = {"model_size": 16, "num_transformer_layers": 1,
                              "num_heads": 2, "dim_feedforward": 32,
                              "dropout": 0.0}
    return cfg


def _setup(ema=0.999, seed=0):
    cfg = _cfg(ema)
    models = tgan.build_models(cfg, seed=seed, device="cpu")
    state = tgan.init_state(cfg, models)
    return cfg, models, state, tgan.make_train_step(cfg, models)


def _trained(steps=2, ema=0.999):
    cfg, models, state, step = _setup(ema)
    for i in range(steps):
        state, _ = step(state, tgan.synthetic_batch(cfg, "cpu", seed=i))
    return cfg, models, state, step


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for key in fa:
        if isinstance(fa[key], torch.Tensor):
            assert torch.equal(fa[key], fb[key]), key
        else:
            assert fa[key] == fb[key], key


def test_round_trip_is_exact_and_in_place(tmp_path):
    _, models, state, _ = _trained()
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in _flat(tgan.state_tree(models, state)).items()}
    ckpt = CheckpointManager(tmp_path / "run")
    ckpt.save("checkpoint-00000002", tgan.state_tree(models, state), epoch=1)

    _, models2, state2, _ = _setup(seed=1)  # other weights, same shapes
    template = tgan.state_tree(models2, state2)
    ptrs = {k: v.data_ptr() for k, v in _flat(template).items()
            if isinstance(v, torch.Tensor)}
    tree, epoch = ckpt.restore("checkpoint-00000002", template)
    state2.step = tree["step"]
    assert epoch == 1 and state2.step == 2
    got = _flat(tgan.state_tree(models2, state2))
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(got[key], value), key
            assert got[key].data_ptr() == ptrs[key], key  # copied, not rebound
        else:
            assert got[key] == value, key
    # The spectral-norm vectors are part of the state.
    assert any(k.endswith("weight_u") for k in got)


def test_step_after_restore_equals_step_without(tmp_path):
    """The optimizer state's parameter and moment lists must still be the
    restored tensors: one more step from the restored state equals one
    more step from the saved one."""
    cfg, models, state, step = _trained()
    ckpt = CheckpointManager(tmp_path)
    ckpt.save("best", tgan.state_tree(models, state), epoch=0)
    _, models2, state2, step2 = _setup(seed=3)
    # The frozen encoder is not part of the train state (as in JAX).
    models2.encoder.load_state_dict(models.encoder.state_dict())
    tree, _ = ckpt.restore("best", tgan.state_tree(models2, state2))
    state2.step = tree["step"]
    batch = tgan.synthetic_batch(cfg, "cpu", seed=9)
    state, m1 = step(state, batch)
    state2, m2 = step2(state2, batch)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    _assert_trees_equal(tgan.state_tree(models, state),
                        tgan.state_tree(models2, state2))


def test_background_save_snapshots_before_returning(tmp_path):
    cfg, models, state, step = _trained(steps=1)
    before = {k: v.clone() for k, v in models.generator.state_dict().items()}
    ckpt = CheckpointManager(tmp_path)
    ckpt.save_periodic(tgan.state_tree(models, state), 1, 0)  # block=False
    state, _ = step(state, tgan.synthetic_batch(cfg, "cpu", seed=5))
    ckpt.wait_until_finished()
    saved = torch.load(tmp_path / "checkpoint-00000001" / "state.pt",
                       weights_only=True)
    assert saved["step"] == 1
    changed = 0
    for k, v in before.items():
        assert torch.equal(saved["generator"][k], v), k
        changed += not torch.equal(models.generator.state_dict()[k], v)
    assert changed  # the later step did move the live weights


def test_tags_meta_best_and_latest(tmp_path):
    _, models, state, _ = _trained(steps=1)
    ckpt = CheckpointManager(tmp_path)
    assert ckpt.latest_periodic_tag() is None
    assert ckpt.restore_latest(tgan.state_tree(models, state)) is None
    assert ckpt.best_su_error() == float("inf")
    tree = tgan.state_tree(models, state)
    ckpt.save_final(tree, epoch=4)
    assert ckpt.latest_periodic_tag() == "checkpoint-final"
    ckpt.save_last(tree, epoch=4)
    ckpt.wait_until_finished()
    assert ckpt.latest_periodic_tag() == "checkpoint-last"
    ckpt.save_periodic(tree, 3, 1)
    ckpt.save_periodic(tree, 12, 2)
    ckpt.save_best(tree, epoch=2, su_error=1.25)
    ckpt.wait_until_finished()
    assert ckpt.latest_periodic_tag() == "checkpoint-00000012"
    assert json.loads((tmp_path / "checkpoint-00000012.meta.json").read_text()) \
        == {"epoch": 2}
    assert json.loads((tmp_path / "best.meta.json").read_text()) == {
        "su_error": 1.25, "epoch": 2}
    assert CheckpointManager(tmp_path).best_su_error() == 1.25
    _, epoch = ckpt.restore_latest(tgan.state_tree(models, state))
    assert epoch == 2
    # A stale in-flight write (a crash) is invisible to resume.
    (tmp_path / "checkpoint-00000099.inflight").mkdir()
    assert ckpt.latest_periodic_tag() == "checkpoint-00000012"


def test_old_copy_survives_until_the_new_one_is_promoted(tmp_path):
    ckpt = CheckpointManager(tmp_path / "run")
    ckpt.save("best", {"x": torch.tensor(1.0)}, epoch=1, block=True)
    assert json.loads((ckpt.run_dir / "best.meta.json").read_text()) == {
        "epoch": 1}
    ckpt.save("best", {"x": torch.tensor(2.0)}, epoch=2, block=False)
    assert (ckpt.run_dir / "best").is_dir()
    assert json.loads((ckpt.run_dir / "best.meta.json").read_text()) == {
        "epoch": 1}
    ckpt.wait_until_finished()
    assert not (ckpt.run_dir / "best.inflight").exists()
    tree, epoch = ckpt.restore("best", {"x": torch.tensor(0.0)})
    assert epoch == 2 and float(tree["x"]) == 2.0


def test_restore_from_path_and_load_trained_state(tmp_path):
    cfg, models, state, _ = _trained(steps=2)
    run = tmp_path / "run"
    ckpt = CheckpointManager(run)
    ckpt.save_periodic(tgan.state_tree(models, state), 2, 0, block=True)
    ckpt.save("best", tgan.state_tree(models, state), epoch=0)
    cfg.save(run / "config.yaml")
    for path in (run / "checkpoint-00000002", run):
        _, m2, s2, _ = _setup(seed=7)
        tree, _ = restore_from_path(path, tgan.state_tree(m2, s2))
        assert tree["step"] == 2
    with pytest.raises(FileNotFoundError):
        restore_from_path(run / "nope", tgan.state_tree(models, state))
    with pytest.raises(FileNotFoundError):
        restore_from_path(tmp_path, tgan.state_tree(models, state))
    for tag in ("best", "latest"):
        _, lmodels, lstate = tgan.load_trained_state(run, tag, device="cpu")
        assert lstate.step == 2
        _assert_trees_equal(tgan.state_tree(lmodels, lstate),
                            tgan.state_tree(models, state))


@pytest.mark.parametrize("saved_ema,config_ema", [(0.0, 0.999), (0.999, 0.0)])
def test_ema_mismatch_names_the_setting(tmp_path, saved_ema, config_ema):
    _, models, state, _ = _trained(steps=1, ema=saved_ema)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save("checkpoint-00000001", tgan.state_tree(models, state))
    _, m2, s2, _ = _setup(ema=config_ema)
    with pytest.raises(ValueError, match="generator_ema"):
        ckpt.restore("checkpoint-00000001", tgan.state_tree(m2, s2))


def test_structure_and_shape_mismatches_raise(tmp_path):
    ckpt = CheckpointManager(tmp_path)
    ckpt.save("best", {"a": torch.zeros(3), "b": [torch.ones(2)]})
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore("best", {"a": torch.zeros(4), "b": [torch.ones(2)]})
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore("best", {"a": torch.zeros(3), "b": [torch.ones(2)],
                              "c": torch.zeros(1)})
    with pytest.raises(ValueError, match="items"):
        ckpt.restore("best", {"a": torch.zeros(3), "b": []})


def test_standalone_pytrees(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "n": 3,
            "layers": [torch.ones(2), torch.zeros(1, dtype=torch.int32)]}
    save_pytree(tmp_path / "enc" / "tree.pt", tree)
    loaded = load_pytree(tmp_path / "enc" / "tree.pt")
    _assert_trees_equal(loaded, tree)
    template = {"w": torch.zeros(2, 3), "n": 0,
                "layers": [torch.zeros(2), torch.ones(1, dtype=torch.int32)]}
    ptr = template["w"].data_ptr()
    out = load_pytree(tmp_path / "enc" / "tree.pt", template)
    assert out["w"].data_ptr() == ptr
    _assert_trees_equal(out, tree)
    assert np.array_equal(template["w"].numpy(), tree["w"].numpy())
