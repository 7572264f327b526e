"""Whole runs with the timed path broken underneath: each fault a cell can
have must turn ``correct`` false under the limits the cells commit. The
runs skip the look for a card and run the program's CPU path at a tiny
size; the faults are planted in the program, below everything the harness
records. The GAN cell's networks run in f32 here (the program's path
without mixed precision): at these widths bf16's relative noise is larger
than at the cell's, and the tests are about the faults."""
import numpy as np
import pytest
import torch

from portbench.tests.tiny import execute


def _frozen_gan_step(monkeypatch):
    """A GAN step that returns its state unchanged: parameters and the EMA
    are put back after the real step."""
    from ste_gan_torch.train import gan as tgan

    real = tgan.make_train_step

    def make(cfg, models, *a, **k):
        step = real(cfg, models, *a, **k)
        params = [*models.generator.parameters(),
                  *models.discriminator.parameters()]

        def frozen(state, batch):
            saved = [p.detach().clone() for p in params]
            ema = [e.clone() for e in state.gen_ema or []]
            state, metrics = step(state, batch)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
                for e, s in zip(state.gen_ema or [], ema):
                    e.copy_(s)
            return state, metrics
        return frozen

    monkeypatch.setattr(tgan, "make_train_step", make)


def _restoring_gan_step(monkeypatch, kept):
    """A GAN step after which the tensors ``kept(models, state)`` are put
    back as they were before it: that part of the state left unchanged."""
    from ste_gan_torch.train import gan as tgan

    real = tgan.make_train_step

    def make(cfg, models, *a, **k):
        step = real(cfg, models, *a, **k)

        def restoring(state, batch):
            tensors = kept(models, state)
            saved = [t.clone() for t in tensors]
            state, metrics = step(state, batch)
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
            return state, metrics
        return restoring

    monkeypatch.setattr(tgan, "make_train_step", make)


def _frozen_ema(monkeypatch):
    """The generator's EMA left unchanged; the parameters update."""
    _restoring_gan_step(monkeypatch, lambda models, state: state.gen_ema)


def _stale_spectral_norm(monkeypatch):
    """The spectral norm's power-iteration vectors left unchanged."""
    _restoring_gan_step(monkeypatch, lambda models, state: [
        b for n, b in models.discriminator.named_buffers()
        if n.endswith(("weight_u", "weight_v"))])


def _half_gan_batch(monkeypatch):
    """A GAN step that leaves out the second half of its rows."""
    from ste_gan_torch.train import gan as tgan

    real = tgan.make_train_step

    def make(cfg, models, *a, **k):
        step = real(cfg, models, *a, **k)

        def half(state, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return step(state, {key: v[:n] for key, v in batch.items()})
        return half

    monkeypatch.setattr(tgan, "make_train_step", make)


def _frozen_enc_step(monkeypatch):
    from ste_gan_torch.train import encoder as tenc

    real = tenc.make_encoder_train_step

    def make(model, *a, **k):
        step = real(model, *a, **k)
        params = list(model.parameters())

        def frozen(state, batch):
            saved = [p.detach().clone() for p in params]
            state, metrics = step(state, batch)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return state, metrics
        return frozen

    monkeypatch.setattr(tenc, "make_encoder_train_step", make)


def _tf32_products(monkeypatch):
    """The encoder step switches cuBLAS's f32 products to TF32."""
    from ste_gan_torch.train import encoder as tenc

    real = tenc.make_encoder_train_step

    def make(model, *a, **k):
        step = real(model, *a, **k)

        def tf32(state, batch):
            torch.set_float32_matmul_precision("high")
            return step(state, batch)
        return tf32

    monkeypatch.setattr(tenc, "make_encoder_train_step", make)


def _half_enc_batch(monkeypatch):
    """The fold keeps the first half of a batch's utterances."""
    from ste_gan_torch.train.encoder_data import EncoderDeviceCorpus

    real = EncoderDeviceCorpus.fold

    def fold(self, rows, num_samples, **k):
        return real(self, rows, torch.clamp(num_samples // 2, min=1), **k)

    monkeypatch.setattr(EncoderDeviceCorpus, "fold", fold)


def _altered_answer(monkeypatch):
    """One utterance's EMG altered where the synthesizer produces it."""
    from ste_gan_torch.infer import EMGSynthesizer

    real = EMGSynthesizer.synthesize_padded

    def altered(self, feats, *a, **k):
        out = real(self, feats, *a, **k).clone()
        out[0, 0, 0] += 0.5
        return out

    monkeypatch.setattr(EMGSynthesizer, "synthesize_padded", altered)


FAULTS = [("gan_su.train", _frozen_gan_step),
          ("gan_su.train", _frozen_ema),
          ("gan_su.train", _stale_spectral_norm),
          ("gan_su.train", _half_gan_batch),
          ("enc.train_mixed", _frozen_enc_step),
          ("enc.train_mixed", _half_enc_batch),
          ("enc.train_mixed", _tf32_products),
          ("gan_su.generate", _altered_answer)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    try:
        code, result, lines = execute(cell, 2 ** 34 + 5,
                                      f32=cell == "gan_su.train")
    finally:
        torch.set_float32_matmul_precision("highest")
    assert code == 0
    assert result["correct"] is False, lines


@pytest.mark.parametrize("cell", ["gan_su.train", "enc.train_mixed",
                                  "gan_su.generate"])
def test_sound_run_is_correct(cell):
    code, result, lines = execute(cell, 2 ** 34 + 5,
                                  f32=cell == "gan_su.train")
    assert code == 0 and result["correct"] is True, lines
    assert np.isfinite(result["metrics"][next(iter(result["metrics"]))][
        "value"])
