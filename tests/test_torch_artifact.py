"""The port's deployment artifacts (``ste_gan_torch/export.py``, the int8
programs of ``ste_gan_torch/quant.py``) on the CPU.

Weights are made by JAX from a seed and carried across by
``ste_gan_torch.interop``; inputs are numpy-seeded. An artifact is held to
the port's module it was exported from (atol 1e-5: the program runs the
same ATen ops) and to the JAX package's export on the same inputs (the
model tolerance of tests/test_model_parity.py, rtol 1e-3, atol 2e-5); an
int8 artifact to the module with the dequantised weights (atol 1e-6, as
tests/test_quant.py holds the JAX one). Each artifact is exported once per
module.
"""
import copy
import json
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import export as texport
from ste_gan_torch import interop
from ste_gan_torch import quant as tquant
from ste_gan_torch.infer import EMGSynthesizer
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.models.generator import EMGGeneratorGanTTS
from ste_gan_tpu import export as jexport
from ste_gan_tpu.models import emg_encoder as jenc
from ste_gan_tpu.models import generator as jgen

TOL = dict(rtol=1e-3, atol=2e-5)
ENC = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
           num_heads=4, dim_feedforward=64, dropout=0.0,
           relative_positional_distance=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_generator(ft, dim, params):
    tm = EMGGeneratorGanTTS(speech_feature_type=ft, speech_input_dim=dim,
                            num_sessions=4, channels=32)
    interop.load_generator(tm, params, ft)
    return tm.eval()


@pytest.fixture(scope="module")
def gen(tmp_path_factory):
    """JAX module, params and exports; the port's generator; the port's
    minimal and serving artifacts of it (saved with their meta files), each
    loaded once."""
    jm = jgen.EMGGeneratorGanTTS(num_sessions=4, channels=32)
    ids = jnp.zeros((1,), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 256)), ids,
                     ids)["params"]
    tm = _port_generator(C.DataType.SPEECH_UNITS, 256, params)
    root = tmp_path_factory.mktemp("gen")
    out = SimpleNamespace(jm=jm, params=params, tm=tm, paths={}, loaded={},
                          jax={})
    for serving in (False, True):
        path = root / f"generator{'-serving' if serving else ''}.pt2"
        texport.save_exported(texport.export_generator(tm, 256, serving),
                              path, texport.generator_meta(tm, 256, serving))
        out.paths[serving] = path
        out.loaded[serving] = texport.load_exported(path, device="cpu")
        out.jax[serving] = jexport.export_generator(jm, params, 256,
                                                    serving=serving)
    out.minimal = out.loaded[False].module()
    return out


def _run(module, *args, **kwargs):
    with torch.no_grad():
        out = module(*[torch.from_numpy(np.asarray(a)) for a in args],
                     **kwargs)
    return out.numpy() if isinstance(out, torch.Tensor) else [
        o.numpy() for o in out]


@pytest.mark.parametrize("b,t", [(1, 16), (3, 40), (2, 128)])
def test_minimal_artifact_is_polymorphic_and_exact(gen, b, t):
    rng = np.random.default_rng(t)
    feats = rng.normal(size=(b, t, 256)).astype(np.float32)
    sess = rng.integers(0, 4, (b,)).astype(np.int64)
    got = _run(gen.minimal, feats, sess)
    assert got.shape == (b, C.HOPSIZE * t, 8)
    np.testing.assert_allclose(got, _run(gen.tm, feats, sess), atol=1e-5,
                               rtol=0)
    want = gen.jax[False].call(jnp.asarray(feats),
                               jnp.asarray(sess, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_serving_artifact_padded_exactness(gen):
    art = texport.ExportedSynthesizer(gen.paths[True], device="cpu")
    assert art.upsample == 16 and art.device.type == "cpu"
    assert art.generator.speech_input_dim == 256
    assert art.generator.num_emg_channels == 8
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(3, 48, 256)).astype(np.float32)
    sess, mode = np.array([0, 1, 2]), np.zeros(3, np.int64)
    valid = np.array([48, 17, 33])
    got = art.synthesize_padded(feats, sess, mode, valid).numpy()
    want = EMGSynthesizer(gen.tm, device="cpu").synthesize_padded(
        feats, sess, mode, valid).numpy()
    jwant = np.asarray(gen.jax[True].call(
        jnp.asarray(feats), jnp.asarray(sess, jnp.int32),
        jnp.asarray(mode, jnp.int32), jnp.asarray(valid, jnp.int32)))
    for row, v in enumerate(valid):
        np.testing.assert_allclose(got[row, :16 * v], want[row, :16 * v],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[row, :16 * v], jwant[row, :16 * v],
                                   **TOL)
        assert not got[row, 16 * v:].any()  # masked: tanh(0)
    # Streaming needs the in-framework generator: 501 over HTTP.
    with pytest.raises(NotImplementedError):
        art.synthesize_streaming(np.zeros((8, 256), np.float32), 0)


def test_mfcc_variant_exports_x8(tmp_path):
    jm = jgen.EMGGeneratorGanTTS(speech_feature_type=C.DataType.MFCCS,
                                 speech_input_dim=C.NUM_MFCCS, num_sessions=4,
                                 channels=32)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, C.NUM_MFCCS)),
                     jnp.zeros((1,), jnp.int32))["params"]
    tm = _port_generator(C.DataType.MFCCS, C.NUM_MFCCS, params)
    path = tmp_path / "mfcc.pt2"
    texport.save_exported(texport.export_generator(tm, C.NUM_MFCCS), path,
                          texport.generator_meta(tm, C.NUM_MFCCS, False))
    assert json.loads((tmp_path / "mfcc.pt2.meta.json").read_text())[
        "upsample"] == 8
    feats = np.random.default_rng(3).normal(
        size=(2, 32, C.NUM_MFCCS)).astype(np.float32)
    sess = np.array([1, 3])
    got = _run(texport.load_exported(path, "cpu").module(), feats, sess)
    assert got.shape == (2, 8 * 32, 8)
    np.testing.assert_allclose(got, _run(tm, feats, sess), atol=1e-5, rtol=0)
    want = jexport.export_generator(jm, params, C.NUM_MFCCS).call(
        jnp.asarray(feats), jnp.asarray(sess, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def enc(tmp_path_factory):
    jm = jenc.EMGEncoderTransformer(**ENC)
    variables = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 16 * 9, 8)), train=False))()
    tm = EMGEncoderTransformer(**ENC)
    interop.load_encoder(tm, variables)
    path = tmp_path_factory.mktemp("enc") / "encoder.pt2"
    texport.save_exported(texport.export_emg_encoder(tm.eval(), 8), path,
                          {"min_frames": texport.encoder_min_frames(tm),
                           "num_emg_channels": 8})
    return SimpleNamespace(
        tm=tm, path=path,
        program=texport.load_exported(path, "cpu").module(),
        jax=jexport.export_emg_encoder(jm, variables, 8))


@pytest.mark.parametrize("b,t", [(1, 9), (2, 9), (2, 37)])
def test_encoder_artifact_at_and_above_min_frames(enc, b, t):
    assert texport.encoder_min_frames(enc.tm) == 9  # distance 8 + 1
    emg = (np.random.default_rng(t).normal(size=(b, 16 * t, 8)) * 0.1
           ).astype(np.float32)
    got = _run(enc.program, emg)
    assert got[0].shape == (b, t, 256) and got[1].shape == (b, t, 48)
    want = enc.jax.call(jnp.asarray(emg))
    for g, m, w in zip(got, _run(enc.tm, emg), want):
        np.testing.assert_allclose(g, m, atol=1e-5, rtol=0)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_encoder_artifact_refuses_below_min_frames(enc):
    with pytest.raises(Exception):
        enc.program(torch.zeros((1, 16 * 8, 8)))


def _f32_bytes(exported) -> int:
    return sum(v.numel() * v.element_size()
               for v in exported.state_dict.values()
               if v.dtype == torch.float32)


@pytest.mark.parametrize("kind", ["generator", "encoder"])
def test_int8_artifact_is_smaller_and_exact(gen, enc, tmp_path, kind):
    if kind == "generator":
        model, generic, f32_path = gen.tm, False, gen.paths[True]
        int8 = tquant.export_generator_quantized(model, 256, serving=True)
        fresh = EMGGeneratorGanTTS(num_sessions=4, channels=32)
        rng = np.random.default_rng(4)
        args = (rng.normal(size=(2, 20, 256)).astype(np.float32),
                np.array([0, 2]), np.zeros(2, np.int64), np.array([20, 13]))
    else:
        model, generic, f32_path = enc.tm, True, enc.path
        int8 = tquant.export_emg_encoder_quantized(model, 8)
        fresh = EMGEncoderTransformer(**ENC)
        args = ((np.random.default_rng(5).normal(size=(2, 16 * 12, 8)) * 0.1
                 ).astype(np.float32),)
    sd = model.state_dict()
    qsd = tquant.quantize_state_dict(sd, generic=generic)
    path = tmp_path / "int8.pt2"
    int8_bytes = texport.save_exported(int8, path)
    saved = (tquant.quantized_param_bytes(sd)
             - tquant.quantized_param_bytes(qsd))
    assert f32_path.stat().st_size - int8_bytes > 0.85 * saved
    # No f32 copy of the weights: the program's f32 state is the scales,
    # biases and norms alone.
    assert _f32_bytes(int8) == sum(
        v.numel() * v.element_size() for v in qsd.values()
        if v.dtype == torch.float32)
    fresh.load_state_dict(tquant.dequantize_state_dict(qsd), strict=True)
    program = texport.load_exported(path, "cpu").module()
    got, want = _run(program, *args), _run(fresh.eval(), *args)
    if kind == "generator":
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


def test_artifact_loads_without_the_package(gen, tmp_path):
    """The .pt2 file runs in a process that imports torch alone."""
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(2, 24, 256)).astype(np.float32)
    np.save(tmp_path / "feats.npy", feats)
    np.save(tmp_path / "want.npy", _run(gen.tm, feats, np.array([1, 2]),
                                        np.zeros(2, np.int64),
                                        num_valid_frames=torch.tensor(
                                            [24, 10])))
    code = (
        "import sys, numpy as np, torch\n"
        f"program = torch.export.load({str(gen.paths[True])!r}).module()\n"
        "feats = torch.from_numpy(np.load('feats.npy'))\n"
        "with torch.no_grad():\n"
        "    out = program(feats, torch.tensor([1, 2]), torch.zeros(2, "
        "dtype=torch.long), torch.tensor([24, 10])).numpy()\n"
        "assert not [m for m in sys.modules if m.startswith('ste_gan')]\n"
        "print(float(np.abs(out - np.load('want.npy')).max()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert float(proc.stdout.strip().splitlines()[-1]) <= 1e-5


def test_exported_synthesizer_refusals(gen, tmp_path):
    with pytest.raises(ValueError, match="serving"):
        texport.ExportedSynthesizer(gen.paths[False], device="cpu")
    bare = tmp_path / "bare.pt2"
    bare.write_bytes(gen.paths[True].read_bytes())
    with pytest.raises(FileNotFoundError, match="meta"):
        texport.ExportedSynthesizer(bare, device="cpu")
    with pytest.raises(FileNotFoundError):
        texport.load_exported(bare, device="cpu")


def test_load_moves_the_program_and_raises_when_it_cannot(gen, monkeypatch):
    """A CPU-traced program is moved to the requested device (here the meta
    device: every tensor and the masks' baked-in arange go with it); a move
    that fails, or leaves a tensor behind, raises. (``torch.export.load``
    hands back a copy of the program loaded once.)"""
    import torch.export.passes as passes

    meta = json.loads(gen.paths[True].with_name(
        gen.paths[True].name + ".meta.json").read_text())
    assert meta["device"] == "cpu"
    monkeypatch.setattr(torch.export, "load",
                        lambda path: copy.deepcopy(gen.loaded[True]))
    moved = texport.load_exported(gen.paths[True], device="meta")
    assert {v.device.type for v in moved.state_dict.values()} == {"meta"}
    ids = torch.zeros((3,), dtype=torch.long, device="meta")
    out = moved.module()(torch.zeros((3, 30, 256), device="meta"), ids, ids,
                         torch.full((3,), 30, device="meta"))
    assert out.shape == (3, 480, 8) and out.device.type == "meta"

    def broken(ep, location):
        raise RuntimeError("cannot move")

    monkeypatch.setattr(passes, "move_to_device_pass", broken)
    with pytest.raises(RuntimeError, match="cannot move"):
        texport.load_exported(gen.paths[True], device="meta")
    monkeypatch.setattr(passes, "move_to_device_pass", lambda ep, loc: ep)
    with pytest.raises(RuntimeError, match="left tensors"):
        texport.load_exported(gen.paths[True], device="meta")
