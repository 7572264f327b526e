"""The port's int8 weight-only quantisation (``ste_gan_torch/quant.py``)
against the JAX package's (``ste_gan_tpu/quant.py``) on the CPU.

Weights are made by JAX from a seed and carried across by
``ste_gan_torch.interop``; the JAX package's quantised trees are carried the
same way, int8 values and scales each through the layout of the tensor they
quantise, so both packages' results meet in the port's layout. Tolerances:
q equal except +-1 where ``w / scale`` lies within rounding of a tie,
scales to rtol 1e-6, dequantised forwards at the model tolerance of
tests/test_model_parity.py (rtol 1e-3, atol 2e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import interop
from ste_gan_torch import quant as tquant
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer
from ste_gan_torch.models.generator import EMGGeneratorGanTTS
from ste_gan_tpu import quant as jquant
from ste_gan_tpu.models import emg_encoder as jenc
from ste_gan_tpu.models import generator as jgen

TOL = dict(rtol=1e-3, atol=2e-5)
ENC = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
           num_heads=4, dim_feedforward=64, dropout=0.0,
           relative_positional_distance=20)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gen():
    """(JAX module, params, the port's generator with the same weights)."""
    jm = jgen.EMGGeneratorGanTTS(num_sessions=4, channels=32)
    ids = jnp.zeros((1,), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 256)), ids,
                     ids)["params"]
    tm = EMGGeneratorGanTTS(num_sessions=4, channels=32)
    interop.load_generator(tm, params, C.DataType.SPEECH_UNITS)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def enc():
    jm = jenc.EMGEncoderTransformer(**ENC)
    variables = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 512, 8)), train=False))()
    tm = EMGEncoderTransformer(**ENC)
    interop.load_encoder(tm, variables)
    return jm, variables, tm.eval()


def _split(node):
    """A JAX quantised tree -> (values tree, scales tree) shaped like the
    float tree, so that the interop layout maps each into the port's."""
    if not isinstance(node, dict):
        return node, node
    if "v_q" in node:
        rest = {k: v for k, v in node.items() if k not in ("v_q", "v_scale")}
        out = node["v_q"].shape[-1]
        zeros = np.zeros((out,), np.float32)
        return (dict(rest, v=node["v_q"], g=zeros),
                dict(rest, v=node["v_scale"], g=zeros))
    if "embedding_q" in node:
        return ({"embedding": node["embedding_q"]},
                {"embedding": node["embedding_scale"]})
    values, scales = {}, {}
    for k, child in node.items():
        if k.endswith("__scale"):
            continue
        if k.endswith("__q"):
            values[k[:-3]] = child
            scales[k[:-3]] = node[k[:-3] + "__scale"]
        else:
            values[k], scales[k] = _split(child)
    return values, scales


def _count_quantised(node) -> int:
    if not isinstance(node, dict):
        return 0
    return sum(1 for k in node if k.endswith(("__q", "v_q", "embedding_q"))
               ) + sum(_count_quantised(c) for c in node.values())


def _assert_same_quantisation(port_q, jax_values, jax_scales, n_jax):
    """``port_q`` (the port's quantised dict) against the JAX quantised tree
    carried into the port's layout."""
    bases = sorted(k[:-len(tquant.Q_SUFFIX)] for k in port_q
                   if k.endswith(tquant.Q_SUFFIX))
    assert len(bases) == n_jax
    plain = [k for k in port_q if not k.endswith(
        (tquant.Q_SUFFIX, tquant.SCALE_SUFFIX))]
    assert set(bases) | set(plain) == set(jax_values) - {
        b[:-1] + "g" for b in bases if b.endswith(".weight_v")}
    ties = 0
    for base in bases:
        q = port_q[base + tquant.Q_SUFFIX]
        scale = port_q[base + tquant.SCALE_SUFFIX]
        assert q.dtype == torch.int8, base
        want_q = np.asarray(jax_values[base]).astype(np.int64)
        want_s = np.asarray(jax_scales[base], np.float32)
        assert scale.shape == want_s.shape, base
        np.testing.assert_allclose(scale.numpy(), want_s, rtol=1e-6,
                                   err_msg=base)
        diff = np.abs(q.numpy().astype(np.int64) - want_q)
        assert diff.max() <= 1, base
        ties += int(diff.sum())
    assert ties <= 1e-3 * sum(port_q[b + tquant.Q_SUFFIX].numel()
                              for b in bases)
    for key in plain:
        np.testing.assert_array_equal(port_q[key].numpy(),
                                      np.asarray(jax_values[key]), key)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_quantize_tensor_matches_jax(axis):
    rng = np.random.default_rng(axis)
    w = rng.normal(size=(6, 16, 24)).astype(np.float32)
    w[..., 3] = 0.0  # a zero channel on the last axis
    q, scale = tquant.quantize_tensor(torch.from_numpy(w), axis)
    jq, jscale = jquant.quantize_tensor(w, axis)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-6)
    diff = np.abs(q.numpy().astype(np.int64) - np.asarray(jq, np.int64))
    assert diff.max() <= 1 and diff.sum() <= 1e-3 * w.size
    # |w - dequant| <= scale / 2 per channel; an all-zero channel stays 0.
    err = (tquant.dequantize_tensor(q, scale) - torch.from_numpy(w)).abs()
    assert bool((err <= scale / 2 + 1e-6).all())
    assert bool(torch.isfinite(scale).all())
    if axis == 2:
        assert not q[..., 3].any()


def test_generator_state_dict_matches_jax(gen):
    _, params, tm = gen
    port_q = tquant.quantize_state_dict(tm.state_dict())
    jq = jquant.quantize_generator_params(params)
    values, scales = _split(jq)
    ft = C.DataType.SPEECH_UNITS
    _assert_same_quantisation(
        port_q, interop.generator_params_to_state_dict(values, ft),
        interop.generator_params_to_state_dict(scales, ft),
        _count_quantised(jq))
    assert not any(k.endswith(".weight_g") for k in port_q)
    assert port_q["session_embeddings.weight__scale"].shape == (4, 1)


def test_encoder_state_dict_matches_jax(enc):
    _, variables, tm = enc
    port_q = tquant.quantize_state_dict(tm.state_dict(), generic=True)
    jq = jquant.quantize_params(variables["params"], generic=True)
    values, scales = _split(jq)
    stats = variables["batch_stats"]
    _assert_same_quantisation(
        port_q,
        interop.encoder_variables_to_state_dict(
            {"params": values, "batch_stats": stats}),
        interop.encoder_variables_to_state_dict(
            {"params": scales, "batch_stats": stats}),
        _count_quantised(jq))
    # The relative-position table [H, 2d-1, Dh, 1] is quantised per Dh,
    # JAX's trailing axis, not per element of the port's trailing singleton.
    key = "transformer.layers.0.self_attn.relative_positional.embeddings"
    heads, head_dim = 4, ENC["model_size"] // 4
    assert port_q[key + "__q"].shape == (heads, 2 * 20 - 1, head_dim, 1)
    assert port_q[key + "__scale"].shape == (1, 1, head_dim, 1)
    assert port_q["conv_blocks.0.conv1.weight__scale"].shape == (32, 1, 1)
    assert port_q["w_out.weight__scale"].shape == (256, 1)
    # BatchNorm and LayerNorm tensors pass through in f32.
    for key in ("conv_blocks.0.bn1.weight", "conv_blocks.0.bn1.running_var",
                "transformer.layers.0.norm1.weight"):
        assert port_q[key].dtype == torch.float32


def test_dequantized_generator_matches_jax(gen):
    jm, params, tm = gen
    dq = tquant.dequantize_state_dict(tquant.quantize_state_dict(
        tm.state_dict()))
    assert list(dq) == list(tm.state_dict())
    model = EMGGeneratorGanTTS(num_sessions=4, channels=32)
    model.load_state_dict(dq, strict=True)
    # g = ||v|| makes the weight norm reproduce the dequantised kernel.
    conv = model.gblocks[0]
    np.testing.assert_allclose(conv.weight().detach().numpy(),
                               dq["gblocks.0.weight_v"].numpy(), rtol=1e-6,
                               atol=1e-7)
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, 24, 256)).astype(np.float32)
    sess = np.array([0, 3], np.int32)
    mode = np.zeros((2,), np.int32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(feats), torch.from_numpy(sess),
                           torch.from_numpy(mode)).numpy()
        f32 = tm(torch.from_numpy(feats), torch.from_numpy(sess),
                 torch.from_numpy(mode)).numpy()
    jdq = jquant.dequantize_generator_params(
        jquant.quantize_generator_params(params))
    want = np.asarray(jm.apply({"params": jdq}, feats, sess, mode))
    np.testing.assert_allclose(got, want, **TOL)
    assert 0 < np.abs(got - f32).max() < 5e-3  # quantisation is real


def test_dequantized_encoder_matches_jax(enc):
    jm, variables, tm = enc
    dq = tquant.dequantize_state_dict(tquant.quantize_state_dict(
        tm.state_dict(), generic=True))
    model = EMGEncoderTransformer(**ENC)
    model.load_state_dict(dq, strict=True)
    emg = (np.random.default_rng(3).normal(size=(2, 512, 8)) * 0.1).astype(
        np.float32)
    with torch.no_grad():
        got = [o.numpy() for o in model.eval()(torch.from_numpy(emg))]
    jdq = dict(variables, params=jquant.dequantize_params(
        jquant.quantize_params(variables["params"], generic=True)))
    want = jm.apply(jdq, emg, train=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("name,generic,ratio", [
    ("generator", False, 0.3),
    # The narrow encoder's f32 BatchNorm, LayerNorm and bias tensors hold a
    # larger share of its bytes than at full width.
    ("encoder", True, 0.35)])
def test_param_bytes_shrink(gen, enc, name, generic, ratio):
    sd = (gen if name == "generator" else enc)[2].state_dict()
    q = tquant.quantize_state_dict(sd, generic=generic)
    assert (tquant.quantized_param_bytes(q)
            < ratio * tquant.quantized_param_bytes(sd))
