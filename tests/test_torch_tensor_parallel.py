"""The port's tensor-parallel layer (``ste_gan_torch/parallel/
tensor_parallel.py``) against the JAX package's partition rule, and its
collectives, split spectral norm and grouped-conv slabs against the
unsplit computation on four spawned CPU gloo ranks (one spawn, rendezvous
through a file under ``tmp_path``, every check of this file in it).

* The rule: every leaf of the generator, the discriminator and the encoder
  gets the split the JAX ``leaf_partition_spec`` gives its JAX leaf, at 2
  and 4 model ranks, and the per-rank parameter counts equal JAX's
  ``sharding_summary`` (the shipped G and D at 2: 11,773,416 and
  5,936,624, of which 16,912 replicated), so the per-rank state bytes are
  JAX's.
* ``copy_to_model``, ``gather_from_model`` and ``replicated_sum``: forward
  and gradients equal the unsplit computation (rtol 1e-6, f32 sums in
  another order); the gradient of a sum that every rank uses alike is
  the unsplit one, where ``mesh.all_reduce_sum`` (whose backward
  all-reduces) gives the model size times it.
* ``SNConv`` under TP, plain and dual sigma: ``u``, ``v``, the output, the
  input gradient and the weight gradient's slab equal one rank's (rtol
  1e-5, atol 1e-6 of the largest magnitude: the power iteration's sums run
  in parts, and a split layer scales its gathered output by ``1/sigma``
  where one rank convolves with ``W/sigma``).
* A grouped layer's per-rank output is the slice of the full conv at every
  slab geometry: whole groups at ``groups / model`` > 1 and = 1 (a dense
  conv), and a slab inside one group (``groups < model``).
"""
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ste_gan_torch import interop
from ste_gan_torch.config import Config as TConfig
from ste_gan_torch.models.emg_encoder import EMGEncoderTransformer as TEnc
from ste_gan_torch.parallel import tensor_parallel as tp
from ste_gan_torch.parallel.launch import run_ranks
from ste_gan_torch.train import gan as tgan
from ste_gan_tpu.config import Config as JConfig
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer as JEnc
from ste_gan_tpu.parallel.tensor_parallel import (
    create_mesh_2d, leaf_partition_spec, sharding_summary)
from ste_gan_tpu.train import gan as jgan

ROOT = Path(__file__).resolve().parents[1]
RANK_ENV = {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}
ENC_KW = dict(model_size=32, num_extra_res_blocks=3, num_transformer_layers=1,
              num_heads=4, dim_feedforward=64, dropout=0.0)
#: (in, out, kernel, stride, pad, groups) of the grouped layers held at
#: every slab geometry: the shipped small discriminator's two grouped
#: layers narrowed, and a 2-group layer that 4 model ranks split inside
#: its groups.
GROUPED = ((16, 32, 9, 2, 4, 4), (32, 64, 9, 2, 4, 16), (8, 16, 5, 1, 2, 2))

#: What each of the four ranks runs: for the model groups of a (2, 2) and
#: a (1, 4) layout, every check of this file, each result saved to
#: ``<out>/r{rank}_{layout}.npz`` as (got, want) pairs.
RANK_CODE = r'''
import sys, numpy as np, torch, torch.distributed as dist
from ste_gan_torch.parallel import mesh as M
from ste_gan_torch.parallel import tensor_parallel as tp
from ste_gan_torch.ops.conv import Conv, SNConv, WNConv
out, init = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
M.init_distributed("gloo", 90, "cpu", init)
rank = dist.get_rank()
GROUPED = ''' + repr(GROUPED) + r'''

def seeded(seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g)

for name, layout in (("2x2", (2, 2)), ("1x4", (1, 4))):
    mesh = tp.create_mesh_2d(*layout)
    grp, m, n = mesh.model, mesh.model_rank, mesh.model_size
    res = {}
    # copy_to_model -> split matmul -> gather_from_model, against x @ w.
    x, w, c = seeded(1, 6, 8), seeded(2, 8, 12), seeded(3, 6, 12)
    xs = x.clone().requires_grad_(True)
    ws = w[:, m * 12 // n:(m + 1) * 12 // n].clone().requires_grad_(True)
    y = tp.gather_from_model(tp.copy_to_model(xs, grp) @ ws, 1, grp)
    (y * c).sum().backward()
    xf, wf = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yf = xf @ wf
    (yf * c).sum().backward()
    res["column_out"] = (y.detach(), yf.detach())
    res["column_dx"] = (xs.grad, xf.grad)
    res["column_dw"] = (ws.grad, wf.grad[:, m * 12 // n:(m + 1) * 12 // n])
    # A sum every rank then uses alike: replicated_sum's gradient is the
    # unsplit one; mesh.all_reduce_sum's is n times it.
    v = seeded(4, 16)
    for key, fn in (("replicated_sum", tp.replicated_sum),
                    ("all_reduce_sum", M.all_reduce_sum)):
        part = v[m * 16 // n:(m + 1) * 16 // n].clone().requires_grad_(True)
        s = fn((part * part).sum(), grp)
        (s * s).backward()
        vf = v.clone().requires_grad_(True)
        sf = (vf * vf).sum()
        (sf * sf).backward()
        res[key + "_value"] = (s.detach(), sf.detach())
        res[key + "_grad"] = (part.grad, vf.grad[m * 16 // n:(m + 1) * 16 // n])
    # SNConv, plain and dual sigma, split over the model ranks.
    for dual in (False, True):
        gen = torch.Generator().manual_seed(5)
        full = SNConv(8, 16, 5, padding=2, groups=4, generator=gen)
        split = SNConv(8, 16, 5, padding=2, groups=4,
                       generator=torch.Generator().manual_seed(5))
        holder = torch.nn.Sequential(split)
        tp.shard_module_(holder, mesh)
        xin = seeded(6, 4, 8, 40)
        r = seeded(7, 4, 16, 40)
        outs = []
        for layer in (split, full):
            xi = xin.clone().requires_grad_(True)
            for _ in range(2):  # the power iteration advances twice
                yo = layer(xi, dual_batch=2 if dual else None)
            (yo * r).sum().backward()
            outs.append((yo.detach(), xi.grad, layer.weight_orig.grad,
                         layer.weight_u.clone(), layer.weight_v.clone()))
        tag = "sn_dual" if dual else "sn_plain"
        (ys, gs, ws_, us, vs), (yf_, gf, wf_, uf, vf_) = outs
        rows = 16 // n
        res[tag + "_out"] = (ys, yf_)
        res[tag + "_dx"] = (gs, gf)
        res[tag + "_dw"] = (ws_, wf_[m * rows:(m + 1) * rows])
        res[tag + "_u"] = (us, uf)
        res[tag + "_v"] = (vs, vf_)
    # Grouped layers: the rank's slab (Conv, gather=False) and the gathered
    # WNConv against the full conv.
    for i, (cin, cout, k, s_, pad, g) in enumerate(GROUPED):
        for cls in (Conv, WNConv):
            full = cls(cin, cout, k, stride=s_, padding=pad, groups=g,
                       generator=torch.Generator().manual_seed(8 + i))
            split = cls(cin, cout, k, stride=s_, padding=pad, groups=g,
                        generator=torch.Generator().manual_seed(8 + i))
            tp.shard_module_(torch.nn.Sequential(split), mesh)
            xin = seeded(20 + i, 3, cin, 64)
            want = full(xin).detach()
            if cls is Conv:
                got = split(xin, gather=False).detach()
                want = want[:, m * cout // n:(m + 1) * cout // n]
                res[f"grouped_{i}_slab"] = (got, want)
                res[f"grouped_{i}_groups"] = (
                    torch.tensor(split.tp.groups), torch.tensor(
                        g // n if g % n == 0 else 1))
            else:
                res[f"grouped_{i}_gathered"] = (split(xin).detach(), want)
    np.savez(f"{out}/r{rank}_{name}.npz",
             **{f"{k}__got": a.detach().numpy() for k, (a, b) in res.items()},
             **{f"{k}__want": b.detach().numpy() for k, (a, b) in res.items()})
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's saved ``{check: (got, want)}`` by (rank, layout)."""
    tmp = tmp_path_factory.mktemp("tp_ranks")
    rendezvous = f"file://{(tmp / 'rendezvous').resolve()}"
    run_ranks([sys.executable, "-c", RANK_CODE, str(tmp), rendezvous], 4,
              tmp / "logs", 240, env=RANK_ENV)
    out = {}
    for rank in range(4):
        for layout in ("2x2", "1x4"):
            saved = dict(np.load(tmp / f"r{rank}_{layout}.npz"))
            keys = {k.split("__")[0] for k in saved}
            out[rank, layout] = {k: (saved[f"{k}__got"], saved[f"{k}__want"])
                                 for k in keys}
    return out


def _cases(ranks, prefix):
    for (rank, layout), checks in ranks.items():
        for key, pair in checks.items():
            if key.startswith(prefix):
                yield f"rank {rank} {layout} {key}", pair


# ---------------------------------------------------------------------------
# The rule against JAX
# ---------------------------------------------------------------------------


def _jax_spec_state_dict(tree_to_sd, tree, model):
    """The port-layout state dict whose every entry is 1 where the JAX rule
    splits the JAX leaf and 0 where it replicates it (the bridge carries
    each marker to the port's key and layout)."""
    marked = jax.tree.map(
        lambda leaf: np.full(leaf.shape, 1.0 if leaf_partition_spec(
            leaf, model) != P() else 0.0, np.float32), tree)
    return tree_to_sd(marked)


def _assert_same_splits(port_module, jax_sd, model, skip=()):
    specs = tp.state_shardings(port_module, model)
    checked = 0
    for key, axis in specs.items():
        if key in jax_sd and not key.endswith(skip):
            want = bool(np.all(np.asarray(jax_sd[key]) == 1.0))
            assert (axis is not None) == want, (key, axis, model)
            checked += 1
    assert checked > 10


@pytest.fixture(scope="module")
def tiny_pair():
    """Tiny JAX and port networks: JAX parameter trees and the port
    modules (shapes only matter here)."""
    from ste_gan_torch.parallel.multiprocess import tiny_setup
    from ste_gan_tpu.parallel.multiprocess import tiny_setup as j_tiny_setup

    jcfg, jmodels = j_tiny_setup()
    jstate = jax.eval_shape(lambda: jgan.init_state(
        jcfg, jmodels, jax.random.PRNGKey(0)))
    _, models = tiny_setup()
    return jstate, models


@pytest.mark.parametrize("model", [2, 4])
def test_rule_splits_the_leaves_jax_splits(tiny_pair, model):
    jstate, models = tiny_pair
    _assert_same_splits(models.generator, _jax_spec_state_dict(
        lambda t: interop.generator_params_to_state_dict(
            t, models.generator.speech_feature_type),
        jstate.gen_params, model), model)
    # The spectral u/v have no JAX parameter: the port keeps them whole.
    spectral = jax.tree.map(lambda leaf: np.zeros(leaf.shape, np.float32),
                            jstate.disc_spectral)
    _assert_same_splits(models.discriminator, _jax_spec_state_dict(
        lambda t: interop.discriminator_params_to_state_dict(t, spectral),
        jstate.disc_params, model), model, skip=("weight_u", "weight_v"))
    jenc = JEnc(**ENC_KW)
    variables = jax.eval_shape(lambda: jenc.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((1, 512, 8)), train=False))
    _assert_same_splits(
        TEnc(**ENC_KW),
        _jax_spec_state_dict(interop.encoder_variables_to_state_dict,
                             dict(variables), model), model,
        skip=("num_batches_tracked",))


@pytest.fixture(scope="module")
def shipped():
    """The shipped configuration's networks: JAX shapes and the port's
    modules (on the CPU)."""
    jcfg = JConfig()
    jmodels = jgan.build_models(jcfg)
    jstate = jax.eval_shape(lambda: jgan.init_state(
        jcfg, jmodels, jax.random.PRNGKey(0)))
    models = tgan.build_models(TConfig(), device="cpu")
    return jstate, models


@pytest.mark.parametrize("grid", [(4, 2), (2, 4)])
def test_per_rank_parameters_equal_jax_shards(shipped, grid):
    jstate, models = shipped
    data, model = grid
    jmesh = create_mesh_2d(data, model)
    for jtree, module in ((jstate.gen_params, models.generator),
                          (jstate.disc_params, models.discriminator)):
        j_sharded, j_replicated, j_leaves = sharding_summary(jtree, jmesh)
        assert tp.sharding_summary(module, model) == (
            j_sharded, j_replicated, j_leaves)
    if model == 2:
        g = tp.sharding_summary(models.generator, 2)
        d = tp.sharding_summary(models.discriminator, 2)
        assert g[0] // 2 + g[1] == 11_773_416
        assert d[0] // 2 + d[1] == 5_936_624 and d[1] == 16_912


def test_sliced_state_holds_a_share_of_the_bytes(shipped):
    """Slicing (no collective needed) each model rank's state: parameters,
    both moments and the EMA per rank are the rule's per-rank counts, and
    every rank's slabs put back together are the full tensors."""
    _, models = shipped
    cfg = TConfig()
    cfg.train.generator_ema = 0.999
    full = tgan.init_state(cfg, models)
    full_params = {k: v.clone() for k, v in
                   models.generator.state_dict().items()}
    g_sh, g_rep, _ = tp.sharding_summary(models.generator, 2)
    d_sh, d_rep, _ = tp.sharding_summary(models.discriminator, 2)
    buffers = sum(b.numel() * b.element_size()
                  for mod in (models.generator, models.discriminator)
                  for b in mod.buffers())
    assert tp.tp_state_bytes(models, full) - buffers == 4 * (
        (g_sh + g_rep) * 4 + (d_sh + d_rep) * 3)
    pieces = []
    for m in range(2):
        fresh = tgan.build_models(TConfig(), device="cpu")
        state = tgan.init_state(cfg, fresh)
        tp.shard_state(fresh, state,
                            tp.Mesh2D(None, None, None, 0, 1, m, 2))
        want = 4 * ((g_sh // 2 + g_rep) * 4 + (d_sh // 2 + d_rep) * 3)
        assert tp.tp_state_bytes(fresh, state) - buffers == want
        pieces.append(fresh.generator.state_dict())
    axes = fresh.generator.tp_axes
    for key, value in full_params.items():
        axis = axes[key]
        got = pieces[0][key] if axis is None else torch.cat(
            [p[key] for p in pieces], dim=axis)
        assert torch.equal(got, value), key
    # 247.6 MiB per rank at model 2, where one rank holds 495.0.
    assert round(want / 2**20, 1) == 247.6


def test_interop_shards_a_jax_state_dict_as_the_port_does(shipped):
    _, models = shipped
    sd = {k: v.numpy() for k, v in models.generator.state_dict().items()}
    axes = tp.state_shardings(models.generator, 4)
    slab = interop.shard_state_dict(sd, axes, 3, 4)
    emb = sd["session_embeddings.weight"]
    assert np.array_equal(slab["session_embeddings.weight"], emb[:, 48:])
    assert slab["last_conv.1.weight_v"].shape[0] == 2
    assert all(slab[k].shape == sd[k].shape for k in sd if axes[k] is None)


def test_a_layout_that_does_not_fit_the_ranks_raises():
    assert tp.mesh_shape(8, -1, 2) == (4, 2)
    assert tp.mesh_shape(4, 2, 2) == (2, 2)
    for args in ((4, 3, 2), (6, -1, 4), (2, 1, 1)):
        with pytest.raises(ValueError, match="tensor_parallel.py"):
            tp.mesh_shape(*args)
    with pytest.raises(ValueError, match="positive"):
        tp.mesh_shape(4, 2, 0)


# ---------------------------------------------------------------------------
# The collectives, the split spectral norm, the grouped slabs (four ranks)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("check", ["column_out", "column_dx", "column_dw",
                                   "replicated_sum_value",
                                   "replicated_sum_grad"])
def test_collectives_match_the_unsplit_computation(ranks, check):
    cases = list(_cases(ranks, check))
    assert len(cases) == 8
    for what, (got, want) in cases:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=what)


def test_an_all_reduce_backward_would_scale_the_gradient(ranks):
    """The case ``replicated_sum`` is for: ``mesh.all_reduce_sum``'s
    backward sums the already whole gradient over the model ranks."""
    for (rank, layout), checks in ranks.items():
        n = 2 if layout == "2x2" else 4
        got, want = checks["all_reduce_sum_grad"]
        np.testing.assert_allclose(got, n * want, rtol=1e-6)
        assert not np.allclose(got, want)


@pytest.mark.parametrize("mode", ["sn_plain", "sn_dual"])
@pytest.mark.parametrize("what", ["out", "dx", "dw", "u", "v"])
def test_split_spectral_norm_equals_one_rank(ranks, mode, what):
    cases = list(_cases(ranks, f"{mode}_{what}"))
    assert len(cases) == 8
    for name, (got, want) in cases:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("layer", range(len(GROUPED)))
def test_grouped_layer_slab_is_the_slice_of_the_full_conv(ranks, layer):
    """Whole groups (16 groups: 8 and 4 per rank; 4 groups: 2 per rank,
    then 1, a dense conv) and a slab inside one group (2 groups over 4
    ranks)."""
    seen = set()
    for (rank, layout), checks in ranks.items():
        got_g, want_g = checks[f"grouped_{layer}_groups"]
        assert int(got_g) == int(want_g)
        seen.add(int(got_g))
        for key in (f"grouped_{layer}_slab", f"grouped_{layer}_gathered"):
            got, want = checks[key]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {rank} {layout} {key}")
    assert seen == ({1, 2}, {4, 8}, {1})[layer]
