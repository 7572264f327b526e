"""Time-sharded synthesis of the port (``ste_gan_torch/parallel/
sequence_parallel.py``) on spawned CPU gloo ranks against one-device
synthesis and against the JAX package's ``synthesize_time_sharded`` on its
8-device CPU mesh, at the tolerance of ``tests/test_sequence_parallel.py``
(atol 2e-4).

One spawn of four ranks (rendezvous through a file under ``tmp_path``)
runs every case: over all four ranks, and over two ranks ([0, 1] and
[2, 3], the same call in two groups), for 512 frames (blocks that divide
evenly), 1000 (the round-up padding path) and 200 (blocks shorter than
the 128-frame context: three hops at four ranks, and at two ranks one hop
that covers less than the context, the far-side padding path). Every rank
returns the whole result, so each rank's output is held.
"""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ste_gan_torch import interop
from ste_gan_torch.models.generator import EMGGeneratorGanTTS as TGen
from ste_gan_torch.parallel.launch import run_ranks
from ste_gan_torch.parallel.sequence_parallel import (
    synthesize_time_sharded)
from ste_gan_tpu.models.generator import EMGGeneratorGanTTS as JGen
from ste_gan_tpu.parallel.mesh import create_mesh
from ste_gan_tpu.parallel.sequence_parallel import (
    synthesize_time_sharded as j_synthesize_time_sharded)

ROOT = Path(__file__).resolve().parents[1]
RANK_ENV = {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join(
                [str(ROOT)] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else []))}
FRAMES = (512, 1000, 200)
SESSION = 2

#: Each rank: the generator from ``weights.pt``, every case over the
#: world and over its pair, each output saved as ``{ranks}_{frames}_r{rank}``.
RANK_CODE = r'''
import sys, numpy as np, torch, torch.distributed as dist
from ste_gan_torch.models.generator import EMGGeneratorGanTTS
from ste_gan_torch.parallel import mesh as M
from ste_gan_torch.parallel.sequence_parallel import synthesize_time_sharded
out, init = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
M.init_distributed("gloo", 90, "cpu", init)
rank = dist.get_rank()
gen = EMGGeneratorGanTTS(num_sessions=4, channels=32).eval()
gen.load_state_dict(torch.load(f"{out}/weights.pt", weights_only=True))
pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
feats = np.load(f"{out}/feats.npz")
res = {}
for frames in ''' + repr(FRAMES) + r''':
    f = feats[str(frames)]
    res[f"4_{frames}_r{rank}"] = synthesize_time_sharded(
        gen, f, ''' + repr(SESSION) + r''', group=dist.group.WORLD)
    res[f"2_{frames}_r{rank}"] = synthesize_time_sharded(
        gen, f, ''' + repr(SESSION) + r''', group=pairs[rank // 2])
np.savez(f"{out}/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX test's generator (4 sessions, 32 channels, PRNGKey(0)),
    carried to the port; seeded features per case."""
    tmp = tmp_path_factory.mktemp("sequence_parallel")
    jgen = JGen(num_sessions=4, channels=32)
    ids = jnp.zeros((1,), jnp.int32)
    params = jgen.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 256)), ids,
                       ids)["params"]
    tgen = TGen(num_sessions=4, channels=32).eval()
    interop.load_generator(tgen, params, tgen.speech_feature_type)
    torch.save(tgen.state_dict(), tmp / "weights.pt")
    rng = np.random.default_rng(0)
    feats = {str(f): rng.normal(size=(f, 256)).astype(np.float32)
             for f in FRAMES}
    np.savez(tmp / "feats.npz", **feats)
    return tmp, jgen, params, tgen, feats


@pytest.fixture(scope="module")
def ranks(setup):
    tmp = setup[0]
    rendezvous = f"file://{(tmp / 'rendezvous').resolve()}"
    run_ranks([sys.executable, "-c", RANK_CODE, str(tmp), rendezvous], 4,
              tmp / "logs", 240, env=RANK_ENV)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def one_device(setup):
    _, _, _, tgen, feats = setup
    return {f: synthesize_time_sharded(tgen, feats[str(f)], SESSION)
            for f in FRAMES}


@pytest.mark.parametrize("frames", FRAMES)
@pytest.mark.parametrize("world", [2, 4])
def test_matches_one_device(ranks, one_device, frames, world):
    want = one_device[frames]
    assert want.shape == (16 * frames, 8)
    for rank, saved in enumerate(ranks):
        got = saved[f"{world}_{frames}_r{rank}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-4,
                                   err_msg=f"rank {rank} of {world}")


@pytest.mark.parametrize("frames", FRAMES)
def test_matches_the_jax_time_sharded_synthesis(setup, ranks, frames):
    _, jgen, params, _, feats = setup
    want = j_synthesize_time_sharded(jgen, params, feats[str(frames)],
                                     session_idx=SESSION,
                                     mesh=create_mesh(8))
    for world in (2, 4):
        got = ranks[0][f"{world}_{frames}_r0"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-4,
                                   err_msg=f"{world} ranks")


def test_one_device_equals_the_synthesizer(setup, one_device):
    """With no group the function is one window with zero halos: the
    exact synthesis of ``EMGSynthesizer``."""
    from ste_gan_torch.infer import EMGSynthesizer

    _, _, _, tgen, feats = setup
    synth = EMGSynthesizer(tgen, device="cpu")
    for frames in FRAMES:
        np.testing.assert_allclose(
            one_device[frames], synth.synthesize(feats[str(frames)], SESSION),
            atol=2e-4)
