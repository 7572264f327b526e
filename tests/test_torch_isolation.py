"""The port stands alone: it imports neither JAX nor the JAX package (nor
scipy or matplotlib, which the card's machine may lack), its entry points
refuse to run on the CPU unless asked to, and its weight bridge emits
exactly the JAX package's exporter output."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ste_gan_torch import constants as C
from ste_gan_torch import interop
from ste_gan_torch.config import Config as TConfig
from ste_gan_tpu.interop import torch_export
from ste_gan_tpu.models.discriminator import DiscriminatorEnsemble
from ste_gan_tpu.models.emg_encoder import EMGEncoderTransformer
from ste_gan_tpu.models.generator import EMGGeneratorGanTTS

ROOT = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import ste_gan_torch, chip_smoke, compare_conv\n"
        "for m in pkgutil.walk_packages(ste_gan_torch.__path__, "
        "'ste_gan_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ste_gan_tpu', 'scipy', "
        "'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_parallel_modules_import_no_jax():
    """The multi-rank layer in a fresh interpreter: the modules a rank and
    the launcher import bring in no JAX, nothing of the JAX package."""
    code = (
        "import sys\n"
        "import ste_gan_torch.parallel.mesh, ste_gan_torch.parallel.fsdp\n"
        "import ste_gan_torch.parallel.multiprocess\n"
        "import ste_gan_torch.parallel.launch\n"
        "import ste_gan_torch.parallel.tensor_parallel\n"
        "import ste_gan_torch.parallel.sequence_parallel\n"
        "import ste_gan_torch.parallel.pipeline_parallel\n"
        "import ste_gan_torch.parallel.expert_parallel\n"
        "import ste_gan_torch.parallel.multiprocess_axes\n"
        "from ste_gan_torch.parallel import (create_mesh_2d,\n"
        "    synthesize_time_sharded, create_stage_mesh_2d,\n"
        "    pipeline_apply, create_expert_mesh, shard_moe_module_)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ste_gan_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_parallel_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """A rank runs on its card unless asked for the CPU, and NCCL is never
    swapped for gloo (or the card for the CPU) by itself."""
    from ste_gan_torch.parallel import (
        mesh, multiprocess, multiprocess_axes, sequence_parallel)

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multiprocess.main(["--out", str(tmp_path / "out")])
    for mode in ("pipeline", "expert"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multiprocess_axes.main(["--mode", mode,
                                    "--out", str(tmp_path / mode)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sequence_parallel.main(["--out", str(tmp_path / "sp")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_distributed()
    with pytest.raises(ValueError, match="nccl backend needs device cuda"):
        mesh.init_distributed("nccl", 10, "cpu")
    assert not torch.distributed.is_initialized()


def test_entry_points_raise_without_cuda(monkeypatch):
    from ste_gan_torch.train.gan import build_models, main_path

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_models(TConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_path()


def test_inference_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from ste_gan_torch import evaluate, generate_emg
    from ste_gan_torch.infer import EMGDecoder, EMGSynthesizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    calls = [
        lambda: EMGSynthesizer.from_config(TConfig(), {}),
        lambda: EMGDecoder.from_checkpoint(TConfig(), missing),
        lambda: evaluate.main(["gan", "--run_dir", missing,
                               "--emg_enc_ckpt", missing]),
        lambda: evaluate.main(["encoder", "--ckpt", missing, "--data_root",
                               missing]),
        lambda: generate_emg.main(["--run_dir", missing]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_deployment_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Export, artifact loading and serving run on the card unless asked
    otherwise; an artifact with its meta file still refuses the CPU."""
    from ste_gan_torch import (export, export_emg_encoder, export_generator,
                               serve, serve_load)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    artifact = tmp_path / "generator-serving.pt2"
    artifact.write_bytes(b"")
    (tmp_path / "generator-serving.pt2.meta.json").write_text(
        '{"serving": true, "device": "cuda:0", "feature_dim": 256, '
        '"upsample": 16, "num_emg_channels": 8, "min_frames": 101, '
        '"num_sessions": 8, "num_speaking_modes": null}')
    calls = [
        lambda: serve.main(["--run_dir", missing]),
        lambda: serve.main(["--artifact", str(artifact)]),
        lambda: serve.SynthesisService.from_run_dir(missing),
        lambda: serve.SynthesisService.from_artifact(artifact),
        lambda: serve.EMGDecoderService(artifact),
        lambda: serve_load.main(["--run_dir", missing]),
        lambda: export.ExportedSynthesizer(artifact),
        lambda: export.load_exported(artifact),
        lambda: export_generator.main(["--run_dir", missing]),
        lambda: export_emg_encoder.main(["--ckpt", missing]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_corpus_preparation_raises_without_cuda(monkeypatch, tmp_path):
    """The cleaning and prep CLIs, the MFCC frontend and the filter
    cascade on a CUDA tensor refuse to run without a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ste_gan_torch import clean_audio, prep_data
    from ste_gan_torch.etl.audio_dsp import MFCCsCalculator
    from ste_gan_torch.ops.iir import filtfilt_cascade

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing")
    calls = [
        lambda: prep_data.main(["--source_data_dir", missing,
                                "--target_dir", missing]),
        lambda: clean_audio.main(["--source_data_dir", missing]),
        lambda: MFCCsCalculator(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with FakeTensorMode(allow_non_fake_inputs=True):
        rows = torch.zeros(8, 100, dtype=torch.float64, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            filtfilt_cascade(rows, [100] * 8, [(np.ones(3), np.ones(3))])
    assert not any(tmp_path.iterdir())


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _assert_same(got, want):
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_bridge_equals_jax_exporter():
    key = jax.random.PRNGKey(0)
    feats = np.zeros((1, 8, 256), np.float32)
    ids = np.zeros((1,), np.int32)
    gen = EMGGeneratorGanTTS(num_sessions=4, channels=32)
    gparams = gen.init(key, feats, ids, ids)["params"]
    _assert_same(
        interop.generator_params_to_state_dict(gparams,
                                               C.DataType.SPEECH_UNITS),
        torch_export.generator_params_to_state_dict(
            gparams, C.DataType.SPEECH_UNITS))

    disc = DiscriminatorEnsemble(
        period_spec_override=((8, 3, 1, 2), (16, 3, 3, 2)),
        scale_spec_override=((8, 15, 1, 1, 7), (16, 9, 2, 4, 4)))
    dvars = disc.init(key, np.zeros((1, 128, 8), np.float32), train=False)
    _assert_same(
        interop.discriminator_params_to_state_dict(dvars["params"],
                                                   dvars["spectral"]),
        torch_export.discriminator_params_to_state_dict(dvars["params"],
                                                        dvars["spectral"]))

    enc = EMGEncoderTransformer(model_size=32, num_transformer_layers=1,
                                num_heads=4, dim_feedforward=64)
    evars = enc.init(key, np.zeros((1, 256, 8), np.float32), train=False)
    _assert_same(interop.encoder_variables_to_state_dict(evars),
                 torch_export.encoder_variables_to_state_dict(evars))


@pytest.mark.parametrize("config,data,encoder", [
    ("configs/ste_gan_base_gantts.yaml", "configs/data/synthetic.yaml",
     "configs/emg_encoder/conv_transformer.yaml"),
    ("configs/ste_gan_25k_synth.yaml", None, None),
    ("configs/ste_gan_mfcc_synth.yaml", "configs/data/synthetic_hard.yaml",
     None),
    ("configs/ste_gan_speaking_mode.yaml", None,
     "configs/emg_encoder/conv_transformer_moe.yaml"),
    ("configs/ste_gan_xl_synth.yaml", "configs/data/synthetic_xl.yaml", None),
])
def test_config_copy_loads_the_same_yaml(config, data, encoder):
    from ste_gan_torch.config import load_config as t_load
    from ste_gan_tpu.config import load_config as j_load

    paths = [None if p is None else str(ROOT / p)
             for p in (config, data, encoder)]
    assert t_load(*paths).to_dict() == j_load(*paths).to_dict()
