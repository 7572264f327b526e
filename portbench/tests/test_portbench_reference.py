"""The reference against the program's CPU path at a tiny size: with the
program in f32 the two agree to rounding, so what a cell's check reads on
the card is the program's precision and not a slip of the reference."""
import pytest
import torch

from portbench.drivers import common
from portbench.reference import nets
from portbench.tests.tiny import execute, tiny
from portbench import spec


def test_seeded_weights_load_into_the_program_strictly():
    from ste_gan_torch.config import config_from_dict
    from ste_gan_torch.models.discriminator import init_emg_discriminators
    from ste_gan_torch.models.emg_encoder import init_emg_encoder
    from ste_gan_torch.models.generator import init_emg_generator

    cell = spec.load_cell("gan_su.train", overrides=tiny("gan_su.train"))
    states = common.seeded_weights(cell.config, "gde", 3, "cpu")
    again = common.seeded_weights(cell.config, "gde", 3, "cpu")
    cfg = config_from_dict(cell.config["program"])
    with torch.device("meta"):
        mods = {"g": init_emg_generator(cfg), "d": init_emg_discriminators(cfg),
                "e": init_emg_encoder(cfg)}
    for key, module in mods.items():
        common.materialise(module, states[key], "cpu")
        for name, value in states[key].items():
            assert torch.equal(value, again[key][name]), name


def _numbers(result):
    """Every number a run read: those compared and the readings."""
    return {**result.get("readings", {}),
            **{k: v["value"] for k, v in result["checks"].items()}}


@pytest.mark.parametrize("seed", [2 ** 33 + 1, 7])
def test_gan_step_matches_the_program_in_f32(seed):
    code, result, _ = execute("gan_su.train", seed, f32=True)
    assert code == 0 and result["correct"]
    numbers = _numbers(result)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap.g"] < 1e-3
    assert numbers["change_gap"] < 1e-3
    assert numbers["out_gap"] < 1e-5
    assert numbers["ema_gap"] < 1e-3
    assert numbers["sn_gap"] < 1e-3


def test_encoder_step_matches_the_program():
    code, result, _ = execute("enc.train_mixed", 2 ** 40 + 3)
    assert code == 0 and result["correct"]
    checks = result["checks"]
    assert checks["loss_gap"]["value"] < 1e-5
    assert checks["grad_gap.enc"]["value"] < 1e-3
    assert checks["bn_var_gap"]["value"] < 1e-5
    assert checks["change_gap"]["value"] < 1e-3
    assert checks["out_gap"]["value"] < 1e-5


def test_synthesis_matches_the_program():
    code, result, _ = execute("gan_su.generate", 2 ** 35 + 9)
    assert code == 0 and result["correct"]
    assert result["checks"]["emg_gap"]["value"] < 1e-5


def test_dtw_alignment_by_hand():
    from portbench.reference.train import dtw_align

    costs = torch.tensor([[[0., 9., 9.], [9., 0., 9.], [9., 9., 0.],
                           [9., 9., 0.]]])
    out = dtw_align(costs, torch.tensor([[3, 2]]))
    assert out.tolist() == [[0, 1, 2, 2]]


def test_spectral_norm_dual_equals_two_forwards():
    torch.manual_seed(0)
    layer = nets.SNConv(4, 8, 5, padding=2, groups=2)
    twin = nets.SNConv(4, 8, 5, padding=2, groups=2)
    for m in (layer, twin):
        with torch.no_grad():
            for t in (m.weight_orig, m.bias, m.weight_u, m.weight_v):
                t.copy_(torch.arange(t.numel()).float().view(t.shape).sin())
    a, b = torch.randn(2, 4, 16), torch.randn(2, 4, 16)
    both = layer(torch.cat([a, b]), dual=2)
    first, second = twin(a), twin(b)
    assert torch.allclose(both, torch.cat([first, second]), atol=1e-6)
