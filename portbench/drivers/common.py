"""What the drivers share: the program's configuration from a config file,
the reference's modules with the seeded weights, and the draws of lengths
that every seed shares (only their order and the values drawn at those
lengths change with the seed, so every seed does the same work)."""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from portbench.reference import nets
from portbench.weights import seeded_state

#: Offsets of the seed for each stream drawn from it, so the streams differ.
WEIGHTS, DATA, ORDER = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng((int(seed), stream))


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 7919 + stream) % (2 ** 63))


def program_config(run):
    """The program's ``Config`` from the config file's ``program`` part."""
    from ste_gan_torch.config import config_from_dict

    return config_from_dict(run.config["program"])


def sizes(config: Dict) -> Dict[str, Dict]:
    """The reference's constructor arguments per network (``g``, ``d``,
    ``e``), read from the config file's ``program`` part, so every width
    has one copy; what the program part does not name (256 speech-unit
    dimensions, 48 phonemes, the 64-wide session embedding) are the
    reference's defaults."""
    prog = config["program"]
    ch = prog["data"]["num_emg_channels"]
    enc = prog["emg_encoder"]["params"]
    out = {"e": dict(num_ins=ch, model_size=enc["model_size"],
                     extra_blocks=enc["num_extra_res_blocks"],
                     layers=enc["num_transformer_layers"],
                     heads=enc["num_heads"], ffn=enc["dim_feedforward"])}
    if "model" in prog:
        out["g"] = dict(num_sessions=prog["data"]["num_emg_sessions"],
                        channels=prog["model"]["params"]["channels"],
                        out_ch=ch)
        out["d"] = dict(cin=ch)
    return out


def batch_shape(config: Dict) -> Tuple[int, int]:
    """The GAN step's rows and EMG samples a row."""
    t = config["program"]["train"]
    return int(t["batch_size"]), int(t["chunk_size"])


def reference_modules(config: Dict, which: Iterable[str]
                      ) -> Dict[str, torch.nn.Module]:
    """The reference's networks of ``config`` on the meta device."""
    kw = sizes(config)
    ctor = {"g": lambda: nets.Generator(**kw["g"]),
            "d": lambda: nets.Discriminator(**kw["d"]),
            "e": lambda: nets.Encoder(**kw["e"])}
    with torch.device("meta"):
        return {k: ctor[k]() for k in which}


def seeded_weights(config: Dict, which: Iterable[str], seed: int, device
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    metas = reference_modules(config, which)
    return seeded_state(list(metas.items()), torch_gen(seed, WEIGHTS, device)
                        .initial_seed(), device)


def materialise(module: torch.nn.Module, state: Dict[str, torch.Tensor],
                device) -> torch.nn.Module:
    """A meta-device module moved to ``device`` and loaded strictly."""
    module.to_empty(device=device)
    module.load_state_dict(state, strict=True)
    return module


def reference_nets(config: Dict, which: Iterable[str], seed: int, device
                   ) -> Tuple[Dict[str, torch.nn.Module], Dict]:
    """The reference's networks with the run's seeded weights in f32."""
    which = list(which)
    states = seeded_weights(config, which, seed, device)
    metas = reference_modules(config, which)
    return ({k: materialise(m, states[k], device) for k, m in metas.items()},
            states)


def spread_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` lengths spread evenly over ``[lo, hi]``."""
    return np.round(np.linspace(lo, hi, n)).astype(np.int64)


def lognormal_lengths(n: int, median: float, sigma: float, lo: int,
                      hi: int) -> np.ndarray:
    """The ``n`` quantiles at ``(i + 0.5) / n`` of a log-normal with the
    given median and sigma, clipped to ``[lo, hi]``."""
    from statistics import NormalDist

    z = np.asarray([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.round(median * np.exp(sigma * z)), lo, hi).astype(
        np.int64)
