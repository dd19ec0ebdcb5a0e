"""The paper's spiking networks: the family of a configuration file that
names none.  A file gives the port's ``SNNConfig`` name (``snn_config``)
and every width in its ``model`` block; the modes are ``drivers.py``'s."""
from __future__ import annotations

import dataclasses
from typing import Dict

from skybench.drivers import ClosedInfer, ClosedTrain, OpenLoop

__all__ = ["MODEL_KEYS", "MODES", "NARROW", "port_config", "narrow"]

MODEL_KEYS = ("input_hw", "input_channels", "conv_channels", "kernel_size",
              "dense_units", "timesteps", "v_threshold", "aprc")

MODES = {"closed_infer": ClosedInfer, "open_loop": OpenLoop,
         "closed_train": ClosedTrain}


def port_config(config: Dict):
    """The port's ``SNNConfig`` of ``config``, checked width by width
    against the file's ``model`` block."""
    from repro_torch.config import get_snn
    cfg = get_snn(config["snn_config"])
    for key in MODEL_KEYS:
        have = getattr(cfg, key)
        have = list(have) if isinstance(have, tuple) else have
        if have != config["model"][key]:
            raise ValueError(f"{config['snn_config']}: {key} is {have} in "
                             f"the port, {config['model'][key]} in the file")
    return cfg


# the CPU rehearsal's cuts of the paper's two files, by file name; any
# other file is cut by ``narrow``'s rule
NARROW = {
    "snn-mnist": dict(input_hw=[12, 12], conv_channels=[4, 8, 4],
                      timesteps=3),
    "snn-seg": dict(input_hw=[12, 20], conv_channels=[4, 8, 8, 8, 4, 1],
                    timesteps=3),
}
SMALL_SIDE, SMALL_WIDTH, SMALL_T = 12, 8, 3


def narrow(name: str, config: Dict):
    """(the port's config, the ``model`` override) of the file ``name``
    cut for a run on the CPU in a second or two: ``NARROW``'s entry, or
    else each input side at most 12, each conv width at most 8 and T at
    most 3."""
    from repro_torch.config import get_snn
    model = config["model"]
    over = NARROW.get(name) or dict(
        input_hw=[min(s, SMALL_SIDE) for s in model["input_hw"]],
        conv_channels=[min(c, SMALL_WIDTH) for c in model["conv_channels"]],
        timesteps=min(model["timesteps"], SMALL_T))
    cfg = dataclasses.replace(
        get_snn(config["snn_config"]), input_hw=tuple(over["input_hw"]),
        conv_channels=tuple(over["conv_channels"]),
        timesteps=over["timesteps"])
    return cfg, over
