"""The paper's spiking networks: the family of a configuration file that
names none.  A file gives the port's ``SNNConfig`` name (``snn_config``)
and every width in its ``model`` block; the modes are ``drivers.py``'s."""
from __future__ import annotations

from typing import Dict

from skybench.drivers import ClosedInfer, ClosedTrain, OpenLoop

__all__ = ["MODEL_KEYS", "MODES", "port_config"]

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
