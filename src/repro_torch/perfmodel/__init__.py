from repro_torch.perfmodel.skydiver import (HardwareConfig, LayerPerf, NetPerf,
                                      XC7Z045, simulate_network)

__all__ = ["HardwareConfig", "LayerPerf", "NetPerf", "XC7Z045", "simulate_network"]
