"""Narrowed networks and small mixes that let a whole run of every cell go
through on the CPU in a second or two (the port's plain paths)."""
import dataclasses

from repro_torch.config import get_snn

from skybench import harness

NARROW = {
    "snn-mnist": dict(input_hw=[12, 12], conv_channels=[4, 8, 4],
                      timesteps=3),
    "snn-seg": dict(input_hw=[12, 20], conv_channels=[4, 8, 8, 8, 4, 1],
                    timesteps=3),
}
MIX = {
    "closed_infer": dict(batch=4, pool_batches=2, ref_block=4),
    "open_loop": dict(pool_frames=6, rate_per_s=40, warm_requests=4,
                      check_requests=20, max_batch=4),
    "closed_train": dict(batch=4, pool_batches=4),
}


def tiny(config_name: str, mode: str):
    """(cfg, model override, traffic override) of a narrowed cell."""
    over = NARROW[config_name]
    conf = harness.load_config(config_name)
    cfg = dataclasses.replace(
        get_snn(conf["snn_config"]), input_hw=tuple(over["input_hw"]),
        conv_channels=tuple(over["conv_channels"]),
        timesteps=over["timesteps"])
    return cfg, over, MIX[mode]


def run_tiny(workload: str, *, seconds: float = 0.6, trace: bool = False,
             bench=None, base=harness.BENCH, seed: int = 2**31 + 7):
    """One run of ``workload`` on the CPU at its narrowed size."""
    import time
    bench = bench if bench is not None else harness.load_bench()
    cell = harness.cell_entry(bench, workload)
    mode = harness.load_traffic(cell["traffic"], base)["mode"]
    cfg, over, mix = tiny(cell["config"], mode)
    return harness.run_cell(workload, seed, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            bench=bench, base=base, cfg=cfg,
                            model_override=over, traffic_override=mix,
                            log=lambda s: None)
