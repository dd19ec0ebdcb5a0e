"""Narrowed networks and small mixes that let a whole run of every cell go
through on the CPU in a second or two (the port's plain paths)."""
import json

from skybench import harness


# ``moe16b-decode`` is kept as files (its configuration, traffic mix,
# limits and readers) and out of BENCHMARK.json: the port's MoE
# renormalises its top-k gates and DeepSeekMoE 16B does not, so the port's
# check refuses the file (``port_config``: ``norm_topk_prob``).  These are
# the entries that would declare it; the tests run it narrowed, on the
# port's own gates (``families/lm.py:tiny_lm``).
_DECODE = ["moe16b-decode"]
KEPT_DECODE = {
    "configs": [{"name": "deepseek-moe-16b",
                 "source": "DeepSeekMoE 16B, arXiv:2401.06066",
                 "file": "skybench/configs/deepseek-moe-16b.json",
                 "reduced": [],
                 "why": "a fine-grained MoE whole: 28 layers, 64 routed "
                        "experts of 1408 top-6 plus 2 shared, MHA 16x128, "
                        "bf16"}],
    "workloads": [{"name": "moe16b-decode", "config": "deepseek-moe-16b",
                   "traffic": "decode_16x1k", "chips": 1,
                   "why": "greedy decode, closed loop: 16 sequences of 1024 "
                          "uniform ids, caches of 2048; host launches, the "
                          "attention's full-cache copy, the experts' GEMMs"}],
    "end_to_end": [{"name": "decode_tok_s", "unit": "tokens/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock", "workloads": _DECODE}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "decode_tok_s", "workloads": _DECODE}
        for name, unit, better, source, layer in (
            ("launches.decode", "ops/step", "lower", "device_trace",
             "model"),
            ("roofline.decode", "%", "higher", "device_trace", "kernels"),
            ("mfu.decode", "%", "higher", "host_clock", "whole step"),
            ("idle.decode", "%", "lower", "device_trace", "device"))],
}


def with_kept(bench):
    """A copy of ``bench`` with the kept decode cell declared."""
    out = json.loads(json.dumps(bench))
    for part, entries in KEPT_DECODE.items():
        out[part].extend(json.loads(json.dumps(entries)))
    return out


def tiny(config_name: str, mode: str, base=harness.BENCH):
    """(cfg, model override, traffic override) of a narrowed cell: the
    family's cut of the configuration (``narrow``) and the mode's small
    mix (``SMALL_MIX``)."""
    conf = harness.load_config(config_name, base)
    family = harness.load_family(conf, base)
    return (*family.narrow(config_name, conf), family.MODES[mode].SMALL_MIX)


def run_tiny(workload: str, *, seconds: float = 0.6, trace: bool = False,
             bench=None, base=harness.BENCH, seed: int = 2**31 + 7):
    """One run of ``workload`` on the CPU at its narrowed size."""
    import time
    bench = bench if bench is not None else harness.load_bench()
    cell = harness.cell_entry(bench, workload)
    mode = harness.load_traffic(cell["traffic"], base)["mode"]
    cfg, over, mix = tiny(cell["config"], mode, base)
    return harness.run_cell(workload, seed, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            bench=bench, base=base, cfg=cfg,
                            model_override=over, traffic_override=mix,
                            log=lambda s: None)
