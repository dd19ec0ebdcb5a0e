"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it resolved to the files the harness finds by that name."""
import json
import re

import pytest

from skybench import harness
from skybench.tests._tiny import with_kept

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# what ``reduced`` may name: the depth, and the chip's share of a layer
# (its heads, experts or vocabulary rows); never a width, and nothing of
# the mathematics
CUTS = {"num_hidden_layers", "num_attention_heads", "num_key_value_heads",
        "n_routed_experts", "num_experts", "num_local_experts", "vocab_size"}
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS["top"]
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "skybench/run.py"]
    assert BENCH["paths"] == ["skybench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_entries_keys_names_and_units(kind):
    entries = BENCH[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        texts = {"configs": ("source", "why"), "workloads": ("why",),
                 "per_layer": ("layer",), "end_to_end": ()}[kind]
        for key in texts:
            assert _line(e[key]), (e["name"], key)


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def _reports(cell: str):
    return {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        got = _reports(w["name"])
        assert "setup_s" in got and len(got) >= 2, w["name"]
        layers = [m for m in BENCH["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert layers, w["name"]


def test_per_layer_moves_a_metric_each_of_its_cells_reports():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert m["moves"] in _reports(cell), (m["name"], cell)


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(_line(layer) for layer in layers)


def test_cells_configs_and_files_resolve():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert _line(w["why"])
        assert w["config"] in configs
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = harness.load_traffic(w["traffic"])
        conf = json.loads((harness.ROOT / configs[w["config"]]["file"])
                          .read_text())
        assert traffic["mode"] in harness.load_family(conf).MODES
        limits = harness.load_limits(w["name"])
        assert limits and all(v >= 0 for v in limits.values())
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        assert c["file"].startswith("skybench/configs/")
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            # a cut key gives its published value, and the file says
            # where the rest of the deployment would live
            assert key in CUTS, key
            assert key in conf["published"], key
            assert conf["model"][key] != conf["published"][key], key
        if c["reduced"]:
            assert _line(conf["deployment"])
        harness.port_config(conf)       # every width is the port's


FAMILIES = sorted({harness.load_config(c["name"]).get("family", "snn")
                   for c in with_kept(BENCH)["configs"]})


@pytest.mark.parametrize("family", FAMILIES)
def test_a_family_offers_its_hooks(family):
    """What the harness and the CPU rehearsal take from a family module:
    ``port_config``, ``MODES``, ``narrow``, and each mode's
    ``SMALL_MIX``."""
    mod = harness.load_family({"family": family})
    assert callable(mod.port_config) and callable(mod.narrow)
    assert mod.MODES
    for mode, cls in mod.MODES.items():
        assert isinstance(cls.SMALL_MIX, dict) and cls.SMALL_MIX, mode


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_a_full_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
