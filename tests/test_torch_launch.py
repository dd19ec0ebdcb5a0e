"""The port's LM accounting against the reference's, with no process
group: the cell matrix (``launch/cells.py``), the collective arithmetic
(``launch/comm_analysis.py`` against ``launch/hlo_analysis.py``) and the
roofline (``launch/roofline.py``).

  * all 40 (arch x shape) cells, their skip reasons and default
    profiles, and every cell's ``input_specs`` (shapes and dtypes) equal
    the reference's;
  * ``tune_cache_rules`` gives the reference's ``cache_seq`` for every
    decode cell on both production meshes (the reference's context on an
    ``AbstractMesh``, the port's on a mesh description);
  * ``CollectiveStats`` fed the collectives of the reference's
    ``test_hlo_analyzer_synthetic``, and each kind at group sizes 2, 4
    and 16, equals ``analyze_collectives`` of the same HLO, kind by kind;
  * ``roofline.make_row`` on the same records gives the reference's
    FLOPs, HBM bytes, model FLOPs and useful ratio to 1e-12 relative,
    each term the reference's times the ratio of the two peaks (H100 SXM
    against the reference's chip); ``load_rows`` keeps the latest record
    per key, as the reference's does.

The traced side (``build_cell`` on the production meshes, ``dryrun``,
the recorder on real collectives) is ``test_torch_dryrun.py``'s.
"""
import json

import pytest
from jax.sharding import AbstractMesh, AxisType

from repro.config import SHAPES_BY_NAME as JX_SHAPES
from repro.config import get_arch as jx_get_arch
from repro.launch import cells as jx_cells
from repro.launch import hlo_analysis as jx_hlo
from repro.launch import roofline as jx_roofline
from repro.sharding import context as jx_ctx
from repro_torch.config import SHAPES_BY_NAME, get_arch
from repro_torch.launch import cells, comm_analysis, roofline
from repro_torch.sharding.context import ShardingCtx, make_rules

MESHES = {"data=16,model=16": ((16, 16), ("data", "model")),
          "pod=2,data=16,model=16": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def test_cell_matrix_matches_the_reference():
    assert cells.all_cells() == jx_cells.all_cells()
    assert len(cells.all_cells()) == 40
    assert cells.runnable_cells() == jx_cells.runnable_cells()
    assert len(cells.runnable_cells()) == 33
    assert cells.SUBQUADRATIC == jx_cells.SUBQUADRATIC
    for arch, shape in cells.all_cells():
        cfg, sh = get_arch(arch), SHAPES_BY_NAME[shape]
        jcfg, jsh = jx_get_arch(arch), JX_SHAPES[shape]
        assert cells.cell_skip_reason(cfg, sh) == \
            jx_cells.cell_skip_reason(jcfg, jsh), (arch, shape)
        assert cells.default_profile(cfg, sh) == \
            jx_cells.default_profile(jcfg, jsh), (arch, shape)


@pytest.mark.parametrize("arch", sorted({a for a, _ in cells.all_cells()}))
def test_input_specs_match_the_reference(arch):
    for shape in SHAPES_BY_NAME:
        got = cells.input_specs(get_arch(arch), SHAPES_BY_NAME[shape])
        want = jx_cells.input_specs(jx_get_arch(arch), JX_SHAPES[shape])
        assert list(got) == list(want), (arch, shape)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (arch, shape, k)
            assert _dtype(v.dtype) == str(want[k].dtype), (arch, shape, k)


def test_tune_cache_rules_match_the_reference_on_both_meshes():
    seen = 0
    for sizes, names in MESHES.values():
        ref_mesh = AbstractMesh(sizes, names,
                                axis_types=(AxisType.Auto,) * len(sizes))
        for arch, shape in cells.all_cells():
            cfg, sh = get_arch(arch), SHAPES_BY_NAME[shape]
            prof = cells.default_profile(cfg, sh)
            ctx = ShardingCtx(tuple(zip(names, sizes)), make_rules(prof))
            ref = jx_ctx.ShardingCtx(ref_mesh, jx_ctx.make_rules(prof))
            cells.tune_cache_rules(ctx, cfg, sh)
            jx_cells.tune_cache_rules(ref, jx_get_arch(arch), JX_SHAPES[shape])
            assert ctx.rules == ref.rules, (arch, shape, names)
            seen += sh.kind == "decode"
    assert seen == 2 * 20


_SYNTHETIC = """
HloModule test, num_partitions=8

%body.1 (p: (s32[], f32[8,8])) -> (s32[], f32[8,8]) {
  %p = (s32[], f32[8,8]{1,0}) parameter(0)
  %g = f32[8,8]{1,0} get-tuple-element(%p), index=1
  %ar = f32[8,8]{1,0} all-reduce(%g), replica_groups=[2,4]<=[8], to_apply=%add.2
  ROOT %t = (s32[], f32[8,8]{1,0}) tuple(%g, %ar)
}

%cond.1 (p: (s32[], f32[8,8])) -> pred[] {
  %p2 = (s32[], f32[8,8]{1,0}) parameter(0)
  %i = s32[] get-tuple-element(%p2), index=0
  %c = s32[] constant(7)
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}

ENTRY %main (a: f32[8,8]) -> f32[8,8] {
  %a = f32[8,8]{1,0} parameter(0)
  %t0 = (s32[], f32[8,8]{1,0}) tuple(%a, %a)
  %w = (s32[], f32[8,8]{1,0}) while(%t0), condition=%cond.1, body=%body.1
  %ag = f32[64,8]{1,0} all-gather(%a), replica_groups=[1,8]<=[8], dimensions={0}
  ROOT %r = f32[8,8]{1,0} get-tuple-element(%w), index=1
}
"""


def kind_hlo(kind: str, n: int, rows: int = 8, cols: int = 8) -> str:
    """One collective of ``kind`` over groups of ``n`` on an f32[rows,
    cols] operand, as XLA prints it (the reference's parser reads it)."""
    out = {"all-gather": f"f32[{rows * n},{cols}]",
           "reduce-scatter": f"f32[{rows // n},{cols}]"}.get(
               kind, f"f32[{rows},{cols}]")
    return f"""
HloModule k, num_partitions={n}

ENTRY %main (a: f32[{rows},{cols}]) -> {out} {{
  %a = f32[{rows},{cols}]{{1,0}} parameter(0)
  ROOT %c = {out}{{1,0}} {kind}(%a), replica_groups=[1,{n}]<=[{n}]
}}
"""


def _same_stats(got, want):
    for field in ("payload_bytes", "wire_bytes", "count"):
        g = {k: v for k, v in getattr(got, field).items() if v}
        w = {k: v for k, v in getattr(want, field).items() if v}
        assert g == w, field
    assert got.total_wire() == want.total_wire()
    assert got.total_payload() == want.total_payload()


def test_collective_stats_match_the_reference_on_its_synthetic_hlo():
    st = comm_analysis.CollectiveStats()
    body = comm_analysis.CollectiveStats()
    body.add("all-reduce", 8 * 8 * 4, 4)      # the while body, 7 trips
    st.merge_scaled(body, 7.0)
    st.add("all-gather", 8 * 8 * 4, 8)
    _same_stats(st, jx_hlo.analyze_collectives(_SYNTHETIC))


@pytest.mark.parametrize("n", (2, 4, 16))
def test_collective_stats_match_the_reference_per_kind(n):
    payload = 16 * 8 * 4
    for kind in KINDS:
        st = comm_analysis.CollectiveStats()
        st.add(kind, payload, n)
        ev = comm_analysis.CollectiveEvent(kind, payload, n, False)
        want = jx_hlo.analyze_collectives(kind_hlo(kind, n, rows=16))
        _same_stats(st, want)
        assert ev.wire_bytes == want.wire_bytes[kind]
    assert comm_analysis.COLLECTIVE_KINDS == jx_hlo.COLLECTIVE_KINDS


def _records():
    """A record of every runnable cell on both meshes, with collectives
    the reference's records carry (no split by link)."""
    out = []
    for i, (arch, shape) in enumerate(cells.runnable_cells()):
        for mesh, devices in (("data=16,model=16", 256),
                              ("pod=2,data=16,model=16", 512)):
            out.append({"arch": arch, "shape": shape, "mesh": mesh,
                        "devices": devices, "status": "ok",
                        "profile": "tp_fsdp", "step_kind": "x",
                        "collectives": {"total_wire_bytes":
                                        1e9 * (i + 1) / devices}})
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def test_roofline_rows_match_the_reference_scaled_by_the_peaks():
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW == 450e9 and roofline.NETWORK_BW == 50e9
    for rec in _records():
        got, want = roofline.make_row(rec), jx_roofline.make_row(rec)
        for f in ("total_flops", "hbm_bytes_per_chip", "model_flops",
                  "useful_ratio", "wire_bytes_per_chip"):
            assert _rel(getattr(got, f), getattr(want, f)) <= 1e-12, f
        assert _rel(got.compute_s, want.compute_s * jx_roofline.PEAK_FLOPS
                    / roofline.PEAK_FLOPS) <= 1e-12
        assert _rel(got.memory_s, want.memory_s * jx_roofline.HBM_BW
                    / roofline.HBM_BW) <= 1e-12
        assert _rel(got.collective_s, want.collective_s * jx_roofline.LINK_BW
                    / roofline.NETWORK_BW) <= 1e-12
        assert got.counted_over_analytic is None


def test_roofline_collective_term_splits_by_link():
    rec = dict(_records()[0], cost={"flops": 3e12, "analytic_flops": 1e12})
    rec["collectives"] = {"total_wire_bytes": 5e9, "link_wire_bytes":
                          {"nvlink": 4.5e9, "network": 0.5e9}}
    row = roofline.make_row(rec)
    assert _rel(row.collective_s, 4.5e9 / 450e9 + 0.5e9 / 50e9) <= 1e-12
    assert row.counted_over_analytic == 3.0
    assert "| 3.00 |" in roofline.format_table([row])


def test_load_rows_keeps_the_latest_record_per_key(tmp_path):
    recs = _records()[:4]
    later = dict(recs[0], collectives={"total_wire_bytes": 7e9})
    path = tmp_path / "dry.jsonl"
    with open(path, "w") as f:
        for r in recs + [later, dict(recs[1], status="error", error="x"),
                         dict(recs[2], status="skipped", reason="y")]:
            f.write(json.dumps(r) + "\n")
    got = roofline.load_rows(str(path))
    want = jx_roofline.load_rows(str(path))
    assert [(r.arch, r.shape, r.mesh) for r in got] == \
        [(r.arch, r.shape, r.mesh) for r in want]
    assert [r.wire_bytes_per_chip for r in got] == \
        [r.wire_bytes_per_chip for r in want]
    assert len(got) == 2 and 7e9 in [r.wire_bytes_per_chip for r in got]


def test_format_cells_puts_a_cells_meshes_side_by_side():
    recs = [dict(r, cost={"flops": 2e12, "analytic_flops": 1e12},
                 memory={"peak_bytes": 3e9 / r["devices"] * 256})
            for r in _records()[:4]]
    rows = [roofline.make_row(r) for r in recs]
    table = roofline.format_cells(rows).splitlines()
    assert len(table) == 2 + 2
    assert table[2].count(" / ") == 6
    assert "| 2.00 / 2.00 | 3.00 / 1.50 |" in table[2]
    assert table[2].startswith(f"| {rows[0].arch} | {rows[0].shape} |")


def test_dry_run_needs_the_fake_backend(monkeypatch):
    import sys

    import torch.distributed as dist

    from repro_torch.launch import dryrun
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="never falls back to a group "
                                           "of one"):
        dryrun.init_fake_group(256)
