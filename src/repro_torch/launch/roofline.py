"""Three-term roofline per (arch x shape x mesh) (the reference's
``launch/roofline.py``), on the NVIDIA H100 SXM's published peaks:

    compute term    = FLOPs / (cards * 989 TFLOP/s dense bf16)
    memory term     = HBM bytes / 3.35 TB/s a card
    collective term = a card's wire bytes of groups within one node of 8
                      / 450 GB/s (NVLink 4, one direction) + those of
                      groups across nodes / 50 GB/s (one 400 Gb/s NDR
                      adapter a card)

Sources:
  * FLOPs: the analytic closed form (``models/counting.py``), as the
    reference's; beside it the dry run's count, rank 0's FLOPs at local
    shapes (``cost.flops``) over the analytic share of one card
    (``cost.analytic_flops``), which shows compute that runs replicated;
  * HBM bytes: analytic, the reference's formulas: weight passes,
    optimizer traffic and layer-boundary activations (+ KV-cache reads
    for decode);
  * collective bytes: the collectives the port's step issues on rank 0,
    recorded by the dry run (``launch/comm_analysis.py``) in
    ``results/torch_dryrun.jsonl``.  A record without the split by link
    (the reference's) is read as all across nodes.

Every figure here is a bound from published peaks and counts from
``meta`` tensors; nothing is measured on a card.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.config import SHAPES_BY_NAME, ArchConfig, ShapeConfig, \
    get_arch
from repro_torch.models.counting import count_params, step_flops
from repro_torch.obs.log import LOG_LEVELS, configure_logging, get_logger

__all__ = ["PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NETWORK_BW",
           "RooflineRow", "make_row", "load_rows", "format_table",
           "format_cells", "main"]

log = get_logger("launch")

PEAK_FLOPS = 989e12      # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
HBM_BW = 3.35e12         # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
NVLINK_BW = 450e9        # NVLink 4 bytes/s a direction, 8 cards a node
NETWORK_BW = 50e9        # one 400 Gb/s NDR adapter a card, across nodes


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    step_kind: str
    profile: str
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops: float           # 6*N_active*D
    total_flops: float           # analytic incl. attention + remat
    useful_ratio: float          # model_flops / total_flops
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    counted_over_analytic: Optional[float] = None   # cost.flops / analytic
    peak_bytes_per_chip: Optional[float] = None     # memory.peak_bytes
    note: str = ""

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute term / critical term: 1.0 means compute-bound at peak."""
        return self.compute_s / self.step_s if self.step_s else 0.0


def _train_hbm_bytes(cfg: ArchConfig, shape: ShapeConfig, chips: int) -> float:
    """Per-card HBM traffic for one train step (dominant terms)."""
    P = count_params(cfg)
    bytes_params = 2.0 * P            # bf16
    bytes_opt = 4.0 * P * 2           # m, v fp32
    # weights: read fwd + remat + bwd (3x), grads written once (bf16),
    # optimizer: read m,v + write m,v + write params
    w_traffic = 3.0 * bytes_params + 2.0 * P + 2.0 * bytes_opt + bytes_params
    # layer-boundary activations: saved + re-read (bf16)
    n_tokens = shape.global_batch * shape.seq_len
    act = 2.0 * cfg.num_layers * n_tokens * cfg.d_model * 2.0
    return (w_traffic + act) / chips


def _decode_hbm_bytes(cfg: ArchConfig, shape: ShapeConfig, chips: int) -> float:
    P_active = count_params(cfg, active_only=True)
    cache = _cache_bytes(cfg, shape)
    return (2.0 * P_active + cache) / chips


def _cache_bytes(cfg: ArchConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    total = 0.0
    for mk, fk in cfg.pattern():
        if mk == "attn_mla":
            a = cfg.attn
            total += B * S * (a.kv_lora_rank + a.qk_rope_dim) * 2
        elif mk == "attn_full":
            a = cfg.attn
            total += B * S * a.num_kv_heads * a.head_dim * 2 * 2
        elif mk == "attn_sliding":
            a = cfg.attn
            total += B * min(S, a.window) * a.num_kv_heads * a.head_dim * 2 * 2
        elif mk == "mamba":
            m = cfg.mamba
            total += B * m.expand * cfg.d_model * (m.d_state * 4 + (m.d_conv - 1) * 2)
        elif mk == "rwkv6":
            hd = cfg.rwkv.head_dim
            total += B * (cfg.d_model // hd) * hd * hd * 4
    return total


def _prefill_hbm_bytes(cfg: ArchConfig, shape: ShapeConfig, chips: int) -> float:
    P_active = count_params(cfg, active_only=True)
    n_tokens = shape.global_batch * shape.seq_len
    act = 2.0 * cfg.num_layers * n_tokens * cfg.d_model * 2.0
    return (2.0 * P_active + act + _cache_bytes(cfg, shape)) / chips


def _collective_s(coll: Dict) -> float:
    links = coll.get("link_wire_bytes")
    if links is None:
        return coll.get("total_wire_bytes", 0.0) / NETWORK_BW
    return (links.get("nvlink", 0.0) / NVLINK_BW
            + links.get("network", 0.0) / NETWORK_BW)


def make_row(rec: Dict) -> Optional[RooflineRow]:
    if rec.get("status") != "ok":
        return None
    cfg = get_arch(rec["arch"])
    shape = SHAPES_BY_NAME[rec["shape"]]
    chips = rec["devices"]
    flops = step_flops(cfg, shape)

    if shape.kind == "train":
        total_flops = flops["train"]
        hbm = _train_hbm_bytes(cfg, shape, chips)
    elif shape.kind == "prefill":
        total_flops = flops["fwd"]
        hbm = _prefill_hbm_bytes(cfg, shape, chips)
    else:
        total_flops = flops["fwd"]
        hbm = _decode_hbm_bytes(cfg, shape, chips)

    coll = rec.get("collectives", {})
    wire = coll.get("total_wire_bytes", 0.0)
    compute_s = total_flops / (chips * PEAK_FLOPS)
    memory_s = hbm / HBM_BW
    collective_s = _collective_s(coll)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)
    model_flops = flops["model_6nd"] * (3.0 if shape.kind == "train" else 1.0)
    cost = rec.get("cost", {})
    counted = None
    if cost.get("analytic_flops") and "flops" in cost:
        counted = cost["flops"] / cost["analytic_flops"]
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        step_kind=rec.get("step_kind", shape.kind),
        profile=rec.get("profile", "baseline"),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bound=bound, model_flops=model_flops, total_flops=total_flops,
        useful_ratio=model_flops / total_flops if total_flops else 0.0,
        hbm_bytes_per_chip=hbm, wire_bytes_per_chip=wire,
        counted_over_analytic=counted,
        peak_bytes_per_chip=rec.get("memory", {}).get("peak_bytes"))


def load_rows(path: str = "results/torch_dryrun.jsonl"):
    # keep the LATEST record per (arch, shape, mesh, profile)
    latest: Dict = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            latest[(r.get("arch"), r.get("shape"), r.get("mesh"),
                    r.get("profile", "baseline"))] = r
    rows = []
    for r in latest.values():
        row = make_row(r)
        if row:
            rows.append(row)
    return sorted(rows, key=lambda r: (r.arch, r.shape, r.mesh))


def format_table(rows, mesh_filter: Optional[str] = None) -> str:
    out = ["| arch | shape | cards | profile | step | compute s | memory s "
           "| collect s | bound | roofline frac | 6ND/FLOPs "
           "| counted/analytic FLOPs |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if mesh_filter and mesh_filter not in r.mesh:
            continue
        counted = ("—" if r.counted_over_analytic is None
                   else f"{r.counted_over_analytic:.2f}")
        out.append(
            f"| {r.arch} | {r.shape} | {r.chips} | {r.profile} | "
            f"{r.step_kind} | {r.compute_s:.3e} | {r.memory_s:.3e} | "
            f"{r.collective_s:.3e} | **{r.bound}** | "
            f"{r.roofline_fraction:.2f} | {r.useful_ratio:.2f} | {counted} |")
    return "\n".join(out)


def format_cells(rows) -> str:
    """One row per cell, its meshes side by side (in ``rows``' order):
    each mesh's three terms and bound, then the dry run's counted over
    analytic FLOPs and peak GB a card on each mesh."""
    cells: Dict = {}
    for r in rows:
        cells.setdefault((r.arch, r.shape, r.step_kind, r.profile),
                         []).append(r)
    out = ["| arch | shape | step | profile | compute s | memory s "
           "| collect s | bound | counted/analytic FLOPs | peak GB |",
           "|---|---|---|---|---|---|---|---|---|---|"]

    def each(rs, fn):
        return " / ".join(fn(r) for r in rs)

    for (arch, shape, step, profile), rs in cells.items():
        out.append(
            f"| {arch} | {shape} | {step} | {profile} "
            f"| {each(rs, lambda r: f'{r.compute_s:.3e}')} "
            f"| {each(rs, lambda r: f'{r.memory_s:.3e}')} "
            f"| {each(rs, lambda r: f'{r.collective_s:.3e}')} "
            f"| {each(rs, lambda r: r.bound)} "
            f"| {each(rs, lambda r: '—' if r.counted_over_analytic is None else f'{r.counted_over_analytic:.2f}')} "
            f"| {each(rs, lambda r: '—' if r.peak_bytes_per_chip is None else f'{r.peak_bytes_per_chip / 1e9:.2f}')} |")
    return "\n".join(out)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/torch_dryrun.jsonl")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--by-cell", action="store_true",
                    help="one row per cell, its meshes side by side")
    ap.add_argument("--log-level", default="info", choices=LOG_LEVELS,
                    help="stderr log verbosity (repro_torch.obs.log)")
    args = ap.parse_args(argv)
    configure_logging(args.log_level)
    rows = load_rows(args.results)
    # the markdown table is this CLI's product: it is pasted into PERF.md
    # and consumed by scripts, so it stays on stdout
    table = format_cells(rows) if args.by_cell else \
        format_table(rows, args.mesh)
    print(table)  # lint: allow(print-ban)
    worst = sorted(rows, key=lambda r: r.roofline_fraction)[:5]
    log.info("worst roofline fractions (hillclimb candidates):")
    for r in worst:
        log.info("  %s x %s (%s): frac=%.2f bound=%s",
                 r.arch, r.shape, r.mesh, r.roofline_fraction, r.bound)
    return rows


if __name__ == "__main__":
    main()
