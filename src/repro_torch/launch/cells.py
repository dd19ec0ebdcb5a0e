"""The (arch x shape) dry-run cell matrix and each cell's step (the
reference's ``launch/cells.py``).

Shared by ``launch/dryrun.py`` (the traced step) and ``launch/roofline.py``
(the analysis).  Skip policy, as the reference's:
  * encoder-only archs (hubert) have no decode step: decode cells skipped;
  * ``long_500k`` runs only for sub-quadratic archs (ssm/hybrid/sliding-
    window gemma3); pure full-attention archs skip it.

``build_cell`` builds every argument of a cell's step on the ``meta``
device (no storage) and lays it out as DTensors on the context's mesh,
leaf by leaf, each rank keeping its own shard (``sharding.partitioning``'s
``shard_*``: no communication); nothing is materialised.  Its placements
take the place of the reference's ``in_shardings``/``out_shardings``.  The reference donates the train
state and the decode caches (``donate_argnums``); the port's train step
and decode write them in place, which is the same thing.  The
reference's ``CellProgram.lower()`` has no counterpart: ``trace()`` runs
the step once on its ``meta`` arguments under ``comm_analysis.Recorder``
and returns what it saw.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_map

from repro_torch.config import (LM_SHAPES, SHAPES_BY_NAME, ArchConfig,
                                ShapeConfig, get_arch, list_archs)
from repro_torch.launch.comm_analysis import (CollectiveEvent,
                                              CollectiveStats, Recorder,
                                              tensor_bytes, tensors_of)
from repro_torch.models import lm, transformer
from repro_torch.optim import adam
from repro_torch.sharding import partitioning
from repro_torch.sharding.context import ShardingCtx, use_sharding

__all__ = ["SUBQUADRATIC", "cell_skip_reason", "all_cells",
           "runnable_cells", "input_specs", "CellProgram", "CellTrace",
           "default_profile", "tune_cache_rules", "build_cell"]

SUBQUADRATIC = {"rwkv6-7b", "jamba-v0.1-52b", "gemma3-4b", "gemma3-27b"}


def cell_skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    if cfg.is_encoder_only and shape.kind == "decode":
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return ("pure full-attention arch; 500k decode requires "
                "sub-quadratic mechanism")
    return None


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s.name) for a in list_archs() for s in LM_SHAPES]


def runnable_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a, s in all_cells()
            if cell_skip_reason(get_arch(a), SHAPES_BY_NAME[s]) is None]


# ---------------------------------------------------------------------------
# batch specs (meta tensors: never allocated)
# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors of every model input of this cell's step."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"token": spec((B, 1), i32), "pos": spec((), i32)}
    batch: Dict[str, Any] = {}
    if cfg.frontend == "frames":
        batch["frames"] = spec((B, S, cfg.frontend_dim), torch.bfloat16)
    elif cfg.frontend == "patches+tokens":
        P = cfg.num_patches
        batch["patches"] = spec((B, P, cfg.frontend_dim), torch.bfloat16)
        batch["tokens"] = spec((B, S - P), i32)
    else:
        batch["tokens"] = spec((B, S), i32)
    if shape.kind == "train":
        batch["labels"] = spec((B, S), i32)
    return batch


@dataclasses.dataclass
class CellTrace:
    """What one traced call of a cell's step did on this rank."""
    flops: int                       # FLOPs at local shapes
    argument_bytes: int              # local shards of the arguments
    bytes_by_argument: Tuple[int, ...]   # the same, argument by argument
    output_bytes: int                # local shards of the outputs
    peak_bytes: int                  # most storage live at once
    events: List[CollectiveEvent]    # in issue order
    stats: CollectiveStats
    link_wire_bytes: Dict[str, float]
    seconds: float


@dataclasses.dataclass
class CellProgram:
    """Everything needed to trace one cell: fn, its arguments laid out on
    the mesh, their placements and the context (None: one device)."""
    kind: str
    fn: Any
    args: Tuple[Any, ...]
    in_placements: Tuple[Any, ...]
    out_placements: Any
    ctx: Optional[ShardingCtx] = None
    profile: str = "tp_fsdp"

    def trace(self) -> CellTrace:
        """``fn(*args)`` once under a ``comm_analysis.Recorder`` of the
        arguments' device (``meta`` as built here), the serving steps
        under ``torch.inference_mode``, as the launchers run them."""
        rec = Recorder(next(tensors_of(self.args)).device)
        rec.hold(self.args)
        by_arg = tuple(_bytes(a) for a in self.args)
        grad = self.kind == "train_step"
        t0 = time.perf_counter()
        with use_sharding(self.ctx), torch.inference_mode(not grad), rec:
            out = self.fn(*self.args)
            out_bytes = _bytes(out)
        return CellTrace(
            flops=rec.flops, argument_bytes=sum(by_arg),
            bytes_by_argument=by_arg,
            output_bytes=out_bytes, peak_bytes=rec.peak_bytes,
            events=list(rec.events), stats=rec.stats,
            link_wire_bytes=rec.link_wire_bytes(),
            seconds=time.perf_counter() - t0)


def _bytes(tree) -> int:
    """Bytes of a tree's tensors (their local shards), each tensor once:
    the train step returns its state, whose model is a module."""
    return sum(tensor_bytes(t) for t in {id(t): t for t in
                                         tensors_of(tree)}.values())


def default_profile(cfg: ArchConfig, shape: ShapeConfig) -> str:
    """Parallelism profile per cell."""
    if shape.kind == "train":
        return "tp_fsdp"
    return "serve_ep2d" if cfg.name == "deepseek-v3-671b" else "serve"


def tune_cache_rules(ctx: ShardingCtx, cfg: ArchConfig,
                     shape: ShapeConfig) -> None:
    """Pick the decode-cache seq sharding (flash-decode) per cell:
    * kv_heads divide the model axis -> shard heads, seq unsharded
      (long-context additionally shards seq over data);
    * kv_heads don't divide -> shard seq over model (distributed softmax);
      long-context extends it over (data, model)."""
    if shape.kind != "decode":
        return
    long_ctx = shape.seq_len >= 1 << 19
    n_model = ctx.axis_sizes.get("model", 1)
    kv_divisible = (cfg.attn is not None
                    and cfg.attn.num_kv_heads % n_model == 0)
    if cfg.attn is None:
        ctx.rules["cache_seq"] = ()
    elif kv_divisible:
        ctx.rules["cache_seq"] = ("data",) if long_ctx else ()
    else:
        ctx.rules["cache_seq"] = (("data", "model") if long_ctx
                                  else ("model",))


def _shapes(tree):
    return tree_map(lambda t: tuple(t.shape), tree)


def build_cell(cfg: ArchConfig, shape: ShapeConfig,
               ctx: Optional[ShardingCtx], *, param_dtype=torch.bfloat16,
               opt_dtype=torch.float32, remat: bool = True) -> CellProgram:
    """Construct the step program for one (arch x shape) cell, its
    arguments ``meta`` DTensors on ``ctx``'s mesh (plain ``meta`` tensors
    with ``ctx`` None: one device)."""
    batch = input_specs(cfg, shape)

    def lay(b):
        return b if ctx is None else partitioning.shard_batch(ctx, b)

    def place(fn, *a, **kw):
        return None if ctx is None else fn(ctx, *a, **kw)

    model = transformer.Transformer(cfg, dtype=param_dtype, device="meta")
    if shape.kind == "train":
        state = lm.TrainState(model, adam.init(model, opt_dtype))
        if ctx is not None:
            state = partitioning.shard_train_state(ctx, state)
        state_pl = place(partitioning.train_state_shardings, cfg,
                         param_dtype)
        batch_pl = place(partitioning.batch_shardings, _shapes(batch))
        return CellProgram(
            kind="train_step", fn=lm.make_train_step(cfg, remat=remat),
            args=(state, lay(batch)), in_placements=(state_pl, batch_pl),
            out_placements=(state_pl, None), ctx=ctx)

    params = model if ctx is None else partitioning.shard_model(ctx, model)
    params_pl = place(partitioning.param_shardings, cfg, param_dtype)

    if shape.kind == "prefill":
        batch_pl = place(partitioning.batch_shardings, _shapes(batch))
        if cfg.is_encoder_only:
            return CellProgram(
                kind="encode_step", fn=lm.make_encode_step(cfg),
                args=(params, lay(batch)), in_placements=(params_pl,
                                                          batch_pl),
                out_placements=None, ctx=ctx)
        cache_pl = place(partitioning.cache_shardings, cfg, _shapes(
            transformer.init_caches(cfg, shape.global_batch, shape.seq_len,
                                    device="meta")), long_context=False)
        return CellProgram(
            kind="prefill_step", fn=lm.make_prefill_step(cfg),
            args=(params, lay(batch)), in_placements=(params_pl, batch_pl),
            out_placements=(None, cache_pl), ctx=ctx)

    # decode
    long_context = shape.seq_len >= 1 << 19
    caches = transformer.init_caches(cfg, shape.global_batch, shape.seq_len,
                                     device="meta")
    cache_pl = place(partitioning.cache_shardings, cfg, _shapes(caches),
                     long_context=long_context)
    if ctx is not None:
        caches = partitioning.shard_caches(ctx, cfg, caches,
                                           long_context=long_context)
    token = lay({"token": batch["token"]})["token"]
    tok_pl = place(partitioning.batch_shardings,
                   {"token": tuple(batch["token"].shape)})
    return CellProgram(
        kind="serve_step", fn=lm.make_decode_step(cfg),
        args=(params, caches, token, batch["pos"]),
        in_placements=(params_pl, cache_pl,
                       None if tok_pl is None else tok_pl["token"],
                       place(partitioning.replicated)),
        out_placements=(None, cache_pl), ctx=ctx)

