"""Step functions: train, prefill, encode and decode, and the loss, shared
by the launchers, the examples and the tests.

``make_*_step`` return functions of (state, batch), (params, batch) or
(params, caches, token, pos), as the reference's do.  The train step
writes its ``TrainState`` in place (``optim.adam``: a functional update
of a full-width model would not fit on the card beside its grads) and
returns it with its metrics, 0-d tensors on the device; it makes no host
sync.  Every point where it can raise (the forward, the backward, the
clip) comes before its first write, so a step that raises leaves the
state as it was, as the reference's functional step does
(``runtime.fault_tolerance.ResilientLoop`` relies on that).

Under a ``ShardingCtx`` on a torch mesh the state is DTensors
(``sharding.partitioning``): the step lays the batch out over the batch
axes, brings each grad to its moments' layout (a reduce-scatter where
they are split, ZeRO-1 included), and before its first write all ranks
agree that every rank got there (one all-reduce of a flag, after the
step's last other collective): a failure on any rank after that
collective (the clip, the lr) raises on every rank and no rank writes
(``_agreed``).  The
metrics come out replicated, plain tensors.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.optim import adam, schedules
from repro_torch.sharding.context import current_ctx, lay_out, mesh_ops, \
    redistribute

__all__ = ["TrainState", "cross_entropy", "loss_fn", "make_train_step",
           "make_prefill_step", "make_encode_step", "make_decode_step",
           "init_train_state"]


class TrainState(NamedTuple):
    params: Any                 # a ``transformer.Transformer``
    opt: adam.AdamState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits (B, S, V) any dtype; labels (B, S) integer, -1 = masked.
    Mean over the unmasked positions, in float32."""
    mask = labels >= 0
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    is_gold = vocab == torch.where(mask, labels, -1)[..., None]
    mx = torch.amax(logits, dim=-1)
    exp = torch.exp(logits.to(torch.float32)
                    - mx.to(torch.float32)[..., None])
    logz = torch.log(torch.sum(exp, dim=-1)) + mx.to(torch.float32)
    gold = torch.sum(torch.where(is_gold, logits, 0).to(torch.float32),
                     dim=-1)
    ce = (logz - gold) * mask.to(torch.float32)
    return ce.sum() / torch.clamp(mask.sum().to(torch.float32), min=1.0)


def loss_fn(params, cfg: ArchConfig, batch: Dict, *, remat: bool = True):
    """(loss, {"ce", "aux"}) of a forward over ``batch`` ("tokens",
    "frames" or "patches", and "labels")."""
    logits, aux = transformer.forward(
        params, cfg, tokens=batch.get("tokens"), frames=batch.get("frames"),
        patches=batch.get("patches"), remat=remat)
    ce = cross_entropy(logits, batch["labels"])
    moe_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return ce + moe_w * aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: ArchConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    clip_norm: float = 1.0, remat: bool = True):
    """The reference's step: loss and grads of ``loss_fn``, the grads
    clipped to ``clip_norm``, ``lr = linear_warmup_cosine(step + 1)``, then
    the AdamW update, which writes the state in place.  Returns
    ``(state, metrics)``: ``ce``, ``aux``, ``loss``, ``grad_norm`` and
    ``lr``, detached 0-d tensors."""
    def collect(state: TrainState, batch: Dict):
        """The loss, its grads and the metrics: every collective of a
        sharded step, the global norm's last."""
        model = state.params
        names, leaves = zip(*model.named_parameters())
        loss, metrics = loss_fn(model, cfg, batch, remat=remat)
        if isinstance(loss, DTensor):
            loss = loss.redistribute(loss.device_mesh,
                                     [Replicate()] * loss.device_mesh.ndim)
        # a leaf the loss does not reach gets a zero grad, as under jax.grad
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))}
        metrics = {k: _replicated(v.detach()) for k, v in metrics.items()}
        metrics["loss"] = _replicated(loss.detach())
        if not any(isinstance(g, DTensor) for g in grads.values()):
            return grads, metrics, None
        grads = {n: redistribute(g, state.opt.m[n].placements)
                 for n, g in grads.items()}
        return grads, metrics, adam.global_norm(grads)

    def finish(state: TrainState, grads, metrics, norm):
        """The clip and the lr: no collective."""
        if norm is None:
            grads, gnorm = adam.clip_by_global_norm(grads, clip_norm)
        else:
            grads, gnorm = adam.clip_by_global_norm(grads, clip_norm,
                                                    norm=norm)
        lr = schedules.linear_warmup_cosine(
            state.opt.step + 1, peak_lr=peak_lr, warmup=warmup,
            total=total_steps)
        metrics.update(grad_norm=gnorm, lr=lr)
        return grads, metrics

    def train_step(state: TrainState, batch: Dict):
        if current_ctx() is None:
            grads, metrics = finish(state, *collect(state, batch))
        else:
            with mesh_ops():
                batch = {k: lay_out(v, ("batch",) + (None,) * (v.dim() - 1))
                         for k, v in batch.items()}
                grads, metrics = _agreed(finish, state,
                                         *collect(state, batch))
        # the first write to the state
        adam.update(grads, state.opt, state.params, lr=metrics["lr"])
        return state, metrics

    return train_step


def _replicated(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _agreed(fn, *args):
    """``fn(*args)``, which makes no collective, on every rank of the
    default group; if it raised on any rank, every rank raises before
    returning (this rank's own error where it had one).  A rank that
    fails earlier, in a step's collectives, raises at once and leaves the
    others waiting in a collective: the group's timeout, or ``dist.spmd``
    on that rank's error, ends them all before any writes."""
    err = None
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 — raised again below
        err = e
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    failed = torch.tensor([0 if err is None else 1], device=dev)
    dist.all_reduce(failed)
    if err is not None:
        raise err
    if int(failed):
        raise RuntimeError(f"train step: {int(failed)} other rank(s) "
                           f"failed before the update; no rank wrote")
    return out


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch: Dict):
        return transformer.prefill(
            params, cfg, tokens=batch.get("tokens"),
            frames=batch.get("frames"), patches=batch.get("patches"))

    return prefill_step


def make_encode_step(cfg: ArchConfig):
    """Encoder-only archs (hubert): full forward, no cache, no labels."""
    def encode_step(params, batch: Dict):
        logits, _ = transformer.forward(
            params, cfg, tokens=batch.get("tokens"),
            frames=batch.get("frames"), patches=batch.get("patches"))
        return logits

    return encode_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, caches, token, pos):
        return transformer.decode_step(params, caches, cfg, token=token,
                                       pos=pos)

    return decode_step


def init_train_state(generator: torch.Generator, cfg: ArchConfig,
                     dtype=torch.float32, opt_dtype=torch.float32,
                     device=None) -> TrainState:
    """A ``Transformer`` of ``cfg`` drawn from ``generator`` (which lives on
    ``device``, the card by default) and its zero AdamW state."""
    params = transformer.init_params(generator, cfg, dtype,
                                     device=resolve_device(device))
    return TrainState(params=params, opt=adam.init(params, opt_dtype))
