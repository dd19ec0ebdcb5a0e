"""Weight interchange with the JAX reference package.

The reference's ``init_snn`` returns ``{"conv": [{"w", "b"}], "dense":
[{"w", "b"}]}`` with RRIO conv weights and (din, dout) dense weights — the
layout the port keeps at its public functions.  ``from_jax_params`` and
``to_numpy_params`` move such a dict, as numpy arrays, into torch tensors
and back, bit for bit, so both packages compute with identical weights.

The LM's parameters are the reference's pytree ``{"embed", "stages":
[{"sub": [{"norm1", "mixer", "norm2", "ffn"}]}], "final_norm"}``, every
stage leaf with a leading repeats axis; the port's are a
``models.transformer.Transformer`` with one sublayer per layer, under the
same leaf names (a nested group of leaves, MoE's ``shared`` or MLA's
``q_norm``, is a submodule of the same name).  ``from_jax_lm_params`` and ``to_numpy_lm_params``
convert between the two, bit for bit, and ``*_lm_caches`` do the same for
the decode caches (the reference's stacked per-stage caches, the port's
per-layer list).  None of these imports JAX: the caller hands over numpy
arrays (``np.asarray`` of each JAX leaf; a bfloat16 leaf keeps its bits),
and float32 leaves of a bfloat16 model (Mamba's ``A_log`` and ``D``,
RWKV6's ``w0`` and ``u``; the Mamba and RWKV6 states of bfloat16 caches)
stay float32, as in the reference.

With ``ctx`` (a ``ShardingCtx`` on a torch mesh) the ``from_jax_*``
functions lay what they carry out on the mesh
(``sharding.partitioning``: every rank holds the numpy arrays and keeps
its shard), and the ``to_numpy_*`` functions gather DTensor leaves whole
(on every rank: each must call them).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.tree import flatten_with_paths

__all__ = ["from_jax_params", "to_numpy_params", "from_jax_lm_params",
           "to_numpy_lm_params", "from_jax_lm_caches", "to_numpy_lm_caches",
           "from_jax_train_state", "to_numpy_train_state"]


def _map(params: Dict, fn) -> Dict:
    return {k: [{n: fn(a) for n, a in layer.items()} for layer in params[k]]
            for k in ("conv", "dense")}


def from_jax_params(np_params: Dict, device=None) -> Dict:
    """numpy (or array-like) parameter dict -> float32 torch tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return _map(np_params, lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev))


def to_numpy_params(params: Dict) -> Dict:
    """torch parameter dict (any device) -> float32 numpy arrays."""
    return _map(params, lambda t: t.detach().cpu().numpy())


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """A numpy array as a torch tensor on ``dev``, its bits kept; a
    bfloat16 array (numpy has no such type of its own) by its 16-bit
    pattern."""
    a = np.array(a)             # a copy: the tensor may be written in place
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(dev)
    return torch.from_numpy(a).to(dev)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bfloat16 widens to float32 (exact);
    a DTensor is gathered whole first (a collective: every rank calls)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _layer_slots(cfg: ArchConfig) -> Iterator[Tuple[int, int, int, int]]:
    """(layer, stage, repeat, sub) of every layer of ``cfg``, in order."""
    layer = 0
    for si, (repeats, sub) in enumerate(cfg.stage_list()):
        for r in range(repeats):
            for i in range(len(sub)):
                yield layer, si, r, i
                layer += 1


def from_jax_lm_params(np_params: Dict, cfg: ArchConfig, device=None,
                       ctx=None):
    """The reference's LM pytree (numpy leaves) -> a ``Transformer`` of
    ``cfg`` on ``device`` (default: the card) holding those weights, in
    their dtype; laid out on ``ctx``'s mesh when given."""
    if ctx is not None:
        from repro_torch.sharding import partitioning
        return partitioning.shard_model(
            ctx, from_jax_lm_params(np_params, cfg, device))
    from repro_torch.models.transformer import Transformer
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta").to_empty(device=dev)
    names = {n for n, _ in model.named_parameters()}
    got = _pytree_names(np_params, cfg)
    if got != names:
        raise ValueError(f"from_jax_lm_params: the pytree's leaves do not "
                         f"fit {cfg.name}: {sorted(got ^ names)}")
    with torch.no_grad():
        for name, a in np_params["embed"].items():
            getattr(model.embed, name).data = _tensor(a, dev)
        model.final_norm.scale.data = _tensor(
            np_params["final_norm"]["scale"], dev)
        for layer, si, r, i in _layer_slots(cfg):
            src = np_params["stages"][si]["sub"][i]
            for part, leaves in src.items():
                mod = getattr(model.layers[layer], part)
                for name, a in flatten_with_paths(leaves, ".").items():
                    mod.get_parameter(name).data = _tensor(
                        np.asarray(a)[r], dev)
    return model


def _nested(flat: Dict) -> Dict:
    """The inverse of ``flatten_with_paths(tree, ".")``."""
    out: Dict = {}
    for name, a in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return out


def _pytree_names(np_params: Dict, cfg: ArchConfig) -> set:
    """The port's parameter names that the reference's pytree fills (the
    stages' own names where its stages do not fit ``cfg``'s)."""
    names = {f"embed.{n}" for n in np_params["embed"]}
    names |= {f"final_norm.{n}" for n in np_params["final_norm"]}
    stages = np_params["stages"]
    shape = [(len(st["sub"]), {np.shape(a)[0] for sub in st["sub"]
                               for leaves in sub.values()
                               for a in flatten_with_paths(
                                   leaves, ".").values()})
             for st in stages]
    if shape != [(len(sub), {r}) for r, sub in cfg.stage_list()]:
        return names | {f"stages {shape}"}
    for layer, si, _, i in _layer_slots(cfg):
        for part, leaves in stages[si]["sub"][i].items():
            names |= {f"layers.{layer}.{part}.{n}"
                      for n in flatten_with_paths(leaves, ".")}
    return names


def _stacked(cfg: ArchConfig, per_layer: List[Dict]) -> List[Dict]:
    """Per-layer ``{part: {dotted name: array}}`` -> the reference's
    stages, each leaf stacked over the stage's repeats, the dotted names
    nested again."""
    stages: List[Dict] = [{"sub": [None] * len(sub)}
                          for _, sub in cfg.stage_list()]
    rows: Dict[Tuple[int, int], List[Dict]] = {}
    for layer, si, _, i in _layer_slots(cfg):
        rows.setdefault((si, i), []).append(per_layer[layer])
    for (si, i), items in rows.items():
        stages[si]["sub"][i] = {
            part: _nested({name: np.stack([it[part][name] for it in items])
                           for name in leaves})
            for part, leaves in items[0].items()}
    return stages


def to_numpy_lm_params(model, leaves: Optional[Dict] = None) -> Dict:
    """A ``Transformer`` -> the reference's LM pytree of numpy arrays;
    with ``leaves`` ({parameter name: tensor}, such as AdamW's moments),
    the pytree of those tensors in the model's layout."""
    def value(prefix, name, p):
        return _numpy(p if leaves is None else leaves[prefix + name])

    per_layer = [{part: {n: value(f"layers.{i}.{part}.", n, p) for n, p in
                         getattr(layer, part).named_parameters()}
                  for part in ("norm1", "mixer", "norm2", "ffn")}
                 for i, layer in enumerate(model.layers)]
    return {"embed": {n: value("embed.", n, p) for n, p in
                      model.embed.named_parameters()},
            "stages": _stacked(model.cfg, per_layer),
            "final_norm": {"scale": value("final_norm.", "scale",
                                          model.final_norm.scale)}}


def from_jax_train_state(np_state, cfg: ArchConfig, device=None,
                         ctx=None):
    """The reference's ``TrainState(params, AdamState(step, m, v))``
    (numpy leaves, params, m and v in its stacked layout) -> the port's
    ``models.lm.TrainState`` on ``device`` (default: the card): a
    ``Transformer`` and m and v keyed by its parameter names; laid out on
    ``ctx``'s mesh when given."""
    if ctx is not None:
        from repro_torch.sharding import partitioning
        return partitioning.shard_train_state(
            ctx, from_jax_train_state(np_state, cfg, device))
    from repro_torch.models.lm import TrainState
    from repro_torch.optim.adam import AdamState
    dev = resolve_device(device)
    np_params, (step, np_m, np_v) = np_state
    model = from_jax_lm_params(np_params, cfg, dev)

    def moments(tree):
        return {n: p.detach() for n, p in
                from_jax_lm_params(tree, cfg, dev).named_parameters()}

    return TrainState(model, AdamState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        m=moments(np_m), v=moments(np_v)))


def to_numpy_train_state(state, cfg: ArchConfig) -> Tuple:
    """The port's ``TrainState`` -> ``(params, (step, m, v))`` of numpy
    arrays in the reference's layout: the fields of its ``TrainState`` and
    ``AdamState``, in their order."""
    model, opt = state
    if model.cfg.pattern() != cfg.pattern():
        raise ValueError(f"to_numpy_train_state: the model is not of "
                         f"{cfg.name}")
    return (to_numpy_lm_params(model),
            (np.asarray(int(opt.step), np.int32),
             to_numpy_lm_params(model, opt.m),
             to_numpy_lm_params(model, opt.v)))


def from_jax_lm_caches(np_caches: List[Dict], cfg: ArchConfig,
                       device=None, ctx=None) -> List[Dict]:
    """The reference's stacked per-stage caches (numpy leaves) -> the
    port's per-layer list on ``device`` (default: the card); laid out on
    ``ctx``'s mesh when given."""
    if ctx is not None:
        from repro_torch.sharding import partitioning
        return partitioning.shard_caches(
            ctx, cfg, from_jax_lm_caches(np_caches, cfg, device))
    dev = resolve_device(device)
    return [{part: {name: _tensor(np.asarray(a)[r], dev)
                    for name, a in leaves.items()}
             for part, leaves in np_caches[si]["sub"][i].items()}
            for _, si, r, i in _layer_slots(cfg)]


def to_numpy_lm_caches(caches: List[Dict], cfg: ArchConfig) -> List[Dict]:
    """The port's per-layer caches -> the reference's stacked per-stage
    layout of numpy arrays (bfloat16 caches widen to float32)."""
    return _stacked(cfg, [{part: {n: _numpy(t) for n, t in leaves.items()}
                           for part, leaves in c.items()} for c in caches])
