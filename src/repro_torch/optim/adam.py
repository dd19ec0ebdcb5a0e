"""AdamW on tensors, updated in place.

The reference's ``update`` is functional: it returns new params, m and v.
At full width that would hold a second copy of all three on the card
(qwen2.5-3b in float32: 37 GB more beside the 49.4 GB of params, grads, m
and v), so here ``update`` and ``clip_by_global_norm`` write into their
arguments: the params, the state's step, m and v, and the grads (used as
scratch).  They return the same objects, so the reference's calling form
``params, opt = adam.update(grads, opt, params, lr=lr)`` still reads
right.  The arithmetic is the reference's, operation for operation and in
its order: ``mhat / (sqrt(vhat) + eps) + wd * p``, the bias corrections
in float32 from the int32 step.

A tree of params is an ``nn.Module`` (its named parameters) or a dict of
tensors, its leaves named by ``repro_torch.tree.flatten_with_paths``
joined by ``.``; m, v and the grads are flat dicts keyed by those names,
which for the LM are the reference's leaf names
(``models.layers.leaves.Leaves``).

On a mesh the leaves are DTensors (``sharding.partitioning``): each grad
laid out as its m and v, the update runs on the local shards, and where
the moments are split over axes the parameter is not (a profile with an
``opt`` rule, ZeRO-1) each rank updates its slice of the parameter and
the slices are all-gathered back into it.  ``global_norm`` counts every
shard once: a leaf replicated over an axis adds its square sum from one
coordinate of that axis only, then one all-reduce sums the leaves, so on
a group of one it is the unsharded norm, bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.tree import flatten_with_paths

__all__ = ["AdamState", "init", "update", "global_norm",
           "clip_by_global_norm"]

# the most elements one group of leaves updates at a time: the scratch of
# ``update`` holds one group (1 GiB of float32)
GROUP_NUMEL = 1 << 28


class AdamState(NamedTuple):
    step: torch.Tensor              # 0-d int32
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def init(params, dtype=torch.float32) -> AdamState:
    leaves = flatten_with_paths(params, ".")
    dev = next(iter(leaves.values())).device
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: torch.zeros(p.shape, dtype=dtype, device=p.device)
           for n, p in leaves.items()},
        v={n: torch.zeros(p.shape, dtype=dtype, device=p.device)
           for n, p in leaves.items()})


def _groups(names: List[str], p, g, m) -> List[List[str]]:
    """Runs of names whose leaves share device and dtypes, each at most
    ``GROUP_NUMEL`` elements (a larger leaf is a group of its own)."""
    out: List[List[str]] = []
    key, size = None, 0
    for n in names:
        k = (p[n].device, p[n].dtype, g[n].dtype, m[n].dtype)
        if not out or k != key or size + p[n].numel() > GROUP_NUMEL:
            out.append([])
            key, size = k, 0
        out[-1].append(n)
        size += p[n].numel()
    return out


def _sqrt_(tensors: List[torch.Tensor]) -> None:
    """IEEE square roots in place: the card's are correctly rounded, the
    CPU's vectorised float32 ones are not always (AVX-512), so there the
    root is taken in float64 and rounded once, which is exact."""
    if tensors[0].device.type == "cpu" and tensors[0].dtype == torch.float32:
        for t in tensors:
            t.copy_(torch.sqrt(t.to(torch.float64)))
    else:
        torch._foreach_sqrt_(tensors)


@torch.no_grad()
def update(grads, state: AdamState, params, *,
           lr: Union[torch.Tensor, float], b1: float = 0.9, b2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step, in place: writes the params, ``state.step``,
    ``state.m`` and ``state.v``, and uses the grads as scratch (their
    values are gone after it).  Returns ``(params, state)``, the objects it
    was given.  Everything it allocates (bias corrections, one group's
    scratch, grads cast to the moments' dtype) is allocated before its
    first write, so a failure to allocate on the card leaves the state as
    it was (on the CPU, ``_sqrt_`` and a mixed-dtype leaf allocate
    later)."""
    p, g = flatten_with_paths(params, "."), flatten_with_paths(grads, ".")
    if set(g) != set(p) or set(state.m) != set(p):
        raise ValueError(f"adam.update: grads, moments and params differ in "
                         f"their leaves: {sorted(set(g) ^ set(p))}, "
                         f"{sorted(set(state.m) ^ set(p))}")
    m, v = state.m, state.v
    gathers = []
    if any(isinstance(t, DTensor) for t in p.values()):
        p, g, m, v, gathers = _local_leaves(p, g, m, v)
    step = state.step + 1
    sf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** sf
    bc2 = 1.0 - b2 ** sf
    # gf = g in the moments' dtype: the grad itself when it has it
    gf = {n: t if t.dtype == m[n].dtype else t.to(m[n].dtype)
          for n, t in g.items()}
    groups = _groups(list(p), p, gf, m)
    scratch = {}
    for grp in groups:
        k = (m[grp[0]].device, m[grp[0]].dtype)
        size = sum(p[n].numel() for n in grp)
        scratch[k] = max(scratch.get(k, 0), size)
    scratch = {k: torch.empty(size, dtype=k[1], device=k[0])
               for k, size in scratch.items()}
    # the first write
    for grp in groups:
        P, G = [p[n] for n in grp], [gf[n] for n in grp]
        M, V = [m[n] for n in grp], [v[n] for n in grp]
        buf, off, S = scratch[(M[0].device, M[0].dtype)], 0, []
        for t in P:
            S.append(buf[off:off + t.numel()].view(t.shape))
            off += t.numel()
        # m2 = b1 * m + (1 - b1) * gf
        torch._foreach_copy_(S, G)
        torch._foreach_mul_(S, 1.0 - b1)
        torch._foreach_mul_(M, b1)
        torch._foreach_add_(M, S)
        # v2 = b2 * v + (1 - b2) * gf ** 2
        torch._foreach_mul_(G, G)
        torch._foreach_mul_(G, 1.0 - b2)
        torch._foreach_mul_(V, b2)
        torch._foreach_add_(V, G)
        # delta = (m2 / bc1) / (sqrt(v2 / bc2) + eps) + wd * p
        torch._foreach_copy_(G, V)
        torch._foreach_div_(G, bc2)
        _sqrt_(G)
        torch._foreach_add_(G, eps)
        torch._foreach_copy_(S, M)
        torch._foreach_div_(S, bc1)
        torch._foreach_div_(S, G)
        torch._foreach_copy_(G, P)
        torch._foreach_mul_(G, weight_decay)
        torch._foreach_add_(S, G)
        # p - lr * delta, delta in the params' dtype
        if P[0].dtype == S[0].dtype:
            torch._foreach_mul_(S, lr)
            torch._foreach_sub_(P, S)
        else:
            for t, d in zip(P, S):
                d = d.to(t.dtype)
                if isinstance(lr, torch.Tensor):
                    # lr's dtype wins, as in the reference's promotion
                    t.copy_(t.to(lr.dtype) - lr * d.to(lr.dtype))
                else:
                    # a Python lr takes the params' dtype (a weak type)
                    t.sub_(torch.tensor(lr, dtype=t.dtype,
                                        device=t.device) * d)
    for whole, part in gathers:
        whole.to_local().copy_(part.redistribute(
            whole.device_mesh, whole.placements).to_local())
    state.step.copy_(step)
    return params, state


def _local_leaves(p, g, m, v):
    """The local shards of DTensor leaves, each parameter's the slice its
    moments hold, and [(parameter, its updated slice as a DTensor)] for
    the parameters that slice is gathered back into."""
    P, G, M, V, gathers = {}, {}, {}, {}, []
    for n, w in p.items():
        mesh = w.device_mesh
        if tuple(g[n].placements) != tuple(m[n].placements):
            raise ValueError(f"adam.update: the grad of {n} is laid out "
                             f"as {g[n].placements}, its moments as "
                             f"{m[n].placements}")
        G[n], M[n], V[n] = g[n].to_local(), m[n].to_local(), \
            v[n].to_local()
        local = w.to_local()
        if tuple(w.placements) == tuple(m[n].placements):
            P[n] = local
            continue
        # ZeRO-1: the moments split dims the parameter holds whole
        part = local
        for i, (pw, pm) in enumerate(zip(w.placements, m[n].placements)):
            if pw == pm:
                continue
            if not (isinstance(pm, Shard) and not isinstance(pw, Shard)):
                raise ValueError(f"adam.update: the moments of {n} "
                                 f"({m[n].placements}) do not refine its "
                                 f"placements ({w.placements})")
            k = mesh.size(i)
            size = part.shape[pm.dim] // k
            part = part.narrow(pm.dim, mesh.get_local_rank(i) * size, size)
        P[n] = part
        gathers.append((w, DTensor.from_local(part, mesh, m[n].placements,
                                              run_check=False)))
    return P, G, M, V, gathers


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (0-d); DTensor
    leaves count every shard once (module doc)."""
    leaves = list(flatten_with_paths(grads, ".").values())
    if not any(isinstance(t, DTensor) for t in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                              for t in leaves))
    sums = torch.stack([_owned_square_sum(t) for t in leaves])
    if leaves[0].device_mesh.size() != dist.get_world_size():
        raise ValueError("adam.global_norm: the mesh is not the whole "
                         "group")
    dist.all_reduce(sums)
    return torch.sqrt(sum(s for s in sums))


def _owned_square_sum(t: DTensor) -> torch.Tensor:
    """This rank's share of ``t``'s square sum: its shard's, or zero where
    the rank is not the first along an axis that replicates ``t``."""
    s = torch.sum(torch.square(t.to_local().to(torch.float32)))
    mesh = t.device_mesh
    for i, pl in enumerate(t.placements):
        if not isinstance(pl, Shard) and mesh.get_local_rank(i) != 0:
            return torch.zeros_like(s)
    return s


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, *,
                        norm: Optional[torch.Tensor] = None):
    """Scales the grads in place by min(1, max_norm / (norm + 1e-9));
    returns ``(grads, norm)``, the norm before the scaling
    (``global_norm``'s unless given)."""
    if norm is None:
        norm = global_norm(grads)
    # a true division: ``max_norm / tensor`` is a reciprocal times max_norm
    scale = torch.clamp(torch.div(
        torch.full((), max_norm, dtype=torch.float32, device=norm.device),
        norm + 1e-9), max=1.0)
    leaves = [t.to_local() if isinstance(t, DTensor) else t
              for t in flatten_with_paths(grads, ".").values()]
    f32 = [t for t in leaves if t.dtype == torch.float32]
    if f32:
        torch._foreach_mul_(f32, scale)
    for t in leaves:
        if t.dtype != torch.float32:
            t.copy_(t.to(torch.float32) * scale)
    return grads, norm
