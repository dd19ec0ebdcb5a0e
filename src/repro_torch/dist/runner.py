"""``MeshRunner``: sharded inference and training over a ``DeviceMesh``
(the reference's ``repro.dist.runner`` on torch devices).

The layer ``Session`` routes through when its spec carries a ``mesh``.
The batch is zero-padded up to a multiple of the mesh axes that the
logical ``batch`` axis resolves to (``sharding.ShardingCtx``:
``pod x data`` under the default rules), split into contiguous shards in
mesh order, one per entry of those axes (an axis the batch is not sharded
over, such as ``model``, replicates and computes nothing twice), and each
shard runs on its own entry with its own copy of the params, made once
for each params version.  With more than one shard, each shard runs in a
worker process of its own entry (``dist.workers``), every shard's call
sent before any result is read back, so the shards' host work and their
cards run at once, and a worker replays each ``hopper`` forward from a
CUDA graph (``_infer_shard``); one shard runs eagerly in the calling
thread.

**Bit-parity contract** (tests/test_torch_dist.py):

  * *Logits*: a row's logits depend neither on its batchmates nor on the
    batch size (``core.snn_layers``), so the logits at 1, 2 or 4 shards
    equal the unsharded ones bit for bit.  Counts are summed as exact
    integers and each skip fraction is rebuilt from the shards' cell
    counts as the whole batch's fraction (the float32 count times the
    float32 reciprocal, the reference's mean), never as a mean of means.
    Like the reference's global outputs, counts and skip fractions cover
    the padded batch: its pad rows count, and only the logits are sliced.
  * *Gradients*: per-example gradient rows
    (``core.snn_train.make_grad_rows_fn``, batch-1 rows, each independent
    of the others), combined on the host in float32 numpy in index order:
    the mean gradient, ``mom = m * mom + g``, ``p = p - lr * mom``.  The
    updated params do not depend on the shard count or on torch's
    reduction order, by construction.

The runner is used by one thread at a time (one ``Session`` verb at a
time); it holds no locks and mutates only its own replica cache (the
worker processes are shared, one mesh call at a time).  Serving
lanes are pinned separately (``DeviceMesh.lane_devices`` and
``serving.engine.EngineConfig.lane_devices``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.config import SNNConfig
from repro_torch.core.snn_model import (SNNOutputs, freeze_params,
                                        layer_shapes, snn_apply)
from repro_torch.core.snn_train import make_grad_rows_fn
from repro_torch.device import on_device
from repro_torch.dist import workers
from repro_torch.dist.mesh import DeviceMesh
from repro_torch.kernels.spiking_conv import skip_table_blocks
from repro_torch.serving.batcher import to_device, to_host
from repro_torch.sharding.context import ShardingCtx

__all__ = ["MeshRunner"]


def _as_numpy(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def _pad_rows(a: np.ndarray, m: int) -> np.ndarray:
    n = a.shape[0]
    if m == n:
        return a
    return np.concatenate([a, np.zeros((m - n,) + a.shape[1:], a.dtype)])


def _infer_shard(dev: torch.device, params: Dict, graphs: Optional[Dict],
                 cfg: SNNConfig, kw: Dict, logits_only: bool,
                 frames: np.ndarray) -> SNNOutputs:
    """One shard's forward, read back to the host.  Given ``graphs`` (a
    worker's dict, kept as long as its params version), a ``hopper``
    forward on a card is captured once per shape in a CUDA graph with its
    outputs packed into one byte buffer, and replayed: the same kernels on
    the same inputs, so the same bits, for one launch of host work
    instead of 127 and one copy back instead of one an output.  A replay
    moves no launch counter."""
    with on_device(dev), torch.inference_mode():
        if graphs is None or dev.type != "cuda" \
                or kw.get("backend") != "hopper":
            return to_host(snn_apply(params, to_device(frames, dev), cfg,
                                     logits_only=logits_only, **kw))
        key = (frames.shape, logits_only, tuple(sorted(kw.items())))
        if key not in graphs:
            graphs[key] = _capture(lambda x: snn_apply(
                params, x, cfg, logits_only=logits_only, **kw),
                to_device(frames, dev))
        x, graph, packed, layout = graphs[key]
        x.copy_(torch.from_numpy(frames))
        graph.replay()
        return _unpack(packed.cpu().numpy(), layout)


def _capture(fn: Callable, x: torch.Tensor):
    """(x, graph, packed, layout): ``_pack(fn(x))`` captured in a CUDA
    graph on x's card, after one run on a side stream (plans, kernel
    loads)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        layout = _pack(fn(x))[1]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        packed = _pack(fn(x))[0]
    return x, graph, packed, layout


def _pack(out) -> Tuple[torch.Tensor, Tuple]:
    """(one byte tensor holding every tensor of the tree ``out``, its
    layout: the tree, each leaf's shape and dtype)."""
    leaves, tree = tree_flatten(out)
    return (torch.cat([t.reshape(-1).view(torch.uint8) for t in leaves]),
            (tree, [(tuple(t.shape), t.dtype) for t in leaves]))


def _unpack(buf: np.ndarray, layout) -> object:
    """The tree of numpy arrays that ``_pack`` packed into ``buf``."""
    tree, leaves = layout
    out, at = [], 0
    for shape, dtype in leaves:
        dt = torch.empty((), dtype=dtype).numpy().dtype
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        out.append(buf[at:at + n].view(dt).reshape(shape))
        at += n
    return tree_unflatten(out, tree)


def _rows_shard(dev: torch.device, params: Dict, scratch: Optional[Dict],
                cfg: SNNConfig, spec, x: np.ndarray, y: np.ndarray):
    """One shard's per-example loss and gradient rows, on the host."""
    with on_device(dev):
        return to_host(make_grad_rows_fn(cfg, spec=spec)(
            params, *to_device((x, y), dev)))


def _int_sum(parts) -> np.ndarray:
    """The exact integer sum of integer-valued float32 counts, rounded once
    to float32."""
    return np.sum([np.asarray(p).astype(np.int64) for p in parts],
                  axis=0).astype(np.float32)


class MeshRunner:
    """Multi-device executor for one model config under one spec.

    ``spec`` is duck-typed as everywhere in core: ``backend`` and
    ``surrogate_*`` select the forward, ``lr`` and ``momentum``
    (``TrainSpec``) drive ``train_step``'s host-side update.
    ``spec.timesteps`` must already be resolved into ``cfg`` (``Session``
    does this), and a kernel-level CBWS schedule is rejected: mesh
    execution serves canonical weights, as ``Session.evaluate`` does.
    """

    def __init__(self, device_mesh: DeviceMesh, cfg: SNNConfig,
                 spec: Optional[object] = None):
        if spec is not None \
                and getattr(spec, "resolved_schedule", lambda: None)() \
                is not None:
            raise ValueError(
                "MeshRunner serves canonical weights: a kernel-level CBWS "
                "schedule_mode (a deployed-weight permutation) is not "
                "supported with a mesh — drop the schedule or the mesh")
        self.dm = device_mesh
        self.cfg = cfg
        self.spec = spec
        self.ctx = ShardingCtx(device_mesh)
        axes = self.ctx.axes_for("batch")
        # batch-dim divisor: inputs are zero-padded up to a multiple of it,
        # so the shard split is always exact
        self._batch_div = self.ctx.axes_size(axes)
        self.shard_devices: Tuple[torch.device, ...] = self._shard_entries(
            axes)
        self._version: Optional[Dict] = None    # params the replicas copy
        self._version_no = -1
        self._replicas: Dict[Tuple[torch.device, bool], Dict] = {}

    def _shard_entries(self, batch_axes) -> Tuple[torch.device, ...]:
        """The mesh entry of each batch shard: index 0 along every axis
        the batch is not sharded over, shards in the order of
        ``batch_axes``."""
        names = self.dm.axis_names
        grid = np.arange(self.dm.num_devices).reshape(
            [s for _, s in self.dm.axes])
        sub = grid[tuple(slice(None) if a in batch_axes else 0
                         for a in names)]
        in_mesh_order = [a for a in names if a in batch_axes]
        sub = sub.transpose([in_mesh_order.index(a) for a in batch_axes])
        return tuple(self.dm.devices[int(i)] for i in sub.reshape(-1))

    def _padded(self, n: int) -> int:
        d = self._batch_div
        return -(-n // d) * d

    def _exec_kwargs(self) -> Dict[str, object]:
        kw: Dict[str, object] = {}
        for k in ("backend", "surrogate_alpha", "surrogate_kind"):
            if hasattr(self.spec, k):
                kw[k] = getattr(self.spec, k)
        return kw

    def _replica(self, params: Dict, dev: torch.device, frozen: bool
                 ) -> Dict:
        """``params`` on ``dev``, copied once for each params version (the
        dict object a ``Session`` holds between train steps); ``frozen``
        adds the dense layers' exact-grid weights, as the serving cache
        holds them."""
        rep = self._replicas.get((dev, frozen))
        if rep is None:
            with on_device(dev), torch.no_grad():
                rep = tree_map(lambda t: t.detach().to(dev), params)
                if frozen:
                    rep = freeze_params(rep)
            self._replicas[(dev, frozen)] = rep
        return rep

    def _each_shard(self, fn: Callable, params: Dict, frozen: bool,
                    args: Sequence[Tuple]) -> List:
        """``fn(dev, replica, scratch, *a)`` for every shard: one shard in
        this thread (no scratch: it runs eagerly), several in the entries'
        worker processes, all at once; the results in mesh order."""
        if params is not self._version:
            self._version, self._replicas = params, {}
            self._version_no = workers.new_version()
        if len(self.shard_devices) == 1:
            dev = self.shard_devices[0]
            return [fn(dev, self._replica(params, dev, frozen), None,
                       *args[0])]
        return workers.run_shards(fn, self.shard_devices, args,
                                  self._version_no, params, frozen)

    # -- inference -----------------------------------------------------------
    def infer(self, params: Dict, frames, *, pad_to: Optional[int] = None,
              logits_only: bool = False) -> SNNOutputs:
        """One batch, sharded over the batch axes; returns ``SNNOutputs`` on
        the host (numpy) with the pad rows sliced off the logits.
        ``pad_to`` forces a larger pad target (the canonical-bucket knob),
        rounded up to the shard divisor.  ``logits_only`` leaves the count
        fields empty and computes nothing for them."""
        frames = _as_numpy(frames, np.float32)
        n = frames.shape[0]
        if pad_to is not None and pad_to < n:
            raise ValueError(f"pad_to={pad_to} cannot hold a batch of {n}")
        m = self._padded(n if pad_to is None else int(pad_to))
        shards = np.split(_pad_rows(frames, m), len(self.shard_devices))
        kw = self._exec_kwargs()
        host = self._each_shard(_infer_shard, params, True,
                                [(self.cfg, kw, logits_only, xs)
                                 for xs in shards])
        logits = np.concatenate([h.logits for h in host])[:n]
        if logits_only:
            return SNNOutputs(logits=logits, spike_counts=(),
                              spike_totals=(), timestep_counts=())
        return SNNOutputs(
            logits=logits,
            spike_counts=tuple(_int_sum(c) for c in
                               zip(*(h.spike_counts for h in host))),
            spike_totals=tuple(_int_sum(c) for c in
                               zip(*(h.spike_totals for h in host))),
            timestep_counts=tuple(_int_sum(c) for c in
                                  zip(*(h.timestep_counts for h in host))),
            skip_fractions=self._skip_fractions(
                [h.skip_fractions for h in host], m // len(host)))

    def _skip_fractions(self, per_shard: List[Tuple], rows: int) -> Tuple:
        """Each fused layer's skip fraction over the whole padded batch:
        every shard's skipped cells (its fraction times its cell count,
        exact while a table has fewer than 2^22 cells), summed, times the
        float32 reciprocal of all the cells, as ``skip_table_fraction``
        computes a batch's."""
        if not per_shard[0]:
            return ()
        heights = [h for h, _, _ in layer_shapes(self.cfg)]
        # the fused layers of a direct-coded forward: every layer after the
        # hoisted first, each fed the train of the one before
        cells = [self.cfg.timesteps * rows * skip_table_blocks(
            heights[i - 1], self.cfg.kernel_size, aprc=self.cfg.aprc)
            for i in range(1, len(heights))]
        if len(cells) != len(per_shard[0]):
            raise ValueError(
                f"{len(per_shard[0])} skip fractions for {len(cells)} fused "
                f"layers of {self.cfg.name}")
        out = []
        for j, n_cells in enumerate(cells):
            skipped = sum(int(np.rint(np.float64(fr[j]) * n_cells))
                          for fr in per_shard)
            inv = np.float32(1.0 / (n_cells * len(per_shard)))
            out.append(np.float32(np.float32(skipped) * inv))
        return tuple(out)

    # -- training ------------------------------------------------------------
    def train_step(self, params: Dict, mom: Dict, x, y
                   ) -> Tuple[Dict, Dict, float]:
        """One SGD+momentum step; returns ``(params, mom, loss)`` as
        ``core.snn_train.make_train_step``'s step does, the new params and
        momentum on the device of the given params.

        Per-example loss and gradient rows are computed shard by shard (a
        row touches only its own example, so its bits do not depend on the
        sharding); the batch reduction and the optimizer update run on the
        host in a fixed order, so the result does not depend on the shard
        count."""
        x = _as_numpy(x, np.float32)
        y = _as_numpy(y, np.int64)
        n = x.shape[0]
        m = self._padded(n)
        k = len(self.shard_devices)
        host = self._each_shard(_rows_shard, params, False, [
            (self.cfg, self.spec, xs, ys) for xs, ys in
            zip(np.split(_pad_rows(x, m), k), np.split(_pad_rows(y, m), k))])
        loss_rows = np.concatenate([l for l, _ in host])[:n]
        loss = float(loss_rows.mean(dtype=np.float32))
        lr = np.float32(getattr(self.spec, "lr", 1e-3))
        mv = np.float32(getattr(self.spec, "momentum", 0.9))
        shard_leaves = [tree_flatten(g)[0] for _, g in host]
        p_leaves, treedef = tree_flatten(params)
        home = p_leaves[0].device
        new_p, new_m = [], []
        for i, (w, m_) in enumerate(zip(p_leaves, tree_flatten(mom)[0])):
            r = np.concatenate([s[i] for s in shard_leaves]).astype(
                np.float32)[:n]
            # fixed-order host reduction over the real (unpadded) rows: the
            # canonical combine the parity contract rests on
            g = (r.sum(axis=0) / np.float32(n)).astype(np.float32)
            mnew = (mv * _as_numpy(m_, np.float32) + g).astype(np.float32)
            wnew = (_as_numpy(w, np.float32) - lr * mnew).astype(np.float32)
            new_m.append(torch.from_numpy(mnew).to(home))
            new_p.append(torch.from_numpy(wnew).to(home))
        return (tree_unflatten(new_p, treedef),
                tree_unflatten(new_m, treedef), loss)

    # -- serving -------------------------------------------------------------
    def lane_devices(self, num_lanes: int) -> Tuple[torch.device, ...]:
        """Round-robin lane -> device pinning (``DeviceMesh.lane_devices``)
        for ``EngineConfig.lane_devices``."""
        return self.dm.lane_devices(num_lanes)

    def __repr__(self) -> str:
        return (f"MeshRunner({self.dm!r}, "
                f"backend={getattr(self.spec, 'backend', None)!r})")
