"""CBWS — Channel-Balanced Workload Schedule (paper Algorithm 1).

Partition ``K`` channels into ``N`` groups of near-equal predicted workload:

  1.  s_k = filter-magnitude proxy of channel k        (Alg. 1 line 1)
  2.  sort descending                                   (line 2)
  3.  boustrophedon ("snake") re-sort in blocks of N — adjacent blocks get
      opposite orders (lines 3-10; the paper's prose: "each two adjacent data
      fields have opposite orders" — the pseudocode has a transcription typo
      where both branches sort descending; we implement the stated intent)
  4.  deal element j of each block to sublist L_j       (lines 11-16)
  5.  greedy fine-tune: while diff/2 > min(L_max), move min(L_max) from the
      heaviest to the lightest sublist                  (lines 17-28)

This is an *offline* scheduler (runs at program-build time on host), so it is
plain numpy, run on the host.  The output is a partition of channel indices,
from which ``scheduler.py`` builds channel permutations for kernels/sharding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "cbws_partition", "cbws_partition_equal", "naive_partition",
    "greedy_lpt_partition", "Partition", "partition_sums",
]


@dataclass(frozen=True)
class Partition:
    """groups[j] = indices of the channels assigned to lane j."""
    groups: Tuple[Tuple[int, ...], ...]

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def permutation(self) -> np.ndarray:
        """Channel permutation placing each group's channels contiguously."""
        return np.concatenate([np.asarray(g, dtype=np.int64) for g in self.groups])

    def group_sizes(self) -> np.ndarray:
        return np.asarray([len(g) for g in self.groups])


def partition_sums(p: Partition, workloads: Sequence[float]) -> np.ndarray:
    w = np.asarray(workloads, dtype=np.float64)
    return np.asarray([w[list(g)].sum() for g in p.groups])


def naive_partition(num_channels: int, num_groups: int) -> Partition:
    """Contiguous striping — the no-schedule baseline ('Neither' in Fig. 7)."""
    idx = np.arange(num_channels)
    return Partition(tuple(tuple(map(int, g)) for g in np.array_split(idx, num_groups)))


def greedy_lpt_partition(workloads: Sequence[float], num_groups: int) -> Partition:
    """Longest-processing-time greedy — classic makespan baseline (for tests)."""
    w = np.asarray(workloads, dtype=np.float64)
    order = np.argsort(-w, kind="stable")
    sums = np.zeros(num_groups)
    groups: List[List[int]] = [[] for _ in range(num_groups)]
    for k in order:
        j = int(np.argmin(sums))
        groups[j].append(int(k))
        sums[j] += w[k]
    return Partition(tuple(tuple(g) for g in groups))


def cbws_partition(
    workloads: Sequence[float],
    num_groups: int,
    finetune_iters: int = 1000,
) -> Partition:
    """Algorithm 1, faithful (with the snake-order typo fixed per the prose)."""
    w = np.asarray(workloads, dtype=np.float64)
    K, N = len(w), int(num_groups)
    if N <= 0:
        raise ValueError("num_groups must be positive")
    if N >= K:
        # one (or zero) channel per lane — degenerate but legal
        groups = [[k] for k in np.argsort(-w, kind="stable")]
        groups += [[] for _ in range(N - K)]
        return Partition(tuple(tuple(map(int, g)) for g in groups[:N]))

    # line 2: sort descending (stable for reproducibility)
    order = list(np.argsort(-w, kind="stable"))

    # lines 3-10: snake re-sort in blocks of N. Block 0 descending, block 1
    # ascending, ... A ragged tail block participates with its natural order.
    c_new: List[int] = []
    num_blocks = (K + N - 1) // N
    for i in range(num_blocks):
        block = order[i * N:(i + 1) * N]
        if i % 2 == 1:
            block = block[::-1]
        c_new.extend(block)

    # lines 11-16: deal column-wise into N sublists
    groups_l: List[List[int]] = [[] for _ in range(N)]
    for pos, k in enumerate(c_new):
        groups_l[pos % N].append(k)

    # lines 17-28: greedy fine-tune (move-based; may change group sizes)
    for _ in range(int(finetune_iters)):
        sums = np.asarray([w[g].sum() if g else 0.0 for g in groups_l])
        j_max, j_min = int(np.argmax(sums)), int(np.argmin(sums))
        diff = sums[j_max] - sums[j_min]
        if not groups_l[j_max]:
            break
        # element of minimum workload in the heaviest sublist
        k_move = min(groups_l[j_max], key=lambda k: w[k])
        if diff / 2.0 > w[k_move]:
            groups_l[j_max].remove(k_move)
            groups_l[j_min].append(k_move)
        else:
            break  # BreakTimeLoop()

    return Partition(tuple(tuple(map(int, g)) for g in groups_l))


def cbws_partition_equal(
    workloads: Sequence[float],
    num_groups: int,
    finetune_iters: int = 1000,
) -> Partition:
    """CBWS constrained to equal group sizes (requires N | K).

    Equal sizes are what uniform channel-group blocks and mesh-axis
    sharding need (every lane owns exactly K/N channels; balance comes from
    *which* channels, i.e. the permutation).  Same snake-deal start as
    Algorithm 1; the fine-tune phase swaps (instead of moves) the best pair
    between the heaviest and lightest groups so sizes stay equal.
    """
    w = np.asarray(workloads, dtype=np.float64)
    K, N = len(w), int(num_groups)
    if K % N != 0:
        raise ValueError(f"equal-size CBWS needs N|K, got K={K}, N={N}")

    base = cbws_partition(w, N, finetune_iters=0)   # snake-deal start, no moves
    groups_l = [list(g) for g in base.groups]

    for _ in range(int(finetune_iters)):
        sums = np.asarray([w[g].sum() for g in groups_l])
        j_max, j_min = int(np.argmax(sums)), int(np.argmin(sums))
        diff = sums[j_max] - sums[j_min]
        if diff <= 0:
            break
        # best swap: maximize reduction of (max-min); delta = w[a] - w[b]
        best = None
        for a in groups_l[j_max]:
            for b in groups_l[j_min]:
                delta = w[a] - w[b]
                if 0 < delta < diff:
                    gain = min(delta, diff - delta)
                    if best is None or gain > best[0]:
                        best = (gain, a, b)
        if best is None:
            break
        _, a, b = best
        groups_l[j_max].remove(a)
        groups_l[j_min].remove(b)
        groups_l[j_max].append(b)
        groups_l[j_min].append(a)

    return Partition(tuple(tuple(map(int, g)) for g in groups_l))
