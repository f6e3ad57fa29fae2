"""Per-predicate statistics and rank math (PyTorch port of ``repro.core.stats``).

Paper §2.1: ``num_cut[i]`` monitored rows failing predicate i,
``cost_acc[i]`` accumulated cost, selectivity s_i = 1 - num_cut_i / n,
normalized cost nc_i = avg_cost_i / max_j avg_cost_j, rank_i =
nc_i / (1 - s_i), momentum adj_rank(t) = (1-m)·rank(t) + m·adj_rank(t-1).
CNF lifts the same math to groups (exact group selectivity from the
monitor lane, group cost = Σ member costs) and orders members within a
group by nc_i / s_i.

Every function runs on the tensors' own device and reads nothing on the
host. Group sums add member costs left to right in user order.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from repro_torch.core.predicates import group_members

_EPS = 1e-6

#: Saturation guard for the f32 epoch accumulators: once an epoch has
#: monitored 2^22 rows, ``accumulate`` decays every accumulator by exactly
#: 0.5 (an exponent decrement, never a rounding) before the batch folds
#: in, so +1-sized increments keep landing where f32 absorbs them. Below
#: the threshold the factor is 1.0, a bit-exact no-op.
SAT_THRESHOLD = float(1 << 22)
SAT_DECAY = 0.5


def argsort_stable(a: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort (ties keep index order)."""
    return torch.argsort(a, stable=True)


@functools.lru_cache(maxsize=64)
def group_index(groups: tuple, device: torch.device) -> torch.Tensor:
    """i64[P] dense group id per predicate, resident on ``device``.

    Cached per (groups, device): the one host→device copy happens on the
    first call, never again in a steady-state step.
    """
    return torch.tensor(groups, dtype=torch.int64).to(device)


class FilterStats(NamedTuple):
    """Accumulators collected since the start of the current epoch."""

    num_cut: Any       # f32[P]
    cost_acc: Any      # f32[P]
    n_monitored: Any   # f32[]
    group_cut: Any = None  # f32[G] | None


def init_stats(n_predicates: int, n_groups: int | None = None,
               device="cpu") -> FilterStats:
    if n_groups is None:
        n_groups = n_predicates

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return FilterStats(num_cut=zeros(n_predicates),
                       cost_acc=zeros(n_predicates),
                       n_monitored=zeros(), group_cut=zeros(n_groups))


def accumulate(stats: FilterStats, cut_counts, costs, n_monitored,
               group_cut=None) -> FilterStats:
    """Fold one batch's monitor-lane results into the epoch accumulators,
    decaying all of them by 0.5 first once ``n_monitored`` >= 2^22."""
    n_mon = stats.n_monitored
    scale = torch.where(n_mon >= SAT_THRESHOLD,
                        torch.full_like(n_mon, SAT_DECAY),
                        torch.full_like(n_mon, 1.0))
    if stats.group_cut is None:
        new_gc = None
    else:
        inc = cut_counts if group_cut is None else group_cut
        new_gc = stats.group_cut * scale + inc.to(torch.float32)
    return FilterStats(
        num_cut=stats.num_cut * scale + cut_counts.to(torch.float32),
        cost_acc=stats.cost_acc * scale + costs.to(torch.float32),
        n_monitored=n_mon * scale + torch.as_tensor(
            n_monitored, dtype=torch.float32, device=n_mon.device),
        group_cut=new_gc,
    )


def selectivities(stats: FilterStats) -> torch.Tensor:
    """Pass fraction per predicate, from monitored rows only."""
    n = torch.clamp(stats.n_monitored, min=1.0)
    return torch.clamp(1.0 - stats.num_cut / n, 0.0, 1.0)


def _avg_costs(stats: FilterStats) -> torch.Tensor:
    return stats.cost_acc / torch.clamp(stats.n_monitored, min=1.0)


def normalized_costs(stats: FilterStats) -> torch.Tensor:
    """Average per-row cost normalized to [0, 1] by the max."""
    avg = _avg_costs(stats)
    return avg / torch.clamp(avg.max(), min=_EPS)


def ranks(stats: FilterStats) -> torch.Tensor:
    """rank_i = nc_i / (1 - s_i), the denominator floored at EPS."""
    return normalized_costs(stats) / torch.clamp(1.0 - selectivities(stats),
                                                 min=_EPS)


def member_ranks(stats: FilterStats) -> torch.Tensor:
    """Within-OR-group order key nc_i / s_i (cheap, often-passing first)."""
    return normalized_costs(stats) / torch.clamp(selectivities(stats),
                                                 min=_EPS)


def group_selectivities(stats: FilterStats) -> torch.Tensor:
    """Exact P(group passes) from the monitor lane's group-cut counters."""
    gcut = stats.group_cut if stats.group_cut is not None else stats.num_cut
    n = torch.clamp(stats.n_monitored, min=1.0)
    return torch.clamp(1.0 - gcut / n, 0.0, 1.0)


def group_normalized_costs(stats: FilterStats, groups) -> torch.Tensor:
    """Group cost = Σ member avg costs, normalized by the max group."""
    avg = _avg_costs(stats)
    gavg = torch.stack([functools.reduce(torch.add, [avg[i] for i in m])
                        for m in group_members(tuple(groups))])
    return gavg / torch.clamp(gavg.max(), min=_EPS)


def group_ranks(stats: FilterStats, groups) -> torch.Tensor:
    """Group-level rank gnc_g / (1 - S_g); equals ``ranks`` when flat."""
    s = group_selectivities(stats)
    return group_normalized_costs(stats, groups) / torch.clamp(1.0 - s,
                                                               min=_EPS)


def momentum_update(adj_prev, rank_now, momentum: float, first_epoch):
    """adj = (1-m)·rank + m·adj_prev; adj = rank on the first epoch."""
    m = torch.full((), momentum, dtype=torch.float32, device=rank_now.device)
    blended = (1.0 - m) * rank_now + m * adj_prev
    return torch.where(first_epoch, rank_now, blended)


def order_from_ranks(adj_rank: torch.Tensor) -> torch.Tensor:
    """Ascending stable sort → evaluation permutation (ties by user order)."""
    return argsort_stable(adj_rank).to(torch.int32)


def cnf_order(group_adj_rank, member_rank, groups):
    """Full CNF evaluation order from group + member ranks.

    Returns (perm i32[P], group_perm i32[G]): groups in group-rank order
    (ties by group id), members within a group in member-rank order (ties
    by user order); group members are always contiguous in ``perm``.
    """
    garr = group_index(tuple(groups), group_adj_rank.device)
    group_perm = argsort_stable(group_adj_rank).to(torch.int32)
    group_pos = argsort_stable(group_perm)          # inverse permutation
    primary = group_pos.index_select(0, garr)       # i64[P]
    by_member = argsort_stable(member_rank)
    perm = by_member.index_select(
        0, argsort_stable(primary.index_select(0, by_member)))
    return perm.to(torch.int32), group_perm


def expected_chain_cost(costs, pass_probs, perm):
    """Σ_i c_{perm[i]} Π_{j<i} s_{perm[j]} — what rank order minimizes."""
    perm = perm.to(torch.int64)
    c = costs.index_select(0, perm)
    s = pass_probs.index_select(0, perm)
    surv = torch.cat([torch.ones_like(s[:1]), torch.cumprod(s, dim=0)[:-1]])
    return (c * surv).sum()
