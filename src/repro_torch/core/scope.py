"""Statistics scope policies (paper §2.2).

PyTorch port of ``repro.core.scope``. PER_BATCH resets the epoch
evidence every step; PER_SHARD keeps it per executor (one shard of a
sharded session), with no exchange at all; CENTRALIZED merges the batch
monitor counters across shards, so every shard accumulates the same
global statistics and adopts the same order at each boundary. In the
port all S shards of a session live on its one device as a leading
``[S, ...]`` axis, so ``repro``'s ``psum`` over the mesh axis is a sum
over that axis (``reduce_stats``). When the merge happens is the plan's
``exchange``:

  eager          — every step's counters are merged before they fold in
  deferred       — counters accumulate per shard; the merge runs once per
                   ``calculate_rate`` rows, at the epoch boundary
  deferred-async — the same boundary merge, folded in one epoch late
"""

from __future__ import annotations

import enum

from repro_torch.core.stats import FilterStats


class Scope(enum.Enum):
    PER_BATCH = "per_batch"
    PER_SHARD = "per_shard"
    CENTRALIZED = "centralized"


#: Statistics-exchange cadence for CENTRALIZED.
EXCHANGE_MODES = ("eager", "deferred", "deferred-async")


def _shard_sum(x):
    if x is None:
        return None
    return x.sum(dim=0, keepdim=True).expand(x.shape).contiguous()


def reduce_stats(stats: FilterStats, scope: Scope) -> FilterStats:
    """Apply the scope's reduction to stats with a leading shard axis.

    CENTRALIZED sums ``num_cut``, ``cost_acc``, ``n_monitored`` and
    ``group_cut`` over the shard axis and gives every shard the sum (the
    counterpart of ``repro``'s ``psum``); PER_SHARD and PER_BATCH are the
    identity.
    """
    if scope is not Scope.CENTRALIZED:
        return stats
    return FilterStats(num_cut=_shard_sum(stats.num_cut),
                       cost_acc=_shard_sum(stats.cost_acc),
                       n_monitored=_shard_sum(stats.n_monitored),
                       group_cut=_shard_sum(stats.group_cut))


def scope_from_str(name: str) -> Scope:
    try:
        return Scope(name)
    except ValueError as exc:
        raise ValueError(
            f"unknown scope {name!r}; pick from "
            f"{[s.value for s in Scope]}") from exc
