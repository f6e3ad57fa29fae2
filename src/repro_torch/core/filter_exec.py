"""Chain execution + monitor lane in plain PyTorch (the ``torch`` engine).

Counterpart of ``repro.core.filter_exec``. CNF semantics: predicates in
one group OR together, groups AND together; a row is charged for
predicate ``perm[k]`` while it is still pending at position k (alive
through every closed group and not yet passed by an earlier member of
the open group). ``perm`` keeps each group's members contiguous.

The permutation stays on the device: every position's group flags,
outcomes and costs are gathered with device-side indexing, so the chain
never reads ``perm`` on the host. Predicate ops are static, so all P
outcomes are evaluated once (in user order) and gathered per position —
the same full-width work the masked ``jnp`` engine does.

Monitor lane (paper §2.1): rows with (global_row_index + phase) %
collect_rate == 0 are sampled and evaluated against every predicate.
"""

from __future__ import annotations

import torch

from repro_torch.core import predicates as pred_lib
from repro_torch.core.engine.base import ChainResult
from repro_torch.core.predicates import PredicateSpecs

__all__ = ["ChainResult", "monitor_indices", "run_monitor", "run_chain",
           "run_chain_masks", "compact", "compact_fixed"]


def monitor_indices(n_rows: int, collect_rate: int, sample_phase,
                    device="cpu"):
    """Deterministic-stride sample positions for one batch.

    Returns (idx i64[max_samples], valid bool[max_samples]) with a static
    length; ``sample_phase`` (int or i32[] tensor) is the batch's global
    row offset modulo collect_rate.
    """
    max_samples = n_rows // collect_rate + 1
    first = (-torch.as_tensor(sample_phase, device=device).to(torch.int64)) \
        % collect_rate
    idx = first + torch.arange(max_samples, dtype=torch.int64,
                               device=device) * collect_rate
    valid = idx < n_rows
    return torch.clamp(idx, 0, n_rows - 1), valid


def run_monitor(columns: torch.Tensor, specs: PredicateSpecs,
                collect_rate: int, sample_phase):
    """Evaluate ALL predicates on the sampled rows only.

    Returns (cut f32[P], group_cut f32[G], n_monitored f32[],
    monitor_cost f32[P]).
    """
    n_rows = columns.shape[1]
    idx, valid = monitor_indices(n_rows, collect_rate, sample_phase,
                                 columns.device)
    sampled = columns.index_select(1, idx)           # f32[C, max_samples]
    results = pred_lib.eval_all(specs, sampled)      # bool[P, max_samples]
    cut = (~results & valid).sum(dim=1)
    # a sampled row is cut by group g iff NO member passes
    group_fail = []
    for members in specs.group_members:
        fail = ~results[members[0]]
        for m in members[1:]:
            fail = fail & ~results[m]
        group_fail.append(fail)
    group_cut = (torch.stack(group_fail) & valid).sum(dim=1)
    n_monitored = valid.sum().to(torch.float32)
    monitor_cost = specs.static_cost * n_monitored
    return (cut.to(torch.float32), group_cut.to(torch.float32),
            n_monitored, monitor_cost)


def run_chain_masks(columns: torch.Tensor, specs: PredicateSpecs,
                    perm: torch.Tensor, valid=None):
    """Chain lane only: masked CNF evaluation in ``perm`` order.

    Returns (mask bool[R], work f32[], active_before f32[P]). ``valid``
    (bool[R], optional) pre-cuts rows before the first predicate.
    """
    n_rows = columns.shape[1]
    n_preds = specs.n
    flat = specs.is_flat
    perm = perm.to(device=columns.device, dtype=torch.int64)
    # per-position gathers: group id, cost and outcome of predicate perm[k]
    gpos = specs.group_ids.index_select(0, perm)
    cost_pos = specs.static_cost.index_select(0, perm)
    outcomes = pred_lib.eval_all(specs, columns).index_select(0, perm)

    mask = torch.ones((n_rows,), dtype=torch.bool, device=columns.device) \
        if valid is None else valid
    group_or = torch.zeros((n_rows,), dtype=torch.bool, device=columns.device)
    work = torch.zeros((), dtype=torch.float32, device=columns.device)
    active_before = []
    for k in range(n_preds):
        is_first = True if (flat or k == 0) else gpos[k - 1] != gpos[k]
        closes = True if (flat or k == n_preds - 1) \
            else gpos[k + 1] != gpos[k]
        pending = mask if is_first is True \
            else torch.where(is_first, mask, mask & ~group_or)
        alive = pending.sum().to(torch.float32)
        active_before.append(alive)
        work = work + alive * cost_pos[k]
        res = outcomes[k]
        group_or = res if is_first is True \
            else torch.where(is_first, res, group_or | res)
        new_mask = mask & group_or
        mask = new_mask if closes is True \
            else torch.where(closes, new_mask, mask)
    return mask, work, torch.stack(active_before)


def run_chain(columns: torch.Tensor, specs: PredicateSpecs,
              perm: torch.Tensor, collect_rate: int,
              sample_phase) -> ChainResult:
    """Masked CNF chain in ``perm`` order + monitor lane."""
    mask, work, active_before = run_chain_masks(columns, specs, perm)
    cut, group_cut, n_mon, mon_cost = run_monitor(
        columns, specs, collect_rate, sample_phase)
    return ChainResult(
        mask=mask,
        work_units=work,
        active_before=active_before,
        cut_counts=cut,
        n_monitored=n_mon,
        monitor_cost=mon_cost,
        group_cut_counts=group_cut,
    )


def _scatter_front(columns, mask, capacity: int, fill: float):
    """Survivors to slots [0, n) in stream order; overflow and
    non-survivors land in a dump column that is sliced off."""
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1   # exclusive rank
    dest = torch.where(mask & (pos < capacity), pos,
                       torch.full_like(pos, capacity))
    out = torch.full((columns.shape[0], capacity + 1), fill,
                     dtype=columns.dtype, device=columns.device)
    out[:, dest] = columns
    return out[:, :capacity]


def compact(columns: torch.Tensor, mask: torch.Tensor, fill: float = 0.0):
    """Stable compaction to the full batch width: (packed f32[C, R], n)."""
    packed = _scatter_front(columns, mask, int(columns.shape[1]), fill)
    return packed, mask.sum().to(torch.int32)


def compact_fixed(columns: torch.Tensor, mask: torch.Tensor, capacity: int,
                  fill: float = 0.0):
    """Fixed-capacity compaction: mask → cumsum positions → O(R) scatter.

    Returns (packed f32[C, capacity], n_kept i32[]). Survivors keep their
    stream order in the first ``n_kept`` slots; the tail is ``fill``;
    survivors beyond ``capacity`` are dropped and ``n_kept`` saturates.
    """
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    packed = _scatter_front(columns, mask, capacity, fill)
    n_pass = mask.sum()
    return packed, torch.clamp(n_pass, max=capacity).to(torch.int32)
