"""Dense oracle for the fused filter-chain kernel (PyTorch port).

Counterpart of ``repro.kernels.filter_chain.ref``: the full [P, R]
outcome matrix is built up front and the CNF mask, pending counts and
group cuts are derived from it with plain boolean algebra — a different
route from both the tiled kernel and the masked ``torch`` engine. Eager
and host-driven (it reads ``perm`` on the host); tests only.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import predicates as pred_lib
from repro_torch.core.engine.base import ChainResult
from repro_torch.core.predicates import PredicateSpecs


def filter_chain_ref(columns: torch.Tensor, specs: PredicateSpecs,
                     perm, *, collect_rate: int,
                     sample_phase) -> ChainResult:
    n_rows = columns.shape[1]
    dev = columns.device
    outcomes = pred_lib.eval_all(specs, columns)          # bool[P, R]
    groups = specs.groups
    perm_host = [int(i) for i in torch.as_tensor(perm).cpu().tolist()]

    gpass = torch.stack([outcomes[list(m)].any(dim=0)
                         for m in specs.group_members])   # bool[G, R]
    mask = gpass.all(dim=0)

    closed_pass = torch.ones((n_rows,), dtype=torch.bool, device=dev)
    seen_or = torch.zeros((n_rows,), dtype=torch.bool, device=dev)
    active_before = []
    work = torch.zeros((), dtype=torch.float32, device=dev)
    for k, i in enumerate(perm_host):
        if k > 0 and groups[perm_host[k - 1]] != groups[i]:
            closed_pass = closed_pass & gpass[groups[perm_host[k - 1]]]
            seen_or = torch.zeros((n_rows,), dtype=torch.bool, device=dev)
        pending = closed_pass & ~seen_or
        alive = pending.sum().to(torch.float32)
        active_before.append(alive)
        work = work + alive * specs.static_cost[i]
        seen_or = seen_or | outcomes[i]

    gidx = torch.arange(n_rows, dtype=torch.int64, device=dev)
    sampled = ((gidx + int(sample_phase)) % collect_rate) == 0
    cut = (~outcomes & sampled).sum(dim=1)
    group_cut = (~gpass & sampled).sum(dim=1)
    n_monitored = sampled.sum().to(torch.float32)

    return ChainResult(
        mask=mask,
        work_units=work,
        active_before=torch.stack(active_before),
        cut_counts=cut.to(torch.float32),
        n_monitored=n_monitored,
        monitor_cost=specs.static_cost * n_monitored,
        group_cut_counts=group_cut.to(torch.float32),
    )


def compact_fixed_ref(columns, mask, capacity: int, fill: float = 0.0):
    """Host oracle for fixed-capacity compaction: boolean index + pad."""
    cols = np.asarray(columns)
    m = np.asarray(mask).astype(bool)
    survivors = cols[:, m][:, :capacity]
    out = np.full((cols.shape[0], capacity), fill, cols.dtype)
    out[:, :survivors.shape[1]] = survivors
    return out, survivors.shape[1]
