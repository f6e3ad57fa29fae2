"""Row-exact numpy backend: compacted short-circuit evaluation.

The port's own numpy copy of ``repro.core.np_exec``: the host-side
execution path of the ``numpy`` engine. It mirrors what Spark's generated
``processNext`` does — a row is never evaluated against predicates later
in the order once its fate is decided — by compacting the active row set
between predicates (boolean-index gather). Wall time therefore depends on
the evaluation order, which is what Figures 1–4 of the paper measure.

CNF semantics equal the ``torch`` and ``cuda`` engines': within an
OR-group a row stops evaluating members once one passes; a row that fails
every member of a group is dropped before the next group. HASHMIX rounds
``y*MUL`` and ``+ADD`` separately, as the predicate contract says
(``core.predicates``).
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core import predicates as pred_lib


def eval_pred_np(op: int, t1: float, t2: float, rounds: int,
                 x: np.ndarray) -> np.ndarray:
    if op == pred_lib.OP_GT:
        return x > t1
    if op == pred_lib.OP_LT:
        return x < t1
    if op == pred_lib.OP_BETWEEN:
        return (x > t1) & (x < t2)
    if op == pred_lib.OP_EQ:
        return np.round(x) == np.round(t1)
    if op == pred_lib.OP_HASHMIX:
        y = x.astype(np.float32)
        for _ in range(max(rounds, 1)):
            y = y * np.float32(pred_lib.MIX_MUL) + np.float32(pred_lib.MIX_ADD)
            y = y - np.floor(y / np.float32(pred_lib.MIX_MOD)) \
                * np.float32(pred_lib.MIX_MOD)
        return y > t1
    raise ValueError(f"unknown op {op}")


def _groups_for(preds, groups) -> np.ndarray:
    if groups is None:
        return np.arange(len(preds))
    g = np.asarray(groups, np.int64)
    if g.shape != (len(preds),):
        raise ValueError("groups must give one id per predicate")
    return g


def run_chain_np(columns: np.ndarray, preds, perm,
                 groups=None) -> tuple[np.ndarray, float, np.ndarray]:
    """Short-circuit CNF chain in ``perm`` order with compaction.

    Returns (mask bool[R], work_units, active_before f32[P]). ``preds`` is
    a sequence of ``Predicate``; ``groups`` the dense group id per
    predicate (None → singletons, the flat conjunction). Group members
    must be contiguous in ``perm``. Position k is charged static_cost ×
    rows pending before it, summed in float64.
    """
    g = _groups_for(preds, groups)
    n_rows = columns.shape[1]
    mask = np.zeros(n_rows, dtype=bool)
    work = 0.0
    active_before = np.zeros(len(preds), np.float32)

    perm = [int(i) for i in perm]
    seq = [int(g[i]) for i in perm]
    runs = [x for j, x in enumerate(seq) if j == 0 or seq[j - 1] != x]
    if len(set(runs)) != len(runs):
        raise ValueError("group members must be contiguous in perm")

    alive_idx = np.arange(n_rows)        # survivors of all closed groups
    k = 0
    while k < len(perm):
        gid = g[perm[k]]
        # pending = alive rows not yet passed by this OR-group
        pending = alive_idx
        passed = np.zeros(0, np.int64)
        while k < len(perm) and g[perm[k]] == gid:
            p = preds[perm[k]]
            active_before[k] = pending.size
            work += pending.size * p.static_cost
            if pending.size:
                x = columns[p.column, pending]
                res = eval_pred_np(p.op, p.t1, p.t2, p.rounds, x)
                passed = np.concatenate([passed, pending[res]])
                pending = pending[~res]      # OR short-circuit on first pass
            k += 1
        # group closes: rows that passed no member are cut
        alive_idx = np.sort(passed)

    mask[alive_idx] = True
    return mask, float(work), active_before


def run_monitor_np(columns: np.ndarray, preds, collect_rate: int,
                   sample_phase: int,
                   groups=None) -> tuple[np.ndarray, np.ndarray, int,
                                         np.ndarray]:
    """Monitor lane: all predicates on stride-sampled rows (paper §2.1).

    Returns (cut_counts f64[P], group_cut f64[G], n_monitored,
    per-predicate measured seconds). The seconds are
    ``time.perf_counter()`` around each predicate's evaluation: the
    numpy analogue of the paper's ``System.nanoTime``.
    """
    g = _groups_for(preds, groups)
    n_groups = int(g.max()) + 1
    n_rows = columns.shape[1]
    first = (-sample_phase) % collect_rate
    idx = np.arange(first, n_rows, collect_rate)
    cut = np.zeros(len(preds), np.float64)
    group_cut = np.zeros(n_groups, np.float64)
    secs = np.zeros(len(preds), np.float64)
    if idx.size == 0:
        return cut, group_cut, 0, secs
    group_fail = np.ones((n_groups, idx.size), bool)
    for i, p in enumerate(preds):
        x = columns[p.column, idx]
        t0 = time.perf_counter()
        res = eval_pred_np(p.op, p.t1, p.t2, p.rounds, x)
        secs[i] = time.perf_counter() - t0
        cut[i] = np.sum(~res)
        group_fail[g[i]] &= ~res
    group_cut[:] = group_fail.sum(axis=1)
    return cut, group_cut, int(idx.size), secs
