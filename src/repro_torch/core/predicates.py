"""Predicate algebra for the adaptive filter operator (PyTorch port).

Counterpart of ``repro.core.predicates``. Five op codes over one f32
column each:

  OP_GT       x > t1
  OP_LT       x < t1
  OP_BETWEEN  t1 < x < t2
  OP_EQ       round(x) == round(t1)   (round half to even, as jnp.round)
  OP_HASHMIX  ``rounds`` iterations of y ← (y·MUL + ADD) mod 2^20, then > t1

Predicate ops are static host data, so evaluation dispatches on them in
Python; thresholds live in f32 device tensors so every comparison is an
f32 comparison on either device. HASHMIX multiplies and adds in two
separately rounded steps (never a fused multiply-add), exactly like the
reference and the CUDA kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

OP_GT = 0
OP_LT = 1
OP_BETWEEN = 2
OP_EQ = 3
OP_HASHMIX = 4

_OP_NAMES = {OP_GT: "gt", OP_LT: "lt", OP_BETWEEN: "between", OP_EQ: "eq",
             OP_HASHMIX: "hashmix"}

# Arithmetic-mix constants for OP_HASHMIX (shared with the CUDA kernel).
MIX_MUL = 1.0000019073486328  # exactly representable in f32
MIX_ADD = 0.31830987334251404
MIX_MOD = 1048576.0  # 2**20


@dataclasses.dataclass(frozen=True)
class Predicate:
    """One filter condition over ``column`` of the record batch.

    Predicates sharing a ``group`` label are OR'ed; distinct groups are
    AND'ed (CNF). ``group=None`` makes a singleton group.
    """

    name: str
    column: int
    op: int
    t1: float
    t2: float = 0.0
    rounds: int = 0          # extra mix rounds (OP_HASHMIX only)
    static_cost: float = 1.0  # calibrated per-row work units
    group: object = None     # CNF OR-group label; None → singleton group

    def __post_init__(self) -> None:
        if self.op not in _OP_NAMES:
            raise ValueError(f"unknown op code {self.op}")
        if self.op == OP_HASHMIX and self.rounds < 1:
            raise ValueError("OP_HASHMIX requires rounds >= 1")
        if self.static_cost <= 0:
            raise ValueError("static_cost must be positive")

    def describe(self) -> str:
        grp = "" if self.group is None else f" group={self.group}"
        return f"{self.name}: col[{self.column}] {_OP_NAMES[self.op]} " \
               f"t1={self.t1} t2={self.t2} rounds={self.rounds} " \
               f"c={self.static_cost}{grp}"


@dataclasses.dataclass(frozen=True)
class PredicateSpecs:
    """Structure-of-arrays packing of a chain (the kernel ABI).

    The tensors live on one device; ``group`` (dense group id per
    predicate), ``static`` ((column, op, rounds) per predicate) and
    ``thresholds`` ((t1, t2) per predicate, the f32 values as Python
    floats) are host tuples, so evaluation, group-shaped control flow and
    the skip tier's tile resolution dispatch in Python without reading the
    device.
    """

    column: torch.Tensor       # i32[P]
    op: torch.Tensor           # i32[P]
    t1: torch.Tensor           # f32[P]
    t2: torch.Tensor           # f32[P]
    rounds: torch.Tensor       # i32[P]
    static_cost: torch.Tensor  # f32[P]
    group_ids: torch.Tensor    # i32[P] dense group id per predicate
    group: tuple = ()          # static dense group id per predicate; () → flat
    static: tuple = ()         # static (column, op, rounds) per predicate
    thresholds: tuple = ()     # static f32 (t1, t2) per predicate

    @property
    def n(self) -> int:
        return int(self.column.shape[0])

    @property
    def device(self) -> torch.device:
        return self.column.device

    @property
    def groups(self) -> tuple:
        """Dense group id per predicate (singletons when unset)."""
        return self.group if self.group else tuple(range(self.n))

    @property
    def n_groups(self) -> int:
        return max(self.groups) + 1

    @property
    def is_flat(self) -> bool:
        """True when every group is a singleton (plain conjunction)."""
        g = self.groups
        return len(set(g)) == len(g)

    @property
    def group_members(self) -> tuple:
        """tuple[G] of tuple[int] — predicate indices per group (static)."""
        return group_members(self.groups)


def group_members(groups: tuple) -> tuple:
    members: list[list[int]] = [[] for _ in range(max(groups) + 1)]
    for i, g in enumerate(groups):
        members[g].append(i)
    return tuple(tuple(m) for m in members)


def normalize_groups(predicates: Sequence[Predicate]) -> tuple:
    """Dense group ids in first-appearance order; None → fresh singleton.

    Members of one group must be adjacent in statement order (every engine
    closes one OR accumulator at a time).
    """
    ids: dict = {}
    out = []
    for i, p in enumerate(predicates):
        key = ("__singleton__", i) if p.group is None else ("user", p.group)
        gid = ids.setdefault(key, len(ids))
        if out and gid < len(ids) - 1 and out[-1] != gid:
            raise ValueError(
                f"predicates of group {p.group!r} are not contiguous in "
                f"statement order (predicate {i}: {p.name!r}); OR-group "
                f"members must be adjacent")
        out.append(gid)
    return tuple(out)


def pack(predicates: Sequence[Predicate], device="cpu") -> PredicateSpecs:
    """Pack a python predicate chain into the SoA kernel ABI on ``device``."""
    if not predicates:
        raise ValueError("empty predicate chain")
    groups = normalize_groups(predicates)

    def arr(vals, dtype):
        return torch.tensor(vals, dtype=dtype).to(device)

    return PredicateSpecs(
        column=arr([p.column for p in predicates], torch.int32),
        op=arr([p.op for p in predicates], torch.int32),
        t1=arr([p.t1 for p in predicates], torch.float32),
        t2=arr([p.t2 for p in predicates], torch.float32),
        rounds=arr([p.rounds for p in predicates], torch.int32),
        static_cost=arr([p.static_cost for p in predicates], torch.float32),
        group_ids=arr(list(groups), torch.int32),
        group=groups,
        static=tuple((p.column, p.op, p.rounds) for p in predicates),
        thresholds=tuple((float(np.float32(p.t1)), float(np.float32(p.t2)))
                         for p in predicates),
    )


def hashmix(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Iterated arithmetic mix — the tunably expensive predicate body.

    Each product and sum rounds to f32 on its own (two kernels, no FMA);
    MIX_MUL, MIX_ADD and MIX_MOD are exact f32 values.
    """
    y = x.to(torch.float32)
    for _ in range(rounds):
        y = y * MIX_MUL + MIX_ADD
        y = y - torch.floor(y / MIX_MOD) * MIX_MOD
    return y


def eval_one(specs: PredicateSpecs, i: int, x: torch.Tensor) -> torch.Tensor:
    """Evaluate predicate ``i`` (static index) on values ``x`` → bool."""
    _, op, rounds = specs.static[i]
    t1 = specs.t1[i]
    if op == OP_GT:
        return x > t1
    if op == OP_LT:
        return x < t1
    if op == OP_BETWEEN:
        return (x > t1) & (x < specs.t2[i])
    if op == OP_EQ:
        return torch.round(x) == torch.round(t1)
    return hashmix(x, max(rounds, 1)) > t1


def eval_all(specs: PredicateSpecs, columns: torch.Tensor) -> torch.Tensor:
    """Every predicate on every row: bool[P, ...] for columns f32[C, ...]."""
    return torch.stack([eval_one(specs, i, columns[specs.static[i][0]])
                        for i in range(specs.n)])


def paper_filters_4(selectivity_target: str = "fig1") -> list[Predicate]:
    """The paper's experimental chain: 2 int predicates, 1 date, 1 string.

    Columns: 0=date (days, normal), 1=int (normal), 2=string-hash. The
    thresholds give an overall selectivity of ~4.51% ("fig1") or ~16.14%
    ("sens") under the stream's base distributions.
    """
    from repro_torch.data.stream import threshold_for_quantile

    if selectivity_target == "fig1":
        a, b, d, s = 0.62, 0.62, 0.50, 0.376
    elif selectivity_target == "sens":
        a, b, d, s = 0.75, 0.75, 0.62, 0.5208
    else:
        raise ValueError(selectivity_target)

    return [
        Predicate("int_hi", column=1, op=OP_GT,
                  t1=threshold_for_quantile("int", 1.0 - a), static_cost=1.0),
        Predicate("int_lo", column=1, op=OP_LT,
                  t1=threshold_for_quantile("int", b), static_cost=1.0),
        Predicate("date_gt", column=0, op=OP_GT,
                  t1=threshold_for_quantile("date", 1.0 - d), static_cost=1.2),
        Predicate("str_match", column=2, op=OP_HASHMIX,
                  t1=(1.0 - s) * MIX_MOD, rounds=24, static_cost=6.0),
    ]


def paper_filters_cnf(selectivity_target: str = "fig1") -> list[Predicate]:
    """CNF variant: int_hi AND int_lo AND (date_gt OR str_match)."""
    int_hi, int_lo, date_gt, str_match = paper_filters_4(selectivity_target)
    return [
        int_hi, int_lo,
        dataclasses.replace(date_gt, group="recent_or_match"),
        dataclasses.replace(str_match, group="recent_or_match"),
    ]
