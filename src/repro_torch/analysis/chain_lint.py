"""Chain semantics linter: interval + domain analysis over CNF chains.

PyTorch port's copy of ``lint_chain`` and its interval algebra from
``repro.analysis.chain_lint``, on the port's own ``Predicate``; the
canonicalizer and the tile-proof cross-check stay in ``repro`` for now
(ROADMAP.md queue 1 item 13).

The paper's adaptive reordering assumes every predicate can matter; real
(drifting, hand-edited, multi-tenant) chains routinely carry predicates
that provably cannot — unsatisfiable ranges, subsumed duplicates,
always-true guards — which the runtime then spends epochs "learning" to
demote. Pruning/canonicalizing BEFORE adaptive re-optimization is where
the cheap wins are (Liu & Ives, arXiv 1409.6288), so this linter runs at
plan-compile time (``build_session``).

Semantics are the engines' row-level semantics on **float32** values
(``PredicateSpecs`` packs thresholds to f32, so every proof here quantizes
with ``np.float32`` first — reasoning from the python-float64
``Predicate.t1`` can prove facts the runtime contradicts):

  GT        x > t1            satisfying set  (t1, +inf)
  LT        x < t1                            (-inf, t1)
  BETWEEN   t1 < x < t2                       (t1, t2)
  EQ        round(x) == round32(t1) =: r      exactly  [r-0.5, r+0.5]-ish:
            over-approx [r-0.5, r+0.5] closed, under-approx (r-0.5, r+0.5)
            open (the half-even tie at the endpoints falls between)
  HASHMIX   opaque (the mix destroys ordering): over-approx is the whole
            line, under-approx is empty — it never participates in proofs.

Every check uses the approximation in the sound direction: emptiness /
unsatisfiability intersects OVER-approximations (superset ∩ superset = ∅
⇒ exact ∩ exact = ∅); containment (subsumption, always-true) compares an
over-approximation against an under-approximation.

Diagnostic codes:

  chain-unsat-predicate   empty satisfying set (e.g. BETWEEN with t2<=t1)
  chain-unsat-group       every member of an OR-group is unsatisfiable
  chain-unsat-conjunction contradictory AND-ed constraints on one column
  chain-subsumed          AND-level: a predicate implied by a stricter one
  chain-subsumed-member   OR-level: a member contained in a wider member
  chain-always-true       predicate passes the whole declared column domain
  chain-group-always-true an OR-group containing an always-true member
  chain-bloom-collision   distinct EQ keys sharing a Bloom bit (mod 128)
  chain-hashmix-shadows   HASHMIX member disables a group's tile-fail proof
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core import predicates as pred_lib
from repro_torch.core import skip_tier as skip_tier_lib
from repro_torch.core.predicates import Predicate

_INF = float("inf")


# ============================================================ interval algebra
class Ivl(NamedTuple):
    """An interval of the f32 number line, possibly open at either end."""

    lo: float
    hi: float
    lo_open: bool = False
    hi_open: bool = False

    def is_empty(self) -> bool:
        """Provably empty over float32 values.

        Open-open intervals are additionally empty when no f32 value fits
        strictly between the (f32) endpoints — (t1, nextafter(t1)) holds
        no representable value even though t1 < t2.
        """
        if np.isnan(self.lo) or np.isnan(self.hi):
            return False                    # unknown endpoints prove nothing
        if self.lo > self.hi:
            return True
        if self.lo == self.hi:
            return self.lo_open or self.hi_open
        if self.lo_open and self.hi_open and np.isfinite(self.lo):
            nxt = float(np.nextafter(np.float32(self.lo), np.float32(_INF)))
            return nxt >= self.hi
        return False

    def intersect(self, other: "Ivl") -> "Ivl":
        if (self.lo, not self.lo_open) >= (other.lo, not other.lo_open):
            lo, lo_open = self.lo, self.lo_open
        else:
            lo, lo_open = other.lo, other.lo_open
        if (self.hi, self.hi_open) <= (other.hi, other.hi_open):
            hi, hi_open = self.hi, self.hi_open
        else:
            hi, hi_open = other.hi, other.hi_open
        return Ivl(lo, hi, lo_open, hi_open)

    def hull(self, other: "Ivl") -> "Ivl":
        if (self.lo, not self.lo_open) <= (other.lo, not other.lo_open):
            lo, lo_open = self.lo, self.lo_open
        else:
            lo, lo_open = other.lo, other.lo_open
        if (self.hi, self.hi_open) >= (other.hi, other.hi_open):
            hi, hi_open = self.hi, self.hi_open
        else:
            hi, hi_open = other.hi, other.hi_open
        return Ivl(lo, hi, lo_open, hi_open)

    def contains(self, other: "Ivl") -> bool:
        """other ⊆ self (an empty ``other`` is contained in anything)."""
        if other.is_empty():
            return True
        lo_ok = self.lo < other.lo or (
            self.lo == other.lo and (not self.lo_open or other.lo_open))
        hi_ok = self.hi > other.hi or (
            self.hi == other.hi and (not self.hi_open or other.hi_open))
        return lo_ok and hi_ok

    def disjoint(self, other: "Ivl") -> bool:
        return self.intersect(other).is_empty()


FULL = Ivl(-_INF, _INF)
EMPTY = Ivl(1.0, 0.0)


def _f32(x: float) -> float:
    return float(np.float32(x))


def sat_over(p: Predicate) -> Ivl:
    """Superset of the f32 values satisfying ``p`` (thresholds f32-packed)."""
    t1, t2 = _f32(p.t1), _f32(p.t2)
    if p.op == pred_lib.OP_GT:
        return Ivl(t1, _INF, lo_open=True)
    if p.op == pred_lib.OP_LT:
        return Ivl(-_INF, t1, hi_open=True)
    if p.op == pred_lib.OP_BETWEEN:
        return Ivl(t1, t2, lo_open=True, hi_open=True)
    if p.op == pred_lib.OP_EQ:
        if not np.isfinite(t1):
            return FULL
        r = skip_tier_lib.eq_round(t1)
        # round(x)==r ⇒ |x-r| <= 0.5 regardless of f32 spacing (r is the
        # nearest integer to x); the half-even ties sit on the endpoints
        return Ivl(r - 0.5, r + 0.5)
    return FULL                              # OP_HASHMIX: opaque


def sat_under(p: Predicate) -> Ivl:
    """Subset of the f32 values satisfying ``p`` (∅ when nothing provable)."""
    t1, t2 = _f32(p.t1), _f32(p.t2)
    if p.op == pred_lib.OP_GT:
        return Ivl(t1, _INF, lo_open=True)
    if p.op == pred_lib.OP_LT:
        return Ivl(-_INF, t1, hi_open=True)
    if p.op == pred_lib.OP_BETWEEN:
        return Ivl(t1, t2, lo_open=True, hi_open=True)
    if p.op == pred_lib.OP_EQ:
        if not np.isfinite(t1):
            return EMPTY
        r = skip_tier_lib.eq_round(t1)
        return Ivl(r - 0.5, r + 0.5, lo_open=True, hi_open=True)
    return EMPTY                             # OP_HASHMIX: opaque


def _provable(p: Predicate) -> bool:
    return p.op != pred_lib.OP_HASHMIX


# ================================================================= the linter
def _groups_of(predicates: Sequence[Predicate]) -> list[list[int]]:
    """Predicate indices per OR-group, in first-appearance order (the same
    dense normalization ``predicates.pack`` applies)."""
    gids = pred_lib.normalize_groups(predicates)
    members: dict[int, list[int]] = {}
    for i, g in enumerate(gids):
        members.setdefault(g, []).append(i)
    return [members[g] for g in sorted(members)]


def _loc(i: int, p: Predicate) -> str:
    return f"chain[{i}]:{p.name}"


def _group_label(predicates, members) -> str:
    g = predicates[members[0]].group
    return repr(g) if g is not None else f"#{members[0]}"


def lint_chain(predicates: Sequence[Predicate],
               domains: dict[int, tuple[float, float]] | None = None,
               ) -> list[Diagnostic]:
    """All chain-semantics findings for one CNF chain.

    ``domains`` optionally maps column index → closed [lo, hi] bounds the
    data layer guarantees (e.g. the paper stream's string-hash column is
    [0, 2^24)); always-true detection only fires with a declared domain.
    """
    preds = list(predicates)
    diags: list[Diagnostic] = []
    groups = _groups_of(preds)
    over = [sat_over(p) for p in preds]
    under = [sat_under(p) for p in preds]

    # ---- unsatisfiable predicates / groups --------------------------------
    unsat = [ov.is_empty() for ov in over]
    for i, p in enumerate(preds):
        if unsat[i]:
            diags.append(Diagnostic(
                "chain-unsat-predicate", "error", _loc(i, p),
                f"predicate can never pass: satisfying set of "
                f"{p.describe()} is empty over f32",
                "fix the thresholds (BETWEEN needs t1 < t2 with room for "
                "an f32 value between) or delete the predicate"))
    for members in groups:
        if len(members) > 1 and all(unsat[i] for i in members):
            label = _group_label(preds, members)
            diags.append(Diagnostic(
                "chain-unsat-group", "error", f"group {label}",
                f"every member of OR-group {label} is individually "
                f"unsatisfiable — the group cuts all rows",
                "fix at least one member or delete the group"))

    # ---- contradictory conjunction per column -----------------------------
    # only groups whose members ALL constrain the same column can constrain
    # that column (a mixed-column group can be satisfied elsewhere); the
    # over-approx of an OR is the hull of its members' over-approxes.
    by_col: dict[int, list[tuple[str, Ivl]]] = {}
    for members in groups:
        cols = {preds[i].column for i in members}
        if len(cols) != 1:
            continue
        if any(unsat[i] for i in members) and not all(
                unsat[i] for i in members):
            # hull over live members only (dead ones add nothing to the OR)
            live = [i for i in members if not unsat[i]]
        else:
            live = members
        gov = over[live[0]]
        for i in live[1:]:
            gov = gov.hull(over[i])
        label = _group_label(preds, members) if len(members) > 1 \
            else preds[members[0]].name
        by_col.setdefault(cols.pop(), []).append((label, gov))
    for col, entries in by_col.items():
        if len(entries) < 2:
            continue
        acc = FULL
        for _, iv in entries:
            acc = acc.intersect(iv)
        if acc.is_empty() and not any(iv.is_empty() for _, iv in entries):
            names = ", ".join(label for label, _ in entries)
            diags.append(Diagnostic(
                "chain-unsat-conjunction", "error", f"column {col}",
                f"AND-ed constraints on column {col} are contradictory: "
                f"{names} admit no common f32 value — the chain cuts "
                "every row",
                "loosen one of the conflicting bounds or delete one "
                "conjunct"))

    # ---- subsumption ------------------------------------------------------
    singles = [m[0] for m in groups if len(m) == 1]
    reported: set[int] = set()
    for j in singles:                        # j: the redundant candidate
        if unsat[j] or not _provable(preds[j]):
            continue
        for i in singles:
            if i == j or unsat[i] or not _provable(preds[i]):
                continue
            if preds[i].column != preds[j].column:
                continue
            # p_i ⊆ p_j  ⇒  p_j is implied by p_i (AND-level redundancy);
            # identical sets keep the EARLIER statement
            if under[j].contains(over[i]) and (
                    not under[i].contains(over[j]) or i < j):
                if j not in reported:
                    reported.add(j)
                    diags.append(Diagnostic(
                        "chain-subsumed", "warning", _loc(j, preds[j]),
                        f"{preds[j].name!r} is implied by the stricter "
                        f"{preds[i].name!r} on column {preds[j].column} — "
                        "it can never cut a row the chain keeps",
                        "delete it (note the plan fingerprint changes)"))
                break
    for members in groups:
        if len(members) < 2:
            continue
        for j in members:                    # j: the redundant member
            if unsat[j] or not _provable(preds[j]):
                continue
            for i in members:
                if i == j or unsat[i] or not _provable(preds[i]):
                    continue
                if preds[i].column != preds[j].column:
                    continue
                # OR-level: member j ⊆ member i ⇒ j adds nothing
                if under[i].contains(over[j]) and (
                        not under[j].contains(over[i]) or i < j):
                    diags.append(Diagnostic(
                        "chain-subsumed-member", "warning",
                        _loc(j, preds[j]),
                        f"OR-member {preds[j].name!r} is contained in the "
                        f"wider {preds[i].name!r} — it can never pass a "
                        "row the group rejects",
                        "delete the narrower member"))
                    break

    # ---- always-true under declared domains -------------------------------
    always = [False] * len(preds)
    if domains:
        for i, p in enumerate(preds):
            dom = domains.get(p.column)
            if dom is None or not _provable(p):
                continue
            if under[i].contains(Ivl(_f32(dom[0]), _f32(dom[1]))):
                always[i] = True
        for members in groups:
            hits = [i for i in members if always[i]]
            if not hits:
                continue
            if len(members) == 1:
                i, p = hits[0], preds[hits[0]]
                diags.append(Diagnostic(
                    "chain-always-true", "warning", _loc(i, p),
                    f"{p.name!r} passes the entire declared domain "
                    f"{domains[p.column]} of column {p.column} — it never "
                    "cuts and only costs",
                    "delete it, or fix the domain declaration if the data "
                    "layer's bounds changed"))
            else:
                label = _group_label(preds, members)
                names = ", ".join(preds[i].name for i in hits)
                diags.append(Diagnostic(
                    "chain-group-always-true", "warning", f"group {label}",
                    f"OR-group {label} contains always-true member(s) "
                    f"{names} — the whole group never cuts",
                    "delete the group (an OR with a tautological member "
                    "is a tautology)"))

    # ---- Bloom key collisions --------------------------------------------
    # the Bloom bit array is per-column (``bloom[col, :, key]``), so only
    # same-column EQ keys can collide
    seen_keys: dict[tuple[int, int], tuple[int, float]] = {}
    for i, p in enumerate(preds):
        if p.op != pred_lib.OP_EQ or not np.isfinite(_f32(p.t1)):
            continue
        r = skip_tier_lib.eq_round(_f32(p.t1))
        key = skip_tier_lib.bloom_key(_f32(p.t1))
        prev = seen_keys.get((p.column, key))
        if prev is not None and prev[1] != r:
            j, rj = prev
            diags.append(Diagnostic(
                "chain-bloom-collision", "warning", _loc(i, p),
                f"EQ keys {rj:g} ({preds[j].name!r}) and {r:g} "
                f"({p.name!r}) collide under the skip-tier Bloom "
                f"quantizer (both ≡ {key} mod "
                f"{skip_tier_lib.BLOOM_BITS}) — tiles holding one key "
                "are never Bloom-skipped for the other",
                "pick equality keys distinct modulo 128, or accept the "
                "weaker zonemap-only fail proof for these"))
        else:
            seen_keys[(p.column, key)] = (i, r)

    # ---- HASHMIX shadowing a group's tile-fail proof ----------------------
    for members in groups:
        if len(members) < 2:
            continue
        mix = [i for i in members if not _provable(preds[i])]
        provable = [i for i in members if _provable(preds[i])]
        if mix and provable:
            label = _group_label(preds, members)
            diags.append(Diagnostic(
                "chain-hashmix-shadows", "info", f"group {label}",
                f"OR-group {label} mixes HASHMIX member(s) "
                f"({', '.join(preds[i].name for i in mix)}) with provable "
                "ones — a group tile-fail proof needs EVERY member "
                "provably failed, so the skip tier can never fail-skip "
                "this group's tiles",
                "expected for regex-like members; to recover fail-skips, "
                "split the HASHMIX into its own AND-ed group if semantics "
                "allow"))

    return diags
