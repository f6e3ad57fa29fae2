"""Drifting-mix synthetic request traffic for the admission server.

A numpy copy of ``repro.serving.traffic`` that produces the same bytes
for the same arguments (the port imports nothing of ``repro``).

~1M persistent user identities drive request features through the
guardrail chain's columns:

  0 prompt_len   — tokens in the prompt (len_ok: < 900)
  1 abuse_score  — heuristic abuse classifier output (abuse_ok: < 0.92)
  2 user_budget  — remaining token budget (budget_ok: > 10)
  3 allowlist    — 0/1 enterprise-allowlist membership (allow: > 0.5)

Three user COHORTS own disjoint, persistent id ranges; a user's
allowlist membership and budget tier are pure functions of a hash of
the user id, so cohort identity survives across batches, restarts, and
replay:

  organic     — moderate prompts, low abuse, mid budgets, ~15% allowlisted
  abusive     — long prompts, high abuse scores, drained budgets
  enterprise  — short prompts, clean, rich budgets, ~92% allowlisted

The PHASE of the stream reweights the cohort mix — organic-dominated →
abuse storm → enterprise/allowlist-heavy — so predicate selectivities
and effective costs drift exactly the way the adaptive gate exists for:
the cheap allowlist probe is nearly useless in phase 0 and nearly
decisive in phase 2, and the expensive abuse check goes from formality
to front line in phase 1.

Counter-based and pure in ``(seed, batch_index)`` (the ``LogStream``
discipline): restartable from any cursor, bit-exact under rollback
replay, and regenerable by the synchronous admission-parity reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import OP_GT, OP_LT, Predicate

COHORTS = ("organic", "abusive", "enterprise")

#: request-feature column indices (the guardrail chain's contract)
COL_PROMPT_LEN = 0
COL_ABUSE = 1
COL_BUDGET = 2
COL_ALLOW = 3
N_FEATURES = 4


def guardrail_chain() -> list[Predicate]:
    """Request-admission predicates over the traffic columns above (CNF):

        len_ok AND (allowlisted OR budget_ok) AND (allowlisted OR abuse_ok)

    i.e. ``allowlisted OR (budget_ok AND abuse_ok)`` distributed into
    AND-of-OR groups — allowlisted traffic skips the expensive
    budget/abuse checks via the OR short-circuit, and the adaptive
    ordering learns to probe the cheap allowlist bit first when
    allowlisted traffic dominates (phase 2 below).
    """
    allow = dict(column=COL_ALLOW, op=OP_GT, t1=0.5, static_cost=0.2)
    return [
        Predicate("len_ok", column=COL_PROMPT_LEN, op=OP_LT, t1=900.0,
                  static_cost=1.0),
        Predicate("allow_b", group="allow_or_budget", **allow),
        Predicate("budget_ok", column=COL_BUDGET, op=OP_GT, t1=10.0,
                  static_cost=1.5, group="allow_or_budget"),
        Predicate("allow_a", group="allow_or_abuse", **allow),
        Predicate("abuse_ok", column=COL_ABUSE, op=OP_LT, t1=0.92,
                  static_cost=4.0, group="allow_or_abuse"),
    ]


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Mix schedule: ``mix[phase]`` are (organic, abusive, enterprise)
    cohort weights; the stream cycles through the phases every
    ``phase_requests`` rows."""

    seed: int = 0
    n_users: int = 1 << 20        # ~1.05M persistent identities
    phase_requests: int = 2048    # rows per phase before the mix shifts
    mix: tuple = (
        (0.85, 0.05, 0.10),       # phase 0: organic traffic
        (0.40, 0.50, 0.10),       # phase 1: abuse storm
        (0.25, 0.05, 0.70),       # phase 2: enterprise/allowlist-heavy
    )

    def __post_init__(self) -> None:
        if self.phase_requests <= 0:
            raise ValueError("phase_requests must be positive")
        for row in self.mix:
            if len(row) != len(COHORTS) or abs(sum(row) - 1.0) > 1e-6:
                raise ValueError(f"mix rows must be {len(COHORTS)} weights "
                                 f"summing to 1, got {row}")

    @property
    def n_phases(self) -> int:
        return len(self.mix)


def phase_of(cfg: TrafficConfig, row_mid: float) -> int:
    """Phase owning a row position (batches use their midpoint row)."""
    return int(row_mid // cfg.phase_requests) % cfg.n_phases


def _user_hash(uid: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer: per-user u64 the persistent attributes hang
    off (the splitmix64 mix the tokenizer hashes with)."""
    x = uid.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


#: per-cohort generative parameters:
#: (prompt mean/std, abuse Beta a/b, budget base/span, P(allowlisted))
_COHORT_PARAMS = {
    "organic": ((550.0, 220.0), (2.0, 12.0), (15.0, 85.0), 0.15),
    "abusive": ((950.0, 280.0), (16.0, 2.0), (-5.0, 30.0), 0.02),
    "enterprise": ((420.0, 160.0), (1.0, 16.0), (150.0, 120.0), 0.92),
}

# disjoint user-id ranges per cohort (fractions of n_users): identity —
# and therefore allowlist membership and budget tier — persists across
# every batch that samples the cohort
_COHORT_ID_RANGES = {
    "organic": (0.0, 0.70),
    "abusive": (0.70, 0.80),
    "enterprise": (0.80, 1.0),
}


def gen_requests_with_users(
        cfg: TrafficConfig, batch_index: int, row_start: int,
        n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """Rows [row_start, row_start+n_rows) as (f32[4, n], user_ids i64[n]).

    Counter-based: depends only on ``(cfg, batch_index, row_start,
    n_rows)``, never on generator history. All cohorts draw for every
    row and a mask selects — a fixed draw schedule keeps the stream
    bit-reproducible regardless of the realized mix.
    """
    rng = np.random.Generator(np.random.Philox(
        key=[cfg.seed, batch_index]))
    phase = phase_of(cfg, row_start + n_rows / 2)
    cohort = rng.choice(len(COHORTS), size=n_rows, p=cfg.mix[phase])

    feats = np.zeros((N_FEATURES, n_rows), np.float64)
    users = np.zeros(n_rows, np.int64)
    for ci, name in enumerate(COHORTS):
        (pm, ps), (ba, bb), (b0, bspan), p_allow = _COHORT_PARAMS[name]
        lo, hi = _COHORT_ID_RANGES[name]
        uid = rng.integers(int(lo * cfg.n_users),
                           max(int(hi * cfg.n_users), int(lo * cfg.n_users) + 1),
                           n_rows)
        h = _user_hash(uid)
        u1 = (h & np.uint64(0xFFFF)).astype(np.float64) / 65536.0
        u2 = ((h >> np.uint64(16)) & np.uint64(0xFFFF)).astype(np.float64) \
            / 65536.0
        prompt = rng.normal(pm, ps, n_rows).clip(1.0, 4096.0)
        abuse = rng.beta(ba, bb, n_rows)
        budget = b0 + bspan * u1 + rng.normal(0.0, 5.0, n_rows)
        allow = (u2 < p_allow).astype(np.float64)
        sel = cohort == ci
        feats[COL_PROMPT_LEN, sel] = prompt[sel]
        feats[COL_ABUSE, sel] = abuse[sel]
        feats[COL_BUDGET, sel] = budget[sel]
        feats[COL_ALLOW, sel] = allow[sel]
        users[sel] = uid[sel]
    return feats.astype(np.float32), users


def gen_requests(cfg: TrafficConfig, batch_index: int, row_start: int,
                 n_rows: int) -> np.ndarray:
    """Feature columns only — the ``RequestStream`` generator signature."""
    return gen_requests_with_users(cfg, batch_index, row_start, n_rows)[0]


class TrafficGenerator:
    """A ``TrafficConfig`` bound into the per-batch generator callable the
    serving stream adapter (``data.stream.RequestStream``) consumes."""

    def __init__(self, cfg: TrafficConfig = TrafficConfig()):
        self.cfg = cfg

    def gen(self, batch_index: int, row_start: int,
            n_rows: int) -> np.ndarray:
        return gen_requests(self.cfg, batch_index, row_start, n_rows)

    def stream(self, total_requests: int, batch_rows: int,
               start_batch: int = 0):
        from repro_torch.data.stream import RequestStream

        return RequestStream(self.gen, total_rows=total_requests,
                             batch_rows=batch_rows, start_batch=start_batch)
