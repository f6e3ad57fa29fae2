"""FilterPlan: the one declarative description of an adaptive-filter stage.

PyTorch port of ``repro.core.plan``. The fields, the cross-field rules of
``validate_combo`` (with the same messages) and ``fingerprint()`` are the
reference's; the engines are the port's (``"torch"``, ``"cuda"``,
``"numpy"``) and the default engine is ``"cuda"``. ``shards > 1`` runs S
shards on the session's one device (``core.sharded``). Every combination
``repro`` builds builds here, and every one it refuses is refused with
its message, the engine's name aside: ``cost_mode="measured"`` needs the
``numpy`` engine, and a host engine cannot shard, compact or take
``skip_tier="auto"``. A host engine streams through
``AdaptiveFilter.process_stream``; a session's step of its plan runs the
``torch`` engine (``core.session``).

``fingerprint()`` hashes the semantic identity of the adaptive state
(chain, ordering config, scope, adaptivity, cost mode) byte for byte as
``repro`` does and excludes every execution detail, the engine included,
so a saved state moves freely between the packages and their engines.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Sequence

from repro_torch.core import engine as engine_lib
from repro_torch.core.engine import get_engine
from repro_torch.core.ordering import OrderingConfig
from repro_torch.core.predicates import Predicate
from repro_torch.core.scope import EXCHANGE_MODES, scope_from_str
from repro_torch.core.skip_tier import SKIP_TIER_MODES

#: vocab ceiling of the device tokenizer (as in ``repro``)
MAX_DEVICE_VOCAB = 1 << 24


def validate_combo(*, scope: str, cost_mode: str, backend: str,
                   compact_output: bool, compact_capacity,
                   compact_slack: float, exchange: str, shards: int = 1,
                   device_tokenize: bool = False,
                   skip_tier: str = "off") -> None:
    """The cross-field validation, rule for rule and message for message
    as ``repro.core.plan.validate_combo``: every violated rule is reported
    in ONE aggregated ``ValueError``."""
    problems: list[str] = []
    try:
        scope_from_str(scope)
        scope_ok = True
    except ValueError as e:
        problems.append(str(e))
        scope_ok = False
    if cost_mode not in ("static", "measured"):
        problems.append(f"bad cost_mode {cost_mode}; pick from "
                        "('static', 'measured')")
    backend_ok = backend in engine_lib.available_engines()
    if not backend_ok:
        problems.append(f"bad backend {backend}; registered engines: "
                        f"{engine_lib.available_engines()}")
    if cost_mode == "measured" and backend != "numpy":
        problems.append(
            "measured cost mode needs the host (numpy) backend; "
            f"cost_mode='static' works on every engine, got {backend!r}")
    if shards < 1:
        problems.append(f"shards must be >= 1, got {shards}")
    traceable = backend_ok and get_engine(backend).traceable
    if backend_ok and shards > 1 and not traceable:
        problems.append(
            f"backend {backend!r} is a host engine; the sharded "
            "filter needs a traceable engine (jnp / pallas)")
    if backend_ok and compact_output and not traceable:
        problems.append(
            "compact_output is the device-side gather; the host "
            f"engine {backend!r} already emits compacted rows "
            "(boolean-index short-circuit) — drop the flag")
    if compact_capacity is not None:
        if not compact_output:
            problems.append("compact_capacity needs compact_output=True")
        if isinstance(compact_capacity, str):
            if compact_capacity != "auto":
                problems.append(
                    f"compact_capacity {compact_capacity!r}: pass "
                    "an int, None (batch width), or 'auto'")
        elif compact_capacity < 1:
            problems.append(
                f"compact_capacity must be >= 1, got {compact_capacity!r} "
                "(or None for batch width, or 'auto')")
    if compact_slack < 1.0:
        problems.append(f"compact_slack must be >= 1.0 (headroom factor), "
                        f"got {compact_slack!r}")
    if exchange not in EXCHANGE_MODES:
        problems.append(
            f"bad exchange {exchange!r}; pick from {EXCHANGE_MODES}")
    elif exchange != "eager" and scope_ok and scope != "centralized":
        problems.append(
            "deferred exchange only changes the CENTRALIZED scope's "
            f"collective cadence; scope {scope!r} never exchanges "
            "— drop the flag")
    if device_tokenize and not compact_output:
        problems.append("device_tokenize consumes the padded compacted "
                        "buffers — it needs compact_output=True")
    if skip_tier not in SKIP_TIER_MODES:
        problems.append(
            f"bad skip_tier {skip_tier!r}; pick from {SKIP_TIER_MODES}")
    elif skip_tier != "off":
        if shards > 1:
            problems.append(
                "skip_tier needs shards == 1: the jnp skip path sizes its "
                "ambiguous-tile gather from a per-step host sync, which "
                "cannot drive static shapes under shard_map — run the "
                "tier per-executor or drop it")
        if backend_ok and not getattr(get_engine(backend), "supports_skip",
                                      False):
            problems.append(
                f"backend {backend!r} does not implement the skip tier; "
                "pick an engine with tile-statistics support (jnp / "
                "pallas / numpy) or skip_tier='off'")
        if backend_ok and skip_tier == "auto" and not traceable:
            problems.append(
                "skip_tier='auto' is driven by the session's online "
                "us_per_row tuner, which needs a traceable engine — pick "
                "'zonemap'/'zonemap+bloom' explicitly for host engines")
    if problems:
        if len(problems) == 1:
            raise ValueError(problems[0])
        raise ValueError(
            f"{len(problems)} invalid plan field combinations:\n  - "
            + "\n  - ".join(problems))


@dataclasses.dataclass(frozen=True)
class TokenizeSpec:
    """On-device tokenize/pack stage appended to the compacted survivors."""

    vocab_size: int
    tokens_per_row: int = 8

    def __post_init__(self) -> None:
        if not 1 <= self.vocab_size < MAX_DEVICE_VOCAB:
            raise ValueError(
                f"tokenize vocab_size must be in [1, {MAX_DEVICE_VOCAB}) "
                f"(u32-limb modulo), got {self.vocab_size}")
        if self.tokens_per_row < 1:
            raise ValueError("tokens_per_row must be >= 1")


@dataclasses.dataclass(frozen=True)
class FilterPlan:
    """Declarative adaptive-filter stage (see ``repro.core.plan`` for the
    full table of valid field combinations). Compile with
    ``repro_torch.core.session.build_session(plan, device=None)``."""

    predicates: Sequence[Predicate]      # the chain (CNF via Predicate.group)
    ordering: OrderingConfig = OrderingConfig()
    engine: str = "cuda"
    scope: str = "per_shard"
    shards: int = 1
    axis_name: str = "data"
    adaptive: bool = True
    cost_mode: str = "static"
    compact: bool = False
    capacity: int | str | None = None    # None | int | "auto"
    slack: float = 1.5
    exchange: str = "eager"
    tokenize: TokenizeSpec | None = None
    skip_tier: str = "off"

    def __post_init__(self) -> None:
        object.__setattr__(self, "predicates", tuple(self.predicates))
        if not self.predicates:
            raise ValueError("need at least one predicate")
        validate_combo(scope=self.scope, cost_mode=self.cost_mode,
                       backend=self.engine, compact_output=self.compact,
                       compact_capacity=self.capacity,
                       compact_slack=self.slack, exchange=self.exchange,
                       shards=self.shards,
                       device_tokenize=self.tokenize is not None,
                       skip_tier=self.skip_tier)

    def fingerprint(self) -> str:
        """Semantic identity of the adaptive state this plan produces —
        the same 16 hex digits ``repro.core.plan.FilterPlan`` gives."""
        payload = {
            "predicates": [
                (p.name, p.column, p.op, p.t1, p.t2, p.rounds,
                 p.static_cost, None if p.group is None else str(p.group))
                for p in self.predicates],
            "ordering": dataclasses.asdict(self.ordering),
            "scope": self.scope,
            "adaptive": self.adaptive,
            "cost_mode": self.cost_mode,
        }
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]
