"""Statistics scope policies (paper §2.2), single-device part.

PyTorch port of ``repro.core.scope``. PER_BATCH resets the epoch
evidence every step; PER_SHARD keeps it per executor; CENTRALIZED merges
batch counters across shards. On one device there is nothing to merge
(``repro``'s ``reduce_stats`` is the identity there), so the single-device
port has no reduction; the cross-device merge arrives with the sharding
slice.
"""

from __future__ import annotations

import enum


class Scope(enum.Enum):
    PER_BATCH = "per_batch"
    PER_SHARD = "per_shard"
    CENTRALIZED = "centralized"


#: Statistics-exchange cadence for CENTRALIZED.
EXCHANGE_MODES = ("eager", "deferred", "deferred-async")


def scope_from_str(name: str) -> Scope:
    try:
        return Scope(name)
    except ValueError as exc:
        raise ValueError(
            f"unknown scope {name!r}; pick from "
            f"{[s.value for s in Scope]}") from exc
