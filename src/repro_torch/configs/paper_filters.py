"""The paper's own workload config: Table 1 defaults + the 4-predicate
chain over the 75M-row synthetic date/int/string stream, plus CNF
(AND-of-OR) variants of the chain. Same values as
``repro.configs.paper_filters``."""

import dataclasses

from repro_torch.core.ordering import OrderingConfig
from repro_torch.data.stream import DriftConfig


@dataclasses.dataclass(frozen=True)
class PaperWorkload:
    total_rows: int = 75_000_000          # the paper's dataset size
    bench_rows: int = 3_000_000
    batch_rows: int = 65536
    ordering: OrderingConfig = OrderingConfig(
        collect_rate=1000, calculate_rate=1_000_000, momentum=0.3)
    drift: DriftConfig = DriftConfig(kind="regime", period_rows=750_000,
                                     amplitude=1.5)


DEFAULT = PaperWorkload()

CNF_SHAPES = ("flat", "cnf", "wide")


def filter_chain(shape: str = "flat"):
    """Paper chain in one of the benchmark group shapes.

    flat — the paper's 4-predicate conjunction (all singleton groups)
    cnf  — int_hi AND int_lo AND (date_gt OR str_match): one OR pair
    wide — int_hi AND (int_lo OR date_gt OR str_match): one 3-wide OR group
    """
    from repro_torch.core.predicates import paper_filters_4, paper_filters_cnf

    if shape == "flat":
        return paper_filters_4("fig1")
    if shape == "cnf":
        return paper_filters_cnf("fig1")
    if shape == "wide":
        int_hi, int_lo, date_gt, str_match = paper_filters_4("fig1")
        grouped = [dataclasses.replace(p, group="wide_or")
                   for p in (int_lo, date_gt, str_match)]
        return [int_hi, *grouped]
    raise ValueError(f"unknown chain shape {shape!r}")
