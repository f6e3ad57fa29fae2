"""Data substrate of the port: columnar record batches and the synthetic
drifting log stream (numpy; the same bytes as ``repro.data.stream``)."""

from repro_torch.data.schema import RecordBatch
from repro_torch.data.stream import (BASE_DISTRIBUTIONS, DriftConfig,
                                     LogStream, gen_batch, norm_ppf,
                                     threshold_for_quantile)

__all__ = ["RecordBatch", "BASE_DISTRIBUTIONS", "DriftConfig", "LogStream",
           "gen_batch", "norm_ppf", "threshold_for_quantile"]
