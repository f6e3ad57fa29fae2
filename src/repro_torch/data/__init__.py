"""Data substrate of the port: columnar record batches, the synthetic
drifting log stream and the request-stream adapter (numpy; the same bytes
as ``repro.data.stream``), the hash tokenizer, and the staged ingestion
pipeline that feeds a trainer."""

from repro_torch.data.schema import RecordBatch
from repro_torch.data.stream import (BASE_DISTRIBUTIONS, DriftConfig,
                                     LogStream, RequestStream, gen_batch,
                                     norm_ppf, threshold_for_quantile)
from repro_torch.data.pipeline import (Pipeline, PipelineState,
                                      ShardedPipeline, ShardedPipelineState,
                                      make_pipeline)

__all__ = ["RecordBatch", "BASE_DISTRIBUTIONS", "DriftConfig", "LogStream",
           "RequestStream", "gen_batch", "norm_ppf", "threshold_for_quantile",
           "Pipeline", "PipelineState", "ShardedPipeline",
           "ShardedPipelineState", "make_pipeline"]
