"""Staged ingestion pipeline: stream → adaptive filter → tokenize → pack.

PyTorch port of ``repro.data.pipeline``. Two deployment shapes, both thin
iterators over ONE ``FilterSession`` (``make_pipeline(build_session(plan),
...)`` picks the right one):

  ``Pipeline``        — one stream, one session: each ``LogStream`` batch
                        takes one ``session.step``.
  ``ShardedPipeline`` — S round-robin partitions of one stream
                        (``LogStream(shard_id=i, num_shards=S)``) feed one
                        sharded session step per iteration, shard i's
                        batch as rows [i·R, (i+1)·R) of the [C, S·R]
                        batch; survivors and tokens come back shard-major.

Both emit fixed-shape LM batches {"tokens": i32[B, S], "labels": i32[B,
S]}. All per-step driving —
capacity resolution, auto retune, overflow warnings, metrics — lives in
``FilterSession.step``. The filter's ``OrderState`` is part of the
pipeline state, so adaptive ranks survive restarts, and a restore
continues bit-identically; a ``ShardedPipeline`` also restores a state
saved on another shard count (the session reshards the filter state, and
every stream resumes at the next unconsumed global batch).

With a ``TokenizeSpec`` on the plan (it needs ``compact=True``) the
tokenize/pack stage runs on the session's device over the padded
survivor buffer (``tokenizer.tokens_from_padded``), so one iteration
moves exactly one dense token buffer to the host. Without it, the
iteration copies the survivors' slice of the packed buffer (or boolean-
indexes the batch when compaction is off) and tokenizes on the host with
``tokenizer.rows_to_tokens``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.plan import TokenizeSpec
from repro_torch.core.session import (FilterSession, fstate_from_arrays,
                                      fstate_to_arrays)
from repro_torch.data import tokenizer
from repro_torch.data.stream import DriftConfig, LogStream

__all__ = ["Pipeline", "PipelineState", "ShardedPipeline",
           "ShardedPipelineState", "make_pipeline",
           "state_to_checkpoint", "state_from_checkpoint",
           "fstate_to_arrays", "fstate_from_arrays"]


def _as_session(filt, device_tokenize: bool, vocab_size: int,
                tokens_per_row: int):
    """Normalize a pipeline's filter argument to ONE session.

    Accepts a ``FilterSession`` or a wrapper that proxies its surface and
    says so with ``is_guarded_session``. Returns (session,
    device_tokenize) with the tokenize stage attached to the session when
    requested; combination rules are ``FilterPlan``'s.
    """
    if not (isinstance(filt, FilterSession)
            or getattr(filt, "is_guarded_session", False)):
        raise TypeError(
            f"a pipeline drives a FilterSession (build_session(plan)), got "
            f"{type(filt).__name__}")
    session = filt
    spec = session.plan.tokenize
    if spec is None and device_tokenize:
        spec = TokenizeSpec(vocab_size, tokens_per_row)
        session = session.with_tokenize(spec)
    if spec is not None and (spec.vocab_size != vocab_size
                             or spec.tokens_per_row != tokens_per_row):
        raise ValueError(
            f"pipeline tokenize params (vocab={vocab_size}, "
            f"tokens_per_row={tokens_per_row}) disagree with the plan's "
            f"TokenizeSpec {spec}")
    return session, spec is not None


@dataclasses.dataclass
class PipelineState:
    stream_cursor: int
    filter_state: dict          # versioned session blob (schema v2);
                                # pre-session raw-array (v1) dicts restore too
    buffer: np.ndarray          # leftover tokens not yet emitted
    batches_emitted: int
    rows_in: int
    rows_pass: int


@dataclasses.dataclass
class ShardedPipelineState:
    stream_cursors: list        # one LogStream cursor per shard
    filter_state: dict          # versioned session blob (v2; stacked
                                # [S, ...] arrays inside), v1 loads too
    buffer: np.ndarray
    batches_emitted: int
    rows_in: int
    rows_pass: int


def state_to_checkpoint(st) -> tuple[dict, dict]:
    """A ``PipelineState`` or ``ShardedPipelineState`` as
    ``save_checkpoint``'s (tree, extra): the filter blob's arrays and the
    token buffer go to the npz, its scalars (the stream cursors included)
    and the blob's other keys to the manifest's ``extra``."""
    fs = st.filter_state
    tree = {"filter": fs["arrays"], "buffer": st.buffer}
    extra = {k: v for k, v in dataclasses.asdict(st).items()
             if k not in ("filter_state", "buffer")}
    extra["filter_meta"] = {k: v for k, v in fs.items() if k != "arrays"}
    return tree, extra


def state_from_checkpoint(tree: dict, extra: dict):
    """The inverse of ``state_to_checkpoint`` on what ``load_checkpoint``
    returns."""
    extra = dict(extra)
    meta = extra.pop("filter_meta")
    cls = ShardedPipelineState if "stream_cursors" in extra \
        else PipelineState
    return cls(filter_state=dict(meta, arrays=tree["filter"]),
               buffer=tree["buffer"], **extra)


class _LMBatchEmitter:
    """The session step and the token-buffer emit shared by both
    pipelines."""

    def __init__(self, filt, batch_size: int, seq_len: int,
                 vocab_size: int, tokens_per_row: int,
                 device_tokenize: bool):
        self._session, self._device_tokenize = _as_session(
            filt, device_tokenize, vocab_size, tokens_per_row)
        self.filt = self._session.filter
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.tokens_per_row = tokens_per_row
        self._fstate = self._session.init_state()
        self._buffer = np.zeros((0,), np.int32)
        self.batches_emitted = 0
        self.rows_in = 0
        self.rows_pass = 0
        self.last_metrics: dict = {}

    def _restore_rest(self, st) -> None:
        self._fstate = self._session.restore_state(st.filter_state)
        self._buffer = st.buffer.copy()
        self.batches_emitted = st.batches_emitted
        self.rows_in = st.rows_in
        self.rows_pass = st.rows_pass

    def _emit_tokens(self, toks: np.ndarray) -> Iterator[dict]:
        self._buffer = np.concatenate([self._buffer, toks])
        need = self.batch_size * (self.seq_len + 1)
        while self._buffer.size >= need:
            chunk, self._buffer = self._buffer[:need], self._buffer[need:]
            seq = chunk.reshape(self.batch_size, self.seq_len + 1)
            self.batches_emitted += 1
            yield {"tokens": seq[:, :-1].astype(np.int32),
                   "labels": seq[:, 1:].astype(np.int32)}

    def _filter_step(self, columns) -> tuple[np.ndarray, int]:
        """ONE session step; returns (host tokens, n_pass).

        Under device tokenization only the dense token stream comes back
        to the host; otherwise the surviving rows do (the packed buffer's
        slice under compaction, a boolean index otherwise) and are
        tokenized here. ``last_metrics`` is the session's JSON encoding,
        with the per-shard ``n_dropped`` beside the sum when sharded.
        """
        self._fstate, res = self._session.step(self._fstate, columns)
        self.last_metrics = res.metrics_dict()
        if self._device_tokenize:
            return res.host_tokens(), res.n_pass
        return tokenizer.rows_to_tokens(
            res.survivors(columns), self.vocab_size,
            self.tokens_per_row), res.n_pass


class Pipeline(_LMBatchEmitter):
    def __init__(self, stream: LogStream, filt,
                 batch_size: int, seq_len: int, vocab_size: int,
                 tokens_per_row: int = 8, device_tokenize: bool = False):
        self.stream = stream
        super().__init__(filt, batch_size, seq_len, vocab_size,
                         tokens_per_row, device_tokenize)

    # ------------------------------------------------------------- checkpoint
    def state(self) -> PipelineState:
        return PipelineState(
            stream_cursor=self.stream.cursor,
            filter_state=self._session.save_state(self._fstate),
            buffer=self._buffer.copy(),
            batches_emitted=self.batches_emitted,
            rows_in=self.rows_in,
            rows_pass=self.rows_pass,
        )

    def restore(self, st: PipelineState) -> None:
        self.stream.cursor = st.stream_cursor
        self._restore_rest(st)

    # -------------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[dict]:
        for rb in self.stream:
            toks, n_pass = self._filter_step(rb.columns)
            self.rows_in += rb.n_rows
            self.rows_pass += n_pass
            yield from self._emit_tokens(toks)


class ShardedPipeline(_LMBatchEmitter):
    """Multi-shard ingestion: S per-shard streams → one sharded step.

    ``streams[i]`` must be the i-th round-robin partition of one logical
    stream (``LogStream(shard_id=i, num_shards=S)``), like Spark partitions
    spread over executors. Each iteration pulls one batch per shard,
    block-concatenates them into the [C, S·R] layout of a sharded session
    (shard i owns rows [i·R, (i+1)·R)), runs ONE session step and packs
    the survivors shard-major into LM batches. The stacked per-shard
    ``OrderState`` checkpoints and restores as a whole.
    """

    def __init__(self, streams: Sequence[LogStream], filt,
                 batch_size: int, seq_len: int, vocab_size: int,
                 tokens_per_row: int = 8, device_tokenize: bool = False):
        super().__init__(filt, batch_size, seq_len, vocab_size,
                         tokens_per_row, device_tokenize)
        if len(streams) != self._session.num_shards:
            raise ValueError(f"{len(streams)} streams for "
                             f"{self._session.num_shards} shards")
        self.streams = list(streams)

    # ------------------------------------------------------------- checkpoint
    def state(self) -> ShardedPipelineState:
        return ShardedPipelineState(
            stream_cursors=[s.cursor for s in self.streams],
            filter_state=self._session.save_state(self._fstate),
            buffer=self._buffer.copy(),
            batches_emitted=self.batches_emitted,
            rows_in=self.rows_in,
            rows_pass=self.rows_pass,
        )

    def restore(self, st: ShardedPipelineState) -> None:
        """Restore a state of this shard count, or (elastic S→S′) of
        another: the session reshards the filter state, and every new
        stream partition resumes at the next unconsumed GLOBAL batch index
        (the largest cursor — all source shards have walked the indices
        below it)."""
        if len(st.stream_cursors) != len(self.streams):
            cursor = max(int(c) for c in st.stream_cursors)
            for stream in self.streams:
                stream.cursor = cursor
        else:
            for stream, cur in zip(self.streams, st.stream_cursors):
                stream.cursor = int(cur)
        self._restore_rest(st)

    # -------------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[dict]:
        iters = [iter(s) for s in self.streams]
        while True:
            rbs = []
            for it in iters:
                rb = next(it, None)
                if rb is None:          # a shard ran dry → stream over
                    return
                rbs.append(rb)
            cols = np.concatenate([rb.columns for rb in rbs], axis=1)
            toks, n_pass = self._filter_step(cols)
            self.rows_in += cols.shape[1]
            self.rows_pass += n_pass
            yield from self._emit_tokens(toks)


def make_pipeline(session, *, total_rows: int, batch_rows: int,
                  batch_size: int, seq_len: int, vocab_size: int | None = None,
                  seed: int = 0, drift=None,
                  tokens_per_row: int | None = None):
    """One ``FilterSession`` → its ingestion pipeline.

    Builds one round-robin ``LogStream`` partition per plan shard and
    returns a ``Pipeline`` (1 shard) or a ``ShardedPipeline``. Device
    tokenization follows the plan's ``tokenize`` spec — there is
    nothing to wire by hand: ``vocab_size``/``tokens_per_row`` default from
    it (they are only required here when the plan has no tokenize stage
    and the host tokenizer needs them).
    """
    spec = session.plan.tokenize
    if vocab_size is None:
        if spec is None:
            raise ValueError("vocab_size is required when the plan has no "
                             "TokenizeSpec to default it from")
        vocab_size = spec.vocab_size
    if tokens_per_row is None:
        tokens_per_row = spec.tokens_per_row if spec is not None else 8
    n = session.num_shards
    streams = [LogStream(total_rows=total_rows, batch_rows=batch_rows,
                         seed=seed, drift=drift or DriftConfig(), shard_id=i,
                         num_shards=n) for i in range(n)]
    kw = dict(batch_size=batch_size, seq_len=seq_len, vocab_size=vocab_size,
              tokens_per_row=tokens_per_row)
    if session.sharded:
        return ShardedPipeline(streams, session, **kw)
    return Pipeline(streams[0], session, **kw)
