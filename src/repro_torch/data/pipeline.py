"""Staged ingestion pipeline: stream → adaptive filter → tokenize → pack.

PyTorch port of ``repro.data.pipeline`` (unsharded). A ``Pipeline`` is a
thin iterator over ONE ``FilterSession``
(``make_pipeline(build_session(plan), ...)``): each ``LogStream`` batch
takes one ``session.step``, and the pipeline emits fixed-shape LM batches
{"tokens": i32[B, S], "labels": i32[B, S]}. All per-step driving —
capacity resolution, auto retune, overflow warnings, metrics — lives in
``FilterSession.step``. The filter's ``OrderState`` is part of the
pipeline state, so adaptive ranks survive restarts, and a restore
continues bit-identically.

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
from typing import Iterator

import numpy as np

from repro_torch.core.plan import TokenizeSpec
from repro_torch.core.session import (FilterSession, fstate_from_arrays,
                                      fstate_to_arrays)
from repro_torch.data import tokenizer
from repro_torch.data.stream import DriftConfig, LogStream

__all__ = ["Pipeline", "PipelineState", "make_pipeline",
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


def state_to_checkpoint(st: PipelineState) -> tuple[dict, dict]:
    """A ``PipelineState`` as ``save_checkpoint``'s (tree, extra): the
    filter blob's arrays and the token buffer go to the npz, its scalars
    and the blob's other keys to the manifest's ``extra``."""
    fs = st.filter_state
    tree = {"filter": fs["arrays"], "buffer": st.buffer}
    extra = {k: v for k, v in dataclasses.asdict(st).items()
             if k not in ("filter_state", "buffer")}
    extra["filter_meta"] = {k: v for k, v in fs.items() if k != "arrays"}
    return tree, extra


def state_from_checkpoint(tree: dict, extra: dict) -> PipelineState:
    """The inverse of ``state_to_checkpoint`` on what ``load_checkpoint``
    returns."""
    extra = dict(extra)
    meta = extra.pop("filter_meta")
    return PipelineState(filter_state=dict(meta, arrays=tree["filter"]),
                         buffer=tree["buffer"], **extra)


class Pipeline:
    def __init__(self, stream: LogStream, filt,
                 batch_size: int, seq_len: int, vocab_size: int,
                 tokens_per_row: int = 8, device_tokenize: bool = False):
        self.stream = stream
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
        self._fstate = self._session.restore_state(st.filter_state)
        self._buffer = st.buffer.copy()
        self.batches_emitted = st.batches_emitted
        self.rows_in = st.rows_in
        self.rows_pass = st.rows_pass

    # -------------------------------------------------------------- iteration
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
        tokenized here. ``last_metrics`` is the session's JSON encoding.
        """
        self._fstate, res = self._session.step(self._fstate, columns)
        self.last_metrics = res.metrics_dict()
        if self._device_tokenize:
            return res.host_tokens(), res.n_pass
        return tokenizer.rows_to_tokens(
            res.survivors(columns), self.vocab_size,
            self.tokens_per_row), res.n_pass

    def __iter__(self) -> Iterator[dict]:
        for rb in self.stream:
            toks, n_pass = self._filter_step(rb.columns)
            self.rows_in += rb.n_rows
            self.rows_pass += n_pass
            yield from self._emit_tokens(toks)


def make_pipeline(session, *, total_rows: int, batch_rows: int,
                  batch_size: int, seq_len: int, vocab_size: int | None = None,
                  seed: int = 0, drift=None,
                  tokens_per_row: int | None = None) -> Pipeline:
    """One unsharded ``FilterSession`` → its ingestion ``Pipeline``.

    Device tokenization follows the plan's ``tokenize`` spec — there is
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
    stream = LogStream(total_rows=total_rows, batch_rows=batch_rows,
                       seed=seed, drift=drift or DriftConfig())
    return Pipeline(stream, session, batch_size=batch_size, seq_len=seq_len,
                    vocab_size=vocab_size, tokens_per_row=tokens_per_row)
