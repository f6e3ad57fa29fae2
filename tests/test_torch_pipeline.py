"""The single-pass ingestion path through both packages.

``repro``'s sessions run on the ``jnp`` engine (its Pallas kernels do not
run on this JAX), the port's on both of its engines with ``device="cpu"``,
over the same ``LogStream``:

* every step's ``tokens`` (whole tensor, zero tail included), ``n_tokens``
  and survivors equal ``repro``'s, for capacity None / 512 / 8 (overflow)
  / "auto" and skip tier "off" / "zonemap" on a clustered stream;
* the port's ``Pipeline`` emits ``repro``'s LM batches, with device
  tokenize and without (``repro``'s host-tokenize batches equal its own
  device path by ``tests/test_single_pass_ingest.py``, so its tokenizer is
  compiled here only at ``tokens_per_row=2``);
* a mid-stream restart, directly and through the port's checkpoints, is
  bit-identical, and ``PipelineState`` filter blobs move between the
  packages both ways;
* ``make_pipeline``'s defaults and the reference's error messages.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.configs import paper_filters as R_paper  # noqa: E402
from repro.data import pipeline as R_pipe  # noqa: E402
from repro.data import stream as R_stream  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402,E501
from repro_torch.configs import paper_filters as T_paper  # noqa: E402
from repro_torch.data import pipeline as T_pipe  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402

BATCH = 16_384
N_BATCHES = 4
ORDER = dict(collect_rate=16, calculate_rate=BATCH, momentum=0.3)
DRIFT = dict(kind="regime", period_rows=8192, amplitude=1.5)
VOCAB = 1000
# the pipelines' stream: 8 batches, ~20 LM batches of 256 tokens a step
PIPE_ROWS = dict(total_rows=8 * 8192, batch_rows=8192)
LM = dict(batch_size=2, seq_len=127)
STEP_CASES = {          # label → (plan fields, stream layout)
    "cap_none": (dict(capacity=None), "iid"),
    "cap_512": (dict(capacity=512), "iid"),
    "cap_8": (dict(capacity=8), "iid"),
    "cap_auto": (dict(capacity="auto"), "iid"),
    "zonemap": (dict(capacity=None, skip_tier="zonemap"), "clustered"),
}


def r_plan(**kw):
    return R.FilterPlan(R_paper.filter_chain("cnf"),
                        R.OrderingConfig(**ORDER), engine="jnp", **kw)


def t_plan(engine="torch", **kw):
    return T.FilterPlan(T_paper.filter_chain("cnf"),
                        T.OrderingConfig(**ORDER), engine=engine, **kw)


def batches(layout="iid"):
    return [b.columns for b in T_stream.LogStream(
        N_BATCHES * BATCH, BATCH, seed=0,
        drift=T_stream.DriftConfig(**DRIFT), layout=layout)]


def run_steps(session, cols_list):
    state, out = session.init_state(), []
    for cols in cols_list:
        state, res = session.step(state, cols)
        out.append(dict(tokens=np.asarray(res.tokens),
                        n_tokens=int(np.asarray(res.n_tokens)),
                        host_tokens=res.host_tokens(),
                        survivors=res.survivors(), n_pass=res.n_pass))
    return out


@functools.lru_cache(maxsize=None)
def repro_steps(label):
    kw, layout = STEP_CASES[label]
    plan = r_plan(compact=True, tokenize=R.TokenizeSpec(VOCAB, 2), **kw)
    return run_steps(R.build_session(plan), batches(layout))


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("label", list(STEP_CASES))
def test_step_tokens_match_repro(label, engine):
    kw, layout = STEP_CASES[label]
    plan = t_plan(engine, compact=True, tokenize=T.TokenizeSpec(VOCAB, 2),
                  **kw)
    got = run_steps(T.build_session(plan, device="cpu"), batches(layout))
    want = repro_steps(label)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["tokens"].dtype == np.int32, i
        np.testing.assert_array_equal(g["tokens"], w["tokens"], err_msg=i)
        assert g["n_tokens"] == w["n_tokens"] == 2 * g["n_pass"], i
        np.testing.assert_array_equal(g["host_tokens"], w["host_tokens"])
        np.testing.assert_array_equal(g["survivors"], w["survivors"])
    if label == "cap_8":
        assert all(g["n_pass"] == 8 for g in got)


# ================================================================ pipelines
def r_pipeline(*, capacity=None, tokenize=None, seed=0):
    plan = r_plan(compact=True, capacity=capacity, tokenize=tokenize)
    return R_pipe.make_pipeline(
        R.build_session(plan), vocab_size=VOCAB, seed=seed,
        drift=R_stream.DriftConfig(**DRIFT), **PIPE_ROWS, **LM)


def t_pipeline(*, capacity=None, device_tokenize=True, engine="torch",
               seed=0):
    spec = T.TokenizeSpec(VOCAB, 8) if device_tokenize else None
    plan = t_plan(engine, compact=True, capacity=capacity, tokenize=spec)
    return T_pipe.make_pipeline(
        T.build_session(plan, device="cpu"), vocab_size=VOCAB, seed=seed,
        drift=T_stream.DriftConfig(**DRIFT), **PIPE_ROWS, **LM)


def take(pipe, n):
    out = [b for _, b in zip(range(n), iter(pipe))]
    assert len(out) == n
    return out


def assert_same_batches(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("tokens", "labels"):
            assert g[k].dtype == np.int32 and g[k].shape == (2, 127)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{k} {i}")


@functools.lru_cache(maxsize=None)
def repro_batches(capacity, n):
    return take(r_pipeline(capacity=capacity), n)


@pytest.mark.parametrize("device_tokenize", [True, False])
@pytest.mark.parametrize("capacity", [None, 8])
def test_pipeline_batches_match_repro_host_path(capacity, device_tokenize):
    """Capacity 8 drops survivors every step: the port's survivors slice
    and tokens hold to repro's there too."""
    n = 2 if capacity == 8 else 60
    pipe = t_pipeline(capacity=capacity, device_tokenize=device_tokenize)
    assert pipe._device_tokenize is device_tokenize
    assert_same_batches(take(pipe, n), repro_batches(capacity, n))
    assert pipe.rows_pass > 0 and pipe.rows_in % 8192 == 0


def _roundtrip(st, tmp_path):
    """A PipelineState through the port's checkpoint."""
    tree, extra = T_pipe.state_to_checkpoint(st)
    save_checkpoint(tmp_path, 3, tree, extra=extra)
    tree, extra, step = load_checkpoint(tmp_path, tree)
    assert step == 3
    return T_pipe.state_from_checkpoint(tree, extra)


@pytest.mark.parametrize("via", ["state", "checkpoint"])
@pytest.mark.parametrize("device_tokenize", [True, False])
def test_restart_is_bit_identical(device_tokenize, via, tmp_path):
    pipe = t_pipeline(capacity="auto", device_tokenize=device_tokenize)
    it = iter(pipe)
    for _ in range(3):
        next(it)
    st = pipe.state()
    want = [next(it) for _ in range(50)]       # crosses into later steps
    if via == "checkpoint":
        st = _roundtrip(st, tmp_path)
    fresh = t_pipeline(capacity="auto", device_tokenize=device_tokenize)
    fresh.restore(st)
    assert_same_batches(take(fresh, 50), want)
    assert fresh.rows_in == pipe.rows_in
    assert fresh.batches_emitted == pipe.batches_emitted


@pytest.mark.parametrize("direction", ["repro_to_port", "port_to_repro"])
def test_filter_state_blobs_cross_packages(direction):
    src, dst = ((r_pipeline(), t_pipeline(device_tokenize=False))
                if direction == "repro_to_port"
                else (t_pipeline(device_tokenize=False), r_pipeline()))
    it = iter(src)
    for _ in range(40):
        next(it)
    st = src.state()
    cls = type(dst.state())
    dst.restore(cls(**dataclasses.asdict(st)))
    assert_same_batches(take(dst, 30), [next(it) for _ in range(30)])


# ======================================================= surface and errors
def test_make_pipeline_defaults_from_the_spec():
    plan = t_plan(compact=True, tokenize=T.TokenizeSpec(VOCAB, 2))
    pipe = T_pipe.make_pipeline(T.build_session(plan, device="cpu"),
                                total_rows=BATCH, batch_rows=BATCH, **LM)
    assert (pipe.vocab_size, pipe.tokens_per_row) == (VOCAB, 2)
    assert pipe._device_tokenize
    host = T_pipe.make_pipeline(T.build_session(t_plan(), device="cpu"),
                                total_rows=BATCH, batch_rows=BATCH,
                                vocab_size=VOCAB, **LM)
    assert (host.tokens_per_row, host._device_tokenize) == (8, False)


def _same_error(make_r, make_t, exc=ValueError):
    with pytest.raises(exc) as want:
        make_r()
    with pytest.raises(exc) as got:
        make_t()
    assert str(got.value) == str(want.value)


def test_make_pipeline_needs_a_vocab_without_a_spec():
    kw = dict(total_rows=BATCH, batch_rows=BATCH, **LM)
    _same_error(
        lambda: R_pipe.make_pipeline(R.build_session(r_plan()), **kw),
        lambda: T_pipe.make_pipeline(
            T.build_session(t_plan(), device="cpu"), **kw))


def test_tokenize_without_compaction_raises_as_repro():
    _same_error(
        lambda: R_pipe.Pipeline(
            R_stream.LogStream(BATCH, BATCH), R.build_session(r_plan()),
            vocab_size=VOCAB, device_tokenize=True, **LM),
        lambda: T_pipe.Pipeline(
            T_stream.LogStream(BATCH, BATCH),
            T.build_session(t_plan(), device="cpu"),
            vocab_size=VOCAB, device_tokenize=True, **LM))


def test_mismatched_tokenize_params_raise_as_repro():
    r_sess = R.build_session(r_plan(compact=True,
                                    tokenize=R.TokenizeSpec(VOCAB, 8)))
    t_sess = T.build_session(t_plan(compact=True,
                                    tokenize=T.TokenizeSpec(VOCAB, 8)),
                             device="cpu")
    _same_error(
        lambda: R_pipe.Pipeline(R_stream.LogStream(BATCH, BATCH), r_sess,
                                vocab_size=VOCAB + 1, **LM),
        lambda: T_pipe.Pipeline(T_stream.LogStream(BATCH, BATCH), t_sess,
                                vocab_size=VOCAB + 1, **LM))


def test_pipeline_takes_only_a_session():
    with pytest.raises(TypeError, match="FilterSession"):
        T_pipe.Pipeline(T_stream.LogStream(BATCH, BATCH), object(),
                        vocab_size=VOCAB, **LM)


def test_with_tokenize_keeps_the_filter_and_state_mirror():
    sess = T.build_session(t_plan(compact=True), device="cpu")
    state, _ = sess.step(sess.init_state(), batches()[0])
    tok = sess.with_tokenize(T.TokenizeSpec(VOCAB, 2))
    assert tok.filter is sess.filter and sess.plan.tokenize is None
    assert tok._rows_ref is state.rows_into_epoch
    _, res = tok.step(state, batches()[1])
    assert res.tokens is not None and not tok._foreign
    with pytest.raises(ValueError, match="no tokenize stage"):
        sess.step(state, batches()[1])[1].host_tokens()


def test_with_tokenize_gets_its_own_skip_tuner():
    """The two sessions share the filter, never the skip-tier tuner: each
    times its own steps."""
    sess = T.build_session(t_plan(compact=True, skip_tier="auto"),
                           device="cpu")
    cols = batches("clustered")
    state, _ = sess.step(sess.init_state(), cols[0])
    assert sess._skip_tuner is not None
    tok = sess.with_tokenize(T.TokenizeSpec(VOCAB, 2))
    assert tok.filter is sess.filter and tok._skip_tuner is None
    _, res = tok.step(state, cols[1])
    assert res.tokens is not None
    assert tok._skip_tuner is not None
    assert tok._skip_tuner is not sess._skip_tuner
