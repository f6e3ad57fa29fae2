"""CENTRALIZED sharding and the sharded ingestion pipeline, against repro.

``repro`` merges CENTRALIZED statistics with a ``psum`` over a device
mesh, so its side runs once, in ONE module-scoped subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the main pytest
process keeps seeing one device). It writes every reference trajectory
to one ``.npz``; the port's runs (``torch`` and ``cuda`` engines, the
latter on its kernels' twins here) are held to it:

* CENTRALIZED x ``eager`` / ``deferred`` / ``deferred-async`` on 4 shards
  of 4096 rows with ``compact=True, capacity="auto"``: every step's mask,
  perm, epoch, capacity, ``n_kept`` and packed buffer bit for bit, the
  final ``save_state`` arrays (f32 accumulators and ranks to rtol 1e-6,
  the rest bit for bit) and the accumulator layout tag;
* the trainer's sharded input stage — ``make_pipeline`` over 4 shard
  streams, CENTRALIZED, deferred, ``capacity="auto"``,
  ``TokenizeSpec(1000, 2)`` — gives ``repro``'s LM batches; its state after
  2 steps restores 4→4 (the rest of the stream bit-identical), 4→2 and,
  from the 2-shard pipeline's state after one step, 2→4, each with
  ``repro``'s restored arrays, stream cursors and following LM batches.

``repro``'s tokenizer is compiled only at ``tokens_per_row=2``
(ROADMAP.md §3: it takes minutes at 8 on XLA:CPU), and its shard_maps
run without JAX 0.9's varying-axis check, which its eager sharded step
fails (ROADMAP.md §3).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.configs import paper_filters as T_paper  # noqa: E402
from repro_torch.data import pipeline as T_pipe  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
S, R_ROWS, N_STEPS = 4, 4096, 4
ORDER = dict(collect_rate=16, calculate_rate=6000, momentum=0.3)
DRIFT = dict(kind="regime", period_rows=8192, amplitude=1.5)
VOCAB, TPR = 1000, 2
LM = dict(batch_size=2, seq_len=127)
EXCHANGES = ("eager", "deferred", "deferred-async")
FLOAT_ARRAYS = ("adj_rank", "stats.num_cut", "stats.cost_acc",
                "stats.n_monitored", "stats.group_cut")

#: the reference side: repro on a forced 4-device CPU mesh
REF_SCRIPT = f"""
import sys
import numpy as np
import jax
assert jax.device_count() == 4, jax.devices()
# repro's eager sharded step fails JAX 0.9's varying-axis check under
# shard_map (a lax.cond in ordering.advance); its shard_maps run here
# unchecked, as repro.compat's old-API branch runs them (ROADMAP.md §3)
import repro.compat as compat
_checked = compat.shard_map


def _unchecked(f, *, mesh, in_specs, out_specs, check_vma=None):
    return _checked(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                    check_vma=False if check_vma is None else check_vma)


compat.shard_map = _unchecked
import repro.core as R
from repro.configs import paper_filters as P
from repro.data import stream as St
from repro.data.pipeline import make_pipeline

S, R_ROWS, N = {S}, {R_ROWS}, {N_STEPS}
ORDER = R.OrderingConfig(**{ORDER!r})
DRIFT = St.DriftConfig(**{DRIFT!r})
LM = {LM!r}
out = {{}}


def plan(**kw):
    return R.FilterPlan(P.filter_chain("cnf"), ORDER, engine="jnp",
                        scope="centralized", compact=True, capacity="auto",
                        **kw)


cols = [St.gen_batch(0, b, b * R_ROWS, R_ROWS, DRIFT) for b in range(S * N)]
batches = [np.concatenate(cols[k * S:(k + 1) * S], axis=1) for k in range(N)]
for ex in {EXCHANGES!r}:
    sess = R.build_session(plan(exchange=ex, shards=S))
    st = sess.init_state()
    for k, b in enumerate(batches):
        st, res = sess.step(st, b)
        for name, v in (("mask", res.mask_np), ("perm", st.perm),
                        ("epoch", st.epoch), ("packed", res.packed),
                        ("n_kept", res.n_kept), ("capacity", res.capacity)):
            out[f"{{ex}}|{{k}}|{{name}}"] = np.asarray(v)
    blob = sess.save_state(st)
    out[f"{{ex}}|layout"] = np.asarray(blob["stats_layout"])
    for key, v in blob["arrays"].items():
        out[f"{{ex}}|final|{{key}}"] = np.asarray(v)


def pipeline(shards):
    sess = R.build_session(plan(exchange="deferred", shards=shards,
                                tokenize=R.TokenizeSpec({VOCAB}, {TPR})))
    return make_pipeline(sess, total_rows=S * N * R_ROWS, batch_rows=R_ROWS,
                         seed=0, drift=DRIFT, **LM)


def keep(prefix, batches):
    out[prefix + "|tokens"] = np.stack([b["tokens"] for b in batches])
    out[prefix + "|labels"] = np.stack([b["labels"] for b in batches])


def keep_state(prefix, pipe, st):
    arrays = pipe._session.save_state(pipe._fstate)["arrays"]
    for key, v in arrays.items():
        out[f"{{prefix}}|arrays|{{key}}"] = np.asarray(v)
    out[prefix + "|cursors"] = np.asarray([s.cursor for s in pipe.streams])


pipe, lm, st = pipeline(S), [], None
for b in pipe:
    lm.append(b)
    if st is None and pipe.streams[-1].cursor == 2 * S:
        st, at = pipe.state(), len(lm)
keep("pipe", lm)
out["pipe|at"] = np.asarray(at)
for label, shards in (("to4", S), ("to2", 2)):
    p = pipeline(shards)
    p.restore(st)
    keep_state(label, p, st)
    rest, st2 = [], None
    for b in p:
        rest.append(b)
        if st2 is None and p.streams[-1].cursor == 2 * S + shards:
            st2 = p.state()
    keep(label, rest)
    if shards == 2:
        back = pipeline(S)
        back.restore(st2)
        keep_state("2to4", back, st2)
        keep("2to4", list(back))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference trajectory, from one repro subprocess."""
    path = tmp_path_factory.mktemp("sharded_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    print(f"repro reference subprocess: {time.perf_counter() - t0:.1f} s")
    with np.load(path) as z:
        return dict(z)


def t_plan(engine, **kw):
    return T.FilterPlan(T_paper.filter_chain("cnf"),
                        T.OrderingConfig(**ORDER), engine=engine,
                        scope="centralized", compact=True, capacity="auto",
                        **kw)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_like_repro(got, want, key):
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, key
    if key.split("|")[-1] in FLOAT_ARRAYS:
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


def batches():
    stream = T_stream.LogStream(S * N_STEPS * R_ROWS, R_ROWS, seed=0,
                                drift=T_stream.DriftConfig(**DRIFT))
    cols = [b.columns for b in stream]
    return [np.concatenate(cols[k * S:(k + 1) * S], axis=1)
            for k in range(N_STEPS)]


# ================================================== CENTRALIZED x exchange
@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_centralized_exchange_modes_match_repro(ref, engine, exchange):
    sess = T.build_session(t_plan(engine, exchange=exchange, shards=S),
                           device="cpu")
    st = sess.init_state()
    for k, cols in enumerate(batches()):
        st, res = sess.step(st, torch.from_numpy(cols))
        for name, v in (("mask", res.mask), ("perm", st.perm),
                        ("epoch", st.epoch), ("packed", res.packed),
                        ("n_kept", res.n_kept)):
            assert_like_repro(_np(v), ref[f"{exchange}|{k}|{name}"],
                              f"{exchange}|{k}|{name}")
        assert res.capacity == int(ref[f"{exchange}|{k}|capacity"])
        # one global order: every shard holds the same perm
        assert (_np(st.perm) == _np(st.perm)[0]).all()
    assert int(_np(st.epoch).min()) >= 2
    blob = sess.save_state(st)
    assert blob["stats_layout"] == str(ref[f"{exchange}|layout"])
    for key, v in blob["arrays"].items():
        assert_like_repro(v, ref[f"{exchange}|final|{key}"], key)


# ======================================================= sharded pipeline
def t_pipeline(engine, shards):
    sess = T.build_session(t_plan(engine, exchange="deferred", shards=shards,
                                  tokenize=T.TokenizeSpec(VOCAB, TPR)),
                           device="cpu")
    return T_pipe.make_pipeline(
        sess, total_rows=S * N_STEPS * R_ROWS, batch_rows=R_ROWS, seed=0,
        drift=T_stream.DriftConfig(**DRIFT), **LM)


def assert_batches(got, ref, prefix):
    assert len(got) == len(ref[prefix + "|tokens"]), prefix
    for k in ("tokens", "labels"):
        want = ref[f"{prefix}|{k}"]
        np.testing.assert_array_equal(np.stack([b[k] for b in got]), want,
                                      err_msg=prefix)
        assert want.dtype == np.int32


def assert_state(pipe, ref, prefix):
    arrays = pipe._session.save_state(pipe._fstate)["arrays"]
    for key, v in arrays.items():
        assert_like_repro(v, ref[f"{prefix}|arrays|{key}"], key)
    np.testing.assert_array_equal([s.cursor for s in pipe.streams],
                                  ref[prefix + "|cursors"])


def run_pipeline(engine):
    pipe, lm, st, at = t_pipeline(engine, S), [], None, 0
    assert isinstance(pipe, T_pipe.ShardedPipeline) and pipe._device_tokenize
    for b in pipe:
        lm.append(b)
        if st is None and pipe.streams[-1].cursor == 2 * S:
            st, at = pipe.state(), len(lm)
    return lm, st, at


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_sharded_pipeline_matches_repro(ref, engine):
    lm, st, at = run_pipeline(engine)
    assert_batches(lm, ref, "pipe")
    assert at == int(ref["pipe|at"])
    assert isinstance(st, T_pipe.ShardedPipelineState)
    assert st.filter_state["shards"] == S


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_sharded_pipeline_restores_4_to_4_and_4_to_2(ref, engine, tmp_path):
    """From the state after 2 steps, through the port's checkpoints:
    4→4 continues bit-identically; 4→2 reshards as repro does."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    lm, st, at = run_pipeline(engine)
    tree, extra = T_pipe.state_to_checkpoint(st)
    save_checkpoint(tmp_path, 2, tree, extra=extra)
    tree, extra, _ = load_checkpoint(tmp_path, tree)
    st = T_pipe.state_from_checkpoint(tree, extra)
    assert isinstance(st, T_pipe.ShardedPipelineState)
    for label, shards in (("to4", S), ("to2", 2)):
        p = t_pipeline(engine, shards)
        p.restore(st)
        assert_state(p, ref, label)
        rest = list(p)
        assert_batches(rest, ref, label)
        if shards == S:
            assert_batches(lm[at:], ref, label)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_sharded_pipeline_restores_2_to_4(ref, engine):
    _, st, _ = run_pipeline(engine)
    two = t_pipeline(engine, 2)
    two.restore(st)
    st2 = None
    for _ in two:
        if st2 is None and two.streams[-1].cursor == 2 * S + 2:
            st2 = two.state()
            break
    back = t_pipeline(engine, S)
    back.restore(st2)
    assert_state(back, ref, "2to4")
    assert_batches(list(back), ref, "2to4")
