"""The port's sharded execution layer, in process, against ``repro``.

S = 4 (and 2) shards of R = 4096 rows a step, ``calculate_rate`` 6000 so
epochs fire; the batches are round-robin partitions of one drifting
stream, so the shards see different regimes and PER_SHARD shards diverge.

* ``per_shard`` and ``per_batch`` sharded sessions of the port (``torch``
  and ``cuda`` engines; on the CPU ``cuda`` runs its kernels' twins) equal
  ``repro``'s unsharded session run on each shard's slice: masks, packed
  survivors, ``n_kept``, perms and epochs every step, and every
  ``save_state`` array of every shard (f32 accumulators and ranks to
  rtol 1e-6, the rest bit for bit); ``capacity="auto"`` takes the
  largest of the slices' widths.
* ``reshard_state_arrays`` equals ``repro.core.session``'s on the same
  arrays for 4→2, 2→4, 4→0 and 0→4, from partitioned and replicated
  sources and into both layouts, with heterogeneous shards; an unsharded
  session restores a sharded blob as ``repro``'s does.
* ``FilterPlan(..., shards=S)`` builds exactly where ``repro``'s does, with
  ``repro``'s messages where it does not, and steps on the CPU.
* the sharded ``StepResult``: shard-major survivors and tokens, the
  per-shard ``n_dropped``; a guarded sharded session quarantines with
  per-shard zeros and keeps clean batches equal to an unguarded run.

CENTRALIZED (whose merge needs ``repro`` on a multi-device mesh) and the
sharded pipeline are in ``test_torch_sharded_pipeline.py``.
"""

import functools
import inspect
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.configs import paper_filters as R_paper  # noqa: E402
from repro.core import session as R_session  # noqa: E402
from repro.data.pipeline import fstate_to_arrays as r_arrays  # noqa: E402

import repro_torch.core as T  # noqa: E402
import repro_torch.runtime as T_rt  # noqa: E402
from repro_torch.configs import paper_filters as T_paper  # noqa: E402
from repro_torch.core import plan as T_plan_lib  # noqa: E402
from repro_torch.core import session as T_session  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402
from repro_torch.data import tokenizer as T_tok  # noqa: E402

S, R_ROWS, N_STEPS = 4, 4096, 4
ORDER = dict(collect_rate=16, calculate_rate=6000, momentum=0.3)
DRIFT = T_stream.DriftConfig(kind="regime", period_rows=8192, amplitude=1.5)
CAPACITY = 136          # between the shards' survivor counts: some overflow
#: f32 arrays held to rtol 1e-6 against repro (XLA may contract or reorder
#: their arithmetic); every other array is compared bit for bit
FLOAT_ARRAYS = ("adj_rank", "stats.num_cut", "stats.cost_acc",
                "stats.n_monitored", "stats.group_cut")


def assert_like_repro(got, want, key):
    assert got.dtype == want.dtype and got.shape == want.shape, key
    if key in FLOAT_ARRAYS:
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


def r_plan(engine="jnp", **kw):
    return R.FilterPlan(R_paper.filter_chain("cnf"),
                        R.OrderingConfig(**ORDER), engine=engine, **kw)


def t_plan(engine="torch", **kw):
    return T.FilterPlan(T_paper.filter_chain("cnf"),
                        T.OrderingConfig(**ORDER), engine=engine, **kw)


def t_session(plan):
    return T.build_session(plan, device="cpu")


@functools.lru_cache(maxsize=None)
def sharded_batches(s=S, n=N_STEPS):
    """Step k holds the stream's global batches s·k .. s·k+s-1, shard i's
    as rows [i·R, (i+1)·R) — what ``ShardedPipeline`` assembles."""
    stream = T_stream.LogStream(s * n * R_ROWS, R_ROWS, seed=0, drift=DRIFT)
    cols = [b.columns for b in stream]
    return tuple(np.concatenate(cols[k * s:(k + 1) * s], axis=1)
                 for k in range(n))


def shard(cols, i):
    return np.ascontiguousarray(cols[:, i * R_ROWS:(i + 1) * R_ROWS])


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def run_sharded(plan, batches=None):
    sess = t_session(plan)
    state, steps = sess.init_state(), []
    for cols in batches or sharded_batches():
        state, res = sess.step(state, torch.from_numpy(cols))
        steps.append(dict(mask=res.mask_np, perm=_np(state.perm),
                          epoch=_np(state.epoch),
                          packed=None if res.packed is None
                          else _np(res.packed),
                          n_kept=None if res.n_kept is None
                          else _np(res.n_kept)))
    return sess, state, steps


# ================================================ per_shard / per_batch
@functools.lru_cache(maxsize=None)
def repro_per_slice(scope, compact):
    """repro's unsharded session on each shard's slice, shard by shard."""
    kw = dict(compact=True, capacity=CAPACITY) if compact else {}
    sess = R.build_session(r_plan(scope=scope, **kw))
    out = []
    for i in range(S):
        state, steps = sess.init_state(), []
        for cols in sharded_batches():
            state, res = sess.step(state, shard(cols, i))
            steps.append(dict(mask=res.mask_np,
                              perm=np.asarray(state.perm),
                              epoch=np.asarray(state.epoch),
                              packed=None if res.packed is None
                              else np.asarray(res.packed),
                              n_kept=None if res.n_kept is None
                              else np.asarray(res.n_kept)))
        out.append((steps, r_arrays(state)))
    return out


@pytest.mark.parametrize("compact", [False, True], ids=["mask", "compact"])
@pytest.mark.parametrize("scope", ["per_shard", "per_batch"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_sharded_scopes_equal_repro_on_each_slice(engine, scope, compact):
    kw = dict(compact=True, capacity=CAPACITY) if compact else {}
    sess, state, steps = run_sharded(
        t_plan(engine, scope=scope, shards=S, **kw))
    arrays = sess.save_state(state)["arrays"]
    want = repro_per_slice(scope, compact)
    r = R_ROWS
    for i, (r_steps, r_final) in enumerate(want):
        for k, (g, w) in enumerate(zip(steps, r_steps)):
            np.testing.assert_array_equal(g["mask"][i * r:(i + 1) * r],
                                          w["mask"], err_msg=f"{i}/{k}")
            np.testing.assert_array_equal(g["perm"][i], w["perm"])
            assert g["epoch"][i] == w["epoch"]
            if compact:
                assert g["n_kept"][i] == w["n_kept"]
                np.testing.assert_array_equal(g["packed"][i], w["packed"])
        for key, v in r_final.items():
            assert_like_repro(arrays[key][i], v, key)
    if scope == "per_shard":
        # the shards adapted to their own slices: not one perm for all
        assert len({tuple(p) for p in _np(state.perm)}) > 1


#: the shards' slices reordered so that the widest is neither the first
#: nor the last shard
AUTO_ORDER = (2, 0, 1, 3)


@functools.lru_cache(maxsize=None)
def repro_auto_widths():
    """repro's ``capacity="auto"`` width at each step, per slice; a fresh
    session per slice, since a filter keeps its auto width."""
    caps = []
    for i in AUTO_ORDER:
        r_sess = R.build_session(r_plan(compact=True, capacity="auto"))
        state, row = r_sess.init_state(), []
        for cols in sharded_batches():
            state, res = r_sess.step(state, shard(cols, i))
            row.append(res.capacity)
        caps.append(row)
    return caps


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_auto_capacity_is_the_largest_over_the_shards(engine):
    """``capacity="auto"`` sizes one per-shard width from the largest pass
    rate over the shards: under per_shard, each step's width is the
    largest of repro's unsharded sessions' widths on the slices."""
    caps = repro_auto_widths()
    sess = t_session(t_plan(engine, shards=S, compact=True, capacity="auto"))
    state, got = sess.init_state(), []
    for cols in sharded_batches():
        state, res = sess.step(state, torch.from_numpy(np.concatenate(
            [shard(cols, i) for i in AUTO_ORDER], axis=1)))
        got.append(res.capacity)
    assert got == [max(c) for c in zip(*caps)]
    last = [c[-1] for c in caps]
    assert max(last) not in (last[0], last[-1])   # the shards differ


# ============================================================ reshard
@functools.lru_cache(maxsize=None)
def source_arrays(kind):
    """Checkpointed state arrays: per_shard (partitioned, shards disagree)
    on 4 and 2 shards, eager centralized (replicated) on 4 and 2, and an
    unsharded state."""
    if kind == "unsharded":
        sess = t_session(t_plan())
        state = sess.init_state()
        for cols in sharded_batches():
            state, _ = sess.step(state, torch.from_numpy(shard(cols, 1)))
        return sess.save_state(state)["arrays"]
    scope, s = {"per_shard4": ("per_shard", 4), "per_shard2": ("per_shard", 2),
                "central4": ("centralized", 4),
                "central2": ("centralized", 2)}[kind]
    # two shards: the slices of shards 0 and 2, which see other regimes
    batches = sharded_batches() if s == S else tuple(
        np.concatenate([shard(c, 0), shard(c, 2)], axis=1)
        for c in sharded_batches())
    sess, state, _ = run_sharded(t_plan(scope=scope, shards=s), batches)
    blob = sess.save_state(state)
    assert blob["shards"] == s
    assert blob["stats_layout"] == ("replicated" if scope == "centralized"
                                    else "partitioned")
    return blob["arrays"]


RESHARD_CASES = [
    # (source, new_shards, src_replicated, tgt_replicated)
    ("per_shard4", 2, False, False),
    ("per_shard2", 4, False, False),
    ("per_shard4", 0, False, False),
    ("unsharded", 4, False, False),
    ("unsharded", 4, False, True),
    ("central4", 2, True, False),
    ("central2", 4, True, True),
    ("central4", 0, True, False),
    ("per_shard4", 4, False, True),
]


@pytest.mark.parametrize("case", RESHARD_CASES,
                         ids=lambda c: f"{c[0]}-to-{c[1]}-"
                         f"{'rep' if c[2] else 'part'}-"
                         f"{'rep' if c[3] else 'part'}")
def test_reshard_state_arrays_equals_repro(case):
    kind, new, src_rep, tgt_rep = case
    arrays = source_arrays(kind)
    groups = T.pack(T_paper.filter_chain("cnf")).groups
    got = T_session.reshard_state_arrays(
        dict(arrays), new, groups=groups, src_replicated=src_rep,
        tgt_replicated=tgt_rep)
    want = R_session.reshard_state_arrays(
        dict(arrays), new, groups=groups, src_replicated=src_rep,
        tgt_replicated=tgt_rep)
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    if kind.startswith("per_shard"):
        # heterogeneous shards: the consensus order is re-derived
        assert not all((arrays[k] == arrays[k][0]).all()
                       for k in ("perm", "adj_rank"))


@pytest.mark.parametrize("kind", ["per_shard4", "central4"])
def test_unsharded_session_restores_a_sharded_blob_as_repro(kind):
    """4 → 0 through the sessions (and the envelope's layout tag)."""
    scope = "per_shard" if kind.startswith("per") else "centralized"
    t_sess = t_session(t_plan(scope=scope))
    blob = t_session(t_plan(scope=scope, shards=S)).save_state(
        T_session.fstate_from_arrays(source_arrays(kind)))
    assert blob["stats_layout"] == ("partitioned" if scope == "per_shard"
                                    else "replicated")
    got = T_session.fstate_to_arrays(t_sess.restore_state(blob))
    want = r_arrays(R.build_session(r_plan(scope=scope)).restore_state(blob))
    for k, v in want.items():
        assert_like_repro(got[k], v, k)
    # and the 4-shard session takes the unsharded state back (0 → 4)
    back = t_session(t_plan(scope=scope, shards=S)).restore_state(
        t_sess.save_state(t_sess.restore_state(blob)))
    assert tuple(back.perm.shape) == (S, 4)


# ======================================================= plan combinations
SCOPES = ("per_shard", "per_batch", "centralized")
ENGINES = (("jnp", "torch"), ("pallas", "cuda"))


@pytest.mark.parametrize("scope,exchange", list(itertools.product(
    SCOPES, ("eager", "deferred", "deferred-async"))))
def test_sharded_plans_build_exactly_where_repro_does(scope, exchange):
    built = 0
    for (r_eng, t_eng), compact, tier, shards in itertools.product(
            ENGINES, (False, True), ("off", "zonemap"), (2, 4)):
        kw = dict(scope=scope, exchange=exchange, shards=shards,
                  compact=compact, skip_tier=tier)
        try:
            r_plan(r_eng, **kw)
            r_err = None
        except ValueError as e:
            r_err = str(e)
        try:
            plan = t_plan(t_eng, **kw)
            t_err = None
        except ValueError as e:
            t_err = str(e)
        assert t_err == r_err, kw
        if t_err is None:
            sess = t_session(plan)
            assert sess.sharded and sess.num_shards == shards
            _, res = sess.step(sess.init_state(), torch.from_numpy(
                sharded_batches()[0][:, :shards * R_ROWS]))
            assert res.mask.shape == (shards * R_ROWS,)
            built += 1
    assert (built > 0) == (scope == "centralized" or exchange == "eager")


def test_reject_unported_no_longer_mentions_sharding():
    """The plan refuses no combination as unported: ``_reject_unported``
    went with the last of them (the ``numpy`` engine and measured costs)."""
    assert not hasattr(T_plan_lib, "_reject_unported")
    assert "NotImplementedError" not in inspect.getsource(T_plan_lib)
    t_plan(shards=4)                            # no NotImplementedError


@pytest.mark.parametrize("exchange", ["deferred", "deferred-async"])
def test_filter_level_exchange_equals_the_session(exchange):
    """``ShardedAdaptiveFilter.sharded_step`` + ``maybe_exchange`` (which
    reads the row counter on the device) give the session's states, whose
    boundary comes from its host mirror."""
    plan = t_plan(scope="centralized", exchange=exchange, shards=S)
    sess = t_session(plan)
    f = t_session(plan).filter
    a, b = sess.init_state(), f.init_state()
    fired = 0
    for cols in sharded_batches():
        cols = torch.from_numpy(cols)
        a, _ = sess.step(a, cols)
        b, _, _ = f.sharded_step(b, cols)
        fired += f.exchange_due(b)
        b = f.maybe_exchange(b)
        assert not f.exchange_due(b)
        for k, v in T_session.fstate_to_arrays(a).items():
            np.testing.assert_array_equal(
                T_session.fstate_to_arrays(b)[k], v, err_msg=k)
    assert fired >= 2


def test_sharded_filter_takes_the_unsharded_step_signatures():
    """``step`` / ``_step_compact`` keep ``AdaptiveFilter``'s keywords
    (``sharded_step*`` are the same functions); a fixed capacity resolves
    per shard when none is passed; ``skip`` is refused (``shards == 1``)."""
    plan = t_plan(shards=S, compact=True, capacity=CAPACITY)
    f = t_session(plan).filter
    one = t_session(t_plan(compact=True, capacity=CAPACITY)).filter
    assert f.sharded_step == f.step
    assert f.sharded_step_compact == f._step_compact
    for name in ("step", "_step_compact"):
        assert (inspect.signature(getattr(f, name)).parameters.keys()
                == inspect.signature(getattr(one, name)).parameters.keys())
    assert f.specs is f.inner.specs
    assert f.rows_after(5000, R_ROWS) == one.rows_after(5000, R_ROWS)
    cols = torch.from_numpy(sharded_batches()[0])
    st = f.init_state()
    _, packed, n_kept, mask, _ = f._step_compact(st, cols)
    _, packed2, n_kept2, mask2, _ = f._step_compact(st, cols,
                                                    capacity=CAPACITY)
    assert packed.shape == (S, 3, CAPACITY)
    assert torch.equal(packed, packed2) and torch.equal(n_kept, n_kept2)
    assert torch.equal(mask, mask2)
    for name in ("step", "_step_compact"):
        with pytest.raises(ValueError, match="shards == 1"):
            getattr(f, name)(st, cols, skip=object())


def test_a_batch_that_does_not_split_raises():
    sess = t_session(t_plan(shards=S))
    with pytest.raises(ValueError, match="do not split"):
        sess.step(sess.init_state(), torch.zeros((3, 4 * R_ROWS + 2)))


# ======================================================== the result ABI
def test_sharded_step_result_is_shard_major():
    plan = t_plan(shards=S, compact=True, capacity=CAPACITY,
                  tokenize=T.TokenizeSpec(1000, 8))
    sess = t_session(plan)
    cols = sharded_batches()[1]
    _, res = sess.step(sess.init_state(), torch.from_numpy(cols))
    mask = res.mask_np
    assert res.packed.shape == (S, 3, CAPACITY) and res.n_kept.shape == (S,)
    assert res.tokens.shape == (S, CAPACITY * 8)
    kept = [cols[:, i * R_ROWS:(i + 1) * R_ROWS][
        :, mask[i * R_ROWS:(i + 1) * R_ROWS]][:, :CAPACITY]
        for i in range(S)]
    want = np.concatenate(kept, axis=1)
    np.testing.assert_array_equal(res.survivors(), want)
    np.testing.assert_array_equal(res.host_tokens(),
                                  T_tok.rows_to_tokens(want, 1000, 8))
    m = res.metrics_dict()
    per = [int(mask[i * R_ROWS:(i + 1) * R_ROWS].sum()) - k.shape[1]
           for i, k in enumerate(kept)]
    assert m["n_dropped_per_shard"] == per and m["n_dropped"] == sum(per)
    assert sum(per) > 0 and res.n_pass == want.shape[1]
    assert len(m["perm"]) == S and m["n_pass"] == int(mask.sum())


# ============================================================ the guard
def test_guarded_sharded_soak():
    """per_shard, a bounded capacity, one poisoned batch, one storm, one
    killed step: the poisoned batch is quarantined with per-shard zeros,
    the storm is kept whole, clean batches equal an unguarded run."""
    plan = t_plan(shards=S, compact=True, capacity=CAPACITY,
                  tokenize=T.TokenizeSpec(1000, 1))
    batches = sharded_batches()
    _, _, base = run_sharded(plan)
    host = list(batches)
    survivor = int(np.nonzero(base[0]["mask"])[0][0])
    inj = T_rt.DataFaultInjector(poison_at={1}, storm_at={2},
                                 storm_row=host[0][:, survivor])
    kill = T_rt.FailureInjector({3})
    guard = T_rt.GuardedSession(
        t_session(plan), T_rt.GuardPolicy(validate_every=1,
                                           checkpoint_every=2,
                                           sleep=lambda s: None),
        step_injector=kill.maybe_fail)
    stream = T_stream.RequestStream(lambda b, start, rows: host[b],
                                    total_rows=len(host) * S * R_ROWS,
                                    batch_rows=S * R_ROWS)
    state, results = guard.run_log_stream(stream, batch_hook=inj)
    q = results[1]
    assert q.quarantined and q.n_pass == 0 and not q.mask_np.any()
    assert _np(q.n_kept).tolist() == [0] * S
    assert _np(q.n_tokens).tolist() == [0] * S
    assert q.host_tokens().size == 0 and q.survivors().shape == (3, 0)
    assert q.metrics_dict()["n_dropped_per_shard"] == [0] * S
    assert results[2].n_pass == S * R_ROWS
    for b in (0, 3):
        np.testing.assert_array_equal(results[b].mask_np, base[b]["mask"])
    h = guard.health
    assert (h.quarantined, h.overflow_events, h.retries) == (1, 1, 1)
    assert [e["changes"] for e in h.degrades] == [{"capacity": "None"}]
    assert guard.session.sharded and guard.session.num_shards == S
    assert guard.session.validate_state(state)
    assert not guard.session.validate_state(
        T_rt.corrupt_state(state, "bad_perm"))
