"""The unsharded FilterSession main path through both packages.

A 10-batch drifting ``LogStream`` (made by each package's own copy of the
generator, checked byte-equal) goes through ``repro``'s session on the
``jnp`` engine and through ``repro_torch``'s on both of its engines, with
compaction off, at a fixed (saturating) capacity and at ``"auto"``.
``StepResult`` masks, packed buffers, ``n_kept``, metrics, the perm
trajectory and the final ``save_state`` arrays agree exactly; ``adj_rank``
and the cuda engine's work sum to rtol 1e-6 (summation order). Plus the
plan surface (fingerprint, validation messages, the host-engine and
measured-cost combinations) and checkpoints across the packages.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.core.session as R_session  # noqa: E402
from repro.configs import paper_filters as R_paper  # noqa: E402
from repro.data import stream as R_stream  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.configs import paper_filters as T_paper  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402

BATCH = 4096
N_BATCHES = 10
ORDER = dict(collect_rate=16, calculate_rate=8192, momentum=0.3)
DRIFT = dict(kind="regime", period_rows=8192, amplitude=1.5)
COMPACTION = {"off": {}, "fixed": dict(compact=True, capacity=160),
              "auto": dict(compact=True, capacity="auto")}


def t_stream():
    return T_stream.LogStream(N_BATCHES * BATCH, BATCH, seed=0,
                              drift=T_stream.DriftConfig(**DRIFT))


def r_plan(shape="cnf", **kw):
    return R.FilterPlan(R_paper.filter_chain(shape),
                        R.OrderingConfig(**ORDER), engine="jnp", **kw)


def t_plan(shape="cnf", **kw):
    return T.FilterPlan(T_paper.filter_chain(shape),
                        T.OrderingConfig(**ORDER), **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def record(session, state, batches):
    """Per-step results + state trajectory as host arrays."""
    steps = []
    for cols in batches:
        state, res = session.step(state, cols)
        steps.append(dict(
            mask=res.mask_np, n_kept=None if res.n_kept is None
            else int(_np(res.n_kept)),
            packed=None if res.packed is None else _np(res.packed),
            metrics={k: _np(v) for k, v in res.metrics._asdict().items()},
            perm=_np(state.perm), group_perm=_np(state.group_perm),
            metrics_dict=res.metrics_dict()))
    return state, steps


@functools.lru_cache(maxsize=None)
def repro_run(mode):
    """repro's jnp session over the stream (computed once per mode)."""
    sess = R.build_session(r_plan(**COMPACTION[mode]))
    batches = [b.columns for b in R_stream.LogStream(
        N_BATCHES * BATCH, BATCH, seed=0,
        drift=R_stream.DriftConfig(**DRIFT))]
    state, steps = record(sess, sess.init_state(), batches)
    return sess.save_state(state)["arrays"], steps, batches


def assert_steps_equal(got, want, engine):
    for i, (g, w) in enumerate(zip(got, want)):
        where = f"{engine} step {i}"
        np.testing.assert_array_equal(g["mask"], w["mask"], err_msg=where)
        np.testing.assert_array_equal(g["perm"], w["perm"], err_msg=where)
        np.testing.assert_array_equal(g["group_perm"], w["group_perm"],
                                      err_msg=where)
        assert g["n_kept"] == w["n_kept"], where
        if w["packed"] is not None:
            assert g["packed"].shape == w["packed"].shape, where
            np.testing.assert_array_equal(g["packed"], w["packed"],
                                          err_msg=where)
        for k, wv in w["metrics"].items():
            gv = g["metrics"][k]
            if k == "adj_rank" or (k == "work_units" and engine == "cuda"):
                np.testing.assert_allclose(gv, wv, rtol=1e-6,
                                           err_msg=f"{where}: {k}")
            else:
                np.testing.assert_array_equal(gv, wv, err_msg=f"{where}: {k}")
        assert g["metrics_dict"].keys() == w["metrics_dict"].keys()


def assert_arrays_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        if k == "adj_rank":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", ["off", "fixed", "auto"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_drifting_stream_matches_repro(engine, mode):
    want_arrays, want_steps, r_batches = repro_run(mode)
    batches = [b.columns for b in t_stream()]
    for a, b in zip(batches, r_batches):      # the same bytes in
        np.testing.assert_array_equal(a, b)
    sess = T.build_session(t_plan(engine=engine, **COMPACTION[mode]),
                           device="cpu")
    state, steps = record(sess, sess.init_state(),
                          [torch.from_numpy(b) for b in batches])
    assert_steps_equal(steps, want_steps, engine)
    assert_arrays_equal(sess.save_state(state)["arrays"], want_arrays)
    assert int(state.epoch) >= 3                       # epochs fired
    assert len({tuple(s["perm"]) for s in steps}) > 1  # the order moved
    if mode == "fixed":
        assert any(s["metrics"]["n_dropped"] > 0 for s in steps)


@pytest.mark.parametrize("variant", [
    dict(scope="per_batch"), dict(adaptive=False),
    dict(scope="centralized", exchange="deferred"),
    dict(scope="centralized", exchange="deferred-async"),
])
def test_scope_and_exchange_variants_match_repro(variant):
    batches = [b.columns for b in t_stream()][:6]
    r_sess = R.build_session(r_plan("flat", **variant))
    _, want = record(r_sess, r_sess.init_state(), batches)
    t_sess = T.build_session(t_plan("flat", engine="torch", **variant),
                             device="cpu")
    _, got = record(t_sess, t_sess.init_state(),
                    [torch.from_numpy(b) for b in batches])
    assert_steps_equal(got, want, "torch")


@pytest.mark.parametrize("shape", ["flat", "cnf", "wide"])
def test_fingerprint_equals_repro(shape):
    for kw in ({}, dict(scope="per_batch"), dict(adaptive=False),
               dict(ordering=None)):
        if "ordering" in kw:
            r = R.FilterPlan(R_paper.filter_chain(shape))
            t = T.FilterPlan(T_paper.filter_chain(shape))
        else:
            r, t = r_plan(shape, **kw), t_plan(shape, **kw)
        assert t.fingerprint() == r.fingerprint()
    # the engine is an execution detail, excluded from the fingerprint
    assert t_plan(engine="torch").fingerprint() == \
        t_plan(engine="cuda").fingerprint()


BAD_COMBOS = [
    dict(capacity=64),
    dict(compact=True, capacity=0),
    dict(compact=True, capacity="big"),
    dict(compact=True, slack=0.5),
    dict(exchange="lazy"),
    dict(exchange="deferred"),
    dict(scope="global"),
    dict(cost_mode="wall"),
    dict(shards=0),
    dict(skip_tier="maybe"),
    dict(scope="global", exchange="lazy", slack=0.1, capacity=3),
]


@pytest.mark.parametrize("kw", BAD_COMBOS)
def test_validate_combo_raises_the_same_errors(kw):
    with pytest.raises(ValueError) as want:
        r_plan(**kw)
    with pytest.raises(ValueError) as got:
        t_plan(**kw)
    assert str(got.value) == str(want.value)


ENGINE_TWIN = {"jnp": "torch", "pallas": "cuda", "numpy": "numpy"}


def _built_or_message(make):
    try:
        return make()
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("kw,item", [
    (dict(shards=2, cost_mode="measured"), "item 12"),
    (dict(engine="numpy"), "item 12"),
    (dict(cost_mode="measured"), "item 12"),
])
def test_unported_combinations_raise_not_implemented(kw, item):
    """The combinations ``item`` of ROADMAP queue 1 ported (they raised
    NotImplementedError before it): for the same keywords, with the
    engine names mapped (``r_plan``'s ``jnp`` is the port's ``torch``),
    the port builds the plan where ``repro`` does, with its fingerprint,
    and raises its ValueError text where ``repro`` raises."""
    r_kw = {"engine": "jnp", **kw}
    t_kw = dict(r_kw, engine=ENGINE_TWIN[r_kw["engine"]])
    chain = ("cnf", R.OrderingConfig(**ORDER), T.OrderingConfig(**ORDER))
    want = _built_or_message(lambda: R.FilterPlan(
        R_paper.filter_chain(chain[0]), chain[1], **r_kw))
    got = _built_or_message(lambda: T.FilterPlan(
        T_paper.filter_chain(chain[0]), chain[2], **t_kw))
    if isinstance(want, str):
        for r_name, t_name in ENGINE_TWIN.items():
            got = got.replace(repr(t_name), repr(r_name))
        assert got == want, item
    else:
        assert got.fingerprint() == want.fingerprint(), item
        assert (got.engine, got.cost_mode) == (t_kw["engine"],
                                              want.cost_mode), item


@pytest.mark.parametrize("tier", ["zonemap", "zonemap+bloom", "auto"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_skip_tier_plans_build(engine, tier):
    """Skip-tier plans build and step, with the plain plan's mask."""
    cols = torch.from_numpy(T_stream.gen_batch(0, 0, 0, BATCH,
                                               layout="clustered"))
    masks = []
    for kw in (dict(skip_tier=tier), {}):
        sess = T.build_session(t_plan(engine=engine, **kw), device="cpu")
        _, res = sess.step(sess.init_state(), cols)
        masks.append(res.mask_np)
    np.testing.assert_array_equal(masks[0], masks[1])
    assert res.n_tiles_skipped_fail == 0          # the plain plan's counters


def test_default_engine_and_bad_engine():
    assert t_plan().engine == "cuda"
    with pytest.raises(ValueError, match="registered engines"):
        t_plan(engine="jnp")


def _steps(session, state, batches):
    for b in batches:
        state, _ = session.step(state, b)
    return state


def test_v2_blobs_cross_restore_both_ways():
    batches = [b.columns for b in t_stream()][:6]
    r_sess = R.build_session(r_plan())
    t_sess = T.build_session(t_plan(engine="torch"), device="cpu")
    # repro → port, then both continue over the same batches
    r_state = _steps(r_sess, r_sess.init_state(), batches[:3])
    t_state = t_sess.restore_state(r_sess.save_state(r_state))
    r_state = _steps(r_sess, r_state, batches[3:])
    t_state = _steps(t_sess, t_state,
                     [torch.from_numpy(b) for b in batches[3:]])
    assert_arrays_equal(t_sess.save_state(t_state)["arrays"],
                        r_sess.save_state(r_state)["arrays"])
    # port → repro
    blob = t_sess.save_state(t_state)
    assert blob["crc32"] == R_session.arrays_crc32(blob["arrays"])
    back = r_sess.restore_state(blob)
    assert_arrays_equal(r_sess.save_state(back)["arrays"], blob["arrays"])
    # v1 raw-array blobs load too
    v1 = t_sess.restore_state(dict(r_sess.save_state(r_state)["arrays"]))
    assert torch.equal(v1.perm, t_state.perm)


def test_auto_capacity_retunes_on_the_first_step_after_a_restore():
    """repro retunes ``capacity="auto"`` on any step whose state's epoch is
    past the last one it tuned for, so the first step after restoring an
    epoch-1 blob retunes; the port must too, though its host mirror sees
    no boundary fire on that step."""
    order = dict(ORDER, calculate_rate=12288)
    kw = dict(compact=True, capacity="auto")
    r_make = lambda: R.build_session(R.FilterPlan(  # noqa: E731
        R_paper.filter_chain("cnf"), R.OrderingConfig(**order),
        engine="jnp", **kw))
    batches = [b.columns for b in t_stream()][:6]
    src = r_make()
    blob = src.save_state(_steps(src, src.init_state(), batches[:4]))
    assert int(blob["arrays"]["epoch"]) == 1
    r_sess = r_make()
    t_sess = T.build_session(T.FilterPlan(
        T_paper.filter_chain("cnf"), T.OrderingConfig(**order),
        engine="torch", **kw), device="cpu")
    r_state, t_state = r_sess.restore_state(blob), t_sess.restore_state(blob)
    caps = []
    for b in batches[4:]:
        r_state, r_res = r_sess.step(r_state, b)
        t_state, t_res = t_sess.step(t_state, torch.from_numpy(b))
        assert t_res.capacity == r_res.capacity
        assert tuple(t_res.packed.shape) == tuple(r_res.packed.shape)
        np.testing.assert_array_equal(_np(t_res.packed), _np(r_res.packed))
        caps.append(t_res.capacity)
    assert caps[1] < BATCH          # the retune narrowed the buffer


def test_restore_rejects_corruption_and_foreign_plans():
    t_sess = T.build_session(t_plan(engine="torch"), device="cpu")
    blob = t_sess.save_state(_steps(
        t_sess, t_sess.init_state(),
        [torch.from_numpy(b.columns) for b in t_stream()][:2]))
    bad = dict(blob, arrays=dict(blob["arrays"]))
    bad["arrays"]["stats.num_cut"] = bad["arrays"]["stats.num_cut"] + 1.0
    with pytest.raises(ValueError, match="crc32 mismatch"):
        t_sess.restore_state(bad)
    r_sess = R.build_session(r_plan())
    with pytest.raises(ValueError, match="crc32 mismatch"):
        r_sess.restore_state(bad)
    other = T.build_session(t_plan("flat", engine="torch"), device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        other.restore_state(blob)
    sharded = dict(blob, shards=2, arrays={
        k: np.stack([v, v]) for k, v in blob["arrays"].items()})
    sharded["crc32"] = R_session.arrays_crc32(sharded["arrays"])
    # a sharded blob reshards into the unsharded session, as in repro
    from repro.data.pipeline import fstate_to_arrays
    got = T.session.fstate_to_arrays(t_sess.restore_state(sharded))
    want = fstate_to_arrays(r_sess.restore_state(sharded))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


def test_validate_state_and_foreign_state_reanchor():
    batches = [torch.from_numpy(b.columns) for b in t_stream()][:5]
    a = T.build_session(t_plan(engine="torch"), device="cpu")
    b = T.build_session(t_plan(engine="torch"), device="cpu")
    state = _steps(a, a.init_state(), batches[:3])
    assert a.validate_state(state)
    assert not a.validate_state(state._replace(
        perm=torch.zeros_like(state.perm)))
    # b never saw this state: it re-anchors its row counter and continues
    # exactly as a does
    b.init_state()
    sa = _steps(a, state, batches[3:])
    sb = _steps(b, state, batches[3:])
    for x, y in zip(T.session.fstate_to_arrays(sa).values(),
                    T.session.fstate_to_arrays(sb).values()):
        np.testing.assert_array_equal(x, y)


def test_step_result_accessors():
    sess = T.build_session(t_plan(engine="cuda", compact=True, capacity=100),
                           device="cpu")
    cols = torch.from_numpy(next(iter(t_stream())).columns)
    state, res = sess.step(sess.init_state(), cols)
    surv = res.survivors()
    mask = res.mask_np
    want = cols.numpy()[:, mask][:, :100]
    np.testing.assert_array_equal(surv, want)
    assert res.n_pass == min(int(mask.sum()), 100)
    assert res.n_dropped == max(int(mask.sum()) - 100, 0)
    assert res.capacity == 100 and res.gate_s > 0
    d = res.metrics_dict()
    assert d["n_pass"] == int(mask.sum()) and d["epoch"] == 0
    plain = T.build_session(t_plan(engine="cuda"), device="cpu")
    _, res2 = plain.step(plain.init_state(), cols)
    np.testing.assert_array_equal(res2.survivors(cols), cols.numpy()[:, mask])
    with pytest.raises(ValueError, match="pass the original columns"):
        res2.survivors()


def test_session_runs_host_batches_and_dataclass_plans():
    plan = dataclasses.replace(t_plan(engine="torch"), slack=2.0)
    sess = T.build_session(plan, device="cpu")
    state, res = sess.step(sess.init_state(),
                           next(iter(t_stream())).columns)   # numpy batch
    assert res.mask.device.type == "cpu" and state.perm.dtype == torch.int32
