"""The guarded runtime and its fault toolkit in the port, against repro's.

The same numpy inputs go through ``repro.runtime`` (``jnp`` engine) and
``repro_torch.runtime`` (``torch`` and ``cuda`` engines; on the CPU the
``cuda`` engine runs its kernels' twins):

* the 1-device chaos soak (poison, storm, an injected step kill and live
  state corruption, under ``run_log_stream``): every batch's mask and
  ``quarantined`` flag, every health counter, every degrade/promote and
  the final ``save_state`` arrays equal ``repro``'s (float accumulators
  to rtol 1e-6, everything else bit for bit);
* ``DataFaultInjector``, ``corrupt_state`` and ``corrupt_blob`` give the
  same bytes, and the validator catches every ``STATE_CORRUPTIONS`` class;
* the ladder (cuda → torch, skip tier → off, fused → mask compaction),
  re-promotion and oscillation, ring rollback past corrupt blobs, retry
  and backoff; the event sequences equal ``repro``'s wherever ``repro``
  runs them without its Pallas kernels (which fail on this JAX);
* a ``KernelError`` (the kernel library did not build, a launch failed,
  or a wrapper refused to launch) and a CUDA error that torch reports
  propagate from the retry scope with no retry and no degrade; any other
  failure that outlasts the whole ladder propagates at its bottom.

The guarded session on the card is held in ``test_torch_guard_card.py``.
"""

import dataclasses
import functools
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.runtime as R_rt  # noqa: E402
from repro.data import pipeline as R_pipeline  # noqa: E402
from repro.data import stream as R_stream  # noqa: E402

import repro_torch.core as T  # noqa: E402
import repro_torch.runtime as T_rt  # noqa: E402
from repro_torch.core import session as T_session  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402
from repro_torch.kernels.filter_chain import filter_chain as tfc  # noqa: E402

ORDER = dict(collect_rate=32, calculate_rate=8192, momentum=0.3)
#: engine names across the packages
TO_REPRO = {"cuda": "pallas", "torch": "jnp"}
FLOAT_ARRAYS = ("adj_rank", "stats.num_cut", "stats.cost_acc",
                "stats.n_monitored", "stats.group_cut")


def r_plan(**kw):
    kw.setdefault("predicates", R.paper_filters_4("fig1"))
    kw.setdefault("engine", "jnp")
    return R.FilterPlan(ordering=R.OrderingConfig(**ORDER), **kw)


def t_plan(**kw):
    kw.setdefault("predicates", T.paper_filters_4("fig1"))
    kw.setdefault("engine", "torch")
    return T.FilterPlan(ordering=T.OrderingConfig(**ORDER), **kw)


def t_session(plan):
    return T.build_session(plan, device="cpu")


def policy(rt=T_rt, **kw):
    kw.setdefault("sleep", lambda d: None)     # never sleep real time here
    return rt.GuardPolicy(**kw)


def batches(n, rows=1024, seed=0, drift=None):
    stream = T_stream.LogStream(total_rows=n * rows, batch_rows=rows,
                                seed=seed,
                                drift=drift or T_stream.DriftConfig())
    return [rb.columns for rb in stream]


def storm_row(session, cols):
    """A [C] feature vector every predicate passes: any survivor row."""
    _, res = session.step(session.init_state(), cols)
    idx = np.flatnonzero(res.mask_np)
    assert idx.size, "no survivor in the probe batch"
    return np.array(cols[:, idx[0]])


def mapped(events, names=TO_REPRO):
    """Degrade/promote events with the port's engine names as repro's."""
    return [dict(e, changes={k: names.get(v, v) if k == "engine" else v
                             for k, v in e["changes"].items()})
            for e in events]


def assert_arrays_match(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in FLOAT_ARRAYS:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# ====================================================== chaos soak (1 device)
SOAK_BATCHES, SOAK_ROWS = 16, 2048
POISON_AT, STORM_AT, FAIL_AT, CORRUPT_AT = {3, 11}, {7}, {5}, {9}


def soak(build, plan, rt, stream_mod):
    """Faulted guarded run + fault-free baseline over the same stream, as
    ``tests/test_guard.py`` makes them, through one package."""
    drift = stream_mod.DriftConfig("sine", period_rows=16_000)

    def stream():
        return stream_mod.LogStream(total_rows=SOAK_BATCHES * SOAK_ROWS,
                                    batch_rows=SOAK_ROWS, drift=drift)

    base = build(plan)
    bstate, base_masks = base.init_state(), {}
    for rb in stream():
        bstate, r = base.step(bstate, rb.columns)
        base_masks[rb.row_offset // SOAK_ROWS] = r.mask_np
    probe = next(iter(stream_mod.LogStream(SOAK_ROWS, SOAK_ROWS))).columns
    row = storm_row(build(plan), probe)
    inj = rt.DataFaultInjector(poison_at=POISON_AT, storm_at=STORM_AT,
                               storm_row=row)
    kill = rt.FailureInjector(fail_at_steps=FAIL_AT)

    def state_inj(i, st):
        return rt.corrupt_state(st, "nan_stat") if i in CORRUPT_AT else st

    guard = rt.GuardedSession(
        build(plan), policy(rt, validate_every=1, checkpoint_every=4),
        step_injector=kill.maybe_fail, state_injector=state_inj)
    state, results = guard.run_log_stream(stream(), batch_hook=inj)
    return dict(guard=guard, state=state, results=results,
                base_masks=base_masks, storm_row=row,
                arrays=guard.session.save_state(state)["arrays"])


@functools.lru_cache(maxsize=None)
def repro_soak():
    return soak(R.build_session, r_plan(compact=True, capacity=256), R_rt,
                R_stream)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_chaos_soak_matches_repro(engine):
    got = soak(t_session, t_plan(engine=engine, compact=True, capacity=256),
               T_rt, T_stream)
    want = repro_soak()
    guard, results = got["guard"], got["results"]
    np.testing.assert_array_equal(got["storm_row"], want["storm_row"])
    assert sorted(results) == sorted(want["results"]) \
        == list(range(SOAK_BATCHES))
    for b, res in results.items():
        ref = want["results"][b]
        assert res.quarantined == ref.quarantined, b
        np.testing.assert_array_equal(res.mask_np, ref.mask_np,
                                      err_msg=f"batch {b}")
        assert res.n_pass == ref.n_pass, b
        if b in POISON_AT:
            assert res.quarantined and not res.mask_np.any()
            assert res.metrics_dict()["quarantined"]
        elif b in STORM_AT:
            assert res.n_pass == SOAK_ROWS        # all-pass, kept lossless
        else:                                     # survivor bit-parity
            np.testing.assert_array_equal(res.mask_np, got["base_masks"][b])
    h, rh = guard.health.to_dict(), want["guard"].health.to_dict()
    for k in ("steps", "quarantined", "retries", "rollbacks",
              "validator_failures", "crc_rejects", "overflow_events",
              "n_degrades", "n_promotes"):
        assert h[k] == rh[k], k
    assert h["quarantined"] >= len(POISON_AT) and h["retries"] >= 1
    assert h["overflow_events"] >= 1 and h["rollbacks"] >= 1
    assert mapped(guard.health.degrades) == rh["degrades"]
    assert mapped(guard.health.promotes) == rh["promotes"]
    assert [e["changes"] for e in guard.health.degrades] == [
        {"capacity": "None"}]
    assert guard.session.plan.engine == engine    # the storm keeps it
    assert guard.session.validate_state(got["state"])
    assert_arrays_match(got["arrays"], want["arrays"])
    assert "quarantined=" in guard.health.summary()


# ========================================================== fault toolkit
@functools.lru_cache(maxsize=None)
def states():
    """The same OrderState in both packages (a port state after 3 steps,
    through a checkpoint blob into repro), flat and CNF."""
    out = []
    for preds in ("fig1_flat", "fig1_cnf"):
        tp = T.paper_filters_4("fig1") if preds == "fig1_flat" \
            else T.paper_filters_cnf("fig1")
        rp = R.paper_filters_4("fig1") if preds == "fig1_flat" \
            else R.paper_filters_cnf("fig1")
        sess = t_session(t_plan(predicates=tp))
        state = sess.init_state()
        for cols in batches(3):
            state, _ = sess.step(state, cols)
        r_sess = R.build_session(r_plan(predicates=rp))
        out.append((preds, sess, state,
                    r_sess.restore_state(sess.save_state(state))))
    return out



@pytest.mark.parametrize("kind", T_rt.STATE_CORRUPTIONS)
@pytest.mark.parametrize("which", [0, 1], ids=["flat", "cnf"])
def test_corrupt_state_matches_repro_and_the_validator_catches_it(which,
                                                                  kind):
    _, sess, state, r_state = states()[which]
    assert sess.validate_state(state)
    for seed in (0, 1):
        bad = T_rt.corrupt_state(state, kind, seed=seed)
        assert bad.perm.device == state.perm.device
        assert not sess.validate_state(bad), f"validator missed {kind!r}"
        got = T_session.fstate_to_arrays(bad)
        want = R_pipeline.fstate_to_arrays(
            R_rt.corrupt_state(r_state, kind, seed=seed))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
    assert sess.validate_state(state)              # the original is intact


def test_an_epoch_boundary_heals_nan_stat_but_not_inf_stat():
    """When a batch crosses an epoch boundary (as every 2^22-row batch of
    the paper workload does), the boundary zeroes the accumulators: a NaN
    cut count heals within the step, while an infinite cost has already
    reached the ranks. Both packages agree, state for state."""
    cols = batches(2, rows=4096)
    order = dict(ORDER, calculate_rate=2048)
    healed = {}
    for name, build, plan, rt in (
            ("port", t_session, T.FilterPlan(
                T.paper_filters_cnf("fig1"), T.OrderingConfig(**order)),
             T_rt),
            ("repro", R.build_session, R.FilterPlan(
                R.paper_filters_cnf("fig1"), R.OrderingConfig(**order),
                engine="jnp"), R_rt)):
        sess = build(plan)
        state, _ = sess.step(sess.init_state(), cols[0])
        for kind in ("nan_stat", "inf_stat"):
            bad = rt.corrupt_state(state, kind)
            assert not sess.validate_state(bad)
            healed[name, kind] = sess.validate_state(sess.step(bad,
                                                               cols[1])[0])
    assert healed == {("port", "nan_stat"): True, ("repro", "nan_stat"): True,
                      ("port", "inf_stat"): False,
                      ("repro", "inf_stat"): False}


def test_corrupt_state_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown corruption kind"):
        T_rt.corrupt_state(states()[0][2], "cosmic_ray")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_flips", [1, 3])
def test_corrupt_blob_matches_repro_and_trips_the_crc(seed, n_flips):
    _, sess, state, _ = states()[1]
    blob = sess.save_state(state)
    got = T_rt.corrupt_blob(blob, seed=seed, n_flips=n_flips)
    want = R_rt.corrupt_blob(blob, seed=seed, n_flips=n_flips)
    for k in blob["arrays"]:
        np.testing.assert_array_equal(got["arrays"][k], want["arrays"][k])
    assert T_session.arrays_crc32(blob["arrays"]) == blob["crc32"]
    with pytest.raises(ValueError, match="crc32 mismatch"):
        sess.restore_state(got)
    assert sess.validate_state(sess.restore_state(blob))


def test_data_fault_injector_matches_repro():
    cols = batches(1, rows=3000)[0]
    row = np.array([1.0, 2.0, 3.0], np.float32)
    kw = dict(poison_at=(2, 5), storm_at=(4,), storm_row=row,
              poison_frac=0.02, seed=7)
    got, want = T_rt.DataFaultInjector(**kw), R_rt.DataFaultInjector(**kw)
    for b in range(6):
        g, w = got(b, cols), want(b, cols)
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.array_equal(g, w, equal_nan=True), b
    poisoned = got(2, cols)
    assert np.isnan(poisoned).any() and np.isinf(poisoned).any()
    assert got(2, cols) is not cols and got(0, cols) is cols
    assert (got(4, cols) == row[:, None]).all()
    with pytest.raises(ValueError, match="storm_row"):
        T_rt.DataFaultInjector(storm_at=(1,))


def test_failure_injector_fires_once_per_step():
    inj = T_rt.FailureInjector(fail_at_steps=(2, 4))
    inj.maybe_fail(1)
    with pytest.raises(RuntimeError, match="step 2"):
        inj.maybe_fail(2)
    inj.maybe_fail(2)                              # fired once only
    assert inj.failures == 1


def test_graceful_shutdown_signal_flow():
    """First SIGTERM sets the flag; a second raises KeyboardInterrupt; the
    previous handlers come back on exit."""
    prev = signal.getsignal(signal.SIGTERM)
    stop = T_rt.GracefulShutdown()
    with stop:
        assert not stop.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) is prev


def test_straggler_reassignment_matches_repro():
    mons = [rt.StragglerMonitor(n_shards=4, threshold=1.5, window=4)
            for rt in (T_rt, R_rt)]
    for mon in mons:
        for _ in range(6):
            for s, t in enumerate([0.1, 0.12, 0.1, 0.9]):
                mon.record(s, t)
    assert mons[0].stragglers() == mons[1].stragglers() == [3]
    plan = {i: list(range(i * 10, i * 10 + 10)) for i in range(4)}
    new = mons[0].reassign(plan)
    assert new == mons[1].reassign(plan) and len(new[3]) == 5
    assert sorted(b for v in new.values() for b in v) == list(range(40))


# ========================================================== guard: admission
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_quarantine_poisoned_batch(as_tensor):
    guard = T_rt.GuardedSession(t_session(t_plan()), policy())
    state = guard.init_state()
    cols = batches(1)[0].copy()
    cols[1, 100] = np.nan
    cols[2, 7] = np.inf
    if as_tensor:
        cols = torch.from_numpy(cols)
    before = T_session.fstate_to_arrays(state)
    new_state, res = guard.step(state, cols)
    assert res.quarantined and res.metrics_dict()["quarantined"]
    assert res.metrics_dict()["n_pass"] == 0
    assert not res.mask_np.any() and res.mask_np.shape == (1024,)
    assert res.n_pass == 0 and res.n_dropped == 0
    for k, v in T_session.fstate_to_arrays(new_state).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert guard.health.quarantined == 1 and guard.health.steps == 0


def test_retry_absorbs_transient_failures():
    delays, calls = [], {"n": 0}

    def injector(i):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("transient node failure")

    guard = T_rt.GuardedSession(
        t_session(t_plan()),
        policy(max_retries=3, backoff_base_s=0.05, jitter=0.0,
               sleep=delays.append),
        step_injector=injector)
    cols = batches(1)[0]
    _, res = guard.step(guard.init_state(), cols)
    ref = t_session(t_plan())
    _, ref_res = ref.step(ref.init_state(), cols)
    np.testing.assert_array_equal(res.mask_np, ref_res.mask_np)
    assert guard.health.retries == 2 and not res.quarantined
    assert delays == [0.05, 0.10]                  # exponential, jitter=0


def test_backoff_is_bounded_jittered_and_matches_repro():
    got, want = [], []
    kw = dict(backoff_base_s=0.5, backoff_max_s=1.0, jitter=0.25, seed=1)
    t_guard = T_rt.GuardedSession(t_session(t_plan()),
                                  policy(sleep=got.append, **kw))
    r_guard = R_rt.GuardedSession(R.build_session(r_plan()),
                                  policy(R_rt, sleep=want.append, **kw))
    for attempt in (1, 2, 3, 4):
        t_guard._backoff(attempt, 0, RuntimeError("x"))
        r_guard._backoff(attempt, 0, RuntimeError("x"))
    assert got == want
    assert got[0] <= 0.5 * 1.25 and all(d <= 1.25 for d in got)
    assert len(set(got)) == 4                      # seeded jitter: distinct


# ===================================================== guard: degrade ladder
def test_degrade_cuda_to_torch_keeps_the_device_and_the_masks():
    """A persistently crashing cuda engine degrades to torch mid-stream;
    the live OrderState survives (the fingerprint excludes the engine),
    the session stays on its device, and the masks equal a torch run."""
    holder = {}

    def injector(i):
        if holder["g"].session.plan.engine == "cuda":
            raise RuntimeError("cuda engine crashed")

    guard = T_rt.GuardedSession(t_session(t_plan(engine="cuda")),
                                policy(max_retries=1), step_injector=injector)
    holder["g"] = guard
    state = guard.init_state()
    ref = t_session(t_plan())
    ref_state = ref.init_state()
    for cols in batches(3):
        state, res = guard.step(state, cols)
        ref_state, ref_res = ref.step(ref_state, cols)
        np.testing.assert_array_equal(res.mask_np, ref_res.mask_np)
    assert guard.session.plan.engine == "torch"
    assert guard.session.device == torch.device("cpu")
    assert [e["changes"] for e in guard.health.degrades] == [
        {"engine": "torch"}]
    assert guard.health.retries == 1
    assert_arrays_match(guard.save_state(state)["arrays"],
                        ref.save_state(ref_state)["arrays"])


LADDER_TOP = dict(engine="cuda", skip_tier="zonemap", compact=True,
                  capacity=600)
LADDER_DOWN = [{"engine": "torch"}, {"skip_tier": "off"},
               {"compact": "False", "capacity": "None"}]


def test_ladder_walks_down_and_climbs_back_to_the_top():
    """A fault that fails the next six step attempts walks every rung down
    (max_retries=1: two attempts a rung); once it clears, promote_after=2
    climbs back one rung per two clean boundaries. Masks equal an
    unguarded run of the top plan throughout."""
    fault = {"left": 6}

    def injector(i):
        if i >= 1 and fault["left"] > 0:
            fault["left"] -= 1
            raise RuntimeError("device fault")

    plan = t_plan(**LADDER_TOP)
    guard = T_rt.GuardedSession(
        t_session(plan), policy(max_retries=1, validate_every=1,
                                promote_after=2),
        step_injector=injector)
    ref = t_session(plan)
    state, ref_state = guard.init_state(), ref.init_state()
    for b, cols in enumerate(batches(10)):
        state, res = guard.step(state, cols)
        ref_state, ref_res = ref.step(ref_state, cols)
        np.testing.assert_array_equal(res.mask_np, ref_res.mask_np,
                                      err_msg=f"batch {b}")
        if b == 1:
            assert guard.session.plan.compact is False
            assert res.packed is None
    h = guard.health
    assert [e["changes"] for e in h.degrades] == LADDER_DOWN
    assert [e["changes"] for e in h.promotes] == [
        {"compact": "True", "capacity": "600"}, {"skip_tier": "zonemap"},
        {"engine": "cuda"}]
    assert [e["step"] for e in h.promotes] == [4, 6, 8]
    assert h.retries == 3
    assert guard.health_snapshot()["rungs"] == {
        "engine": "cuda", "skip_tier": "zonemap", "compact": True,
        "capacity": "600", "degrade_depth": 0}
    assert_arrays_match(guard.save_state(state)["arrays"],
                        ref.save_state(ref_state)["arrays"])


def test_failure_past_the_bottom_rung_propagates():
    """A step failure that no rung cures walks the whole ladder and then
    surfaces to the caller."""
    guard = T_rt.GuardedSession(
        t_session(t_plan(**LADDER_TOP)), policy(max_retries=1),
        step_injector=lambda i: (_ for _ in ()).throw(RuntimeError(
            "the step fails on every rung")))
    with pytest.raises(RuntimeError, match="fails on every rung"):
        guard.step(guard.init_state(), batches(1)[0])
    assert [e["changes"] for e in guard.health.degrades] == LADDER_DOWN
    assert guard.health.retries == 4


def _failing_nvcc(tmp_path, monkeypatch):
    """The kernel library's build, made to fail as a broken toolchain
    does: nvcc exits non-zero (no library is built or loaded)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'nvcc fatal: no sm_90a' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(tfc, "_LIBRARY", None)
    monkeypatch.setattr(tfc, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(tfc, "_nvcc", lambda: str(nvcc))


@pytest.mark.parametrize("where", ["build", "launch", "session"])
def test_kernel_errors_propagate_without_retry_or_degrade(where, tmp_path,
                                                          monkeypatch):
    """A build or launch failure of the kernel library, raised inside the
    retry scope, is re-raised at once: no retry, no backoff, no degrade to
    the torch engine (which would hide a missing kernel)."""
    _failing_nvcc(tmp_path, monkeypatch)
    delays = []

    def injector(i):
        if where == "build":
            tfc.build()
        elif where == "launch":
            tfc._check_launch("filter_chain", 700)

    if where == "session":
        def step(self, state, batch):
            tfc.build()
        monkeypatch.setattr(T_session.FilterSession, "step", step)
    guard = T_rt.GuardedSession(
        t_session(t_plan(**LADDER_TOP)), policy(sleep=delays.append),
        step_injector=injector)
    with pytest.raises(tfc.KernelError) as caught:
        guard.step(guard.init_state(), batches(1)[0])
    assert isinstance(caught.value, RuntimeError)
    assert ("CUDA error 700" if where == "launch" else "nvcc failed") \
        in str(caught.value)
    assert guard.health.retries == 0 and delays == []
    assert guard.health.degrades == []
    assert guard.session.plan.engine == "cuda"


def _too_many_predicates():
    base = T.paper_filters_4("fig1")
    return [dataclasses.replace(base[i % len(base)], name=f"p{i}")
            for i in range(tfc.MAX_PREDS + 1)]


@pytest.mark.parametrize("fault", ["refusal", "cuda_error_text",
                                   "accelerator_error"])
def test_device_faults_propagate_without_retry_or_degrade(fault):
    """A wrapper's refusal to launch (here: a ``cuda`` plan with one
    predicate more than the kernel holds, refused by the real step) and a
    CUDA error that torch reports are re-raised at once: no retry, no
    backoff, no degrade to the torch engine."""
    delays = []
    plan = t_plan(**LADDER_TOP)
    injector = None
    if fault == "refusal":
        plan = t_plan(**dict(LADDER_TOP, predicates=_too_many_predicates()))
    else:
        exc = RuntimeError if fault == "cuda_error_text" \
            else torch.AcceleratorError
        injector = lambda i: (_ for _ in ()).throw(exc(  # noqa: E731
            "CUDA error: an illegal memory access was encountered"))
    guard = T_rt.GuardedSession(t_session(plan), policy(sleep=delays.append),
                                step_injector=injector)
    want = tfc.KernelRefusal if fault == "refusal" else RuntimeError
    with pytest.raises(want) as caught:
        guard.step(guard.init_state(), batches(1)[0])
    if fault == "refusal":
        assert isinstance(caught.value, ValueError)
        assert f"at most {tfc.MAX_PREDS} predicates" in str(caught.value)
    assert guard.health.retries == 0 and delays == []
    assert guard.health.degrades == []
    assert guard.session.plan.engine == "cuda"


def test_launch_status_check():
    tfc._check_launch("tile_stats", 0)
    with pytest.raises(tfc.KernelError, match="tile_stats kernel launch"):
        tfc._check_launch("tile_stats", 1)


# ============================================================== guard: storm
def test_storm_overflow_degrades_losslessly():
    plan = t_plan(compact=True, capacity=128)
    probe = batches(1)[0]
    storm = np.tile(storm_row(t_session(plan), probe)[:, None], (1, 1024))
    guard = T_rt.GuardedSession(t_session(plan), policy())
    state, res = guard.step(guard.init_state(), storm)
    assert guard.health.overflow_events == 1
    assert guard.session.plan.capacity is None     # lossless rung
    assert res.n_pass == 1024 and res.n_dropped == 0
    assert [e["changes"] for e in guard.health.degrades] == [
        {"capacity": "None"}]
    # exactly-once stat fold: one batch's worth of monitored rows
    ref = t_session(plan)
    ref_state, _ = ref.step(ref.init_state(), probe)
    assert float(state.stats.n_monitored.max()) \
        == float(ref_state.stats.n_monitored.max())


# ======================================================= guard: re-promotion
def _crashing_engine(rt, name, flaky):
    holder = {}

    def injector(i):
        if flaky["on"] and holder["g"].session.plan.engine == name:
            raise RuntimeError(f"{name} fault")
    return holder, injector


def _run_crashing(rt, build, plan, name, n, *, flaky=None, clear_after=None,
                  **kw):
    flaky = flaky if flaky is not None else {"on": True}
    holder, injector = _crashing_engine(rt, name, flaky)
    guard = rt.GuardedSession(build(plan), policy(rt, max_retries=1, **kw),
                              step_injector=injector)
    holder["g"] = guard
    state, masks = guard.init_state(), []
    for b, cols in enumerate(batches(n)):
        if clear_after is not None and b == clear_after:
            flaky["on"] = False
        state, res = guard.step(state, cols)
        masks.append(res.mask_np)
    return guard, masks


def test_fault_clears_then_recovers_repromotes():
    guard, masks = _run_crashing(T_rt, t_session, t_plan(engine="cuda"),
                                 "cuda", 5, clear_after=1, validate_every=1,
                                 promote_after=2)
    assert guard.session.plan.engine == "cuda"
    assert [e["changes"] for e in guard.health.promotes] == [
        {"engine": "cuda"}]
    assert len(guard.health.degrades) == 1
    ref = t_session(t_plan())
    state = ref.init_state()
    for cols, mask in zip(batches(5), masks):
        state, res = ref.step(state, cols)
        np.testing.assert_array_equal(mask, res.mask_np)


def test_persistent_fault_oscillates_as_repro_does():
    """A fault that never clears: the rung re-promotes after the healthy
    window, crashes again, and degrades again — the same events, step by
    step, as repro's (whose injector stops its Pallas engine before the
    kernel runs)."""
    kw = dict(validate_every=1, promote_after=2)
    got, _ = _run_crashing(T_rt, t_session, t_plan(engine="cuda"), "cuda",
                           7, **kw)
    want, _ = _run_crashing(R_rt, R.build_session, r_plan(engine="pallas"),
                            "pallas", 7, **kw)
    h = got.health
    assert len(h.promotes) >= 1 and len(h.degrades) == len(h.promotes) + 1
    assert got.session.plan.engine == "torch" and h.steps == 7
    for a, b in ((h.degrades, want.health.degrades),
                 (h.promotes, want.health.promotes)):
        assert [(e["step"], e["changes"]) for e in mapped(a)] \
            == [(e["step"], e["changes"]) for e in b]


def test_promotion_disabled_by_default():
    got, _ = _run_crashing(T_rt, t_session, t_plan(engine="cuda"), "cuda",
                           6, clear_after=1, validate_every=1)
    assert got.session.plan.engine == "torch"
    assert got.health.promotes == []


def test_storm_clears_then_capacity_repromotes_as_repro_does():
    out = []
    for rt, build, plan in ((T_rt, t_session, t_plan), (R_rt,
                            R.build_session, r_plan)):
        p = plan(compact=True, capacity=128)
        probe = batches(1)[0]
        storm = np.tile(storm_row(build(p), probe)[:, None], (1, 1024))
        guard = rt.GuardedSession(build(p), policy(rt, validate_every=1,
                                                   promote_after=2))
        state = guard.init_state()
        state, _ = guard.step(state, storm)
        assert guard.session.plan.capacity is None
        for cols in batches(3, seed=5):
            state, _ = guard.step(state, cols)
        assert guard.session.plan.capacity == 128
        out.append(guard.health)
    assert out[0].promotes == out[1].promotes
    assert out[0].degrades == out[1].degrades
    assert out[0].promotes[0]["changes"] == {"capacity": "128"}


def _auto_storm_run(rt, build, plan, storm_at=4):
    cols_list = batches(10)
    row = storm_row(build(plan), cols_list[0])
    guard = rt.GuardedSession(build(plan), policy(rt, validate_every=1,
                                                  promote_after=2))
    state, steps = guard.init_state(), []
    for i, cols in enumerate(cols_list):
        if i == storm_at:
            cols = np.tile(row[:, None], (1, cols.shape[1]))
        state, res = guard.step(state, cols)
        steps.append((res.capacity, res.n_pass, res.mask_np))
    return steps, guard.health


def test_auto_capacity_after_a_swap_retunes_as_repro_does():
    """A storm under ``capacity="auto"`` degrades to lossless and, after
    the healthy window, re-promotes to "auto" on a fresh filter; its first
    step retunes the width as repro's fresh filter does (an epoch of three
    batches, so that step falls inside an epoch), where carrying the old
    session's row-mirror flags kept the batch width one step longer."""
    order = dict(ORDER, calculate_rate=3072)
    got, got_h = _auto_storm_run(T_rt, t_session, T.FilterPlan(
        T.paper_filters_cnf("fig1"), T.OrderingConfig(**order),
        compact=True, capacity="auto"))
    want, want_h = _auto_storm_run(R_rt, R.build_session, R.FilterPlan(
        R.paper_filters_cnf("fig1"), R.OrderingConfig(**order),
        engine="jnp", compact=True, capacity="auto"))
    assert [e["changes"] for e in got_h.promotes] == [{"capacity": "auto"}]
    assert got_h.degrades == want_h.degrades
    assert got_h.promotes == want_h.promotes
    for i, ((cap, n, mask), (rcap, rn, rmask)) in enumerate(zip(got, want)):
        assert (cap, n) == (rcap, rn), f"step {i}"
        np.testing.assert_array_equal(mask, rmask, err_msg=f"step {i}")


def test_health_snapshot_exports_rungs():
    import json

    guard = T_rt.GuardedSession(
        t_session(t_plan(engine="cuda", compact=True, capacity=64)),
        policy())
    snap = guard.health_snapshot()
    assert snap["rungs"] == {"engine": "cuda", "skip_tier": "off",
                             "compact": True, "capacity": "64",
                             "degrade_depth": 0}
    assert snap["n_promotes"] == 0 and snap["promotes"] == []
    json.dumps(snap)


# =========================================================== guard: rollback
def test_rollback_restores_from_ring():
    """Corrupt the live state in flight (validate_every=1 catches it at
    the next boundary): the pre-step state is corrupt too, so the guard
    rolls back to the ring snapshot and re-runs the batch from it."""
    plan = t_plan()
    cols_list = batches(3)
    ref = t_session(plan)
    ref_state, ref_masks = ref.init_state(), []
    for cols in cols_list:
        ref_state, r = ref.step(ref_state, cols)
        ref_masks.append(r.mask_np)

    def state_inj(i, st):
        return T_rt.corrupt_state(st, "nan_stat") if i == 2 else st

    guard = T_rt.GuardedSession(
        t_session(plan), policy(validate_every=1, checkpoint_every=100),
        state_injector=state_inj)
    state = guard.init_state()
    for b, cols in enumerate(cols_list):
        state, res = guard.step(state, cols)
        np.testing.assert_array_equal(res.mask_np, ref_masks[b])
    assert guard.health.validator_failures == 1
    assert guard.health.rollbacks == 1
    assert guard.session.validate_state(state)


def test_ring_skips_corrupt_blobs_newest_first():
    guard = T_rt.GuardedSession(t_session(t_plan()),
                                policy(checkpoint_every=1, ring_size=4))
    state = guard.init_state()
    for cols in batches(3):
        state, _ = guard.step(state, cols)
    assert len(guard._ring) == 4
    newest = guard._ring[-1]
    guard._ring[-1] = newest._replace(blob=T_rt.corrupt_blob(newest.blob))
    entry, restored = guard._restore_newest_valid()
    assert entry.step == guard._ring[-2].step      # fell back one entry
    assert guard.health.crc_rejects == 1
    assert guard.session.validate_state(restored)

    guard._ring.clear()
    for e in [newest._replace(blob=T_rt.corrupt_blob(newest.blob, seed=s))
              for s in range(3)]:
        guard._ring.append(e)
    with pytest.raises(T_rt.GuardStateError, match="cannot self-heal"):
        guard._restore_newest_valid()


# ============================= quarantine under device tokenize (port only)
def _list_stream(cols_list):
    rows = cols_list[0].shape[1]
    return T_stream.RequestStream(lambda b, start, n: cols_list[b],
                                  total_rows=len(cols_list) * rows,
                                  batch_rows=rows)


@pytest.mark.parametrize("shards", [1, 4], ids=["unsharded", "sharded"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_guarded_tokenize_pipeline_goes_past_a_poisoned_batch(engine,
                                                              shards):
    """A quarantined batch of a tokenize plan carries zero tokens: the
    guarded pipeline over a stream with one poisoned batch yields exactly
    the LM batches of an unguarded pipeline over the stream without it
    (the quarantine leaves the state untouched). ``repro`` stops there
    (next test); the port departs from it on purpose (ROADMAP.md §3)."""
    from repro_torch.data import pipeline as T_pipe

    poisoned_at, n = 2, 6
    plan = t_plan(engine=engine, shards=shards, compact=True,
                  capacity="auto", tokenize=T.TokenizeSpec(1000, 1))
    per_shard = [batches(n * shards, rows=2048,
                         drift=T_stream.DriftConfig("regime", 4096, 1.5))
                 [i::shards] for i in range(shards)]
    bad = [list(b) for b in per_shard]
    bad[shards - 1][poisoned_at] = bad[shards - 1][poisoned_at].copy()
    bad[shards - 1][poisoned_at][0, 5] = np.nan
    clean = [b[:poisoned_at] + b[poisoned_at + 1:] for b in per_shard]
    lm = dict(batch_size=2, seq_len=31, vocab_size=1000, tokens_per_row=1)

    def pipeline(session, streams):
        if shards == 1:
            return T_pipe.Pipeline(_list_stream(streams[0]), session, **lm)
        return T_pipe.ShardedPipeline([_list_stream(s) for s in streams],
                                      session, **lm)

    guard = T_rt.GuardedSession(t_session(plan), policy())
    got = list(pipeline(guard, bad))
    want = list(pipeline(t_session(plan), clean))
    assert guard.health.quarantined == 1
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_array_equal(g["labels"], w["labels"])


def test_repro_still_stops_on_a_quarantined_tokenize_batch():
    """The reference keeps its behaviour: its quarantined result of a
    tokenize plan has no tokens, so ``host_tokens`` raises."""
    cols = batches(1, rows=128)[0].copy()
    cols[0, 3] = np.nan
    r_guard = R_rt.GuardedSession(
        R.build_session(r_plan(compact=True,
                               tokenize=R.TokenizeSpec(1000, 1))),
        policy(R_rt))
    _, res = r_guard.step(r_guard.init_state(), cols)
    assert res.quarantined
    with pytest.raises(ValueError, match="no tokenize stage"):
        res.host_tokens()
    t_guard = T_rt.GuardedSession(
        t_session(t_plan(compact=True, tokenize=T.TokenizeSpec(1000, 1))),
        policy())
    _, res = t_guard.step(t_guard.init_state(), cols)
    assert res.quarantined and res.host_tokens().size == 0
    assert int(res.n_tokens) == 0 and int(res.n_kept) == 0
    assert res.survivors().shape == (3, 0)
