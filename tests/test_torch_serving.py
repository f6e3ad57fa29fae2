"""The admission server, its traffic and its CLI in the port, against repro.

* TRAFFIC — ``repro_torch.serving.traffic`` and ``RequestStream`` give
  the same bytes as ``repro``'s for the same arguments, and the mix drifts.
* DECISIONS — the port's queued server (``torch`` and ``cuda`` engines;
  on the CPU the ``cuda`` engine runs its kernels' twins) admits and
  rejects exactly the requests ``repro``'s ``synchronous_reference``
  does, and ends in the same state (float accumulators to rtol 1e-6,
  everything else bit for bit); against the port's own synchronous
  reference it is bit-identical, a warmup and a restored state included.
* ACCOUNTING, BACKPRESSURE, DRAIN — every request answered exactly once,
  bounded queues block, a stop request (a real SIGTERM through
  ``GracefulShutdown`` too) drains in-flight work and flushes the state.
* The CLI (``repro_torch.launch.serve``) on the CPU with ``--bench-out``
  under ``tmp_path``; without ``--device`` it targets ``cuda``.
"""

import dataclasses
import functools
import json
import os
import signal
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.serving as R_srv  # noqa: E402
from repro.data import stream as R_stream  # noqa: E402
from repro.serving import traffic as R_traffic  # noqa: E402

import repro_torch.core as T  # noqa: E402
import repro_torch.serving as T_srv  # noqa: E402
from repro_torch.core import session as T_session  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime import (DataFaultInjector, GracefulShutdown,  # noqa: E402
                                 GuardedSession)
from repro_torch.serving import traffic as T_traffic  # noqa: E402
from repro_torch.serving import (REASON_ADMITTED, REASON_QUARANTINED,  # noqa: E402
                                 REASON_REJECTED, AdmissionServer,
                                 ServerConfig, SimExecutor,
                                 synchronous_reference)

ORDER = dict(collect_rate=4, calculate_rate=256, momentum=0.3)
FLOAT_ARRAYS = ("adj_rank", "stats.num_cut", "stats.cost_acc",
                "stats.n_monitored", "stats.group_cut")


def t_plan(engine="torch", **order):
    return T.FilterPlan(predicates=T_srv.guardrail_chain(),
                        ordering=T.OrderingConfig(**(ORDER | order)),
                        engine=engine)


def r_plan(**order):
    return R.FilterPlan(predicates=R_srv.guardrail_chain(),
                        ordering=R.OrderingConfig(**(ORDER | order)),
                        engine="jnp")


def t_session(engine="torch", **order):
    return T.build_session(t_plan(engine, **order), device="cpu")


def traffic(seed=3, phase_requests=256):
    return T_srv.TrafficConfig(seed=seed, phase_requests=phase_requests)


def t_stream(tcfg, requests, batch):
    return T_srv.TrafficGenerator(tcfg).stream(requests, batch)


def r_stream(tcfg, requests, batch):
    rcfg = R_srv.TrafficConfig(**dataclasses.asdict(tcfg))
    return R_stream.RequestStream(R_srv.TrafficGenerator(rcfg).gen,
                                  total_rows=requests, batch_rows=batch)


def assert_masks_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for b in want:
        np.testing.assert_array_equal(got[b], want[b], err_msg=f"batch {b}")


def assert_blob_matches(got: dict, want: dict, exact: bool) -> None:
    a, b = got["arrays"], want["arrays"]
    assert set(a) == set(b)
    for k in b:
        g, w = np.asarray(a[k]), np.asarray(b[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in FLOAT_ARRAYS and not exact:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def check_accounting(report):
    """Every ingested request answered exactly once, with a known reason."""
    m = report.metrics
    ids = [r.request_id for r in report.results]
    assert len(ids) == len(set(ids)), "a request was answered twice"
    assert len(ids) == m["requests"]
    by = {REASON_ADMITTED: 0, REASON_REJECTED: 0, REASON_QUARANTINED: 0}
    for r in report.results:
        by[r.reason] += 1
    assert by[REASON_ADMITTED] == m["admitted"] == m["completed"]
    assert by[REASON_REJECTED] == m["rejected"]
    assert by[REASON_QUARANTINED] == m["quarantined"]


@functools.lru_cache(maxsize=None)
def repro_reference(requests, batch, seed=3, phase_requests=256, **order):
    """repro's synchronous reference (jnp) over the seeded traffic."""
    sess = R.build_session(r_plan(**order))
    state, masks = R_srv.synchronous_reference(
        sess, r_stream(traffic(seed, phase_requests), requests, batch))
    return masks, sess.save_state(state)


# ================================================================= traffic
def test_guardrail_chain_matches_repro():
    got, want = T_srv.guardrail_chain(), R_srv.guardrail_chain()
    assert [dataclasses.asdict(p) for p in got] \
        == [dataclasses.asdict(p) for p in want]


@pytest.mark.parametrize("seed,phase_requests,b,n_rows", [
    (0, 2048, 0, 64), (3, 256, 5, 64), (3, 256, 11, 100), (9, 100, 40, 7)])
def test_traffic_matches_repro_bit_for_bit(seed, phase_requests, b, n_rows):
    tcfg = T_srv.TrafficConfig(seed=seed, phase_requests=phase_requests,
                               n_users=1 << 16)
    rcfg = R_srv.TrafficConfig(**dataclasses.asdict(tcfg))
    feats, users = T_srv.gen_requests_with_users(tcfg, b, b * n_rows, n_rows)
    r_feats, r_users = R_srv.gen_requests_with_users(rcfg, b, b * n_rows,
                                                     n_rows)
    assert feats.dtype == np.float32 and users.dtype == np.int64
    np.testing.assert_array_equal(feats, r_feats)
    np.testing.assert_array_equal(users, r_users)
    np.testing.assert_array_equal(
        T_srv.TrafficGenerator(tcfg).gen(b, b * n_rows, n_rows), r_feats)
    for row in (0, 99, 5000, 9000):
        assert T_srv.phase_of(tcfg, row) == R_srv.phase_of(rcfg, row)
    np.testing.assert_array_equal(
        T_traffic._user_hash(users), R_traffic._user_hash(users))


def test_traffic_config_validation():
    with pytest.raises(ValueError, match="phase_requests"):
        T_srv.TrafficConfig(phase_requests=0)
    with pytest.raises(ValueError, match="summing to 1"):
        T_srv.TrafficConfig(mix=((0.5, 0.5, 0.5),))


def test_traffic_three_phases_drift():
    cfg = traffic(phase_requests=4096)
    rows = {p: T_srv.gen_requests(cfg, p, p * 4096, 4096) for p in range(3)}
    allow = {p: (rows[p][T_traffic.COL_ALLOW] > 0.5).mean() for p in rows}
    abuse = {p: (rows[p][T_traffic.COL_ABUSE] >= 0.92).mean() for p in rows}
    long_ = {p: (rows[p][T_traffic.COL_PROMPT_LEN] >= 900.0).mean()
             for p in rows}
    assert allow[2] > allow[0] + 0.3, allow
    assert abuse[1] > abuse[0] + 0.1, abuse
    assert long_[1] > long_[0] + 0.15, long_


def test_request_stream_restartable_and_matches_repro():
    cfg = traffic()
    s1 = t_stream(cfg, 8 * 64 + 5, 64)             # ragged tail dropped
    assert s1.n_batches == 8
    it = iter(s1)
    for _ in range(3):
        next(it)
    snap = s1.state()
    rest1 = [rb.columns for rb in it]
    s2 = T_stream.RequestStream(T_srv.TrafficGenerator(cfg).gen,
                                total_rows=8 * 64, batch_rows=64)
    s2.restore(snap)
    rest2 = list(s2)
    want = list(r_stream(cfg, 8 * 64, 64))[3:]
    assert len(rest1) == len(rest2) == len(want) == 5
    for a, b, w in zip(rest1, rest2, want):
        np.testing.assert_array_equal(a, b.columns)
        np.testing.assert_array_equal(a, w.columns)
        assert b.row_offset == w.row_offset
    with pytest.raises(ValueError, match="at least one batch"):
        t_stream(cfg, 10, 64)
    late = T_srv.TrafficGenerator(cfg).stream(8 * 64, 64, start_batch=3)
    assert [rb.row_offset for rb in late] == [b.row_offset for b in want]


def test_weighted_quantile_and_snapshot_match_repro():
    pairs = [(0.3, 5), (0.1, 64), (0.2, 1), (0.9, 3)]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert T_srv.weighted_quantile(pairs, q) \
            == R_srv.weighted_quantile(pairs, q)
    assert T_srv.weighted_quantile([], 0.5) == 0.0
    ms = [T_srv.ServerMetrics(), R_srv.ServerMetrics()]
    for m in ms:
        m.note_ingest(64)
        m.note_decision(40, 20, 4, 0.25, 0.01)
        m.note_tick(3, 8)
        m.note_completion(2)
    assert ms[0].snapshot(2.0) == ms[1].snapshot(2.0)


# ====================================================== server determinism
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_server_matches_repro_synchronous_reference(engine):
    """The acceptance pin: the port's queued, threaded, slot-packed server
    admits exactly what repro's synchronous reference admits and ends in
    its state; against the port's own synchronous reference it is
    bit-identical, and a second run equals the first."""
    tcfg = traffic()
    want_masks, want_blob = repro_reference(768, 64)

    def run_server():
        return AdmissionServer(t_session(engine), t_stream(tcfg, 768, 64),
                               ServerConfig(num_slots=4,
                                            queue_depth=4)).run()

    reports = [run_server(), run_server()]
    ref_session = t_session(engine)
    ref_state, ref_masks = synchronous_reference(ref_session,
                                                 t_stream(tcfg, 768, 64))
    assert_masks_equal(ref_masks, want_masks)
    for rep in reports:
        assert_masks_equal(rep.masks, want_masks)
        assert_blob_matches(rep.state_blob, want_blob, exact=False)
        assert_blob_matches(rep.state_blob, ref_session.save_state(ref_state),
                            exact=True)
        check_accounting(rep)
    by_id = reports[0].results_by_id()
    for b, mask in want_masks.items():
        for off, bit in enumerate(mask.tolist()):
            assert by_id[b * 64 + off].reason == (
                REASON_ADMITTED if bit else REASON_REJECTED)
    assert all(r.decode_steps >= 1 for r in reports[0].results
               if r.reason == REASON_ADMITTED)
    m = reports[0].metrics
    assert m["slot_occupancy"] > 0.0 and m["guard"] is None
    assert m["admission_latency_ms"]["p99"] \
        >= m["admission_latency_ms"]["p50"] >= 0.0


def test_warmup_then_a_restored_state_decides_as_without_warmup():
    """The warmup steps a throwaway state, which re-anchors the session's
    host row mirror; a restored mid-epoch state handed to ``run`` must then
    take the foreign-state path and step as it would without the warmup."""
    tcfg = traffic()
    pre = t_session()
    state = pre.init_state()
    for rb in t_stream(tcfg, 3 * 64, 64):          # 192 rows: mid-epoch
        state, _ = pre.step(state, rb.columns)
    blob = pre.save_state(state)
    assert int(blob["arrays"]["rows_into_epoch"]) == 192

    session = t_session()
    restored = session.restore_state(blob)
    server = AdmissionServer(
        session, t_stream(tcfg, 640, 64), ServerConfig(num_slots=4),
        warmup_batch=T_srv.gen_requests(tcfg, 0, 0, 64))
    report = server.run(state=restored)

    ref = t_session()
    ref_state, ref_masks = ref.restore_state(blob), {}
    for rb in t_stream(tcfg, 640, 64):
        ref_state, res = ref.step(ref_state, rb.columns)
        ref_masks[rb.row_offset // 64] = res.mask_np
    assert_masks_equal(report.masks, ref_masks)
    assert_blob_matches(report.state_blob, ref.save_state(ref_state),
                        exact=True)
    check_accounting(report)


def test_guarded_server_quarantines_with_reason_codes():
    tcfg = traffic()
    server = AdmissionServer(
        GuardedSession(t_session("cuda")), t_stream(tcfg, 512, 64),
        ServerConfig(num_slots=4), batch_hook=DataFaultInjector(
            poison_at=(2,)))
    report = server.run()
    check_accounting(report)
    by_id = report.results_by_id()
    assert all(by_id[2 * 64 + off].reason == REASON_QUARANTINED
               for off in range(64))
    assert not report.masks[2].any()
    g = report.metrics["guard"]
    assert g["quarantined"] == 1 and g["steps"] == 7
    assert g["rungs"]["engine"] == "cuda" and g["degrades"] == []
    assert report.health_line and "quarantined=1" in report.health_line
    want_masks, _ = repro_reference(512, 64)
    for b, mask in want_masks.items():
        if b != 2:
            np.testing.assert_array_equal(report.masks[b], mask)


# ============================================================ backpressure
def test_backpressure_bounded_queues_never_drop():
    server = AdmissionServer(
        t_session(), t_stream(traffic(), 20 * 16, 16),
        ServerConfig(num_slots=2, queue_depth=1, max_backlog=4),
        executor=SimExecutor(max_decode_steps=4, tick_s=0.001))
    report = server.run()
    check_accounting(report)
    assert report.metrics["requests"] == 20 * 16
    assert len(server._backlog) == 0
    assert server.request_q.empty() and server.result_q.empty()


# =================================================================== drain
def test_drain_on_stop_finishes_inflight():
    stop = types.SimpleNamespace(requested=False)

    def hook(b, cols):
        if b == 3:
            stop.requested = True
        return cols

    total = 64 * 32
    server = AdmissionServer(
        t_session(), t_stream(traffic(), total, 32),
        ServerConfig(num_slots=4, queue_depth=4), batch_hook=hook)
    report = server.run(stop=stop)
    assert report.drained
    check_accounting(report)
    assert 0 < report.metrics["requests"] < total
    assert all(r.decode_steps >= 1 for r in report.results
               if r.reason == REASON_ADMITTED)
    restored = t_session().restore_state(report.state_blob)
    assert t_session().validate_state(restored)


def test_sigterm_drains_and_flushes():
    """A real SIGTERM through GracefulShutdown mid-run: the server drains
    (slots finish, accounting exact) and flushes the final checkpoint and
    health line instead of dying with work in flight."""
    server = AdmissionServer(
        GuardedSession(t_session()), t_stream(traffic(), 256 * 16, 16),
        ServerConfig(num_slots=4, queue_depth=4),
        executor=SimExecutor(max_decode_steps=8, tick_s=0.002))
    timer = threading.Timer(
        0.3, lambda: os.kill(os.getpid(), signal.SIGTERM))
    stop = GracefulShutdown()
    with stop:
        timer.start()
        report = server.run(stop=stop)
    timer.cancel()
    assert stop.requested and report.drained
    check_accounting(report)
    assert report.metrics["requests"] < 256 * 16
    assert report.state_blob is not None and report.health_line is not None


# ================================================================= the CLI
CLI = ["--smoke", "--requests", "192", "--batch", "32", "--slots", "4",
       "--gate-rps", "1", "--gate-p99-ms", "600000"]


def test_serve_cli_on_cpu_matches_repro(tmp_path, monkeypatch):
    """The CLI on the CPU: the parity gate passes, the payload lands only
    where ``--bench-out`` says, and the admissions and final state equal
    repro's synchronous reference over the CLI's traffic and plan."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "serve.json"
    done = serve.run(CLI + ["--device", "cpu", "--bench-out", str(out)])
    assert done.rc == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["serve.json"]
    payload = json.loads(out.read_text())
    assert payload == json.loads(json.dumps(done.payload))
    assert payload["parity"]["ok"] is True
    assert payload["requests_per_sec"] > 0
    assert payload["guard"]["steps"] == 6
    assert payload["guard"]["rungs"]["engine"] == "cuda"
    assert set(payload["config"]["phases_seen"]) == {0, 1, 2}
    assert payload["config"]["device"] == "cpu"
    assert payload["decided"] == payload["requests"] == 192

    want_masks, want_blob = repro_reference(
        192, 32, seed=0, phase_requests=64, collect_rate=4,
        calculate_rate=64)
    assert_masks_equal(done.report.masks, want_masks)
    assert_blob_matches(done.report.state_blob, want_blob, exact=False)
    assert serve.main(CLI + ["--device", "cpu"]) == 0   # writes nothing
    assert sorted(p.name for p in tmp_path.iterdir()) == ["serve.json"]


def test_serve_cli_targets_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(T_session.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(CLI)


def test_serve_cli_model_executor_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 11"):
        serve.main(CLI + ["--executor", "model"])
