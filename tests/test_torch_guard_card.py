"""The guarded session and the serve CLI on the card (``gpu``-marked;
they skip without a CUDA device).

The machine with the card has no JAX, so this file imports only the port:
a clean guarded ``cuda`` run never degrades and launches every kernel of
its plan; a step fault walks the ladder down and, once it clears, back up
to the kernels, with the masks of an unguarded run throughout; quarantine
and ``corrupt_state`` keep their tensors on the card; the serve CLI's
decisions on the card equal those on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
import repro_torch.runtime as T_rt  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402
from repro_torch.kernels.filter_chain import filter_chain as tfc  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

pytestmark = pytest.mark.gpu

TOP = dict(engine="cuda", skip_tier="zonemap", compact=True, capacity=3000)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def plan(**kw):
    return T.FilterPlan(T.paper_filters_cnf("fig1"),
                        T.OrderingConfig(collect_rate=32,
                                         calculate_rate=16384, momentum=0.3),
                        **kw)


def batches(n, rows=8192):
    return [rb.columns for rb in T_stream.LogStream(
        n * rows, rows, seed=0, layout="clustered",
        drift=T_stream.DriftConfig("regime", period_rows=20_000))]


def launches():
    return (tfc.filter_chain_kernel.launches,
            tfc.filter_chain_kernel.skip_launches,
            tfc.compact_gather_kernel.launches, tfc.tile_stats_kernel.launches)


def unguarded_masks(p, cols_list, dev):
    sess = T.build_session(p, device=dev)
    state, masks = sess.init_state(), []
    for cols in cols_list:
        state, res = sess.step(state, cols)
        masks.append(res.mask)
    return masks, sess.save_state(state)["arrays"]


@pytest.mark.parametrize("feed", ["host", "device"])
def test_clean_guarded_cuda_run_never_degrades(cuda, feed):
    cols_list = batches(6)
    if feed == "device":
        cols_list = [torch.from_numpy(c).to(cuda) for c in cols_list]
    want, want_arrays = unguarded_masks(plan(**TOP), cols_list, cuda)
    guard = T_rt.GuardedSession(
        T.build_session(plan(**TOP)),
        T_rt.GuardPolicy(validate_every=1, checkpoint_every=2,
                         promote_after=2))
    tfc.reset_launch_counts()
    state = guard.init_state()
    for cols, mask in zip(cols_list, want):
        state, res = guard.step(state, cols)
        assert res.mask.device.type == "cuda" and torch.equal(res.mask, mask)
    assert launches() == (6, 6, 6, 6)
    h = guard.health
    assert h.degrades == [] and h.promotes == [] and h.retries == 0
    assert h.overflow_events == 0 and h.steps == 6
    arrays = guard.save_state(state)["arrays"]
    for k, v in want_arrays.items():
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)


def test_ladder_walks_down_and_back_up_on_card(cuda):
    fault = {"left": 6}

    def injector(i):
        if i >= 1 and fault["left"] > 0:
            fault["left"] -= 1
            raise RuntimeError("device fault")

    cols_list = [torch.from_numpy(c).to(cuda) for c in batches(10)]
    want, _ = unguarded_masks(plan(**TOP), cols_list, cuda)
    guard = T_rt.GuardedSession(
        T.build_session(plan(**TOP)),
        T_rt.GuardPolicy(max_retries=1, validate_every=1, promote_after=2,
                         sleep=lambda d: None),
        step_injector=injector)
    state = guard.init_state()
    at_promotion = None
    for b, (cols, mask) in enumerate(zip(cols_list, want)):
        before = launches()
        state, res = guard.step(state, cols)
        assert torch.equal(res.mask, mask), b
        assert guard.session.device.type == "cuda"
        if b == 1:                     # the bottom rung: torch, no kernels
            assert guard.session.plan.engine == "torch"
            assert launches() == before
        if len(guard.health.promotes) == 3 and at_promotion is None:
            at_promotion = launches()
    h = guard.health
    assert [e["changes"] for e in h.degrades] == [
        {"engine": "torch"}, {"skip_tier": "off"},
        {"compact": "False", "capacity": "None"}]
    assert [e["changes"] for e in h.promotes] == [
        {"compact": "True", "capacity": "3000"}, {"skip_tier": "zonemap"},
        {"engine": "cuda"}]
    assert guard.health_snapshot()["rungs"] == {
        "engine": "cuda", "skip_tier": "zonemap", "compact": True,
        "capacity": "3000", "degrade_depth": 0}
    after = launches()
    assert all(a > p for a, p in zip(after, at_promotion)), (at_promotion,
                                                              after)


def test_quarantine_and_corrupt_state_stay_on_card(cuda):
    sess = T.build_session(plan(engine="cuda"))
    guard = T_rt.GuardedSession(sess, T_rt.GuardPolicy())
    state = guard.init_state()
    cols = torch.from_numpy(batches(1)[0]).to(cuda)
    state, _ = guard.step(state, cols)
    bad_cols = cols.clone()
    bad_cols[1, 7] = float("nan")
    same, res = guard.step(state, bad_cols)
    assert same is state and res.quarantined
    assert res.mask.device.type == "cuda" and not bool(res.mask.any())
    assert res.metrics_dict()["n_pass"] == 0
    for kind in T_rt.STATE_CORRUPTIONS:
        bad = T_rt.corrupt_state(state, kind)
        assert all(t.device.type == "cuda" for t in
                   (bad.perm, bad.adj_rank, bad.stats.num_cut, bad.epoch))
        assert not sess.validate_state(bad), kind
    assert sess.validate_state(state)


def test_serve_cli_on_card_equals_cpu(cuda, tmp_path):
    argv = ["--guarded", "--requests", "512", "--batch", "32"]
    card = serve.run(argv + ["--bench-out", str(tmp_path / "card.json")])
    cpu = serve.run(argv + ["--device", "cpu"])
    assert card.rc == cpu.rc == 0
    assert card.payload["config"]["device"].startswith("cuda")
    assert card.payload["guard"]["degrades"] == []
    assert set(card.report.masks) == set(cpu.report.masks)
    for b, mask in cpu.report.masks.items():
        np.testing.assert_array_equal(card.report.masks[b], mask)
    for k, v in cpu.report.state_blob["arrays"].items():
        np.testing.assert_array_equal(card.report.state_blob["arrays"][k], v,
                                      err_msg=k)
