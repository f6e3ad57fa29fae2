"""The paper's host reference path in the port against ``repro``'s.

On the same seeded numpy inputs: the port's ``np_exec`` against
``repro.core.np_exec`` (flat and CNF chains, every op with HASHMIX and EQ
at .5 ties, random group-contiguous perms); its ``numpy`` engine against
``repro``'s, with and without the skip tier (the +inf Bloom-key case of
ROADMAP §3 included); ``AdaptiveFilter(predicates, AdaptiveFilterConfig
(...)).process_stream`` and ``static_filter`` on ``numpy`` in every scope
and exchange mode, on ``torch`` (``device="cpu"``) against ``repro``'s
``jnp`` with and without compaction, the port's ``numpy`` against its
``torch``, and ``cost_mode="measured"`` under one fake clock; a session
of an ``engine="numpy"`` plan; and the guard's rungs for such a plan.
Masks, perms, epochs, ``n_pass``, survivors and tile counters are
bit-exact; ``work_units`` between a host and a device engine within rel
1e-5 (``repro``'s own host-vs-device tolerance); ``adj_rank`` rtol 1e-5.
The ``cuda`` engine against ``numpy`` on the card is in
``test_torch_host_paths_card.py`` (``gpu``-marked, no JAX there).
"""

import dataclasses
import itertools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.runtime as R_rt  # noqa: E402
from repro.core import np_exec as R_np_exec  # noqa: E402
from repro.core import ordering as R_ordering  # noqa: E402
from repro.core import predicates as R_pred  # noqa: E402

import repro_torch.core as T  # noqa: E402
import repro_torch.runtime as T_rt  # noqa: E402
from repro_torch.core import np_exec as T_np_exec  # noqa: E402
from repro_torch.core import ordering as T_ordering  # noqa: E402
from repro_torch.core import predicates as T_pred  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402

BATCH = 8192
N_BATCHES = 8
ORDER = dict(collect_rate=16, calculate_rate=16384, momentum=0.3)
DRIFT = dict(kind="regime", period_rows=16384, amplitude=1.5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stream(layout="iid", n=N_BATCHES, rows=BATCH):
    """The port's batches (its generator gives ``repro``'s bytes, pinned
    in test_torch_session.py / test_torch_skip_tier.py)."""
    return [T_stream.gen_batch(0, b, b * rows, rows,
                               T_stream.DriftConfig(**DRIFT), layout=layout)
            for b in range(n)]


# ================================================================ chains
def all_ops(mod):
    """Every op, HASHMIX and an EQ whose target is a .5 tie (round half to
    even: 2.5 → 2), with an OR group of three."""
    return [
        mod.Predicate("gt", 0, mod.OP_GT, -1.5),
        mod.Predicate("eq", 1, mod.OP_EQ, 2.5, group="or"),
        mod.Predicate("lt", 2, mod.OP_LT, 0.5, group="or"),
        mod.Predicate("mix", 1, mod.OP_HASHMIX, 0.4 * mod.MIX_MOD,
                      rounds=3, static_cost=4.0, group="or"),
        mod.Predicate("between", 2, mod.OP_BETWEEN, -3.0, 3.5,
                      static_cost=1.5),
    ]


CHAINS = {
    "flat": lambda mod: mod.paper_filters_4("fig1"),
    "cnf": lambda mod: mod.paper_filters_cnf("fig1"),
    "all_ops": all_ops,
}


def tie_columns(n_rows, seed):
    """f32[3, R] of halves in [-8, 8]: most EQ / BETWEEN comparisons sit
    on a .5 tie or a threshold."""
    r = np.random.default_rng(seed)
    return (r.integers(-16, 17, (3, n_rows)) / 2.0).astype(np.float32)


def group_contiguous_perm(groups, rng):
    """A random perm that keeps every group's members together."""
    members = T_pred.group_members(tuple(groups))
    return [i for g in rng.permutation(len(members))
            for i in rng.permutation(members[g])]


# =============================================================== np_exec
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_np_exec_matches_repro(chain):
    r_preds, t_preds = CHAINS[chain](R_pred), CHAINS[chain](T_pred)
    groups = T_pred.normalize_groups(t_preds)
    assert groups == R_pred.normalize_groups(r_preds)
    rng = np.random.default_rng(7)
    inputs = [stream()[0], tie_columns(3001, 1)]
    if chain == "all_ops":
        inputs = inputs[1:] + [tie_columns(777, 2)]
    for cols, _ in itertools.product(inputs, range(3)):
        perm = group_contiguous_perm(groups, rng)
        want = R_np_exec.run_chain_np(cols, r_preds, perm, groups=groups)
        got = T_np_exec.run_chain_np(cols, t_preds, perm, groups=groups)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2].dtype == want[2].dtype == np.float32
        for phase in (0, 5):
            w = R_np_exec.run_monitor_np(cols, r_preds, 7, phase,
                                         groups=groups)
            g = T_np_exec.run_monitor_np(cols, t_preds, 7, phase,
                                         groups=groups)
            for a, b in zip(g[:3], w[:3]):
                np.testing.assert_array_equal(a, b)
    split = [1, 0, 2, 4, 3] if chain == "all_ops" else [3, 0, 1, 2]
    if len(set(groups)) < len(groups):          # an OR group to split
        for mod, preds in ((R_np_exec, r_preds), (T_np_exec, t_preds)):
            with pytest.raises(ValueError, match="contiguous"):
                mod.run_chain_np(inputs[0], preds, split, groups=groups)


# ======================================================== numpy engine
def _engine_result(mod, preds, cols, perm, *, skip_tier="off", phase=3):
    """One ``numpy``-engine call of either package: ``repro``'s through
    ``run_chain_skip`` (its own triage), the port's through ``triage`` and
    ``run_chain(skip=...)``."""
    eng, specs = mod.get_engine("numpy"), mod.pack(preds)
    mon = mod.MonitorSpec(collect_rate=ORDER["collect_rate"],
                          sample_phase=phase)
    if skip_tier == "off":
        return eng.run_chain(cols, specs, np.asarray(perm, np.int32), mon)
    bloom = skip_tier == "zonemap+bloom"
    if mod is R:
        return eng.run_chain_skip(cols, specs, np.asarray(perm, np.int32),
                                  mon, bloom=bloom)
    skip = eng.triage(cols, specs, bloom=bloom)
    return eng.run_chain(cols, specs, torch.tensor(perm, dtype=torch.int32),
                         mon, skip=skip)


def assert_results_equal(got, want):
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=f)
        assert np.asarray(g).dtype == np.asarray(w).dtype, f


def inf_tile_case():
    """A clustered batch whose column 1 holds, in tile 5, values in
    [200, 300] with no round(x) ≡ 0 mod 128 (so no 256) and one +inf;
    the EQ target 256.0 has Bloom key 0. Under numpy +inf sets no bit and
    the tile provably fails; under XLA:CPU it sets bit 0: ambiguous."""
    cols = stream("clustered")[0].copy()
    r = np.random.default_rng(3)
    vals = r.uniform(200.0, 300.0, 128).astype(np.float32)
    vals[np.round(vals) == 256.0] = 250.0
    vals[17] = np.inf
    cols[1, 5 * 128:6 * 128] = vals
    preds = [T_pred.Predicate("date_gt", 0, T_pred.OP_GT, -1e9),
             T_pred.Predicate("int_eq", 1, T_pred.OP_EQ, 256.0,
                              group="g"),
             T_pred.Predicate("int_lt", 1, T_pred.OP_LT, -1e9, group="g")]
    return cols, preds


@pytest.mark.parametrize("skip_tier", ["off", "zonemap", "zonemap+bloom"])
@pytest.mark.parametrize("case", ["cnf", "all_ops", "chain_clustered",
                                  "inf_tile"])
def test_numpy_engine_matches_repro(case, skip_tier):
    if case == "inf_tile":
        cols, t_preds = inf_tile_case()
        r_preds = [R_pred.Predicate(**dataclasses.asdict(p))
                   for p in t_preds]
    else:
        chain = "all_ops" if case == "all_ops" else "cnf"
        r_preds, t_preds = CHAINS[chain](R_pred), CHAINS[chain](T_pred)
        cols = tie_columns(5000, 4) if case == "all_ops" \
            else stream("clustered" if case == "chain_clustered"
                        else "iid")[1]
    groups = T_pred.normalize_groups(t_preds)
    rng = np.random.default_rng(11)
    for _ in range(2):
        perm = group_contiguous_perm(groups, rng)
        want = _engine_result(R, r_preds, cols, perm, skip_tier=skip_tier)
        got = _engine_result(T, t_preds, cols, perm, skip_tier=skip_tier)
        assert_results_equal(got, want)
    if skip_tier != "off" and case == "chain_clustered":
        assert int(got.n_tiles_fail) + int(got.n_tiles_pass) > 0


def test_inf_bloom_key_splits_repro_engines_and_the_port_follows_each():
    """ROADMAP §3: on the +inf tile, ``repro``'s numpy engine proves the
    tile fails (+inf sets no Bloom bit) where its jnp engine leaves it
    ambiguous (XLA:CPU sets bit 0); masks agree. The port's ``numpy``
    engine follows the first, its ``torch`` engine the second (one step of
    a session of each package, statement order, phase 0)."""
    cols, t_preds = inf_tile_case()
    r_preds = [R_pred.Predicate(**dataclasses.asdict(p)) for p in t_preds]
    perm = [0, 1, 2]
    r_np = _engine_result(R, r_preds, cols, perm, skip_tier="zonemap+bloom",
                          phase=0)
    t_np = _engine_result(T, t_preds, cols, perm, skip_tier="zonemap+bloom",
                          phase=0)
    kw = dict(skip_tier="zonemap+bloom")
    _, r_dev = R.build_session(R.FilterPlan(r_preds, engine="jnp", **kw)) \
        .step(R.build_session(R.FilterPlan(r_preds, **kw)).init_state(),
              cols)
    t_sess = T.build_session(T.FilterPlan(t_preds, engine="torch", **kw),
                             device="cpu")
    _, t_dev = t_sess.step(t_sess.init_state(), torch.from_numpy(cols))

    def tiles(res):
        if hasattr(res, "n_tiles_skipped_pass"):        # a StepResult
            return [res.n_tiles_skipped_pass, res.n_tiles_skipped_fail,
                    res.n_tiles_ambiguous]
        return [int(res.n_tiles_pass), int(res.n_tiles_fail),
                int(res.n_tiles_ambiguous)]

    np.testing.assert_array_equal(r_np.mask, r_dev.mask_np)
    assert tiles(r_np)[1] == tiles(r_dev)[1] + 1
    assert not r_np.mask[5 * 128:6 * 128].any()
    np.testing.assert_array_equal(t_np.mask, r_np.mask)
    np.testing.assert_array_equal(t_dev.mask_np, r_dev.mask_np)
    assert tiles(t_np) == tiles(r_np)
    assert tiles(t_dev) == tiles(r_dev)


# ======================================================= process_stream
@pytest.fixture
def adj_ranks(monkeypatch):
    """Records the ``adj_rank`` of every state ``ordering.advance`` and
    ``boundary_update`` return, per package (the host loops call them
    through the module)."""
    seen = {"repro": [], "port": []}
    for key, mod in (("repro", R_ordering), ("port", T_ordering)):
        for name in ("advance", "boundary_update"):
            def wrap(*a, _f=getattr(mod, name), _out=seen[key], **kw):
                out = _f(*a, **kw)
                _out.append(_np(out.adj_rank).copy())
                return out
            monkeypatch.setattr(mod, name, wrap)
    return seen


def _drive(filt, batches):
    return [(_np(s), _np(m), d) for s, m, d in filt.process_stream(batches)]


def assert_streams_equal(got, want, *, work_rtol=0.0):
    assert len(got) == len(want)
    for i, ((gs, gm, gd), (ws, wm, wd)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gm, wm, err_msg=f"mask, batch {i}")
        np.testing.assert_array_equal(gs, ws, err_msg=f"rows, batch {i}")
        for k in ("perm", "epoch", "n_pass", "n_dropped",
                  "n_tiles_skipped_pass", "n_tiles_skipped_fail",
                  "n_tiles_ambiguous"):
            assert gd[k] == wd[k], (k, i)
        assert gd["work_units"] == pytest.approx(wd["work_units"],
                                                 rel=work_rtol), i


HOST_CASES = [
    ("adaptive", "per_shard", "eager", "off"),
    ("adaptive", "per_batch", "eager", "off"),
    ("adaptive", "centralized", "eager", "off"),
    ("adaptive", "centralized", "deferred", "off"),
    ("adaptive", "centralized", "deferred-async", "off"),
    ("adaptive", "per_shard", "eager", "zonemap+bloom"),
    ("static", "per_shard", "eager", "off"),
    ("static", "per_shard", "eager", "zonemap"),
]


@pytest.mark.parametrize("kind,scope,exchange,tier", HOST_CASES)
def test_numpy_stream_matches_repro(adj_ranks, kind, scope, exchange, tier):
    """``process_stream`` on ``numpy``: adaptive from a shuffled statement
    order, and ``static_filter`` over a non-identity order; the skip tier
    on clustered batches."""
    batches = stream("clustered" if tier != "off" else "iid")
    runs = {}
    for key, mod, pm in (("repro", R, R_pred), ("port", T, T_pred)):
        preds = pm.paper_filters_cnf("fig1")
        if kind == "static":
            filt = mod.static_filter(preds, order=[3, 2, 0, 1],
                                     backend="numpy")
            if tier != "off":
                filt = mod.AdaptiveFilter(
                    [preds[i] for i in (3, 2, 0, 1)],
                    mod.AdaptiveFilterConfig(backend="numpy",
                                             adaptive=False,
                                             skip_tier=tier))
        else:
            filt = mod.AdaptiveFilter(
                [preds[i] for i in (2, 3, 1, 0)],
                mod.AdaptiveFilterConfig(
                    ordering=mod.OrderingConfig(**ORDER), backend="numpy",
                    scope=scope, exchange=exchange, skip_tier=tier))
        runs[key] = _drive(filt, batches)
    assert_streams_equal(runs["port"], runs["repro"])
    assert len(adj_ranks["port"]) == len(adj_ranks["repro"])
    for g, w in zip(adj_ranks["port"], adj_ranks["repro"]):
        np.testing.assert_allclose(g, w, rtol=1e-5)
    perms = {tuple(d["perm"]) for _, _, d in runs["port"]}
    if kind == "adaptive":
        assert runs["port"][-1][2]["epoch"] >= 2 and len(perms) > 1
    else:
        assert perms == {(0, 1, 2, 3)}
    if tier != "off":
        assert any(d["n_tiles_skipped_fail"] for _, _, d in runs["port"])


@pytest.mark.parametrize("capacity", [None, 96, "auto"])
def test_torch_stream_matches_repro_jnp(capacity):
    """``process_stream`` through a fresh session: the port's ``torch`` on
    the CPU against ``repro``'s ``jnp``, compaction off and on."""
    batches = stream(n=6, rows=4096)
    kw = dict(compact_output=True, compact_capacity=capacity)
    runs = {}
    for key, mod, pm, engine in (("repro", R, R_pred, "jnp"),
                                 ("port", T, T_pred, "torch")):
        cfg = mod.AdaptiveFilterConfig(
            ordering=mod.OrderingConfig(**dict(ORDER, calculate_rate=8192)),
            backend=engine, **kw)
        extra = {"device": "cpu"} if mod is T else {}
        filt = mod.AdaptiveFilter(pm.paper_filters_cnf("fig1"), cfg,
                                  **extra)
        runs[key] = _drive(filt, batches)
    assert_streams_equal(runs["port"], runs["repro"], work_rtol=1e-5)
    if capacity == 96:
        assert any(d["n_dropped"] for _, _, d in runs["port"])
        assert all(s.shape[1] <= 96 for s, _, _ in runs["port"])
    assert runs["port"][-1][2]["epoch"] >= 2


def test_torch_static_filter_matches_repro_jnp():
    """``static_filter(..., backend="torch", device="cpu")`` over a
    non-identity order against ``repro``'s on ``jnp``."""
    batches = stream(n=4, rows=4096)
    runs = {}
    for key, mod, pm, engine in (("repro", R, R_pred, "jnp"),
                                 ("port", T, T_pred, "torch")):
        extra = {"device": "cpu"} if mod is T else {}
        filt = mod.static_filter(pm.paper_filters_cnf("fig1"),
                                 order=[3, 2, 0, 1], backend=engine,
                                 **extra)
        runs[key] = _drive(filt, batches)
    assert_streams_equal(runs["port"], runs["repro"], work_rtol=1e-5)
    assert {tuple(d["perm"]) for _, _, d in runs["port"]} == {(0, 1, 2, 3)}
    assert runs["port"][0][0].shape[1] < 4096


def test_filter_has_one_constructor():
    """A plan goes through ``AdaptiveFilterConfig.of``; a ``FilterPlan``
    or a positional device in the config's place raises a ``TypeError``
    that says so."""
    plan = T.FilterPlan(T.paper_filters_cnf(), T.OrderingConfig(**ORDER),
                        engine="numpy", cost_mode="measured",
                        skip_tier="zonemap", compact=False)
    cfg = T.AdaptiveFilterConfig.of(plan)
    assert cfg.backend == "numpy" and cfg.skip_tier == "zonemap"
    assert cfg.plan(plan.predicates) == plan
    sharded = dataclasses.replace(plan, engine="torch", skip_tier="off",
                                  cost_mode="static", shards=2)
    assert T.AdaptiveFilterConfig.of(sharded).plan(plan.predicates) == \
        dataclasses.replace(sharded, shards=1)
    with pytest.raises(TypeError, match="build_session"):
        T.AdaptiveFilter(plan, device="cpu")
    with pytest.raises(TypeError, match="keyword-only"):
        T.AdaptiveFilter(T.paper_filters_cnf(), "cpu")


@pytest.mark.parametrize("chain", ["flat", "cnf"])
def test_port_numpy_stream_matches_port_torch(chain):
    """The counterpart of ``test_host_stream_matches_jit_stream``: the
    port's host path against its own device path on the CPU."""
    preds = CHAINS[chain](T_pred)
    ordering = T.OrderingConfig(collect_rate=500, calculate_rate=100_000,
                                momentum=0.3)
    batches = [T_stream.gen_batch(0, b, b * 65536, 65536) for b in range(4)]
    out = {}
    for backend in ("torch", "numpy"):
        filt = T.AdaptiveFilter(preds, T.AdaptiveFilterConfig(
            backend=backend, ordering=ordering), device="cpu")
        out[backend] = _drive(filt, batches)
    assert_streams_equal(out["numpy"], out["torch"], work_rtol=1e-5)
    assert out["numpy"][-1][2]["epoch"] >= 2


def test_measured_costs_follow_repro_under_one_clock(monkeypatch):
    """``cost_mode="measured"``: both packages' ``np_exec`` read
    ``time.perf_counter``; fed the same fake sequence, their perm
    trajectories and everything else agree."""
    batches = stream()

    def fake_clock():
        ticks = iter(np.cumsum(np.random.default_rng(5).uniform(
            1e-6, 1e-3, 100_000)).tolist())
        return lambda: next(ticks)

    runs = {}
    for key, mod, pm in (("repro", R, R_pred), ("port", T, T_pred)):
        filt = mod.AdaptiveFilter(
            pm.paper_filters_4("fig1")[::-1],
            mod.AdaptiveFilterConfig(ordering=mod.OrderingConfig(**ORDER),
                                     backend="numpy", cost_mode="measured"))
        monkeypatch.setattr(time, "perf_counter", fake_clock())
        runs[key] = _drive(filt, batches)
        monkeypatch.undo()
    assert_streams_equal(runs["port"], runs["repro"])
    perms = [tuple(d["perm"]) for _, _, d in runs["port"]]
    assert len(set(perms)) > 1
    assert all(sorted(p) == [0, 1, 2, 3] for p in perms)


# =================================================== plans, sessions, guard
ENGINE_TWIN = {"jnp": "torch", "pallas": "cuda", "numpy": "numpy"}


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [
    dict(backend="numpy", compact_output=True),
    dict(backend="numpy", skip_tier="auto"),
    dict(backend="jnp", cost_mode="measured"),
    dict(backend="pallas", cost_mode="measured", compact_output=True,
         compact_capacity=0),
    dict(backend="numpy", scope="global", compact_output=True),
])
def test_config_refuses_what_repro_refuses(kw):
    """``AdaptiveFilterConfig`` raises ``repro``'s message, the engine's
    name mapped; the plan of a sharded host engine too."""
    t_kw = dict(kw, backend=ENGINE_TWIN[kw["backend"]])
    want = _message(lambda: R.AdaptiveFilterConfig(**kw))
    got = _message(lambda: T.AdaptiveFilterConfig(**t_kw))
    for r_name, t_name in ENGINE_TWIN.items():
        got = got.replace(repr(t_name), repr(r_name))
    assert got == want
    preds_r, preds_t = R.paper_filters_4(), T.paper_filters_4()
    assert _message(lambda: T.FilterPlan(preds_t, engine="numpy",
                                         shards=2)) == \
        _message(lambda: R.FilterPlan(preds_r, engine="numpy", shards=2))


def test_host_plans_build_and_keep_repros_fingerprint():
    for kw in (dict(engine="numpy"), dict(engine="numpy",
                                          cost_mode="measured"),
               dict(engine="numpy", skip_tier="zonemap+bloom",
                    scope="centralized", exchange="deferred")):
        t = T.FilterPlan(T.paper_filters_cnf(), T.OrderingConfig(**ORDER),
                         **kw)
        r = R.FilterPlan(R.paper_filters_cnf(), R.OrderingConfig(**ORDER),
                         **kw)
        assert t.fingerprint() == r.fingerprint()
    cfg = T.AdaptiveFilterConfig(backend="numpy", cost_mode="measured")
    filt = T.AdaptiveFilter(T.paper_filters_4(), cfg)
    assert filt.device.type == "cpu" and filt.config.cost_mode == "measured"
    assert T.AdaptiveFilterConfig().backend == "cuda"
    assert T.static_filter(T.paper_filters_4(), backend="numpy") \
        .config.adaptive is False
    with pytest.raises(ValueError, match="at least one predicate"):
        T.AdaptiveFilter([], cfg)


def test_filter_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: T.AdaptiveFilter(T.paper_filters_4()),
                 lambda: T.static_filter(T.paper_filters_4()),
                 lambda: T.AdaptiveFilter(
                     T.paper_filters_4(),
                     T.AdaptiveFilterConfig(backend="numpy"),
                     device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("tier", ["off", "zonemap"])
def test_session_of_a_numpy_plan_matches_repro(tier):
    """A session's step of an ``engine="numpy"`` plan runs the ``torch``
    engine (``repro``'s runs ``jnp``); masks and perms equal ``repro``'s;
    ``from_filter`` adopts a filter of the paper's surface."""
    batches = stream("clustered" if tier != "off" else "iid", n=6)
    kw = dict(engine="numpy", cost_mode="measured", skip_tier=tier)
    r_sess = R.build_session(R.FilterPlan(
        R.paper_filters_cnf(), R.OrderingConfig(**ORDER), **kw))
    t_sess = T.build_session(T.FilterPlan(
        T.paper_filters_cnf(), T.OrderingConfig(**ORDER), **kw),
        device="cpu")
    assert t_sess.filter._step_engine.name == "torch"
    r_state, t_state = r_sess.init_state(), t_sess.init_state()
    for i, cols in enumerate(batches):
        r_state, r_res = r_sess.step(r_state, cols)
        t_state, t_res = t_sess.step(t_state, torch.from_numpy(cols))
        np.testing.assert_array_equal(t_res.mask_np, r_res.mask_np)
        np.testing.assert_array_equal(_np(t_state.perm),
                                      np.asarray(r_state.perm))
        assert t_res.metrics_dict() == pytest.approx(r_res.metrics_dict())
    filt = T.AdaptiveFilter(T.paper_filters_cnf(),
                            T.AdaptiveFilterConfig(backend="numpy"))
    adopted = T.FilterSession.from_filter(filt)
    assert adopted.filter is filt
    assert adopted.plan == T.FilterPlan(T.paper_filters_cnf(),
                                        engine="numpy")
    assert adopted.device == torch.device("cpu")


def test_guard_rungs_of_a_numpy_plan_match_repro():
    """Two failed attempts (max_retries=1) take one rung: ``skip_tier`` →
    off, as in ``repro``, where ``numpy`` is a bottom engine; never
    ``engine`` → ``torch``. Then both are at the bottom."""
    batches = stream("clustered", n=3)
    degrades = {}
    for key, mod, rt in (("repro", R, R_rt), ("port", T, T_rt)):
        plan = mod.FilterPlan(mod.paper_filters_cnf(),
                              mod.OrderingConfig(**ORDER), engine="numpy",
                              skip_tier="zonemap")
        sess = mod.build_session(plan) if mod is R \
            else mod.build_session(plan, device="cpu")
        fault = {"left": 2}

        def injector(i, fault=fault):
            if i == 1 and fault["left"]:
                fault["left"] -= 1
                raise RuntimeError("device fault")

        guard = rt.GuardedSession(
            sess, rt.GuardPolicy(max_retries=1, sleep=lambda s: None),
            step_injector=injector)
        state = guard.init_state()
        for cols in batches:
            state, _ = guard.step(state, cols)
        degrades[key] = [e["changes"] for e in guard.health.degrades]
        assert guard.session.plan.engine == "numpy"
        assert guard._degrade_once("probe") is False
    assert degrades["port"] == degrades["repro"] == [{"skip_tier": "off"}]
