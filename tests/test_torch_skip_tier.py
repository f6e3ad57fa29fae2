"""The skip tier of the port against ``repro``'s, on the same numpy inputs.

Zone maps, Bloom bitmaps, tile resolution and triage of
``repro_torch.core.skip_tier`` against ``repro.core.skip_tier`` with
``xp=jnp``; the stats twin and the skip variant of the chain twin against
``repro``'s Pallas kernels in interpret mode; the ``torch`` engine against
``jnp`` and the ``cuda`` engine (its twins on the CPU) against ``pallas``,
tile counters included; a drifting clustered stream through both
packages' sessions; and the ``auto`` tuner. Everything is bit-exact except
where noted: zone-map summaries compare NaN positions plus ``==`` on the
rest (``jnp.min`` keeps -0.0 where ``torch.amin`` may return 0.0; no proof
can tell them apart). The CUDA kernels run only on a card: the
``gpu``-marked test in ``test_torch_kernel_filter_chain.py`` holds them
against their twins there.
"""

import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.configs import paper_filters as R_paper  # noqa: E402
from repro.core import skip_tier as r_skip  # noqa: E402
from repro.data import stream as R_stream  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.configs import paper_filters as T_paper  # noqa: E402
from repro_torch.core import skip_tier as t_skip  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402
from repro_torch.kernels.filter_chain import filter_chain as tfc  # noqa: E402
from repro_torch.kernels.filter_chain import ops as t_ops  # noqa: E402

OUT_NAMES = ("mask", "active", "cut", "gcut", "nmon", "packed", "cnt")


@pytest.fixture
def ref(monkeypatch):
    """repro's Pallas kernels, ops and engines, run in interpret mode.

    Restores the ``pallas.load`` / ``pallas.store`` aliases that JAX 0.9
    dropped for the duration of one test, then drops JAX's compile caches.
    """
    import importlib

    import jax
    import jax.numpy as jnp
    from jax._src.pallas import primitives
    from jax.experimental import pallas as pl

    from repro.core.engine import get_engine
    from repro.kernels.filter_chain import ops as r_ops

    r_fc = importlib.import_module("repro.kernels.filter_chain.filter_chain")
    for name in ("load", "store"):
        if not hasattr(pl, name):
            monkeypatch.setattr(pl, name, getattr(primitives, name),
                                raising=False)
    yield types.SimpleNamespace(jax=jax, jnp=jnp, fc=r_fc, ops=r_ops,
                                engine=get_engine)
    jax.clear_caches()


def _jnp():
    import jax.numpy as jnp
    return jnp


# ---------------------------------------------------------------- chains
def chain6(mod, eq_t1=777.0):
    """Six predicates over the stream's columns (0 date, 1 int, 2 string
    hash): an OR group of range predicates, a BETWEEN, an OR group of an
    EQ and a range predicate (so Bloom proofs decide tiles), and HASHMIX."""
    q_date = T_stream.threshold_for_quantile
    return [
        mod.Predicate("date_gt", 0, mod.OP_GT, q_date("date", 0.3),
                      group="a"),
        mod.Predicate("int_lt", 1, mod.OP_LT, q_date("int", 0.2), group="a"),
        mod.Predicate("date_bt", 0, mod.OP_BETWEEN, q_date("date", 0.05),
                      t2=q_date("date", 0.95), static_cost=1.5),
        mod.Predicate("str_eq", 2, mod.OP_EQ, eq_t1, group="b"),
        mod.Predicate("int_gt", 1, mod.OP_GT, q_date("int", 0.97),
                      group="b"),
        mod.Predicate("str_mix", 2, mod.OP_HASHMIX, 0.3 * 1048576.0,
                      rounds=6, static_cost=6.0),
    ]


CHAINS = {
    "paper": lambda mod: mod.paper_filters_4("fig1"),
    "cnf": lambda mod: chain6(mod),
}


def batch(n_rows, layout, index=0):
    """The same batch from both packages' generators (checked byte-equal)."""
    t = T_stream.gen_batch(0, index, index * n_rows, n_rows, layout=layout)
    r = R_stream.gen_batch(0, index, index * n_rows, n_rows, layout=layout)
    np.testing.assert_array_equal(t, r)
    assert t.flags["C_CONTIGUOUS"]         # no per-step copy in the engines
    return t


def assert_summary_equal(got, want, what):
    """NaN positions equal and ``==`` on the rest (see module docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    keep = ~np.isnan(want)
    assert (got[keep] == want[keep]).all(), what


def both_triage(cols, chain_fn, bloom):
    """(port SkipInfo, repro SkipInfo) of one f32[C, R] numpy batch."""
    jnp = _jnp()
    got = t_skip.triage(torch.from_numpy(cols), T.pack(chain_fn(T)),
                        bloom=bloom)
    want = r_skip.triage(jnp.asarray(cols), R.pack(chain_fn(R)),
                         bloom=bloom, xp=jnp)
    for name in ("pass_tiles", "fail_tiles", "n_ambiguous"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    return got, want


# ================================================ summaries and resolution
@pytest.mark.parametrize("layout", ["clustered", "zordered", "shuffled"])
@pytest.mark.parametrize("n_rows", [4096, 4000])
@pytest.mark.parametrize("chain", ["paper", "cnf"])
def test_summaries_and_triage_match_repro(layout, n_rows, chain):
    jnp = _jnp()
    cols = batch(n_rows, layout)
    for bloom in (False, True):
        got = t_skip.tile_summaries(torch.from_numpy(cols), bloom=bloom)
        want = r_skip.tile_summaries(jnp.asarray(cols), bloom=bloom, xp=jnp)
        assert_summary_equal(got[0].numpy(), want[0], "mins")
        assert_summary_equal(got[1].numpy(), want[1], "maxs")
        if bloom:
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        else:
            assert got[2] is None and want[2] is None
        info, _ = both_triage(cols, CHAINS[chain], bloom)
        assert info.pass_tiles.shape == (math.ceil(n_rows / 128),)
    if layout == "clustered":
        assert int(info.fail_tiles.sum()) > 0


def test_bloom_proofs_decide_tiles_on_clustered_data():
    cols = batch(8192, "clustered")
    off, _ = both_triage(cols, CHAINS["cnf"], False)
    on, _ = both_triage(cols, CHAINS["cnf"], True)
    assert int(on.fail_tiles.sum()) > int(off.fail_tiles.sum())
    assert int(on.n_ambiguous) < int(off.n_ambiguous)


def test_nonfinite_bloom_keys_match_repro():
    """±inf fold to key 0 in repro (NaN → int32 gives 0 there); NaN lanes,
    ±0, negatives and values past 2^31 fold exactly as ``jnp.mod``."""
    jnp = _jnp()
    specials = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, -1.0, -128.0,
                         -129.5, 2.5, 3.5, 3e9, -3e9, 2.0 ** 31 + 128 * 7,
                         1e38, -1e38, 127.5], np.float32)
    r = np.random.default_rng(0)
    cols = r.uniform(-500, 500, (2, 128 * 6)).astype(np.float32)
    cols[0, :specials.size] = specials          # tile 0 of column 0
    cols[1, 128:128 + 3] = [np.inf, np.nan, -np.inf]   # tile 1 of column 1
    cols[1, 256:384] = np.inf                   # a tile of +inf only
    cols[1, 384:512] = np.nan                   # a tile of NaN only
    got = t_skip.bloom_bitmap(torch.from_numpy(cols)).numpy()
    want = np.asarray(r_skip.bloom_bitmap(jnp.asarray(cols), xp=jnp))
    np.testing.assert_array_equal(got, want)
    assert got[1, 2, 0] and got[1, 2].sum() == 1   # inf → bit 0 only
    assert got[1, 3, 0] and got[1, 3].sum() == 1   # NaN → bit 0 only
    # ragged: the NaN padding folds to key 0 as well
    ragged = cols[:, :700]
    np.testing.assert_array_equal(
        t_skip.bloom_bitmap(torch.from_numpy(ragged)).numpy(),
        np.asarray(r_skip.bloom_bitmap(jnp.asarray(ragged), xp=jnp)))


# the tri-state edge cases of tests/test_skip_tier.py, through both packages
def _tiles(*parts):
    return np.stack([np.concatenate(parts)]).astype(np.float32)


_T = 0.5
_UP = float(np.nextafter(np.float32(_T), np.float32(1.0)))
EDGE_CASES = {
    "gt_boundary": (
        lambda m: [m.Predicate("gt", 0, m.OP_GT, _T)],
        _tiles(np.full(128, 1.0), np.full(128, 0.0), np.full(128, _T),
               np.linspace(0.0, 1.0, 128), np.full(128, _UP)),
        False, [True, False, False, False, True],
        [False, True, True, False, False]),
    "lt_boundary": (
        lambda m: [m.Predicate("lt", 0, m.OP_LT, _T)],
        _tiles(np.full(128, 1.0), np.full(128, 0.0), np.full(128, _T),
               np.linspace(0.0, 1.0, 128), np.full(128, _UP)),
        False, [False, True, False, False, False],
        [True, False, True, False, True]),
    "between": (
        lambda m: [m.Predicate("bt", 0, m.OP_BETWEEN, 1.0, t2=2.0)],
        _tiles(np.full(128, 1.5), np.full(128, 0.5), np.full(128, 2.0),
               np.linspace(0.5, 1.5, 128)),
        False, [True, False, False, False], [False, True, True, False]),
    "eq": (
        lambda m: [m.Predicate("eq", 0, m.OP_EQ, 7.0)],
        _tiles(np.full(128, 7.2), np.full(128, 9.0),
               np.linspace(0.0, 20.0, 128),
               np.repeat([2.0, 4.0, 6.0, 8.0], 32)),
        False, [True, False, False, False], [False, True, False, False]),
    "eq_bloom": (
        lambda m: [m.Predicate("eq", 0, m.OP_EQ, 7.0)],
        _tiles(np.full(128, 7.2), np.full(128, 9.0),
               np.linspace(0.0, 20.0, 128),
               np.repeat([2.0, 4.0, 6.0, 8.0], 32)),
        True, [True, False, False, False], [False, True, False, True]),
    "all_pass_all_fail": (
        lambda m: [m.Predicate("gt", 0, m.OP_GT, 0.0),
                   m.Predicate("lt", 0, m.OP_LT, 10.0)],
        _tiles(np.full(128, 5.0), np.full(128, -5.0), np.full(128, 50.0)),
        False, [True, False, False], [False, True, True]),
    "hashmix_never": (
        lambda m: [m.Predicate("mix", 0, m.OP_HASHMIX, 0.5, rounds=4)],
        _tiles(np.full(128, 1.0), np.zeros(128)),
        True, [False, False], [False, False]),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_tristate_edge_cases_match_repro(case):
    chain_fn, cols, bloom, want_pass, want_fail = EDGE_CASES[case]
    got, _ = both_triage(cols, chain_fn, bloom)
    assert got.pass_tiles.tolist() == want_pass
    assert got.fail_tiles.tolist() == want_fail


def test_cnf_group_proofs_match_repro():
    def chain_fn(m):
        return [m.Predicate("a", 0, m.OP_GT, 0.5, group="or"),
                m.Predicate("b", 1, m.OP_LT, 0.5, group="or")]
    cols = np.stack([
        np.concatenate([np.full(128, 1.0), np.full(128, 0.0),
                        np.full(128, 0.0)]),
        np.concatenate([np.full(128, 1.0), np.full(128, 0.0),
                        np.full(128, 1.0)])]).astype(np.float32)
    got, _ = both_triage(cols, chain_fn, False)
    assert got.pass_tiles.tolist() == [True, True, False]
    assert got.fail_tiles.tolist() == [False, False, True]


@pytest.mark.parametrize("n_amb,n_tiles", [
    (0, 32), (1, 32), (16, 32), (17, 32), (100, 32), (5, 1), (40, 1000)])
def test_quantize_amb_cap_matches_repro(n_amb, n_tiles):
    assert t_skip.quantize_amb_cap(n_amb, n_tiles) == \
        r_skip.quantize_amb_cap(n_amb, n_tiles)
    assert t_skip.eq_round(7.5) == r_skip.eq_round(7.5)
    assert t_skip.bloom_key(777.0) == r_skip.bloom_key(777.0)
    assert (t_skip.SKIP_TILE, t_skip.BLOOM_BITS, t_skip.AMBIG_QUANTUM_TILES,
            t_skip.SKIP_TIER_MODES) == (
        r_skip.SKIP_TILE, r_skip.BLOOM_BITS, r_skip.AMBIG_QUANTUM_TILES,
        r_skip.SKIP_TIER_MODES)


def test_host_rows_are_the_f32_specs():
    specs = T.pack(chain6(T))
    want = r_skip.host_pred_rows(R.pack(chain6(R)))
    assert t_skip.host_pred_rows(specs) == want
    assert [t for _, _, t, _ in want] == specs.t1.tolist()


# ========================================================= kernel twins
def _planted(n_rows, seed):
    """Test columns with NaN, ±inf and ±0 planted inside some sub-tiles."""
    r = np.random.default_rng(seed)
    cols = r.uniform(-1, 1, (3, n_rows)).astype(np.float32)
    cols[0, 5] = np.nan
    cols[1, 300:302] = [np.inf, -np.inf]
    cols[2, 512:640] = 0.0
    cols[2, 520] = -0.0
    cols[0, 700:828] = -0.0
    cols[0, 710] = 0.0
    cols[1, n_rows - 1] = np.nan
    return cols


@pytest.mark.parametrize("n_rows", [1024, 2048 + 777])
def test_stats_twin_matches_pallas(ref, n_rows):
    cols = _planted(n_rows, n_rows)
    padded = np.pad(cols, ((0, 0), (0, (-n_rows) % 256)))
    want = ref.fc.tile_stats_pallas(ref.jnp.asarray(padded), tile=256,
                                    interpret=True)
    got = tfc.tile_stats_twin(torch.from_numpy(padded), tile=256)
    for g, w, name in zip(got, want, ("mins", "maxs")):
        assert_summary_equal(g.numpy(), w, name)
    assert np.isnan(got[0].numpy()[0, 0]) and np.isnan(got[1].numpy()[0, 0])
    assert got[1].numpy()[1, 2] == np.inf and got[0].numpy()[1, 2] == -np.inf
    with pytest.raises(ValueError, match="multiple"):
        tfc.tile_stats_twin(torch.zeros((3, 300)), tile=256)


def _decisions(kind, n_sub, cols_t, specs, seed):
    if kind == "random":
        r = np.random.default_rng(seed)
        pas = (r.uniform(size=n_sub) < 0.3)
        fail = ~pas & (r.uniform(size=n_sub) < 0.4)
        return pas.astype(np.int32), fail.astype(np.int32)
    mins, maxs = tfc.tile_stats_twin(cols_t, tile=256)
    bl = t_skip.bloom_bitmap(cols_t)
    p, f = t_skip.resolve_tiles(mins, maxs, bl, specs)
    return p.numpy().astype(np.int32), f.numpy().astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "triage"])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("compact", [False, True])
def test_skip_chain_twin_matches_pallas(ref, kind, mode, compact):
    jnp = ref.jnp
    n_rows, tile = 2048 + 777, 256
    cols = batch(n_rows, "clustered", index=3)
    padded = np.pad(cols, ((0, 0), (0, (-n_rows) % tile)))
    t_specs, r_specs = T.pack(chain6(T)), R.pack(chain6(R))
    perm = np.asarray([4, 3, 2, 5, 1, 0], np.int32)
    meta = np.asarray([n_rows, 37, 5, mode], np.int32)
    pas, fail = _decisions(kind, padded.shape[1] // 128,
                           torch.from_numpy(padded), t_specs, mode)
    assert pas.any() or kind == "triage"
    assert fail.any()
    want = ref.fc.filter_chain_pallas(
        jnp.asarray(padded), r_specs, jnp.asarray(perm), jnp.asarray(meta),
        tile=tile, compact=compact, fill=-1.5,
        skip_decisions=(jnp.asarray(pas), jnp.asarray(fail)))
    got = tfc.filter_chain_twin(
        torch.from_numpy(padded), t_specs, torch.from_numpy(perm),
        torch.from_numpy(meta), tile=tile, compact=compact, fill=-1.5,
        skip_decisions=(torch.from_numpy(pas), torch.from_numpy(fail)))
    assert len(got) == (7 if compact else 5)
    for name, w, g in zip(OUT_NAMES, want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_cpu_wrappers_run_the_twins_without_counting():
    cols = torch.from_numpy(_planted(4096, 2))
    specs = T.pack(chain6(T))
    perm = torch.arange(6, dtype=torch.int32)
    meta = torch.tensor([4000, 10, 0, 0], dtype=torch.int32)
    r = np.random.default_rng(1)
    decisions = tuple(torch.from_numpy((r.uniform(size=32) < 0.3)
                                       .astype(np.int32)) for _ in range(2))
    tfc.reset_launch_counts()
    got = tfc.filter_chain_kernel(cols, specs, perm, meta, compact=True,
                                  skip_decisions=decisions)
    want = tfc.filter_chain_twin(cols, specs, perm, meta, compact=True,
                                 skip_decisions=decisions)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for g, w in zip(tfc.tile_stats_kernel(cols), tfc.tile_stats_twin(cols)):
        assert_summary_equal(g.numpy(), w.numpy(), "stats")
    assert (tfc.filter_chain_kernel.launches,
            tfc.filter_chain_kernel.skip_launches,
            tfc.tile_stats_kernel.launches) == (0, 0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        tfc.tile_stats_kernel(torch.empty((3, 2048), device="meta"))


# ======================================================= ops and engines
def _ops_inputs(n_rows, layout):
    cols = batch(n_rows, layout, index=1)
    return cols, torch.from_numpy(cols), T.pack(chain6(T)), R.pack(chain6(R))


@pytest.mark.parametrize("n_rows,layout", [(4096 + 500, "clustered")])
def test_skip_ops_match_repro_ops(ref, n_rows, layout):
    jnp, r_ops = ref.jnp, ref.ops
    cols, cols_t, t_specs, r_specs = _ops_inputs(n_rows, layout)
    perm = np.asarray([2, 0, 1, 5, 4, 3], np.int32)
    kw = dict(collect_rate=37, sample_phase=5, monitor_mode="row")
    for bloom in (False, True):
        w_info = r_ops.skip_triage(jnp.asarray(cols), r_specs, bloom=bloom)
        g_info = t_ops.skip_triage(cols_t, t_specs, bloom=bloom)
        for name in ("pass_tiles", "fail_tiles", "n_ambiguous"):
            np.testing.assert_array_equal(
                getattr(g_info, name).numpy(),
                np.asarray(getattr(w_info, name)), err_msg=name)
        # zero padding to the 2048-row tile: the counters cover Rp / 128
        assert g_info.pass_tiles.shape == (-(-n_rows // 2048) * 16,)
    want = r_ops.filter_chain_skip(jnp.asarray(cols), r_specs,
                                   jnp.asarray(perm), w_info, **kw)
    got = t_ops.filter_chain_skip(cols_t, t_specs, torch.from_numpy(perm),
                                  g_info, **kw)
    w_res, w_packed, w_kept = r_ops.filter_chain_compact_skip(
        jnp.asarray(cols), r_specs, jnp.asarray(perm), w_info, capacity=500,
        **kw)
    g_res, g_packed, g_kept = t_ops.filter_chain_compact_skip(
        cols_t, t_specs, torch.from_numpy(perm), g_info, capacity=500, **kw)
    for w_r, g_r in ((want, got), (w_res, g_res)):
        for field in ("mask", "cut_counts", "n_monitored", "group_cut_counts",
                      "active_before", "n_tiles_pass", "n_tiles_fail",
                      "n_tiles_ambiguous"):
            np.testing.assert_array_equal(
                getattr(g_r, field).numpy(), np.asarray(getattr(w_r, field)),
                err_msg=field)
        # summation order of the per-tile counters (rtol 1e-6, ROADMAP)
        for field in ("work_units", "monitor_cost"):
            np.testing.assert_allclose(
                getattr(g_r, field).numpy(), np.asarray(getattr(w_r, field)),
                rtol=1e-6, err_msg=field)
    np.testing.assert_array_equal(g_packed.numpy(), np.asarray(w_packed))
    assert int(g_kept) == int(w_kept)
    assert int(got.n_tiles_fail) > 0


@pytest.mark.parametrize("pair,n_rows,bloom", [
    (("torch", "jnp"), 4096, False), (("torch", "jnp"), 3000, True),
    (("cuda", "pallas"), 4096, True), (("cuda", "pallas"), 3000, False)])
def test_engines_match_repro_engines(ref, pair, n_rows, bloom):
    """torch ↔ jnp and cuda (twins) ↔ pallas, tile counters included: the
    two pairs pad differently (NaN to 128 rows / zeros to 2048)."""
    jnp = ref.jnp
    t_eng, r_eng = T.get_engine(pair[0]), ref.engine(pair[1])
    cols, cols_t, t_specs, r_specs = _ops_inputs(n_rows, "clustered")
    perm = np.asarray([3, 4, 2, 0, 1, 5], np.int32)
    from repro.core.engine.base import MonitorSpec as RMon
    from repro.core.engine.base import SkipInfo as RSkip
    from repro_torch.core.engine.base import MonitorSpec as TMon
    r_mon, t_mon = RMon(64, 3), TMon(64, 3)
    w_info = r_eng.triage(jnp.asarray(cols), r_specs, bloom=bloom)
    g_info = t_eng.triage(cols_t, t_specs, bloom=bloom)
    np.testing.assert_array_equal(g_info.pass_tiles.numpy(),
                                  np.asarray(w_info.pass_tiles))
    np.testing.assert_array_equal(g_info.fail_tiles.numpy(),
                                  np.asarray(w_info.fail_tiles))
    n_tiles = math.ceil(n_rows / 128)
    cap = r_skip.quantize_amb_cap(int(w_info.n_ambiguous), n_tiles)
    assert t_skip.quantize_amb_cap(int(g_info.n_ambiguous),
                                   n_tiles) == cap
    got = t_eng.run_chain(cols_t, t_specs, torch.from_numpy(perm), t_mon,
                          skip=g_info, amb_cap=cap)
    # jitted with the specs closed over, as repro's session runs it
    w_c, w_packed, w_kept = ref.jax.jit(
        lambda c, p, pt, ft: r_eng.run_chain_compact_skip(
            c, r_specs, p, r_mon, RSkip(pt, ft, None), amb_cap=cap,
            capacity=200))(jnp.asarray(cols), jnp.asarray(perm),
                           w_info.pass_tiles, w_info.fail_tiles)
    g_c, g_packed, g_kept = t_eng.run_chain_compact(
        cols_t, t_specs, torch.from_numpy(perm), t_mon, capacity=200,
        skip=g_info, amb_cap=cap)
    # repro's compacting skip path returns its plain skip path's result
    for w_r, g_r in ((w_c, got), (w_c, g_c)):
        for field in ("mask", "cut_counts", "n_monitored",
                      "group_cut_counts", "active_before",
                      "n_tiles_pass", "n_tiles_fail",
                      "n_tiles_ambiguous"):
            np.testing.assert_array_equal(
                getattr(g_r, field).numpy(),
                np.asarray(getattr(w_r, field)), err_msg=field)
        np.testing.assert_allclose(g_r.work_units.numpy(),
                                   np.asarray(w_r.work_units), rtol=1e-6)
    np.testing.assert_array_equal(g_packed.numpy(), np.asarray(w_packed))
    assert int(g_kept) == int(w_kept)
    # the tier never changes the mask or the monitor lane
    plain = t_eng.run_chain(cols_t, t_specs, torch.from_numpy(perm),
                            t_mon)
    np.testing.assert_array_equal(plain.mask.numpy(), got.mask.numpy())
    np.testing.assert_array_equal(plain.cut_counts.numpy(),
                                  got.cut_counts.numpy())


# ============================================================ the stream
BATCH = 4096
N_BATCHES = 6
ORDER = dict(collect_rate=16, calculate_rate=8192, momentum=0.3)
DRIFT = dict(kind="regime", period_rows=8192, amplitude=1.5)
COMPACTION = {"off": {}, "fixed": dict(compact=True, capacity=160)}


def _stream_batches():
    t = [b.columns for b in T_stream.LogStream(
        N_BATCHES * BATCH, BATCH, seed=0,
        drift=T_stream.DriftConfig(**DRIFT), layout="clustered")]
    r = [b.columns for b in R_stream.LogStream(
        N_BATCHES * BATCH, BATCH, seed=0,
        drift=R_stream.DriftConfig(**DRIFT), layout="clustered")]
    for a, b in zip(t, r):
        np.testing.assert_array_equal(a, b)
    return t


def _record(session, batches, to_device):
    state = session.init_state()
    steps = []
    for cols in batches:
        state, res = session.step(state, to_device(cols))
        steps.append(dict(
            mask=res.mask_np,
            n_kept=None if res.n_kept is None else int(np.asarray(
                res.n_kept.numpy() if hasattr(res.n_kept, "numpy")
                else res.n_kept)),
            packed=None if res.packed is None else np.asarray(
                res.packed.numpy() if hasattr(res.packed, "numpy")
                else res.packed),
            perm=np.asarray(state.perm), gperm=np.asarray(state.group_perm),
            tiles=(res.n_tiles_skipped_pass, res.n_tiles_skipped_fail,
                   res.n_tiles_ambiguous)))
    return session.save_state(state)["arrays"], steps


@pytest.mark.parametrize("compaction", ["off", "fixed"])
@pytest.mark.parametrize("tier", ["zonemap", "zonemap+bloom"])
@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_clustered_stream_matches_repro(engine, tier, compaction):
    """6 drifting clustered batches through both packages' sessions: the
    same masks, packed survivors, n_kept, perm trajectory, tile counters
    and save_state arrays; and the same masks as the tier switched off.
    At 4096-row batches the engines' two paddings coincide, so the jnp
    session is the reference for both port engines."""
    batches = _stream_batches()
    chain_r, chain_t = R_paper.filter_chain("cnf"), T_paper.filter_chain(
        "cnf")
    if tier == "zonemap+bloom":
        chain_r, chain_t = chain6(R), chain6(T)
    kw = COMPACTION[compaction]
    r_sess = R.build_session(R.FilterPlan(chain_r, R.OrderingConfig(**ORDER),
                                          engine="jnp", skip_tier=tier, **kw))
    want_arrays, want = _record(r_sess, batches, lambda c: c)
    t_sess = T.build_session(T.FilterPlan(chain_t, T.OrderingConfig(**ORDER),
                                          engine=engine, skip_tier=tier,
                                          **kw), device="cpu")
    got_arrays, got = _record(t_sess, batches, torch.from_numpy)
    off_sess = T.build_session(T.FilterPlan(
        chain_t, T.OrderingConfig(**ORDER), engine=engine, **kw),
        device="cpu")
    _, off = _record(off_sess, batches, torch.from_numpy)
    for i, (g, w, o) in enumerate(zip(got, want, off)):
        where = f"step {i}"
        np.testing.assert_array_equal(g["mask"], w["mask"], err_msg=where)
        np.testing.assert_array_equal(g["mask"], o["mask"], err_msg=where)
        np.testing.assert_array_equal(g["perm"], w["perm"], err_msg=where)
        np.testing.assert_array_equal(g["perm"], o["perm"], err_msg=where)
        np.testing.assert_array_equal(g["gperm"], w["gperm"], err_msg=where)
        assert g["n_kept"] == w["n_kept"] == o["n_kept"], where
        assert g["tiles"] == w["tiles"], where
        assert o["tiles"] == (0, 0, 0), where
        if w["packed"] is not None:
            np.testing.assert_array_equal(g["packed"], w["packed"],
                                          err_msg=where)
            np.testing.assert_array_equal(g["packed"], o["packed"],
                                          err_msg=where)
    assert got_arrays.keys() == want_arrays.keys()
    for k in want_arrays:
        if k == "adj_rank":
            np.testing.assert_allclose(got_arrays[k], want_arrays[k],
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(got_arrays[k], want_arrays[k],
                                          err_msg=k)
    assert sum(s["tiles"][1] for s in got) > 0          # tiles were decided
    assert len({tuple(s["perm"]) for s in got}) > 1     # the order moved


# ================================================================ tuner
def test_tuner_matches_repro_on_the_same_observations():
    r = np.random.default_rng(5)
    for warmup, probe in ((2, 8), (3, 64), (1, 4)):
        a = t_skip.SkipTierTuner("zonemap", warmup=warmup, probe_period=probe)
        b = r_skip.SkipTierTuner("zonemap", warmup=warmup, probe_period=probe)
        for i in range(60):
            arm = a.choose()
            assert arm == b.choose(), i
            us = float(r.uniform(1.0, 3.0)) * (0.5 if arm == "off" else 1.0)
            frac = None if i % 7 else float(r.uniform(0.5, 1.0))
            a.observe(arm, us, frac)
            b.observe(arm, us, frac)
            assert a.active_mode == b.active_mode
            assert a.us_ema == b.us_ema and a.samples == b.samples
    with pytest.raises(ValueError):
        t_skip.SkipTierTuner("off")


def test_tuner_schedule_override_and_first_sample_discard():
    t = t_skip.SkipTierTuner("zonemap", warmup=2, probe_period=8)
    arms = []
    for _ in range(4):
        m = t.choose()
        arms.append(m)
        t.observe(m, 1.0)
    assert arms == ["zonemap", "off", "zonemap", "off"]
    for _ in range(4):
        t.observe("zonemap", 1.0)
        t.observe("off", 3.0)
    assert t.active_mode == "zonemap"
    t.observe("zonemap", 1.0, ambig_frac=0.95)
    assert t.active_mode == "off"
    t.step_idx = t.probe_period
    assert t.choose() == "off"
    t.observe("off", 3.0, ambig_frac=0.1)
    assert t.active_mode == "zonemap"

    t = t_skip.SkipTierTuner("zonemap", warmup=1)
    t.observe("zonemap", 1000.0)
    t.observe("off", 1000.0)
    assert t.us_ema == {"zonemap": None, "off": None}
    t.observe("zonemap", 1.0)
    t.observe("off", 2.0)
    assert t.us_ema == {"zonemap": 1.0, "off": 2.0}


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_auto_settles_on_off_for_shuffled_layout(engine):
    sess = T.build_session(T.FilterPlan(
        T.paper_filters_4("fig1"),
        T.OrderingConfig(collect_rate=100, calculate_rate=100_000),
        engine=engine, skip_tier="auto"), device="cpu")
    assert sess.skip_tier_active == "auto"
    st = sess.init_state()
    for b in range(8):                   # past the 2·warmup alternation
        st, res = sess.step(st, torch.from_numpy(T_stream.gen_batch(
            0, b, b * 2048, 2048, layout="shuffled")))
    assert sess.skip_tier_active == "off"
    assert res.n_tiles_skipped_pass == res.n_tiles_skipped_fail == 0
    assert sess.filter.skip_on_mode() == "zonemap"
    eq_sess = T.build_session(T.FilterPlan(chain6(T), skip_tier="auto"),
                              device="cpu")
    assert eq_sess.filter.skip_on_mode() == "zonemap+bloom"
