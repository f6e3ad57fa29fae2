"""The port's engines and oracle against repro's jnp engine and ref.py.

Same numpy inputs through both packages: the ``torch`` engine against
``repro``'s ``jnp`` engine, the ``cuda`` engine (on CPU tensors: the
kernels' twins) and the port's dense oracle against ``repro``'s oracle,
on the flat sweep of ``tests/test_kernel_filter_chain.py`` and the CNF
cases of ``tests/test_engine_cnf.py``. Masks and counts exactly; float
work sums to rtol 1e-6 (summation order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import MonitorSpec as RMonitor  # noqa: E402
from repro.core import get_engine as r_engine  # noqa: E402
from repro.core import predicates as RP  # noqa: E402
from repro.core.filter_exec import compact_fixed as r_compact_fixed  # noqa
from repro.kernels.filter_chain.ref import (  # noqa: E402
    compact_fixed_ref, filter_chain_ref)
from repro_torch.core import MonitorSpec as TMonitor  # noqa: E402
from repro_torch.core import available_engines, get_engine  # noqa: E402
from repro_torch.core import predicates as TP  # noqa: E402
from repro_torch.core.filter_exec import compact, compact_fixed  # noqa: E402
from repro_torch.kernels.filter_chain import ref as t_ref  # noqa: E402

EXACT = ("mask", "cut_counts", "n_monitored", "group_cut_counts",
         "active_before")


def flat_chain(mod, n_preds):
    return [
        mod.Predicate("gt", 0, mod.OP_GT, 0.2, static_cost=1.0),
        mod.Predicate("lt", 1, mod.OP_LT, 0.7, static_cost=1.3),
        mod.Predicate("bet", 0, mod.OP_BETWEEN, 0.1, t2=0.9, static_cost=2.0),
        mod.Predicate("eq", 2, mod.OP_EQ, 3.0, static_cost=0.7),
        mod.Predicate("mix", 3, mod.OP_HASHMIX, 0.45 * mod.MIX_MOD, rounds=6,
                      static_cost=6.0),
        mod.Predicate("gt2", 1, mod.OP_GT, 0.05, static_cost=0.9),
    ][:n_preds]


def cnf_chain(mod, shape):
    if shape == "pair":
        return [
            mod.Predicate("gt", 0, mod.OP_GT, 0.6, group="a"),
            mod.Predicate("lt", 1, mod.OP_LT, 0.3, group="a",
                          static_cost=1.3),
            mod.Predicate("bet", 0, mod.OP_BETWEEN, 0.1, t2=0.9,
                          static_cost=2.0),
            mod.Predicate("eq", 2, mod.OP_EQ, 3.0, group="b",
                          static_cost=0.7),
            mod.Predicate("mix", 3, mod.OP_HASHMIX, 0.45 * mod.MIX_MOD,
                          rounds=6, group="b", static_cost=6.0),
        ]
    if shape == "wide":
        return [
            mod.Predicate("gt", 0, mod.OP_GT, 0.2),
            mod.Predicate("lt", 1, mod.OP_LT, 0.2, group="w",
                          static_cost=1.3),
            mod.Predicate("bet", 0, mod.OP_BETWEEN, 0.4, t2=0.6, group="w",
                          static_cost=2.0),
            mod.Predicate("eq", 2, mod.OP_EQ, 5.0, group="w",
                          static_cost=0.7),
        ]
    return [  # single_group
        mod.Predicate("gt", 0, mod.OP_GT, 0.9, group="o"),
        mod.Predicate("lt", 1, mod.OP_LT, 0.05, group="o", static_cost=1.3),
        mod.Predicate("eq", 2, mod.OP_EQ, 7.0, group="o", static_cost=0.7),
    ]


def cols_for(n_rows, seed=0):
    r = np.random.default_rng(seed)
    return np.stack([
        r.uniform(0, 1, n_rows),
        r.uniform(0, 1, n_rows),
        r.integers(0, 8, n_rows).astype(np.float64),
        r.uniform(0, RP.MIX_MOD, n_rows),
    ]).astype(np.float32)


def group_contig_perms(groups, seed):
    r = np.random.default_rng(seed)
    members = [[i for i, g in enumerate(groups) if g == gg]
               for gg in range(max(groups) + 1)]
    perms = []
    for _ in range(3):
        perm = []
        for g in r.permutation(len(members)):
            mem = list(members[g])
            r.shuffle(mem)
            perm.extend(mem)
        perms.append(np.asarray(perm, np.int32))
    return perms


# repro's jnp engine, jitted once per (shape, chain structure) with the
# monitor stride of these tests; eager dispatch would dominate the runtime
_jnp_run_chain = jax.jit(
    lambda cols, specs, perm: r_engine("jnp").run_chain(
        cols, specs, perm, RMonitor(37, 5)))


def assert_result(got, want, where):
    for field in got._fields[:7]:
        g = getattr(got, field)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(getattr(want, field))
        if field in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}: {field}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       err_msg=f"{where}: {field}")


def run_all(preds_r, preds_t, cols, perm, collect_rate=37, phase=5):
    """(repro jnp, repro oracle) vs (port torch, port cuda, port oracle)."""
    r_specs, t_specs = RP.pack(preds_r), TP.pack(preds_t)
    j_cols, t_cols = jnp.asarray(cols), torch.from_numpy(cols)
    j_perm, t_perm = jnp.asarray(perm), torch.from_numpy(perm)
    want_jnp = _jnp_run_chain(j_cols, r_specs, j_perm)
    want_ref = filter_chain_ref(j_cols, r_specs, j_perm,
                                collect_rate=collect_rate,
                                sample_phase=phase)
    got = {name: get_engine(name).run_chain(t_cols, t_specs, t_perm,
                                            TMonitor(collect_rate, phase))
           for name in ("torch", "cuda")}
    got["oracle"] = t_ref.filter_chain_ref(t_cols, t_specs, t_perm,
                                           collect_rate=collect_rate,
                                           sample_phase=phase)
    for name, res in got.items():
        assert_result(res, want_jnp, f"{name} vs repro jnp")
        assert_result(res, want_ref, f"{name} vs repro oracle")


@pytest.mark.parametrize("n_rows", [64, 2048, 5000])
@pytest.mark.parametrize("n_preds", [1, 3, 6])
def test_engines_match_repro_flat(n_rows, n_preds):
    cols = cols_for(n_rows)
    perm = np.random.default_rng(n_preds).permutation(n_preds) \
        .astype(np.int32)
    run_all(flat_chain(RP, n_preds), flat_chain(TP, n_preds), cols, perm)


@pytest.mark.parametrize("shape", ["pair", "wide", "single_group"])
@pytest.mark.parametrize("n_rows", [64, 5000])
def test_engines_match_repro_cnf(shape, n_rows):
    cols = cols_for(n_rows, seed=n_rows)
    groups = TP.normalize_groups(cnf_chain(TP, shape))
    for perm in group_contig_perms(groups, seed=n_rows):
        run_all(cnf_chain(RP, shape), cnf_chain(TP, shape), cols, perm)


def test_cnf_mask_is_and_of_ors():
    preds = [TP.Predicate("x_hi", 0, TP.OP_GT, 0.5, group="g"),
             TP.Predicate("y_hi", 1, TP.OP_GT, 0.5, group="g"),
             TP.Predicate("z_hi", 2, TP.OP_GT, 0.5)]
    specs = TP.pack(preds)
    cols = torch.tensor([[0.9, 0.1, 0.9, 0.1],
                         [0.9, 0.9, 0.1, 0.1],
                         [0.9, 0.9, 0.9, 0.9]])
    for name in available_engines():
        got = get_engine(name).run_chain(cols, specs,
                                         torch.arange(3, dtype=torch.int32),
                                         TMonitor(2, 0))
        assert got.mask.tolist() == [True, True, True, False], name


def test_or_short_circuit_work_accounting():
    preds = [TP.Predicate("always", 0, TP.OP_GT, -1.0, group="g"),
             TP.Predicate("mix", 3, TP.OP_HASHMIX, 0.5 * TP.MIX_MOD,
                          rounds=8, group="g", static_cost=9.0)]
    specs = TP.pack(preds)
    cols = torch.from_numpy(cols_for(4096, seed=1))
    for name in available_engines():
        got = get_engine(name).run_chain(cols, specs,
                                         torch.arange(2, dtype=torch.int32),
                                         TMonitor(1 << 20, 1))
        assert got.active_before.tolist() == [4096.0, 0.0], name
        assert float(got.work_units) == 4096.0
        assert int(got.mask.sum()) == 4096


def _hashmix_separately_rounded(x, rounds):
    """repro's HASHMIX body with every product and sum rounded to f32."""
    y = np.asarray(x, np.float32)
    for _ in range(rounds):
        y = y * np.float32(RP.MIX_MUL) + np.float32(RP.MIX_ADD)
        y = y - np.floor(y / np.float32(RP.MIX_MOD)) * np.float32(RP.MIX_MOD)
    return y


def test_hashmix_rounds_each_step_and_agrees_on_masks():
    """The port never fuses y*MUL + ADD into one rounding.

    repro's jitted ``hashmix`` does on XLA:CPU (see ROADMAP.md §3: x = 33.0,
    one round), so the values are held against the separately rounded
    formula and only the predicate outcomes against repro's function.
    """
    from repro.core.predicates import hashmix as r_hashmix

    x = cols_for(4096, seed=2)[3]
    t1 = np.float32(0.45 * RP.MIX_MOD)
    for rounds in (1, 6, 24):
        got = TP.hashmix(torch.from_numpy(x), rounds).numpy()
        want = _hashmix_separately_rounded(x, rounds)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        np.testing.assert_array_equal(
            got > t1, np.asarray(r_hashmix(jnp.asarray(x), rounds)) > t1)


def test_eq_rounds_half_to_even():
    specs = TP.pack([TP.Predicate("eq", 0, TP.OP_EQ, 2.0)])
    x = torch.tensor([1.5, 2.5, 2.4999, 3.5, -2.5], dtype=torch.float32)
    assert TP.eval_one(specs, 0, x).tolist() == [True, True, True, False,
                                                  False]


@pytest.mark.parametrize("n_rows,capacity", [
    (1000, 1), (1000, 37), (5000, 2048), (5000, 5000), (777, 900),
])
def test_compact_fixed_matches_repro(n_rows, capacity):
    cols = cols_for(n_rows, seed=capacity)
    mask = np.random.default_rng(n_rows).uniform(size=n_rows) < 0.4
    want, n_want = compact_fixed_ref(cols, mask, capacity, fill=-3.0)
    got, n_got = compact_fixed(torch.from_numpy(cols),
                               torch.from_numpy(mask), capacity, fill=-3.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(n_got) == n_want
    j_got, j_n = r_compact_fixed(jnp.asarray(cols), jnp.asarray(mask),
                                 capacity, fill=-3.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_got))
    assert int(j_n) == int(n_got)
    t_want, t_n = t_ref.compact_fixed_ref(cols, mask, capacity, fill=-3.0)
    np.testing.assert_array_equal(t_want, want)
    assert t_n == n_want


def test_compact_full_width_matches_boolean_index():
    cols = cols_for(3000, seed=4)
    mask = cols[0] > 0.5
    packed, n = compact(torch.from_numpy(cols), torch.from_numpy(mask))
    np.testing.assert_array_equal(packed.numpy()[:, :int(n)], cols[:, mask])


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_run_chain_compact_matches_repro_jnp(engine):
    preds_r, preds_t = cnf_chain(RP, "pair"), cnf_chain(TP, "pair")
    cols = cols_for(5000, seed=9)
    perm = np.asarray([2, 3, 4, 1, 0], np.int32)
    for cap in (64, 5000):
        want = r_engine("jnp").run_chain_compact(
            jnp.asarray(cols), RP.pack(preds_r), jnp.asarray(perm),
            RMonitor(100, 3), capacity=cap)
        got = get_engine(engine).run_chain_compact(
            torch.from_numpy(cols), TP.pack(preds_t), torch.from_numpy(perm),
            TMonitor(100, 3), capacity=cap)
        assert_result(got[0], want[0], engine)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert int(got[2]) == int(want[2])


def test_registry_surface():
    assert available_engines() == ("cuda", "numpy", "torch")
    with pytest.raises(ValueError, match="unknown filter engine"):
        get_engine("jnp")


def test_non_adjacent_group_members_rejected():
    preds = [TP.Predicate("a", 0, TP.OP_GT, 0.1, group="z"),
             TP.Predicate("b", 1, TP.OP_GT, 0.2),
             TP.Predicate("c", 2, TP.OP_GT, 0.3, group="z")]
    with pytest.raises(ValueError, match="not contiguous"):
        TP.pack(preds)
    assert TP.normalize_groups(
        [TP.Predicate("a", 0, TP.OP_GT, 0.1, group="z"),
         TP.Predicate("b", 1, TP.OP_GT, 0.2, group="z"),
         TP.Predicate("c", 2, TP.OP_GT, 0.3),
         TP.Predicate("d", 3, TP.OP_GT, 0.4, group=7)]) == (0, 0, 1, 2)
