"""Stats and ordering parity: the port's torch math against repro's jnp math.

After ``tests/test_ordering_parity.py``: the same per-batch monitor
results (made with numpy) folded through ``repro.core.ordering.advance``
and ``repro_torch.core.ordering.advance``. Perms, group perms, epochs and
counters exactly; ``adj_rank`` to rtol 1e-6 (summation order, as in
``tests/test_kernel_filter_chain.py:51-56``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ordering as RO  # noqa: E402
from repro.core import stats as RS  # noqa: E402
from repro_torch.core import ordering as TO  # noqa: E402
from repro_torch.core import stats as TS  # noqa: E402


def synthetic_batches(n_preds, n_batches, seed=0, n_mon_range=(50, 80)):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        n_mon = int(r.integers(*n_mon_range))
        cut = r.integers(0, n_mon, n_preds).astype(np.float32)
        costs = (r.uniform(0.5, 4.0, n_preds) * n_mon).astype(np.float32)
        out.append((cut, costs, np.float32(n_mon)))
    return out


def group_cut_of(cut, groups, n_groups):
    return np.asarray([cut[[i for i, g in enumerate(groups) if g == gg]]
                       .min() for gg in range(n_groups)], np.float32)


def assert_states(t_state, j_state):
    np.testing.assert_array_equal(t_state.perm.numpy(),
                                  np.asarray(j_state.perm))
    np.testing.assert_array_equal(t_state.group_perm.numpy(),
                                  np.asarray(j_state.group_perm))
    np.testing.assert_allclose(t_state.adj_rank.numpy(),
                               np.asarray(j_state.adj_rank), rtol=1e-6)
    for name in ("rows_into_epoch", "sample_phase", "epoch"):
        a, b = getattr(t_state, name), getattr(j_state, name)
        assert a.dtype == torch.int32
        assert int(a) == int(b), name
    for name in ("num_cut", "cost_acc", "n_monitored", "group_cut"):
        np.testing.assert_array_equal(
            getattr(t_state.stats, name).numpy(),
            np.asarray(getattr(j_state.stats, name)), err_msg=name)


@pytest.mark.parametrize("snap", [0.0, 1.05])
@pytest.mark.parametrize("groups", [None, (0, 0, 1, 2), (0, 1, 1, 1)])
def test_advance_parity_torch_vs_jnp(snap, groups):
    n_preds = 4
    n_groups = max(groups) + 1 if groups else n_preds
    r_cfg = RO.OrderingConfig(collect_rate=100, calculate_rate=150,
                              momentum=0.3, snap_threshold=snap)
    t_cfg = TO.OrderingConfig(collect_rate=100, calculate_rate=150,
                              momentum=0.3, snap_threshold=snap)
    st_j = RO.init_order_state(n_preds, n_groups, xp=jnp)
    st_t = TO.init_order_state(n_preds, n_groups)
    for cut, costs, n_mon in synthetic_batches(n_preds, 12):
        gcut = None if groups is None else group_cut_of(cut, groups,
                                                        n_groups)
        st_j = RO.advance(st_j, r_cfg, jnp.asarray(cut), jnp.asarray(costs),
                          jnp.asarray(n_mon), n_rows=64,
                          group_cut=None if gcut is None
                          else jnp.asarray(gcut), groups=groups, xp=jnp)
        st_t = TO.advance(st_t, t_cfg, torch.from_numpy(cut),
                          torch.from_numpy(costs), torch.tensor(n_mon),
                          n_rows=64, group_cut=None if gcut is None
                          else torch.from_numpy(gcut), groups=groups)
        assert_states(st_t, st_j)
    assert int(st_t.epoch) >= 3


def test_host_fire_decision_equals_device_read():
    """``fire`` passed from a host row mirror gives the same trajectory as
    reading ``rows_into_epoch`` on the device."""
    cfg = TO.OrderingConfig(collect_rate=10, calculate_rate=200)
    a = b = TO.init_order_state(3)
    rows = 0
    for cut, costs, n_mon in synthetic_batches(3, 10, seed=5):
        rows += 64
        fire = rows >= cfg.calculate_rate
        rows = rows % cfg.calculate_rate if fire else rows
        args = (torch.from_numpy(cut), torch.from_numpy(costs),
                torch.tensor(n_mon))
        a = TO.advance(a, cfg, *args, n_rows=64)
        b = TO.advance(b, cfg, *args, n_rows=64, fire=fire)
        assert torch.equal(a.perm, b.perm) and int(a.epoch) == int(b.epoch)
        assert int(b.rows_into_epoch) == rows


def test_saturation_decay_at_2_pow_22_matches_jnp():
    """Epochs past 2^22 monitored rows decay every accumulator by exactly
    0.5 before folding in — identically in both packages."""
    n_preds = 3
    r_cfg = RO.OrderingConfig(collect_rate=1, calculate_rate=1 << 30)
    t_cfg = TO.OrderingConfig(collect_rate=1, calculate_rate=1 << 30)
    st_j = RO.init_order_state(n_preds, xp=jnp)
    st_t = TO.init_order_state(n_preds)
    decayed = False
    for cut, costs, n_mon in synthetic_batches(
            n_preds, 10, seed=3, n_mon_range=(900_000, 1_100_000)):
        before = float(st_t.stats.n_monitored)
        st_j = RO.advance(st_j, r_cfg, jnp.asarray(cut), jnp.asarray(costs),
                          jnp.asarray(n_mon), n_rows=1 << 20, xp=jnp)
        st_t = TO.advance(st_t, t_cfg, torch.from_numpy(cut),
                          torch.from_numpy(costs), torch.tensor(n_mon),
                          n_rows=1 << 20)
        assert_states(st_t, st_j)
        if before >= TS.SAT_THRESHOLD:
            decayed = True
            assert float(st_t.stats.n_monitored) == before * 0.5 \
                + float(n_mon)
    assert decayed


def test_stats_functions_match_jnp():
    r = np.random.default_rng(1)
    groups = (0, 0, 1, 2, 2, 2)
    for _ in range(10):
        n = np.float32(r.integers(1, 5000))
        cut = r.integers(0, int(n), 6).astype(np.float32)
        j = RS.FilterStats(jnp.asarray(cut),
                           jnp.asarray(r.uniform(1, 9, 6).astype(np.float32)
                                       * n),
                           jnp.asarray(n), jnp.asarray(
                               group_cut_of(cut, groups, 3)))
        t = TS.FilterStats(*[torch.from_numpy(np.array(x)) for x in j])
        pairs = [
            (TS.selectivities(t), RS.selectivities(j)),
            (TS.normalized_costs(t), RS.normalized_costs(j)),
            (TS.ranks(t), RS.ranks(j)),
            (TS.member_ranks(t), RS.member_ranks(j)),
            (TS.group_selectivities(t), RS.group_selectivities(j)),
            (TS.group_normalized_costs(t, groups),
             RS.group_normalized_costs(j, groups)),
            (TS.group_ranks(t, groups), RS.group_ranks(j, groups)),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)


def test_cnf_order_matches_jnp_and_keeps_groups_contiguous():
    groups = (0, 1, 1, 2, 2, 2)
    r = np.random.default_rng(0)
    for i in range(20):
        # integer-valued ranks force ties: both packages break them alike
        grank = r.integers(0, 3, 3).astype(np.float32) if i % 2 \
            else r.uniform(0, 1, 3).astype(np.float32)
        mrank = r.integers(0, 3, 6).astype(np.float32) if i % 2 \
            else r.uniform(0, 1, 6).astype(np.float32)
        perm, gperm = TS.cnf_order(torch.from_numpy(grank),
                                   torch.from_numpy(mrank), groups)
        j_perm, j_gperm = RS.cnf_order(jnp.asarray(grank),
                                       jnp.asarray(mrank), groups)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(j_perm))
        np.testing.assert_array_equal(gperm.numpy(), np.asarray(j_gperm))
        assert perm.dtype == torch.int32 and gperm.dtype == torch.int32
        seq = [groups[k] for k in perm.tolist()]
        runs = [x for k, x in enumerate(seq) if k == 0 or seq[k - 1] != x]
        assert runs == gperm.tolist()


def test_no_evidence_epoch_keeps_order():
    cfg = TO.OrderingConfig(collect_rate=10, calculate_rate=10)
    st = TO.init_order_state(3)._replace(
        perm=torch.tensor([2, 0, 1], dtype=torch.int32))
    out = TO.epoch_update(st, cfg)
    assert out.perm.tolist() == [2, 0, 1] and int(out.epoch) == 0


def test_ordering_config_validation_matches():
    for kw in ({"collect_rate": 0}, {"calculate_rate": 0},
               {"momentum": 1.0}, {"snap_threshold": -1.0}):
        with pytest.raises(ValueError) as r_err:
            RO.OrderingConfig(**kw)
        with pytest.raises(ValueError) as t_err:
            TO.OrderingConfig(**kw)
        assert str(t_err.value) == str(r_err.value)
