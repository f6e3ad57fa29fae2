"""The port's chain and gather kernels: twins against repro's Pallas kernels.

The twins (``filter_chain_twin``, ``compact_gather_twin``) carry the CUDA
kernels' exact per-tile contract; here they are held bit for bit against
``repro``'s ``filter_chain_pallas`` / ``compact_gather_pallas`` run in
interpret mode on the same numpy inputs, and the port's ``ops`` glue
against ``repro``'s. The CUDA kernels themselves run only on a card: the
``gpu``-marked tests hold them (the stats kernel and the chain kernel's
skip variant too) against their twins there, and the device tokenizer on
the card against the CPU's, where JAX is not installed — so ``repro`` is imported by the fixture of the tests that
compare with it, never at module level.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import predicates as TP  # noqa: E402
from repro_torch.data import tokenize_cases, tokenizer  # noqa: E402
from repro_torch.kernels.filter_chain import filter_chain as tfc  # noqa: E402
from repro_torch.kernels.filter_chain import gather_cases  # noqa: E402
from repro_torch.kernels.filter_chain import ops as t_ops  # noqa: E402

OUT_NAMES = ("mask", "active", "cut", "gcut", "nmon", "packed", "cnt")


@pytest.fixture
def ref(monkeypatch):
    """repro's Pallas kernels and ops, run in interpret mode on this JAX.

    JAX releases after those kernels were written dropped the
    ``pallas.load`` / ``pallas.store`` aliases of the ref primitives the
    kernels call; the fixture restores them for the duration of one test
    and then drops JAX's compile caches, so nothing traced with them
    outlives the test.
    """
    import importlib

    import jax
    import jax.numpy as jnp
    from jax._src.pallas import primitives
    from jax.experimental import pallas as pl

    from repro.core import predicates as RP
    from repro.kernels.filter_chain import ops as r_ops

    # the package re-exports a function named like this module
    r_fc = importlib.import_module("repro.kernels.filter_chain.filter_chain")

    for name in ("load", "store"):
        if not hasattr(pl, name):
            monkeypatch.setattr(pl, name, getattr(primitives, name),
                                raising=False)
    yield types.SimpleNamespace(jnp=jnp, P=RP, fc=r_fc, ops=r_ops)
    jax.clear_caches()


def chain(mod, n_preds, groups=None):
    base = [
        ("gt", 0, mod.OP_GT, 0.2, 0.0, 0, 1.0),
        ("lt", 1, mod.OP_LT, 0.7, 0.0, 0, 1.3),
        ("bet", 0, mod.OP_BETWEEN, 0.1, 0.9, 0, 2.0),
        ("eq", 2, mod.OP_EQ, 3.0, 0.0, 0, 0.7),
        ("mix", 3, mod.OP_HASHMIX, 0.45 * mod.MIX_MOD, 0.0, 6, 6.0),
        ("gt2", 1, mod.OP_GT, 0.05, 0.0, 0, 0.9),
    ][:n_preds]
    return [mod.Predicate(n, c, op, t1, t2=t2, rounds=r, static_cost=sc,
                          group=None if groups is None else groups[i])
            for i, (n, c, op, t1, t2, r, sc) in enumerate(base)]


def cols_for(n_rows, seed=0):
    r = np.random.default_rng(seed)
    return np.stack([
        r.uniform(0, 1, n_rows),
        r.uniform(0, 1, n_rows),
        r.integers(0, 8, n_rows).astype(np.float64),
        r.uniform(0, TP.MIX_MOD, n_rows),
    ]).astype(np.float32)


def both_specs(ref, n_preds, groups=None):
    return (ref.P.pack(chain(ref.P, n_preds, groups)),
            TP.pack(chain(TP, n_preds, groups)))


# (n_rows, n_preds, tile, mode, groups) — a spread over the reference sweep
CASES = [
    (64, 1, 256, 0, None),
    (64, 6, 2048, 1, None),
    (2048, 3, 256, 1, None),
    (2048, 6, 2048, 0, None),
    (5000, 1, 2048, 1, None),
    (5000, 3, 2048, 0, None),
    (5000, 6, 256, 0, None),
    (5000, 6, 256, 1, ("a", "a", None, "b", "b", None)),
    (2048, 6, 2048, 0, ("a", "a", "a", None, "b", "b")),
]


@pytest.mark.parametrize("n_rows,n_preds,tile,mode,groups", CASES)
def test_chain_twin_matches_pallas_per_tile(ref, n_rows, n_preds, tile,
                                            mode, groups):
    jnp = ref.jnp
    r_specs, t_specs = both_specs(ref, n_preds, groups)
    cols = cols_for(n_rows, seed=n_rows + n_preds)
    padded = np.pad(cols, ((0, 0), (0, (-n_rows) % tile)))
    perm = np.random.default_rng(n_preds).permutation(n_preds) \
        .astype(np.int32)
    if groups is not None:   # keep group members contiguous
        perm = np.asarray([3, 4, 5, 2, 0, 1] if groups[0] == groups[1] ==
                          groups[2] else [4, 3, 2, 5, 1, 0], np.int32)
    meta = np.asarray([n_rows, 37, 5, mode], np.int32)
    want = ref.fc.filter_chain_pallas(jnp.asarray(padded), r_specs,
                                      jnp.asarray(perm), jnp.asarray(meta),
                                      tile=tile, compact=True, fill=-1.5)
    got = tfc.filter_chain_twin(torch.from_numpy(padded), t_specs,
                                torch.from_numpy(perm),
                                torch.from_numpy(meta), tile=tile,
                                compact=True, fill=-1.5)
    for name, w, g in zip(OUT_NAMES, want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the mask-only launch is the same per-tile prefix
    got5 = tfc.filter_chain_twin(torch.from_numpy(padded), t_specs,
                                 torch.from_numpy(perm),
                                 torch.from_numpy(meta), tile=tile)
    assert len(got5) == 5
    for w, g in zip(got[:5], got5):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("n_rows,tile,capacity,saturates", [
    (5000, 256, 1, True), (5000, 256, 97, True), (5000, 2048, 5000, False),
    (777, 256, 2000, False),
])
def test_gather_twin_matches_pallas(ref, n_rows, tile, capacity, saturates):
    jnp = ref.jnp
    _, t_specs = both_specs(ref, 3)
    cols = cols_for(n_rows, seed=3)
    padded = np.pad(cols, ((0, 0), (0, (-n_rows) % tile)))
    meta = np.asarray([n_rows, 64, 0, 0], np.int32)
    *_, packed, cnt = tfc.filter_chain_twin(
        torch.from_numpy(padded), t_specs, torch.arange(3, dtype=torch.int32),
        torch.from_numpy(meta), tile=tile, compact=True)
    cnt = cnt[:, 0]
    offsets = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
    want = ref.fc.compact_gather_pallas(jnp.asarray(packed.numpy()),
                                        jnp.asarray(offsets.numpy()),
                                        capacity, tile=tile)
    got = tfc.compact_gather_twin(packed, offsets, cnt, capacity, tile=tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (int(cnt.sum()) > capacity) == saturates


@pytest.mark.parametrize("label", gather_cases.HAZARDS)
def test_gather_twin_matches_pallas_on_hazards(ref, label):
    """The gather's hazards, twin against ``compact_gather_pallas`` bit for
    bit (int32 views: NaN fills compare, and ±0 differ)."""
    packed, off, cnt, capacity, fill = gather_cases.hazard(
        label, 12 * 256 - 71, tile=256, fill_tails=True)
    want = ref.fc.compact_gather_pallas(
        ref.jnp.asarray(packed.numpy()), ref.jnp.asarray(off.numpy()),
        capacity, tile=256, fill=fill)
    got = tfc.compact_gather_twin(packed, off, cnt, capacity, tile=256,
                                  fill=fill)
    assert got.shape == (packed.shape[0], capacity)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("n_rows,n_preds,mode", [
    (1000, 3, "row"), (5000, 6, "row"), (10_000, 4, "block"),
])
def test_ops_match_repro_ops(ref, n_rows, n_preds, mode):
    jnp, r_ops = ref.jnp, ref.ops
    r_specs, t_specs = both_specs(ref, n_preds)
    cols = cols_for(n_rows, seed=11)
    perm = np.arange(n_preds, dtype=np.int32)[::-1].copy()
    kw = dict(collect_rate=37, sample_phase=5, monitor_mode=mode)
    want = r_ops.filter_chain(jnp.asarray(cols), r_specs, jnp.asarray(perm),
                              **kw)
    got = t_ops.filter_chain(torch.from_numpy(cols), t_specs,
                             torch.from_numpy(perm), **kw)
    cap = 300
    w_res, w_packed, w_kept = r_ops.filter_chain_compact(
        jnp.asarray(cols), r_specs, jnp.asarray(perm), capacity=cap, **kw)
    g_res, g_packed, g_kept = t_ops.filter_chain_compact(
        torch.from_numpy(cols), t_specs, torch.from_numpy(perm),
        capacity=cap, **kw)
    for w_r, g_r in ((want, got), (w_res, g_res)):
        for field in ("mask", "cut_counts", "n_monitored",
                      "group_cut_counts", "active_before"):
            np.testing.assert_array_equal(
                getattr(g_r, field).numpy(), np.asarray(getattr(w_r, field)),
                err_msg=field)
        for field in ("work_units", "monitor_cost"):
            np.testing.assert_allclose(
                getattr(g_r, field).numpy(), np.asarray(getattr(w_r, field)),
                rtol=1e-6, err_msg=field)
    np.testing.assert_array_equal(g_packed.numpy(), np.asarray(w_packed))
    assert int(g_kept) == int(w_kept)


def test_cpu_wrappers_run_the_twins_without_counting():
    t_specs = TP.pack(chain(TP, 3))
    cols = torch.from_numpy(np.pad(cols_for(2048), ((0, 0), (0, 0))))
    meta = torch.tensor([2048, 10, 0, 0], dtype=torch.int32)
    perm = torch.arange(3, dtype=torch.int32)
    before = (tfc.filter_chain_kernel.launches,
              tfc.compact_gather_kernel.launches)
    got = tfc.filter_chain_kernel(cols, t_specs, perm, meta, compact=True)
    want = tfc.filter_chain_twin(cols, t_specs, perm, meta, compact=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    cnt = got[-1][:, 0]
    off = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
    g = tfc.compact_gather_kernel(got[5], off, cnt, 100)
    np.testing.assert_array_equal(
        g.numpy(), tfc.compact_gather_twin(got[5], off, cnt, 100).numpy())
    assert (tfc.filter_chain_kernel.launches,
            tfc.compact_gather_kernel.launches) == before


def test_wrappers_refuse_other_devices():
    t_specs = TP.pack(chain(TP, 2))
    cols = torch.empty((4, 2048), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfc.filter_chain_kernel(cols, t_specs, torch.arange(2),
                                torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        tfc.compact_gather_kernel(cols, torch.zeros(1), torch.zeros(1), 8)


def test_build_dir_is_inside_the_checkout():
    root = tfc.build_dir().parents[1]
    assert (root / "src" / "repro_torch").is_dir()
    assert tfc.build_dir().name == "repro_torch_kernels"
    assert tfc.SOURCE.is_file()
    assert "--use_fast_math" not in tfc.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in tfc.NVCC_FLAGS


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [64, 5000, 2048 * 37 + 777])
def test_cuda_kernels_match_twins_on_card(n_rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    t_specs = TP.pack(chain(TP, 6, ("a", "a", None, "b", "b", None)), dev)
    cols = torch.from_numpy(cols_for(n_rows, seed=7)).to(dev)
    padded = torch.nn.functional.pad(cols, (0, (-n_rows) % 2048))
    perm = torch.tensor([4, 3, 2, 5, 1, 0], dtype=torch.int32, device=dev)
    for mode in (0, 1):
        meta = torch.tensor([n_rows, 37, 5, mode], dtype=torch.int32,
                            device=dev)
        got = tfc.filter_chain_kernel(padded, t_specs, perm, meta,
                                      compact=True, fill=-2.0)
        want = tfc.filter_chain_twin(padded, t_specs, perm, meta,
                                     compact=True, fill=-2.0)
        for name, g, w in zip(OUT_NAMES, got, want):
            assert torch.equal(g, w), name
        cnt = got[6][:, 0]
        off = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
        for cap in (1, 100, n_rows):
            g = tfc.compact_gather_kernel(got[5], off, cnt, cap, fill=-2.0)
            w = tfc.compact_gather_twin(got[5], off, cnt, cap, fill=-2.0)
            assert torch.equal(g, w), cap
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [2048, 2048 * 37 + 777])
def test_stats_and_skip_chain_kernels_match_twins_on_card(n_rows):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.core import skip_tier

    dev = torch.device("cuda")
    cols = cols_for(n_rows, seed=9)
    cols[0, 5] = np.nan                        # NaN, ±inf, ±0 in sub-tiles
    cols[1, 300:302] = [np.inf, -np.inf]
    cols[2, 512:640] = 0.0
    cols[2, 520] = -0.0
    cols = np.ascontiguousarray(               # clustered on column 0
        cols[:, np.lexsort((cols[1], cols[0]))])
    padded = torch.nn.functional.pad(torch.from_numpy(cols).to(dev),
                                     (0, (-n_rows) % 2048))
    got = tfc.tile_stats_kernel(padded)
    want = tfc.tile_stats_twin(padded)
    torch.cuda.synchronize()
    for g, w in zip(got, want):              # NaN positions, then == (±0)
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        keep = ~torch.isnan(w)
        assert bool((g[keep] == w[keep]).all())
    t_specs = TP.pack(chain(TP, 6, ("a", "a", None, "b", "b", None)), dev)
    pas, fail = skip_tier.resolve_tiles(*got, skip_tier.bloom_bitmap(padded),
                                        t_specs)
    assert bool(fail.any())
    r = np.random.default_rng(n_rows)
    rand = (r.uniform(size=pas.shape[0]) < 0.3,
            r.uniform(size=pas.shape[0]) < 0.3)
    perm = torch.tensor([4, 3, 2, 5, 1, 0], dtype=torch.int32, device=dev)
    for decisions in ((pas, fail), rand):
        decisions = tuple(torch.as_tensor(d).to(device=dev,
                                                dtype=torch.int32)
                          for d in decisions)
        for mode in (0, 1):
            meta = torch.tensor([n_rows, 37, 5, mode], dtype=torch.int32,
                                device=dev)
            for compact in (False, True):
                got = tfc.filter_chain_kernel(padded, t_specs, perm, meta,
                                              compact=compact, fill=-2.0,
                                              skip_decisions=decisions)
                want = tfc.filter_chain_twin(padded, t_specs, perm, meta,
                                             compact=compact, fill=-2.0,
                                             skip_decisions=decisions)
                for name, g, w in zip(OUT_NAMES, got, want):
                    assert torch.equal(g, w), (name, mode, compact)
    torch.cuda.synchronize()


HAZARD_ROWS = 2048 * 41 + 13            # not a multiple of 8, 32 or 2048


def hazard_case(label, dev):
    """(padded f32[4, Rp], specs, perm, meta) of one of the chain kernel's
    hazards at HAZARD_ROWS rows."""
    n = HAZARD_ROWS
    cols = cols_for(n, seed=4)
    mix = TP.MIX_MOD
    meta = [n, 1000, 7, 0]
    if label == "warps_without_pending_rows":
        # column 0 sorted inside every full tile: the GT cuts whole warps
        # while the rest of the tile stays pending
        full = n // 2048 * 2048
        order = np.argsort(cols[0, :full].reshape(-1, 2048), axis=1,
                           kind="stable") + np.arange(0, full, 2048)[:, None]
        cols[:, :full] = cols[:, order.reshape(-1)]
        preds = [TP.Predicate("gt", 0, TP.OP_GT, 0.6),
                 TP.Predicate("lt", 1, TP.OP_LT, 0.3, group="or"),
                 TP.Predicate("mix", 3, TP.OP_HASHMIX, 0.45 * mix, rounds=24,
                              group="or")]
        perm = [0, 2, 1]
    elif label == "p_g_32":                    # 32 singleton groups
        preds = []
        for i in range(tfc.MAX_PREDS):
            if i % 4 == 0:
                preds.append(TP.Predicate(f"gt{i}", 0, TP.OP_GT,
                                          0.01 * (i % 7)))
            elif i % 4 == 1:
                preds.append(TP.Predicate(f"lt{i}", 1, TP.OP_LT,
                                          1 - 0.01 * (i % 7)))
            elif i == 30:
                preds.append(TP.Predicate(f"eq{i}", 2, TP.OP_EQ, 3.0))
            elif i % 4 == 2:
                preds.append(TP.Predicate(f"bet{i}", 2, TP.OP_BETWEEN,
                                          -0.5 + (i % 3 == 0), t2=7.5))
            else:
                preds.append(TP.Predicate(f"mix{i}", 3, TP.OP_HASHMIX,
                                          0.03 * mix, rounds=1 + i % 24))
        perm = np.random.default_rng(32).permutation(tfc.MAX_PREDS).tolist()
        meta = [n, 37, 3, 0]
    elif label == "hashmix_first":             # every row pending at it
        preds = [TP.Predicate("gt", 0, TP.OP_GT, 0.2),
                 TP.Predicate("lt", 1, TP.OP_LT, 0.3, group="or"),
                 TP.Predicate("mix", 3, TP.OP_HASHMIX, 0.45 * mix, rounds=24,
                              group="or")]
        perm = [2, 1, 0]
    else:                                      # the grouped six-chain
        preds = chain(TP, 6, ("a", "a", None, "b", "b", None))
        perm = [4, 3, 2, 5, 1, 0]
        if label == "block_mode_stride_1":     # collect_rate 16: stride 1
            meta = [n, 16, 5, 1]
    padded = torch.nn.functional.pad(torch.from_numpy(cols).to(dev),
                                     (0, (-n) % 2048))
    return (padded, TP.pack(preds, dev),
            torch.tensor(perm, dtype=torch.int32, device=dev),
            torch.tensor(meta, dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("label", [
    "ragged_rows", "warps_without_pending_rows", "p_g_32",
    "block_mode_stride_1", "hashmix_first"])
def test_chain_kernel_hazards_match_twin_on_card(label):
    """The chain kernel's hazards, small (``chip_smoke.py`` phase 2c holds
    the same kinds at a larger width): every output of the mask-only,
    packed and skip variants bit-identical to the twin, the skip decisions
    mixing pass, fail and ambiguous sub-tiles in every tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    padded, specs, perm, meta = hazard_case(label, dev)
    sub = torch.arange(padded.shape[1] // tfc.STAT_TILE, device=dev) % 3
    mixed = ((sub == 0).to(torch.int32), (sub == 1).to(torch.int32))
    for dec in (None, mixed):
        for compact in (False, True):
            kw = dict(compact=compact, fill=-1.0, skip_decisions=dec)
            got = tfc.filter_chain_kernel(padded, specs, perm, meta, **kw)
            want = tfc.filter_chain_twin(padded, specs, perm, meta, **kw)
            for name, g, w in zip(OUT_NAMES, got, want):
                assert g.dtype == w.dtype and g.shape == w.shape, name
                assert torch.equal(g, w), (name, dec is None, compact)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("label",
                         gather_cases.HAZARDS + gather_cases.HAZARDS_WIDE)
def test_gather_kernel_hazards_match_twin_on_card(label):
    """The gather's hazards, kernel against twin bit for bit (int32 views).
    The kernel's output lands in a freed block that held SENTINEL_BITS in
    every slot, so a slot it never writes shows as that payload."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    packed, off, cnt, capacity, fill = gather_cases.hazard(
        label, 37 * 2048 - 5, device="cuda")
    got, in_sentinel = gather_cases.gather_in_sentinel(packed, off, cnt,
                                                       capacity, fill)
    assert in_sentinel, "the kernel did not get the sentinel block"
    want = tfc.compact_gather_twin(packed, off, cnt, capacity, fill=fill)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("case", tokenize_cases.cases(), ids=lambda c: c[0])
def test_device_tokenize_on_card_matches_cpu(case):
    """``tokens_from_padded`` on the card equals the CPU's bit for bit on
    the edge block (NaN payloads, ±inf, ±0, subnormals; counts 0, partial
    and full; one and three pipelines; vocab 2 to 2^24 - 1): the whole
    token tensor, zero tail included, and ``n_valid``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's tokenize runs there")
    _, packed, counts, vocab, t = case
    packed, counts = torch.from_numpy(packed), torch.from_numpy(
        np.asarray(counts))
    want, want_n = tokenizer.tokens_from_padded(packed, counts, vocab, t)
    got, got_n = tokenizer.tokens_from_padded(packed.cuda(), counts.cuda(),
                                              vocab, t)
    assert got.device.type == "cuda" and got_n.device.type == "cuda"
    assert torch.equal(got.cpu(), want) and int(got_n) == int(want_n)
