"""Sharded sessions and the sharded pipeline on the card (``gpu``-marked;
they skip without a CUDA device).

The machine with the card has no JAX, so this file imports only the port:
in every scope and exchange mode the ``cuda`` engine — one chain launch
per shard a step, and one gather per shard when compacting — equals the
``torch`` engine on the card bit for bit (masks, packed survivors,
``n_kept``, perms, ``save_state`` arrays); the sharded device-tokenize
pipeline gives the same LM batches on both engines and restores 4→2→4 on
the card; the CPU (the kernels' twins) gives what the card gives.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.data import pipeline as T_pipe  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402
from repro_torch.kernels.filter_chain import filter_chain as tfc  # noqa: E402

pytestmark = pytest.mark.gpu

S, R_ROWS, N_STEPS = 4, 65_536, 3
ORDER = dict(collect_rate=32, calculate_rate=100_000, momentum=0.3)
DRIFT = T_stream.DriftConfig("regime", period_rows=131_072, amplitude=1.5)
CASES = [("per_shard", "eager"), ("per_batch", "eager"),
         ("centralized", "eager"), ("centralized", "deferred"),
         ("centralized", "deferred-async")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def plan(engine, **kw):
    return T.FilterPlan(T.paper_filters_cnf("fig1"),
                        T.OrderingConfig(**ORDER), engine=engine,
                        shards=kw.pop("shards", S), **kw)


def sharded_batches():
    cols = [rb.columns for rb in T_stream.LogStream(
        S * N_STEPS * R_ROWS, R_ROWS, seed=0, drift=DRIFT)]
    return [np.concatenate(cols[k * S:(k + 1) * S], axis=1)
            for k in range(N_STEPS)]


def run(p, dev):
    sess = T.build_session(p, device=dev)
    state, steps = sess.init_state(), []
    for cols in sharded_batches():
        state, res = sess.step(state, torch.from_numpy(cols).to(dev))
        steps.append((res.mask.cpu(), state.perm.cpu(),
                      None if res.packed is None else res.packed.cpu(),
                      None if res.n_kept is None else res.n_kept.cpu()))
    return steps, sess.save_state(state)["arrays"]


def assert_same(a, b):
    (sa, aa), (sb, ab) = a, b
    for x, y in zip(sa, sb):
        for u, v in zip(x, y):
            assert (u is None and v is None) or torch.equal(u, v)
    for k, v in aa.items():
        assert v.dtype == ab[k].dtype and np.array_equal(v, ab[k]), k


@pytest.mark.parametrize("compact", [False, True], ids=["mask", "compact"])
@pytest.mark.parametrize("scope,exchange", CASES)
def test_cuda_equals_torch_on_card_and_cpu(cuda, scope, exchange, compact):
    kw = dict(scope=scope, exchange=exchange)
    if compact:
        kw.update(compact=True, capacity="auto")
    tfc.reset_launch_counts()
    card = run(plan("cuda", **kw), cuda)
    launched = tfc.launch_counts()
    assert launched["chain"] == S * N_STEPS
    assert launched["gather"] == (S * N_STEPS if compact else 0)
    assert_same(card, run(plan("torch", **kw), cuda))
    assert_same(card, run(plan("cuda", **kw), "cpu"))
    if scope == "centralized":
        for _, perm, _, _ in card[0]:
            assert (perm == perm[0]).all()


def test_sharded_tokenize_pipeline_on_card(cuda):
    spec = T.TokenizeSpec(152_064, 8)
    lm = dict(batch_size=4, seq_len=255)

    def pipeline(engine, shards=S):
        p = plan(engine, shards=shards, scope="centralized",
                 exchange="deferred", compact=True, capacity="auto",
                 tokenize=spec)
        return T_pipe.make_pipeline(
            T.build_session(p, device=cuda), total_rows=S * N_STEPS * R_ROWS,
            batch_rows=R_ROWS, seed=0, drift=DRIFT, **lm)

    pipe, got, st = pipeline("cuda"), [], None
    for b in pipe:
        got.append(b)
        if st is None and pipe.streams[-1].cursor == 2 * S:
            st = pipe.state()
    want = list(pipeline("torch"))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g["tokens"], w["tokens"])
        assert np.array_equal(g["labels"], w["labels"])
    two = pipeline("cuda", shards=2)
    two.restore(st)
    assert two._fstate.perm.device.type == "cuda"
    assert tuple(two._fstate.perm.shape) == (2, 4)
    assert next(iter(two))["tokens"].shape == (4, 255)
    back = pipeline("cuda")
    back.restore(two.state())
    assert tuple(back._fstate.perm.shape) == (S, 4)
