"""The paper's surface on the card (``gpu``-marked; skips without a CUDA
device).

The machine with the card has no JAX, so this file imports only the port:
``process_stream`` of ``AdaptiveFilter(predicates, AdaptiveFilterConfig(
backend="cuda"))`` and of ``static_filter(..., backend="cuda")`` against
the ``numpy`` engine on a small drifting stream — masks, survivors, perms,
epochs and ``n_pass`` equal, ``work_units`` within rel 1e-5 — with one
chain-kernel launch a batch, and the survivors of ``compact_output=True``
out of the gather kernel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.data import stream as T_stream  # noqa: E402
from repro_torch.kernels.filter_chain import filter_chain as tfc  # noqa: E402

pytestmark = pytest.mark.gpu

N_BATCHES = 8
ORDERING = dict(collect_rate=100, calculate_rate=100_000, momentum=0.3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def batches(rows=65536):
    drift = T_stream.DriftConfig("regime", period_rows=150_000)
    return [T_stream.gen_batch(0, b, b * rows, rows, drift)
            for b in range(N_BATCHES)]


@pytest.mark.parametrize("kind", ["adaptive", "static", "compact"])
def test_cuda_stream_equals_numpy_stream(cuda, kind):
    preds = T.paper_filters_4("fig1")[::-1]
    cols = batches()
    runs = {}
    for backend in ("numpy", "cuda"):
        if kind == "static":
            filt = T.static_filter(preds, order=[2, 0, 3, 1],
                                   backend=backend)
        else:
            compact = kind == "compact" and backend == "cuda"
            filt = T.AdaptiveFilter(preds, T.AdaptiveFilterConfig(
                ordering=T.OrderingConfig(**ORDERING), backend=backend,
                compact_output=compact))   # batch width: lossless
        assert filt.device.type == ("cuda" if backend == "cuda" else "cpu")
        tfc.reset_launch_counts()
        runs[backend] = list(filt.process_stream(cols))
        launched = tfc.launch_counts()
    want_gather = N_BATCHES if kind == "compact" else 0
    assert launched == dict(chain=N_BATCHES, skip=0, gather=want_gather,
                            stats=0)
    for i, ((gs, gm, gd), (ws, wm, wd)) in enumerate(
            zip(runs["cuda"], runs["numpy"])):
        np.testing.assert_array_equal(gm, wm, err_msg=f"mask {i}")
        np.testing.assert_array_equal(gs, ws, err_msg=f"rows {i}")
        for k in ("perm", "epoch", "n_pass"):
            assert gd[k] == wd[k], (k, i)
        assert gd["work_units"] == pytest.approx(wd["work_units"], rel=1e-5)
    if kind != "static":
        assert runs["cuda"][-1][2]["epoch"] >= 2
