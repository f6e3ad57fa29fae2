"""The port's hash tokenizer against ``repro.data.tokenizer``.

The host hash (numpy u64) must equal ``repro``'s; the torch device path's
int64 pieces (splitmix64, the f32 → f64 bit widening, the modulo) must
equal numpy's u64 arithmetic; and ``tokens_from_padded`` must equal
``repro``'s jitted device tokenizer bit for bit, whole tensor (zero tail
included) and ``n_valid``. ``repro``'s tokenizer is compiled here only at
``tokens_per_row`` 1 and 2: XLA:CPU's compile time grows steeply with it
(minutes at 8), so at 8 the port is held to ``rows_to_tokens``, which the
first test holds to ``repro``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import tokenizer as R_tok  # noqa: E402

from repro_torch.data import tokenize_cases  # noqa: E402
from repro_torch.data import tokenizer as T_tok  # noqa: E402

VOCAB = 152_064


def u64_inputs(n=20_000, seed=0):
    x = np.random.default_rng(seed).integers(0, 2 ** 64, n, dtype=np.uint64)
    x[:4] = [0, 1, 2 ** 63, 2 ** 64 - 1]
    return x


def edge_floats(seed=1):
    """The edge floats of ``tests/test_tokenizer_u32.py`` and random ones."""
    edge = np.array([0.0, -0.0, 1.0, -1.0, 0.5, 2.0, 3.14159, 65504.0,
                     np.inf, -np.inf, np.nan,
                     np.float32(2 ** -149), -np.float32(2 ** -149),
                     np.float32(1.1754942e-38), np.float32(2 ** -126),
                     np.float32(3.4028235e38)], np.float32)
    edge = np.concatenate([edge, np.array(
        [0x7F800001, 0xFF800001, 0x7FBFFFFF, 0x7FC00001, 0xFF812345],
        np.uint32).view(np.float32)])
    rng = np.random.default_rng(seed)
    return np.concatenate([
        edge,
        rng.normal(0, 1e3, 20_000).astype(np.float32),
        rng.uniform(-1e-40, 1e-40, 5_000).astype(np.float32),
        rng.uniform(-1e-30, 1e30, 5_000).astype(np.float32),
        rng.integers(0, 2 ** 32, 20_000, dtype=np.uint64)
        .astype(np.uint32).view(np.float32)])


def as_i64(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int64))


def test_host_hash_matches_repro():
    x = u64_inputs()
    np.testing.assert_array_equal(T_tok._splitmix(x.copy()),
                                  R_tok._splitmix(x.copy()))
    cols = edge_floats().reshape(1, -1)
    cols = np.concatenate([cols, cols[:, ::-1], np.roll(cols, 7, axis=1)])
    for vocab, t in ((1000, 8), (VOCAB, 3), ((1 << 24) - 1, 1)):
        np.testing.assert_array_equal(T_tok.rows_to_tokens(cols, vocab, t),
                                      R_tok.rows_to_tokens(cols, vocab, t))
    assert T_tok.rows_to_tokens(cols[:, :0], 1000).shape == (0,)


def test_int64_splitmix_matches_u64():
    x = u64_inputs()
    got = T_tok.splitmix64(as_i64(x)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, T_tok._splitmix(x))


def test_f64_bit_widening_matches_numpy():
    vals = edge_floats()
    with np.errstate(invalid="ignore"):
        want = vals.astype(np.float64).view(np.uint64)
    got = T_tok.f64_bits_of_f32(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), want)


@pytest.mark.parametrize("vocab", [2, 7, 1000, 50_257, 151_936,
                                   (1 << 24) - 1])
def test_mod_u64_is_exact(vocab):
    x = u64_inputs(seed=2)
    got = T_tok.mod_u64(as_i64(x), vocab).numpy()
    np.testing.assert_array_equal(got.astype(np.uint64),
                                  x % np.uint64(vocab))


# ----------------------------------------- against repro's device tokenizer
def _reference_inputs():
    rng = np.random.default_rng(3)
    packed3 = rng.normal(0, 100, (3, 4, 128)).astype(np.float32)
    packed3[0, :, 100:] = 0.0
    packed1 = rng.normal(0, 100, (4, 128)).astype(np.float32)
    return {
        "S3": (packed3, np.asarray([100, 0, 127], np.int32)),
        "S1_count0": (packed1, np.int32(0)),
        "S1_full": (packed1, np.int32(128)),
        "S1_partial": (packed1, np.int32(77)),
    }


@pytest.fixture(scope="module")
def reference_tokens():
    """repro's jitted tokenizer on each input, at T = 1 and 2: one compile
    per shape and T for the whole module."""
    import jax.numpy as jnp

    out = {}
    for label, (packed, counts) in _reference_inputs().items():
        for t in (1, 2):
            toks, n = R_tok.tokens_from_padded(
                jnp.asarray(packed), jnp.asarray(counts), VOCAB, t)
            out[label, t] = (np.asarray(toks), int(n))
    return out


@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("label", list(_reference_inputs()))
def test_tokens_from_padded_matches_repro(reference_tokens, label, t):
    packed, counts = _reference_inputs()[label]
    toks, n = T_tok.tokens_from_padded(torch.from_numpy(packed),
                                       torch.from_numpy(np.asarray(counts)),
                                       VOCAB, t)
    want_toks, want_n = reference_tokens[label, t]
    assert toks.dtype == torch.int32 and n.dtype == torch.int32
    assert n.shape == () and int(n) == want_n
    np.testing.assert_array_equal(toks.numpy(), want_toks)


@pytest.mark.parametrize("case", tokenize_cases.cases(),
                         ids=lambda c: c[0])
def test_tokens_from_padded_matches_host_hash_at_8(case):
    """The edge block (NaN payloads, ±inf, ±0, subnormals; counts 0,
    partial, full; one and three pipelines): live tokens equal
    ``rows_to_tokens`` of the concatenated survivors, the tail is zero."""
    _, packed, counts, vocab, t = case
    toks, n = T_tok.tokens_from_padded(torch.from_numpy(packed),
                                       torch.from_numpy(np.asarray(counts)),
                                       vocab, t)
    shards = packed[None] if packed.ndim == 2 else packed
    cnt = np.atleast_1d(counts)
    host = np.concatenate([shards[s][:, :cnt[s]] for s in range(len(cnt))],
                          axis=1)
    want = T_tok.rows_to_tokens(host, vocab, t)
    assert int(n) == want.size
    assert toks.shape == (shards.shape[0] * shards.shape[2] * t,)
    np.testing.assert_array_equal(toks.numpy()[:want.size], want)
    assert not toks[want.size:].any()


@pytest.mark.parametrize("vocab", [0, 1 << 24, (1 << 24) + 5])
def test_vocab_rejections_match_repro(vocab):
    with pytest.raises(ValueError) as want:
        R_tok.tokens_from_padded(np.zeros((1, 2, 8), np.float32),
                                 np.zeros((1,), np.int32), vocab)
    with pytest.raises(ValueError) as got:
        T_tok.tokens_from_padded(torch.zeros((1, 2, 8)),
                                 torch.zeros((1,), dtype=torch.int32), vocab)
    assert str(got.value) == str(want.value)
