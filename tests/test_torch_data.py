"""The port's TokenStream: a batch is a pure function of (seed, step), drawn
from JAX's threefry stream.

The contract of ``tests/data/test_pipeline.py`` (determinism, resume,
shapes, dtypes, the vocabulary range, EOS, the shift between tokens and
labels), and the same numbers as the JAX package: ``PRNGKey``, ``fold_in``,
``split`` and float32 ``uniform`` bit for bit, and the tokens equal
everywhere except where float32 ``exp`` lands within one float32 ulp of an
integer (PyTorch's and XLA's ``exp`` round differently there, so the int
cast may fall on either side).
"""

import jax
import numpy as np
import pytest
import torch

from repro.data import TokenStream as JaxTokenStream
from repro_torch.data import TokenStream, threefry

#: (vocab_size, batch, seq_len, seed, mean_doc_len, step) of the stream cases
STREAMS = [
    (1000, 4, 32, 7, 64.0, 0),
    (1000, 4, 32, 7, 64.0, 5),
    (300, 8, 256, 3, 16.0, 1),
    (151552, 2, 1024, 0, 64.0, 0),
    (50, 3, 100, 11, 8.0, 1000),
    (32000, 1, 4097, 2**31 + 5, 64.0, 77),
]


def stream(**kw):
    return TokenStream(device="cpu", **kw)


def test_batch_is_pure_function_of_step():
    a = stream(vocab_size=1000, batch=4, seq_len=32, seed=7)
    b = stream(vocab_size=1000, batch=4, seq_len=32, seed=7)
    for _ in range(3):
        next(a)
    assert torch.equal(a.batch_at(5)["tokens"], b.batch_at(5)["tokens"])
    assert torch.equal(a.batch_at(5)["labels"], b.batch_at(5)["labels"])


def test_resume_reproduces_stream():
    a = stream(vocab_size=1000, batch=2, seq_len=16, seed=1)
    seen = [next(a)["tokens"] for _ in range(6)]
    state = a.state_dict()
    b = stream(vocab_size=1000, batch=2, seq_len=16, seed=1)
    b.load_state_dict({"step": 3, "seed": 1})
    for i in range(3):
        assert torch.equal(next(b)["tokens"], seen[3 + i])
    assert state == {"step": 6, "seed": 1}


def test_state_dict_matches_the_jax_stream():
    j = JaxTokenStream(vocab_size=100, batch=1, seq_len=4, seed=5)
    t = stream(vocab_size=100, batch=1, seq_len=4, seed=5)
    for _ in range(3):
        next(j), next(t)
    assert t.state_dict() == j.state_dict()
    t2 = stream(vocab_size=100, batch=1, seq_len=4, seed=5)
    t2.load_state_dict(j.state_dict())
    assert t2.step == 3


def test_restoring_another_seed_raises():
    with pytest.raises(ValueError, match="seed"):
        stream(vocab_size=100, batch=1, seq_len=4, seed=5).load_state_dict({"step": 1, "seed": 6})


def test_labels_are_next_tokens():
    s = stream(vocab_size=500, batch=2, seq_len=16, seed=0)
    b = s.batch_at(0)
    assert b["tokens"].shape == (2, 16) and b["labels"].shape == (2, 16)
    assert b["tokens"].dtype == torch.int32 and b["labels"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_vocab_bounds_and_eos():
    s = stream(vocab_size=300, batch=8, seq_len=256, seed=3, mean_doc_len=16.0)
    toks = next(s)["tokens"].numpy()
    assert toks.min() >= 0 and toks.max() < 300
    assert ((toks == 0) | (toks >= 1)).all()
    frac = (toks == s.eos).mean()
    assert 0.03 < frac < 0.10  # 1/16 expected
    # log-rank uniform: about half the non-EOS tokens below sqrt(V)
    low = (toks[toks != 0] < np.sqrt(299)).mean()
    assert 0.4 < low < 0.6


def test_different_seeds_and_steps_differ():
    a = stream(vocab_size=1000, batch=2, seq_len=64, seed=0)
    b = stream(vocab_size=1000, batch=2, seq_len=64, seed=1)
    assert not torch.equal(a.batch_at(0)["tokens"], b.batch_at(0)["tokens"])
    assert not torch.equal(a.batch_at(0)["tokens"], a.batch_at(1)["tokens"])


def test_default_device_is_the_card():
    s = TokenStream(vocab_size=100, batch=1, seq_len=4)
    if torch.cuda.is_available():
        assert s.batch_at(0)["tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            s.batch_at(0)


def key_of(k) -> tuple[int, int]:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, -1, -5, 2**31 - 1, 2**31 + 5, 2**33 + 3])
def test_prng_key_is_jax(seed):
    assert threefry.prng_key(seed) == key_of(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed, data", [(0, 0), (7, 123), (5, 2**32 - 1), (2**31 + 5, 9)])
def test_fold_in_and_split_are_jax(seed, data):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    tk = threefry.fold_in(threefry.prng_key(seed), data)
    assert tk == key_of(jk)
    for num in (2, 3, 7):
        assert threefry.split(tk, num) == [key_of(k) for k in jax.random.split(jk, num)]


@pytest.mark.parametrize("shape", [(1,), (3, 5), (2, 4097), (7, 1, 33)])
def test_uniform_is_jax_bit_for_bit(shape):
    jk = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 17))[1]
    want = np.asarray(jax.random.uniform(jk, shape))
    got = threefry.uniform(key_of(jk), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def exp_near_integer(u: np.ndarray, vocab_size: int) -> np.ndarray:
    """Where float32 ``exp(u * log(V - 1))`` lies within one float32 ulp of an
    integer: the only places the two packages' int casts may disagree."""
    x = u * np.float32(np.log(vocab_size - 1))  # float32, as both compute it
    e = np.exp(x.astype(np.float64))  # exact enough to locate the integer
    return np.abs(e - np.round(e)) <= np.spacing(e.astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("vocab_size, batch, seq_len, seed, mean_doc_len, step", STREAMS)
def test_batches_are_jax_except_at_exp_ulp_ties(vocab_size, batch, seq_len, seed, mean_doc_len, step):
    kw = dict(vocab_size=vocab_size, batch=batch, seq_len=seq_len, seed=seed, mean_doc_len=mean_doc_len)
    want = JaxTokenStream(**kw).batch_at(step)
    got = stream(**kw).batch_at(step)
    k1, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step))
    u = np.asarray(jax.random.uniform(k1, (batch, seq_len + 1)))
    tie = exp_near_integer(u, vocab_size)
    for name, sl in (("tokens", slice(None, -1)), ("labels", slice(1, None))):
        w, g = np.asarray(want[name]), got[name].numpy()
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        diff = w != g
        assert not (diff & ~tie[:, sl]).any(), f"{name}: tokens differ away from an exp ulp tie"
        assert (np.abs(w.astype(np.int64) - g)[diff] <= 1).all()
