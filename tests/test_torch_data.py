"""The port's TokenStream: a batch is a pure function of (seed, step).

The JAX package draws its batches from threefry, which PyTorch does not
have, so these tests hold the port to the same contract rather than the same
bits: determinism, resume, shapes, dtypes, the vocabulary range, EOS, and the
shift between tokens and labels (mirroring ``tests/data/test_pipeline.py``).
"""

import numpy as np
import pytest
import torch

from repro.data import TokenStream as JaxTokenStream
from repro_torch.data import TokenStream


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
