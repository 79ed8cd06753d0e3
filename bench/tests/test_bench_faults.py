"""A run with the timed path broken underneath comes out not correct: for
each fault the cell can have (a train step that returns its state unchanged,
half of the batch left out with the mean over the rest, a served token
altered where it is produced).  The look for a card is skipped; the rest of
the run is the same code as on the card."""

from __future__ import annotations

import pytest
import torch

from bench.harness import cell
from repro_torch.train import steps

SEED = 2**32 + 3


def _unchanged(make):
    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(params, opt_state, batch):
            return params, opt_state, step(params, opt_state, batch)[2]

        return broken

    return factory


def _half_batch(make):
    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(params, opt_state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(params, opt_state, {k: v[:rows] for k, v in batch.items()})

        return broken

    return factory


@pytest.mark.parametrize("workload", ["dense-tiny.train-tiny", "ssm-tiny.train-tiny"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_train_step_is_not_correct(tiny_root, monkeypatch, workload, fault):
    monkeypatch.setattr(steps, "make_train_step", fault(steps.make_train_step))
    result, _ = cell.run(tiny_root, workload, SEED, 0.3, False, "cpu")
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("workload", ["dense-tiny.serve-tiny", "ssm-tiny.serve-tiny"])
def test_an_altered_token_is_not_correct(tiny_root, monkeypatch, workload):
    greedy = steps.greedy_sample

    def altered(logits):  # every token one id off
        return (greedy(logits) + 1) % logits.shape[-1]

    monkeypatch.setattr(steps, "greedy_sample", altered)
    result, _ = cell.run(tiny_root, workload, SEED, 0.3, False, "cpu")
    assert not result["correct"], result["compared"]


def test_the_sound_runs_are_correct(tiny_root):
    for w in ("dense-tiny.train-tiny", "ssm-tiny.serve-tiny"):
        result, _ = cell.run(tiny_root, w, SEED, 0.3, False, "cpu")
        assert result["correct"], (w, result["compared"])
    assert torch.get_default_dtype() == torch.float32
