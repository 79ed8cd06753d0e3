"""The port's package surface against the JAX package's: the names each
subpackage exports, the logging convention, the engines' parity fields, and
the step factories ``make_prefill`` / ``make_decode_step``."""

import logging

import numpy as np
import pytest
import torch

import repro
import repro.engine
import repro.models
import repro.train
import repro_torch
import repro_torch.engine
import repro_torch.models
import repro_torch.train
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T


@pytest.mark.parametrize("pkg, ref", [(repro_torch.models, repro.models), (repro_torch.train, repro.train)])
def test_exports_equal_the_jax_packages(pkg, ref):
    assert sorted(pkg.__all__) == sorted(ref.__all__)
    for name in ref.__all__:
        assert getattr(pkg, name) is not None, name


def test_models_exports_are_the_transformers_functions():
    for name in ("decode_step", "forward", "init_cache", "init_params", "loss_fn", "param_axes", "prefill"):
        assert getattr(repro_torch.models, name) is getattr(T, name)


def test_parity_fields_equal_the_jax_packages():
    assert repro_torch.engine.PARITY_FIELDS == repro.engine.PARITY_FIELDS
    assert "PARITY_FIELDS" in repro_torch.engine.__all__
    assert set(repro_torch.engine.PARITY_FIELDS) <= set(repro_torch.engine.COMPARED)


def test_logging_follows_the_jax_packages_convention(monkeypatch):
    base = logging.getLogger("repro_torch")
    assert any(isinstance(h, logging.NullHandler) for h in base.handlers)
    monkeypatch.setenv("REPRO_LOG", "debug")
    log = repro_torch.configure_logging()
    assert log is base and log.level == logging.DEBUG
    log = repro_torch.configure_logging("warning")
    configured = [h for h in log.handlers if getattr(h, "_repro_configured", False)]
    assert log.level == logging.WARNING and len(configured) == 1  # replaced, not stacked
    log.removeHandler(configured[0])
    assert callable(repro.configure_logging)


def test_prefill_and_decode_step_factories_run_the_models_functions():
    from repro_torch.train import make_decode_step, make_prefill

    cfg = get_smoke_config("glm4-9b")
    params = T.init_params(cfg, 0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)), dtype=torch.int32)
    logits, cache = make_prefill(cfg, 16, q_block=8, kv_block=8)(params, {"tokens": tokens})
    want, want_cache = T.prefill(cfg, params, {"tokens": tokens}, 16, q_block=8, kv_block=8, device="cpu")
    assert torch.equal(logits, want) and cache["len"] == want_cache["len"] == 12
    step_logits, cache = make_decode_step(cfg)(params, tokens[:, :1], cache)
    assert step_logits.shape == (2, 1, cfg.padded_vocab) and cache["len"] == 13
