"""The plain reference against the program on small configurations on the
CPU (both in float32): the prefill's logits, decode through the program's
cache against the reference's full forward, and one train step's loss,
gradients and AdamW update."""

from __future__ import annotations

import pytest
import torch

from bench.harness import weights
from bench.reference import model, train
from conftest import DENSE, SSM, TRAIN
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step

EPS = 1e-6


def _setup(m, seed=11):
    cfg = ModelConfig(**m)
    return cfg, weights.make(T.abstract_params(cfg), seed, "cpu")


@pytest.mark.parametrize("m", [DENSE, SSM], ids=["dense", "ssm"])
def test_prefill_and_decode_match_the_reference(m):
    cfg, params = _setup(m)
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, m["vocab_size"], (2, 40), generator=gen)
    prompt, extra = tokens[:, :33], tokens[:, 33:]
    logits, cache = T.prefill(cfg, params, {"tokens": prompt}, 48, device="cpu")
    got = [logits[:, 0]]
    for j in range(extra.shape[1]):
        step, cache = T.decode_step(cfg, params, extra[:, j:j + 1], cache, device="cpu")
        got.append(step[:, 0])
    got = torch.stack(got, dim=1)
    want = model.logits_at(m, params, tokens, range(32, 40), EPS)
    assert torch.allclose(got.float(), want, atol=2e-4, rtol=1e-4), (got - want).abs().max()


@pytest.mark.parametrize("m", [DENSE, SSM], ids=["dense", "ssm"])
def test_one_train_step_matches_the_reference(m):
    cfg, params = _setup(m)
    opt = TRAIN["optimizer"]
    gen = torch.Generator().manual_seed(6)
    rows = torch.randint(0, m["vocab_size"], (2, 17), generator=gen)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    ref = train.follow(m, params, [batch], opt, EPS)
    opt_cfg = AdamWConfig(**opt)
    step = make_train_step(cfg, opt_cfg, remat=False)
    new, state, metrics = step(params, adamw_init(params, opt_cfg), batch)
    assert float(metrics["loss"]) == pytest.approx(ref["losses"][0], rel=1e-5)
    b1 = opt["b1"]
    for name, mu in train.named_leaves(state["mu"]):
        assert float(mu.norm()) / (1 - b1) == pytest.approx(ref["grad_norms"][name], rel=1e-3, abs=1e-7), name
    old = dict(train.named_leaves(params))
    for name, p in train.named_leaves(new):
        assert float((p - old[name]).norm()) == pytest.approx(ref["change_norms"][name], rel=1e-3, abs=1e-7), name


def test_the_reference_scan_equals_the_recurrence_and_its_gradient():
    from bench.reference import ssm

    gen = torch.Generator().manual_seed(3)
    b, s, d, n = 2, 300, 6, 4
    dt = torch.rand(b, s, d, generator=gen, dtype=torch.float64).requires_grad_(True)
    a = (-torch.rand(d, n, generator=gen, dtype=torch.float64)).requires_grad_(True)
    bm, cm, u = (torch.randn(*shape, generator=gen, dtype=torch.float64).requires_grad_(True)
                 for shape in ((b, s, n), (b, s, n), (b, s, d)))

    def recurrence(dt, a, bm, cm, u):
        h, ys = torch.zeros(b, d, n, dtype=dt.dtype), []
        for t in range(s):
            h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * u[:, t])[..., None] * bm[:, t, None, :]
            ys.append((h * cm[:, t, None, :]).sum(-1))
        return torch.stack(ys, 1)

    ins = (dt, a, bm, cm, u)
    want = recurrence(*ins)
    got = ssm.scan(*(x.float() for x in ins))
    assert torch.allclose(got.double(), want, atol=1e-4)
    g = torch.randn_like(want)
    gw = torch.autograd.grad((want * g).sum(), ins)
    gg = torch.autograd.grad((got * g.float()).sum(), ins)
    for x, y in zip(gw, gg):
        assert float((x - y.double()).norm() / x.norm()) < 1e-5
