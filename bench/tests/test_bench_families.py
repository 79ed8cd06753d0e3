"""A configuration of a family the benchmark has not seen comes in by new
files alone: its reference layers, its model-FLOP counts and the scan reader
are found by the family's name, its expert weights are drawn by their
fan-in, and the serving warm-up reaches every kind of layer it has.  The two
configurations already there read what they read before."""

from __future__ import annotations

import json
import math
import sys
import types

import pytest
import torch

from bench.harness import serve, weights
from bench.harness.cell import Run
from bench.harness.manifest import Manifest
from bench.harness.spans import Span
from bench.reference import model
from bench.roofline import counts
from conftest import DENSE, ROOT, SSM
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

#: A family of two kinds of layer, told apart by their parameters' names:
#: ``toy.w (d, d)`` adds ``x @ w``, ``toy.scale (d,)`` scales the stream.
TOY = {"name": "toy", "family": "toyfam", "n_layers": 5, "d_model": 8, "vocab_size": 32, "ssm_state": 4}
TOY_KINDS = "wswsw"


def _toy_layer(m, p, x, eps, precision):
    assert all(v.dtype == torch.float32 for v in p.values())
    return x + x @ p["toy.w"] if "toy.w" in p else x * p["toy.scale"]


@pytest.fixture()
def toyfam(monkeypatch):
    """``toyfam``'s two family modules, as if they were new files."""
    ref = types.ModuleType("bench.reference.toyfam")
    ref.layer = _toy_layer
    fam = types.ModuleType("bench.roofline.families.toyfam")
    fam.matmul_params = lambda m: TOY_KINDS.count("w") * m["d_model"] ** 2
    fam.attention_flops = lambda m, batch, seq: 7.0 * batch * seq
    fam.scan_layers = lambda m: 2
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    monkeypatch.setitem(sys.modules, fam.__name__, fam)


def _toy_params(dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(4)
    d, v = TOY["d_model"], TOY["vocab_size"]

    def draw(*shape):
        return (torch.randn(*shape, generator=gen) / 4).to(dtype)

    layers = [{"toy.w": draw(d, d)} if k == "w" else {"toy.scale": 1 + draw(d)} for k in TOY_KINDS]
    return {"embed.tokens": draw(v, d), "unembed": draw(d, v), "final_norm.scale": 1 + draw(d), "layers": layers}


def test_the_reference_finds_a_family_by_its_name(toyfam):
    params = _toy_params()
    tokens = torch.tensor([[1, 5, 9, 2], [3, 3, 0, 31]])
    got = model.logits_at(TOY, params, tokens, [1, 3], 1e-6)
    x = params["embed.tokens"].float()[tokens]
    for p in params["layers"]:
        x = x + x @ p["toy.w"].float() if "toy.w" in p else x * p["toy.scale"].float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * params["final_norm.scale"].float()
    want = x[:, [1, 3]] @ params["unembed"].float()
    assert torch.allclose(got, want, atol=1e-5)


def test_the_counts_find_a_family_by_its_name(toyfam):
    weights_ = 3 * 8 * 8
    head = 8 * 128  # the vocabulary padded to 128
    assert counts.matmul_params(TOY) == weights_
    assert counts.scan_layers(TOY) == 2
    assert counts.prefill_flops(TOY, 2, 4) == 2 * weights_ * 8 + 2 * head * 2 + 7 * 8
    assert counts.train_step_flops(TOY, 2, 4) == 6 * (weights_ + head) * 8 + 3 * 7 * 8


def test_the_scan_reader_counts_the_familys_scans(toyfam):
    read = Manifest(ROOT).reader("ssm_scan_roofline")
    prefills = [Span("prefill", 0.0, 1.0, meta={"batch": (2, 64)}), Span("prefill", 1.0, 2.0, meta={"batch": (1, 128)})]

    def run(scans):
        ops = [("ssm_scan_kernel", 0, 1000)] * scans
        return Run(prefills, {"ops": ops}, TOY, {})

    value = read(run(2 * len(prefills)))  # toyfam runs 2 scans a prefill, of its 5 layers
    bound = sum(counts.scan_bound(b, s, 2 * 8, 4)[0] for b, s in ((2, 64), (1, 128)))
    assert value == pytest.approx(100.0 * bound * 2 / (4 * 1000 * 1e-9))
    assert read(run(TOY["n_layers"] * len(prefills))) is None


def test_an_unknown_family_names_the_families_there():
    m = dict(TOY, family="nosuch")
    with pytest.raises(ValueError, match=r"no 'nosuch' family; it has \('dense', 'ssm'\)"):
        model.logits_at(m, _toy_params(), torch.zeros((1, 2), dtype=torch.int64), [0], 1e-6)
    with pytest.raises(ValueError, match=r"no 'nosuch' family; it has \('dense', 'ssm'\)"):
        counts.prefill_flops(m, 1, 2)


def _rule_before(name: str, shape: tuple) -> tuple[str, float]:
    """``weights._rule`` as it was before expert weights had a rule of their own."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("scale", "D"):
        return "fill", 1.0
    if leaf in ("bias", "conv_b", "dt_bias"):
        return "fill", 0.0
    if leaf == "A_log":
        return "a_log", 0.0
    if name == "embed.tokens":
        return "normal", 1.0
    if leaf == "conv_w":
        return "normal", 0.5
    fan_in = shape[0] * shape[1] if name.endswith("attn.wo") and len(shape) == 3 else shape[0]
    return "normal", 1.0 / math.sqrt(fan_in)


@pytest.mark.parametrize("name", ["glm4-9b", "falcon-mamba-7b"])
def test_the_configurations_weights_keep_their_rule(name):
    m = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())["model"]
    leaves = weights._named(T.abstract_params(ModelConfig(**m)))
    assert len(leaves) > 3
    for full, holder, key in leaves:
        shape = tuple(holder[key].shape)
        assert weights._rule(full, shape) == _rule_before(full, shape), full


def test_expert_weights_are_drawn_by_their_fan_in():
    assert weights._rule("layers.1.moe.wi_up", (16, 4096, 14336)) == ("normal", 1 / math.sqrt(4096))
    assert weights._rule("layers.1.moe.wi_gate", (16, 4096, 14336)) == ("normal", 1 / math.sqrt(4096))
    assert weights._rule("layers.1.moe.wo", (16, 14336, 4096)) == ("normal", 1 / math.sqrt(14336))
    assert weights._rule("layers.1.moe.router", (4096, 16)) == ("normal", 1 / math.sqrt(4096))
    # the port's own mixture of experts, drawn: each expert's product has the spread of a dense one
    cfg = ModelConfig(name="moe-tiny", family="moe", n_layers=1, d_model=256, n_heads=4, n_kv_heads=2, d_ff=64,
                      vocab_size=64, n_experts=16, top_k=2, dtype="float32")
    layer = weights.make(T.abstract_params(cfg), 2**33 + 3, "cpu")["layers"][0]
    for key, fan_in in (("moe.wi_up", 256), ("moe.wi_gate", 256), ("moe.wo", 64)):
        assert float(layer[key].std()) == pytest.approx(1 / math.sqrt(fan_in), rel=0.02), key


def _layer(**shapes):
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


@pytest.mark.parametrize("m", [DENSE, SSM], ids=["dense", "ssm"])
@pytest.mark.parametrize("n_layers", [2, 6])
def test_the_warm_up_runs_two_layers_of_a_uniform_model(m, n_layers):
    layers = T.abstract_params(ModelConfig(**dict(m, n_layers=n_layers)))["layers"]
    assert serve.warmup_layers(layers) == 2


def test_the_warm_up_reaches_every_kind_of_layer():
    a = _layer(**{"mixer.in_proj": (8, 32), "mlp.wi_up": (8, 16)})
    b = _layer(**{"mixer.in_proj": (8, 32), "moe.wi_up": (4, 8, 16)})
    c = _layer(**{"attn.wq": (8, 2, 4), "moe.wi_up": (4, 8, 16)})
    wide = _layer(**{"mixer.in_proj": (8, 64), "mlp.wi_up": (8, 16)})  # a's names, other shapes
    assert serve.warmup_layers([a, b, a, b, c]) == 5
    assert serve.warmup_layers([a, b, c, a, b, c, a, b]) == 3
    assert serve.warmup_layers([a, a, a, wide]) == 4
    assert serve.warmup_layers([a, a, a]) == 2
    assert serve.warmup_layers([a]) == 1
    hybrid = ModelConfig(name="hybrid-tiny", family="hybrid", n_layers=6, d_model=64, n_heads=4, n_kv_heads=1,
                         d_ff=128, vocab_size=64, window=8, block_pattern=("rec", "rec", "attn"), dtype="float32")
    assert serve.warmup_layers(T.abstract_params(hybrid)["layers"]) == 3
