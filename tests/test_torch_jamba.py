"""The ``jamba`` family (AI21-Jamba2-Mini) on the port's serving path, on the CPU.

The smoke configuration is one period of eight layers (Mamba-1 mixers with
RMS norms on dt / B / C, attention without RoPE at layer 4, a dropless top-2
mixture of experts at the odd layers).  ``prefill`` and four ``decode_step``
s through the cache are held to :mod:`repro_torch.models.jamba_ref`, the
plain float32 forward of the whole model:

* float32: within 1e-4 of the reference logits' largest magnitude (the two
  sides differ by the order of their sums only);
* bfloat16: within 0.1 of it, with the routers set to zero so that both
  sides choose experts 0 and 1 for every token (a router drawn at random
  leaves ties a bf16 rounding flips), and the experts' weights scaled to the
  fan-in of their own product.  Measured 0.011-0.049 over seeds 0-7.  The
  dt / B / C norms put dt's low-rank input at unit RMS, so a bf16 rounding
  of it and of dt's projection moves the decay exponent dt * A by ~1 % in
  absolute terms; the scan carries that and eight layers compound it (a
  model of only the Mamba-and-MLP layers reads 0.03-0.07, one of only
  attention-and-MLP layers 0.007-0.009, as the ``ssm`` and ``dense`` smoke
  models do at this depth).

The norms' scales are drawn away from one here, so that a misplaced norm
shows.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import PORT_ONLY_ARCHS, PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.configs.jamba2_mini import PERIOD
from repro_torch.models import jamba_ref
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

PROMPT, DECODE_STEPS, BLOCK = 17, 4, 8
#: The published configuration's parameters, and those active for a token (2 of 16 experts).
PUBLISHED_PARAMS, PUBLISHED_ACTIVE = 51_570_323_328, 12_110_311_296
#: The benchmark's cut to one period (layers 0-7 with the embedding and the head).
ONE_PERIOD_PARAMS = 13_295_237_088


def _cfg(dtype="float32", **kw):
    return dataclasses.replace(get_smoke_config("jamba2-mini"), dtype=dtype, **kw)


def _params(cfg, seed=0, *, tied_routers=False):
    """Seeded parameters with every norm's scale drawn in [0.5, 1.5)."""
    params = T.init_params(cfg, seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 100)
    for holder in [params, *params["layers"]]:
        for name, w in holder.items():
            if name.endswith(".scale"):
                w.copy_(0.5 + torch.rand(w.shape, generator=gen))
            elif tied_routers and name == "moe.router":
                w.zero_()
            elif tied_routers and name.startswith("moe."):
                w.mul_((cfg.n_experts / w.shape[1]) ** 0.5)  # drawn with fan-in E: rescaled to fan-in d_in
    return params


def _tokens(cfg, seed=0, rows=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (rows, PROMPT + DECODE_STEPS), generator=gen)


def _serve(cfg, params, tokens):
    """Prefill logits at the prompt's last position, then each decode step's
    logits, fed the given tokens: ``(B, 1 + DECODE_STEPS, V_pad)``."""
    logits, cache = T.prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, PROMPT + DECODE_STEPS,
                              q_block=BLOCK, kv_block=BLOCK, device="cpu")
    out = [logits]
    for i in range(DECODE_STEPS):
        logits, cache = T.decode_step(cfg, params, tokens[:, PROMPT + i:PROMPT + i + 1], cache, device="cpu")
        out.append(logits)
    return torch.cat(out, dim=1).float(), cache


def _gap(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_match_the_plain_reference(seed):
    cfg = _cfg()
    params = _params(cfg, seed)
    tokens = _tokens(cfg, seed)
    got, cache = _serve(cfg, params, tokens)
    ref = jamba_ref.forward(cfg, params, tokens)[:, PROMPT - 1:PROMPT + DECODE_STEPS]
    assert _gap(got, ref) < 1e-4
    assert cache["len"] == PROMPT + DECODE_STEPS
    kinds = T.layer_kinds(cfg)
    for kind, lc in zip(kinds, cache["layers"]):
        assert set(lc) == ({"conv", "h"} if kind.startswith("mamba_") else {"k", "v", "len"}), kind


def test_forward_matches_the_plain_reference():
    cfg = _cfg()
    params = _params(cfg, 2)
    tokens = _tokens(cfg, 2)
    got = T.forward(cfg, params, {"tokens": tokens}, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    assert _gap(got, jamba_ref.forward(cfg, params, tokens)) < 1e-4


def test_bf16_matches_the_plain_reference_within_its_bound():
    cfg = _cfg("bfloat16")
    params = _params(cfg, 0, tied_routers=True)
    assert all(w.dtype == torch.bfloat16 for p in params["layers"] for k, w in p.items()
               if k not in ("mixer.A_log", "mixer.D"))
    tokens = _tokens(cfg, 0)
    got, _ = _serve(cfg, params, tokens)
    ref = jamba_ref.forward(cfg, params, tokens)[:, PROMPT - 1:PROMPT + DECODE_STEPS]
    assert _gap(got, ref) < 0.1


def test_routing_forced_onto_one_expert_drops_nothing():
    """Zero routers give every expert the same probability, so every token's
    first choice is expert 0 and its second expert 1: the capacity path drops
    most of them, the dropless path none, and it still matches the reference."""
    cfg = _cfg()
    params = _params(cfg, 3, tied_routers=True)
    tokens = _tokens(cfg, 3)
    with obs.Telemetry() as tel:
        got, _ = _serve(cfg, params, tokens)
    moe_layers = sum(k.endswith("_moe") for k in T.layer_kinds(cfg))
    ids = tokens.shape[0] * (PROMPT + DECODE_STEPS)
    assert tel.counter("moe.assignments") == moe_layers * ids * cfg.top_k
    assert tel.counter("moe.dropped") == 0
    assert tel.gauges["moe.load_max_over_mean"] == cfg.n_experts / cfg.top_k
    ref = jamba_ref.forward(cfg, params, tokens)[:, PROMPT - 1:PROMPT + DECODE_STEPS]
    assert _gap(got, ref) < 1e-4
    x = torch.randn(2, PROMPT, cfg.d_model, generator=torch.Generator().manual_seed(3))
    layer = params["layers"][1]
    with obs.Telemetry() as tel:
        _, aux = M.apply_moe(cfg, layer, "moe", x)
    capacity = M.moe_capacity(cfg, PROMPT)  # each of experts 0 and 1 keeps this many of a row's PROMPT
    assert tel.counter("moe.dropped") == 2 * 2 * (PROMPT - capacity) > 0
    assert float(aux["drop_frac"]) > 0
    y, aux = M.apply_moe_dropless(cfg, layer, "moe", x)
    assert float(aux["drop_frac"]) == 0
    assert _gap(y, jamba_ref.experts(cfg, layer, x)) < 1e-5


def test_the_dropless_experts_are_bit_stable_and_keep_ties_on_the_lower_expert():
    cfg = _cfg()
    layer = _params(cfg, 4)["layers"][1]
    x = torch.randn(3, 11, cfg.d_model, generator=torch.Generator().manual_seed(4))
    y1, a1 = M.apply_moe_dropless(cfg, layer, "moe", x)
    y2, a2 = M.apply_moe_dropless(cfg, layer, "moe", x)
    assert torch.equal(y1, y2) and torch.equal(a1["top_e"], a2["top_e"])
    tied = dict(layer, **{"moe.router": torch.zeros_like(layer["moe.router"])})
    _, aux = M.apply_moe_dropless(cfg, tied, "moe", x)
    assert (aux["top_e"] == torch.tensor([0, 1])).all()


def test_the_jamba_router_does_not_renormalise_and_the_moe_familys_does():
    cfg = _cfg()
    layer = _params(cfg, 5)["layers"][1]
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(5))
    probs, top_w, top_e = M.route(cfg, layer, "moe", x)
    assert torch.equal(top_w, torch.gather(probs, -1, top_e))
    assert float(top_w.sum(-1).max()) < 1
    _, top_w, _ = M.route(dataclasses.replace(cfg, family="moe"), layer, "moe", x)
    assert torch.allclose(top_w.sum(-1), torch.ones(2, 5))


@pytest.mark.parametrize("fallback", [False, True], ids=["grouped_mm", "a_matmul_an_expert"])
def test_grouped_products_run_each_experts_segment(monkeypatch, fallback):
    if fallback:
        monkeypatch.delattr(torch, "_grouped_mm", raising=False)
    gen = torch.Generator().manual_seed(6)
    rows, w = torch.randn(10, 8, generator=gen), torch.randn(4, 8, 12, generator=gen)
    ends = torch.tensor([3, 3, 9, 10])  # expert 1 has no row
    got = M.grouped_products(rows, w, ends)
    want = torch.cat([rows[:3] @ w[0], rows[3:9] @ w[2], rows[9:] @ w[3]])
    assert torch.allclose(got, want, atol=1e-6)


def test_layer_kinds_of_the_published_config():
    cfg = get_config("jamba2-mini")
    kinds = T.layer_kinds(cfg)
    assert len(kinds) == cfg.n_layers == 32
    for i, kind in enumerate(kinds):
        mixer, ffn = kind.split("_")
        assert mixer == ("attn" if i % 8 == 4 else "mamba"), i
        assert ffn == ("moe" if i % 2 == 1 else "mlp"), i
    assert tuple(kinds[:8]) == PERIOD
    with pytest.raises(ValueError, match="jamba block_pattern"):
        T.layer_kinds(dataclasses.replace(cfg, block_pattern=("mamba_mlp", "rec")))


def test_param_counts_of_the_published_config_and_of_one_period():
    """The analytic counts hold every parameter the port makes (its float32
    ``A_log`` and ``D`` count as one parameter each element, as the bf16
    ones would), and equal the meta tree's element count."""
    cfg = get_config("jamba2-mini")
    assert cfg.param_count() == PUBLISHED_PARAMS
    assert cfg.active_param_count() == PUBLISHED_ACTIVE
    cut = dataclasses.replace(cfg, n_layers=8)
    assert cut.param_count() == ONE_PERIOD_PARAMS
    tree = T.abstract_params(cut)
    top = sum(v.numel() for k, v in tree.items() if k != "layers")
    # the vocabulary 65536 is a multiple of 128: no padded rows
    assert top + sum(v.numel() for p in tree["layers"] for v in p.values()) == ONE_PERIOD_PARAMS
    smoke = _cfg()
    tree = T.abstract_params(smoke)
    pad = 2 * (smoke.padded_vocab - smoke.vocab_size) * smoke.d_model
    assert smoke.param_count() + pad == sum(v.numel() for k, v in tree.items() if k != "layers") + sum(
        v.numel() for p in tree["layers"] for v in p.values())


def test_the_registry_keeps_the_jax_packages_list():
    assert PORT_ONLY_ARCHS == ("jamba2-mini",) and "jamba2-mini" not in PORTED_ARCHS
    assert get_config("jamba2-mini").family == "jamba"
    assert get_smoke_config("jamba2-mini").n_layers == len(PERIOD)


def test_the_ssm_family_keeps_its_parameters():
    cfg = get_smoke_config("falcon-mamba-7b")
    names = set(T.abstract_params(cfg)["layers"][0])
    assert not {n for n in names if "_norm" in n}
    assert names == {"norm.scale", "mixer.in_proj", "mixer.conv_w", "mixer.conv_b", "mixer.x_proj",
                     "mixer.dt_proj", "mixer.dt_bias", "mixer.A_log", "mixer.D", "mixer.out_proj"}


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b", "jamba2-mini"])
@pytest.mark.parametrize("rows", [1, 2])
def test_a_prefills_conv_state_owns_storage_of_its_own_size(arch, rows):
    """The decode conv state after a prefill is a copy of the last K - 1
    positions, not a view that keeps the layer's whole input projection."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = T.init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (rows, PROMPT), generator=torch.Generator().manual_seed(7))
    _, cache = T.prefill(cfg, params, {"tokens": tokens}, PROMPT + 1, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    convs = [lc["conv"] for lc in cache["layers"] if "conv" in lc]
    assert convs
    for conv in convs:
        assert conv.shape[:2] == (rows, cfg.ssm_conv - 1)
        assert conv.untyped_storage().nbytes() == conv.numel() * conv.element_size()


def test_the_loss_adds_the_load_balance_loss_and_has_gradients():
    cfg = _cfg()
    params = _params(cfg, 8)
    tokens = _tokens(cfg, 8)
    leaves = [w for p in params["layers"] for w in p.values()]
    for w in leaves:
        w.requires_grad_(True)
    loss, metrics = T.loss_fn(cfg, params, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}, q_block=BLOCK,
                              kv_block=BLOCK, device="cpu")
    got = {k: float(v.detach()) for k, v in metrics.items()}
    assert got["drop_frac"] == 0 and got["load_balance_loss"] > 0
    assert got["loss"] == pytest.approx(got["nll"] + cfg.router_aux_weight * got["load_balance_loss"])
    grads = torch.autograd.grad(loss, leaves)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


def _tree(spans):
    return [(s.name, _tree(s.children)) for s in spans]


@pytest.mark.parametrize("arch", ["jamba2-mini", "arctic-480b"])
def test_prefill_and_decode_open_a_moe_span_a_moe_layer(arch):
    """``prefill.moe`` / ``decode.moe`` hold each MoE layer's routing,
    products and combine (the capacity path's too); under a collector the
    layers count tokens x top_k assignments."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = T.init_params(cfg, 0, device="cpu")
    tokens = _tokens(cfg, 9)
    with obs.Telemetry() as tel:
        logits, cache = T.prefill(cfg, params, {"tokens": tokens[:, :PROMPT]}, PROMPT + 1, q_block=BLOCK,
                                  kv_block=BLOCK, device="cpu")
        T.decode_step(cfg, params, tokens[:, PROMPT:PROMPT + 1], cache, device="cpu")
    kinds = T.layer_kinds(cfg)
    prefill = []
    for kind in kinds:
        prefill += [("prefill.ssm_inputs", [])] * kind.startswith("mamba_") + [("prefill.moe", [])] * kind.endswith("moe")
    decode = []
    for kind in kinds:
        decode += [("decode.mixer", [])] + [("decode.moe", [])] * kind.endswith("moe")
    assert _tree(tel.spans) == [("prefill", prefill), ("decode.step", decode)]
    moe_layers = sum(k.endswith("moe") for k in kinds)
    assert tel.counter("moe.assignments") == moe_layers * tokens.shape[0] * (PROMPT + 1) * cfg.top_k
    if cfg.moe_impl == "dropless":
        assert tel.counter("moe.dropped") == 0
    assert tel.gauges["moe.load_max_over_mean"] >= 1


def test_the_counters_read_nothing_from_the_device_without_a_collector(monkeypatch):
    def no_read(*args, **kw):
        raise AssertionError("a counter was read without a collector")

    monkeypatch.setattr(torch, "bincount", no_read)
    cfg = _cfg()
    _serve(cfg, _params(cfg, 10), _tokens(cfg, 10))
