"""The port's mixture of experts against the JAX package's, on the CPU.

``repro_torch.models.moe.apply_moe`` against ``repro.models.moe.apply_moe``
on the same numpy inputs (from a seed) and the JAX package's own init carried
across: the output, the chosen experts ``top_e``, ``load_balance_loss`` and
``drop_frac``, with a capacity that drops assignments, and with router
columns made equal so that router logits tie exactly (``jax.lax.top_k`` keeps
the lower expert; so must the port).  Then the whole MoE model: ``forward``'s
logits and aux and ``loss_fn`` (the NLL plus ``router_aux_weight *
load_balance_loss``) against JAX's, in float32 (1e-4 on logits, 1e-5 on the
losses).

The bf16 output is held to 2e-2 of its scale: both sides round each
operation to bf16 (the port's expert SiLU rounds where XLA's does) and differ
only in the products' summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.params import ParamBuilder, from_jax

BLOCK = 8


def f32(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def moe_params(cfg, jcfg, seed=0):
    """The JAX package's init of one MoE block (``init_moe``), numpy and torch."""
    from repro.models.params import ParamBuilder as JaxParamBuilder

    b = JaxParamBuilder(jax.random.PRNGKey(seed), dtype=jnp.float32)
    JM.init_moe(b, "moe", jcfg)
    jp = {k: np.array(v) for k, v in b.params.items()}
    return jp, {k: torch.from_numpy(v.copy()) for k, v in jp.items()}


def run_both(arch, x, dtype="float32", tie=False, **overrides):
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype=dtype, **overrides)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **overrides)
    jp, tp = moe_params(cfg, jcfg)
    if tie:  # experts 2 and 5 (and 0 and 7) get the same router column: their logits tie exactly
        for a, b in ((5, 2), (7, 0)):
            jp["moe.router"][:, a] = jp["moe.router"][:, b]
        tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in jp.items()}
    tp = {k: v.to(tdt) for k, v in tp.items()}
    jy, jaux = jax.jit(lambda p, xx: JM.apply_moe(jcfg, p, "moe", xx))(jp, jnp.asarray(x).astype(jdt))
    ty, taux = M.apply_moe(cfg, tp, "moe", torch.from_numpy(x).to(tdt))
    # JAX's chosen experts, recomputed as its apply_moe routes
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x).astype(jdt), jp["moe.router"]).astype(jnp.float32)
    _, jtop = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    return cfg, (jy, jaux, np.asarray(jtop)), (ty, taux)


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_apply_moe_matches_jax(arch, capacity_factor):
    x = np.random.default_rng(0).standard_normal((2, 24, 64)).astype(np.float32)
    cfg, (jy, jaux, jtop), (ty, taux) = run_both(arch, x, capacity_factor=capacity_factor)
    assert np.array_equal(taux["top_e"].numpy(), jtop)
    np.testing.assert_allclose(f32(ty), f32(jy), atol=1e-5, rtol=1e-5)
    assert float(taux["drop_frac"]) == pytest.approx(float(jaux["drop_frac"]), abs=1e-7)
    assert float(taux["load_balance_loss"]) == pytest.approx(float(jaux["load_balance_loss"]), rel=1e-6)
    if capacity_factor < 1:  # capacity 3 of 6 ideal: assignments are dropped
        assert M.moe_capacity(cfg, 24) == JM.moe_capacity(cfg, 24) == 3
        assert float(taux["drop_frac"]) > 0.2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_go_to_the_lower_expert(dtype):
    x = np.random.default_rng(1).standard_normal((2, 32, 64)).astype(np.float32)
    cfg, (jy, jaux, jtop), (ty, taux) = run_both("kimi-k2-1t-a32b", x, dtype=dtype, tie=True)
    top = taux["top_e"].numpy()
    assert np.array_equal(top, jtop)
    picked = lambda e: (top == e).any(-1)  # noqa: E731
    assert (picked(2) & picked(5)).any() or (picked(0) & picked(7)).any()  # both halves of a tie chosen
    assert not (picked(5) & ~picked(2)).any() and not (picked(7) & ~picked(0)).any()  # never the higher alone
    scale = float(np.abs(f32(jy)).max())
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(f32(ty), f32(jy), atol=tol * scale, rtol=0)
    assert float(taux["drop_frac"]) == pytest.approx(float(jaux["drop_frac"]), abs=1e-7)


def test_moe_capacity_matches_jax():
    cfg = get_smoke_config("kimi-k2-1t-a32b")
    for tokens in (1, 2, 7, 24, 4096):
        for cf in (0.5, 1.0, 1.25, 2.0):
            c = dataclasses.replace(cfg, capacity_factor=cf)
            assert M.moe_capacity(c, tokens) == JM.moe_capacity(c, tokens)


def test_apply_moe_is_deterministic_and_init_has_the_jax_shapes():
    cfg = get_smoke_config("arctic-480b")
    b = ParamBuilder(torch.Generator().manual_seed(0), "cpu", torch.bfloat16)
    M.init_moe(b, "moe", cfg)
    jb_shapes = {k: v.shape for k, v in moe_params(cfg, jax_get_smoke_config("arctic-480b"))[0].items()}
    assert {k: tuple(v.shape) for k, v in b.params.items()} == jb_shapes
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(2)).bfloat16()
    y1, a1 = M.apply_moe(cfg, b.params, "moe", x)
    y2, a2 = M.apply_moe(cfg, b.params, "moe", x)
    assert torch.equal(y1, y2) and torch.equal(a1["top_e"], a2["top_e"]) and y1.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_forward_and_loss_with_moe_aux_match_jax(arch):
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams = jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))
    params = from_jax(cfg, jparams, "cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, jaux = jax.jit(lambda p, b: JT.forward(jcfg, p, b, q_block=BLOCK, kv_block=BLOCK))(jparams, jbatch)
    logits, aux = T._forward(cfg, params, batch, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    np.testing.assert_allclose(f32(logits), f32(jlogits), atol=1e-4, rtol=1e-4)
    assert torch.equal(T.forward(cfg, params, batch, q_block=BLOCK, kv_block=BLOCK, device="cpu"), logits)
    for name in ("load_balance_loss", "drop_frac"):
        assert float(aux[name]) == pytest.approx(float(jaux[name]), rel=1e-5, abs=1e-7), name
    assert float(aux["load_balance_loss"]) > 0
    jloss, jm = jax.jit(lambda p, b: JT.loss_fn(jcfg, p, b, q_block=BLOCK, kv_block=BLOCK))(jparams, jbatch)
    loss, m = T.loss_fn(cfg, params, batch, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(m["nll"]) == pytest.approx(float(jm["nll"]), rel=1e-5)
    assert float(loss) == pytest.approx(float(m["nll"]) + cfg.router_aux_weight * float(m["load_balance_loss"]),
                                        rel=1e-6)
    assert float(m["drop_frac"]) == pytest.approx(float(jm["aux"]["drop_frac"]), abs=1e-7)
