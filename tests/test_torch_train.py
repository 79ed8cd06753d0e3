"""The port's training path against the JAX package's, on the CPU.

For each ported architecture's smoke config, the JAX package's own init is
carried across (``from_jax``) and the same batch (numpy, from a seed; one
label set to -100, which both ignore) goes through
``jax.value_and_grad(repro.models.transformer.loss_fn)`` and the port's
``loss_fn`` + ``backward``.

Tolerances:

* float32 configs: the loss within 1e-5, and every parameter's gradient
  within 1e-4 of the largest magnitude of that leaf's JAX gradient (the two
  differ by matmul and reduction order only);
* bfloat16 configs: the loss within 2e-2 (3e-2 for the hybrid, the enc-dec
  and the MoE), the serving tolerances of ``tests/test_torch_models.py`` (bf16
  rounds at other places in XLA and PyTorch);
* one AdamW step (``make_train_step``): ``mu``, ``nu``, ``grad_norm``, ``lr``
  and the loss within 1e-5 relative.  The parameters cannot be held that
  tight everywhere: at step 1 AdamW's ``m_hat / sqrt(v_hat)`` is
  ``g / (|g| + eps)``, +-1 wherever ``|g| >> eps`` but anything in between
  where ``|g|`` is near ``eps = 1e-8``, so a 1e-9 difference in such a ``g``
  moves the parameter by up to ``2 * lr``.  Every parameter is held within
  ``2 * lr`` (+1e-6), and within 1e-6 wherever ``|g| > 1e-6``.

A MoE's loss adds ``router_aux_weight * load_balance_loss`` to the NLL, as
there.  An encoder-decoder's batch carries random ``frames``, a VLM's random
``vision_embeds`` over the first ``vision_tokens`` positions.

The hybrid's sequence (16) is no longer than its window (16): with a longer
one, the JAX package's ``ref.block_attention`` drops keys that the window
holds (ROADMAP queue C), and its interpret-mode TPU kernel has no gradient.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine, linear_warmup_cosine as jax_warmup_cosine
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.configs import PORTED_ARCHS, get_smoke_config
from repro_torch.kernels import _launch
from repro_torch.kernels.flash_attention import kernel as flash, ref as flash_ref
from repro_torch.kernels.rglru_scan import kernel as rglru, ref as rglru_ref
from repro_torch.kernels.ssm_scan import kernel as ssm, ref as ssm_ref
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax, state_from_jax
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule, linear_warmup_cosine
from repro_torch.train.steps import _split_microbatches, make_train_state, make_train_step

SEQ, BLOCK = 16, 8
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BF16_NOISY, NOISY_BF16_TOL = ("hybrid", "encdec", "moe"), 3e-2
GRAD_TOL = 1e-4
OPT = dict(lr=1e-3, moment_dtype="float32")


def f32(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@functools.cache
def jax_init_f32(arch):
    cfg = dataclasses.replace(jax_get_smoke_config(arch), dtype="float32")
    return jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0)))


def carried(arch, dtype):
    """(jax config, port config, jax params, port params): the JAX package's
    float32 init, cast to the config's dtypes (its bf16 init casts float32
    draws too)."""
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jparams = jax.tree.map(lambda x, spec: np.asarray(x).astype(spec.dtype), jax_init_f32(arch), JT.abstract_params(jcfg))
    return jcfg, cfg, jparams, from_jax(cfg, jparams, "cpu")


def batch(cfg, b=2, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, SEQ + 1)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[0, 3] = -100  # ignored by both
    out = {"tokens": tokens[:, :-1], "labels": labels}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, cfg.encoder_positions, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        out["vision_mask"] = np.arange(SEQ)[None, :].repeat(b, 0) < cfg.vision_tokens
    return out


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_loss_and_grads(cfg, params, b, **kw):
    leaves, treedef = tree_lib.flatten(params)
    wrt = [x.detach().requires_grad_(True) for x in leaves]
    loss, metrics = T.loss_fn(cfg, treedef.unflatten(wrt), b, q_block=BLOCK, kv_block=BLOCK, device="cpu", **kw)
    loss.backward()
    return loss.detach(), metrics, treedef.unflatten([x.grad for x in wrt])


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jcfg, cfg, jparams, params = carried(arch, "float32")
    b = batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: JT.loss_fn(jcfg, p, bb, q_block=BLOCK, kv_block=BLOCK)[0]))(jparams, jax_batch(b))
    loss, metrics, grads = port_loss_and_grads(cfg, params, b)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL["float32"])
    aux = cfg.router_aux_weight * metrics["load_balance_loss"] if cfg.family == "moe" else 0.0
    assert float((metrics["nll"] + aux).detach()) == float(metrics["loss"])
    jl, tl = jax.tree.leaves(jgrads), tree_lib.leaves(grads)
    assert len(jl) == len(tl)
    for i, (g, jg) in enumerate(zip(tl, jl)):
        scale = float(np.abs(np.asarray(jg)).max())
        assert scale > 0, f"leaf {i}: the JAX gradient is zero"
        np.testing.assert_allclose(f32(g), np.asarray(jg), rtol=0, atol=GRAD_TOL * scale, err_msg=f"grad leaf {i}")


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_bf16_loss_matches_jax(arch):
    jcfg, cfg, jparams, params = carried(arch, "bfloat16")
    b = batch(cfg)
    tol = NOISY_BF16_TOL if cfg.family in BF16_NOISY else LOSS_TOL["bfloat16"]
    jloss, _ = jax.jit(lambda p, bb: JT.loss_fn(jcfg, p, bb, q_block=BLOCK, kv_block=BLOCK))(jparams, jax_batch(b))
    loss, metrics, grads = port_loss_and_grads(cfg, params, b)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=tol, atol=tol)
    for g, p in zip(tree_lib.leaves(grads), tree_lib.leaves(params)):
        assert g.dtype == p.dtype and bool(torch.isfinite(g.float()).all())


def test_all_labels_ignored_gives_zero_loss():
    _, cfg, _, params = carried("glm4-9b", "float32")
    b = batch(cfg)
    b["labels"][:] = -1
    loss, _ = T.loss_fn(cfg, params, b, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    assert float(loss) == 0.0


def jax_one_step(jcfg, jparams, b, **kw):
    opt = JaxAdamWConfig(**OPT)
    step = jax.jit(jax_make_train_step(jcfg, opt, q_block=BLOCK, kv_block=BLOCK, **kw))
    return step(jparams, jax_adamw_init(jparams, opt), jax_batch(b))


def port_one_step(cfg, params, b, **kw):
    opt = AdamWConfig(**OPT)
    step = make_train_step(cfg, opt, q_block=BLOCK, kv_block=BLOCK, **kw)
    return step(params, adamw_init(params, opt), b)


def assert_step_close(got, want, grad_of):
    (p, s, m), (jp, js, jm) = got, want
    for name in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-5, err_msg=name)
    assert int(s["step"]) == int(js["step"]) == 1 and s["step"].dtype == torch.int32
    for name in ("mu", "nu"):
        for x, jx in zip(tree_lib.leaves(s[name]), jax.tree.leaves(js[name])):
            scale = float(np.abs(np.asarray(jx)).max()) or 1.0
            np.testing.assert_allclose(f32(x), np.asarray(jx), rtol=0, atol=1e-5 * scale, err_msg=name)
    lr = OPT["lr"]
    for x, jx, g in zip(tree_lib.leaves(p), jax.tree.leaves(jp), jax.tree.leaves(grad_of)):
        diff = np.abs(f32(x) - np.asarray(jx, np.float32))
        assert diff.max() <= 2 * lr + 1e-6
        assert diff[np.abs(np.asarray(g)) > 1e-6].max(initial=0.0) <= 1e-6


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_one_train_step_matches_jax(arch):
    jcfg, cfg, jparams, params = carried(arch, "float32")
    b = batch(cfg)
    want = jax_one_step(jcfg, jparams, b, remat=False)
    got = port_one_step(cfg, params, b, remat=False)
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: JT.loss_fn(jcfg, p, bb, q_block=BLOCK, kv_block=BLOCK)[0]))(jparams, jax_batch(b))
    assert_step_close(got, want, jgrads)
    # the inputs are left as they were (the update is not in place)
    np.testing.assert_array_equal(f32(params["embed.tokens"]), jparams["embed.tokens"])


def test_microbatches_match_jax_and_the_whole_batch():
    jcfg, cfg, jparams, params = carried("glm4-9b", "float32")
    b = batch(cfg, b=4)
    b["labels"][0, 3] = b["tokens"][0, 4]  # equal valid counts in both halves: the means agree
    want = jax_one_step(jcfg, jparams, b, remat=False, microbatches=2)
    got2 = port_one_step(cfg, params, b, remat=False, microbatches=2)
    _, jgrads = jax.jit(jax.value_and_grad(
        lambda p, bb: JT.loss_fn(jcfg, p, bb, q_block=BLOCK, kv_block=BLOCK)[0]))(jparams, jax_batch(b))
    assert_step_close(got2, want, jgrads)
    got1 = port_one_step(cfg, params, b, remat=False, microbatches=1)
    np.testing.assert_allclose(float(got2[2]["loss"]), float(got1[2]["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(got2[2]["grad_norm"]), float(got1[2]["grad_norm"]), rtol=1e-5)
    halves = _split_microbatches({k: torch.from_numpy(v) for k, v in b.items()}, 2)
    assert [h["tokens"].shape for h in halves] == [(2, SEQ), (2, SEQ)]
    assert torch.equal(halves[1]["labels"], torch.from_numpy(b["labels"][2:]))


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_remat_matches_no_remat(arch):
    _, cfg, _, params = carried(arch, "float32")
    b = batch(cfg)
    l0, _, g0 = port_loss_and_grads(cfg, params, b, remat=False)
    l1, _, g1 = port_loss_and_grads(cfg, params, b, remat=True)
    assert float(l0) == float(l1)
    for x, y in zip(tree_lib.leaves(g0), tree_lib.leaves(g1)):
        np.testing.assert_allclose(f32(x), f32(y), rtol=1e-6, atol=1e-9)


def test_train_state_and_step_run_on_the_cpu():
    cfg = get_smoke_config("glm4-9b")
    state = make_train_state(cfg, AdamWConfig(), seed=2, device="cpu")
    assert state.step == 0 and int(state.opt_state["step"]) == 0
    step = make_train_step(cfg, AdamWConfig(lr=1e-2), remat=True, q_block=BLOCK, kv_block=BLOCK)
    p, s, m = state.params, state.opt_state, None
    losses = []
    for i in range(4):
        p, s, m = step(p, s, batch(cfg, seed=0))
        losses.append(float(m["loss"]))
    assert int(s["step"]) == 4 and losses[-1] < losses[0]
    assert not any(x.requires_grad for x in tree_lib.leaves(p))


# ---------------------------------------------------------------------------
# AdamW and the schedules against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_jax(moment_dtype, grad_clip):
    rng = np.random.default_rng(4)
    shapes = {"a": (33, 7), "b": (5,), "c": {"d": (64,)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
    params["b"] = params["b"].astype(jnp.bfloat16)
    kw = dict(lr=0.01, moment_dtype=moment_dtype, grad_clip=grad_clip, weight_decay=0.05)
    jcfg, cfg = JaxAdamWConfig(**kw), AdamWConfig(**kw)
    jstate = jax_adamw_init(params, jcfg)
    tparams = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32), params)
    tparams = {"a": tparams["a"], "b": tparams["b"], "c": tparams["c"]}
    tstate = adamw_init(tparams, cfg)
    jp, tp = params, tparams
    for i in range(3):
        grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 3).astype(np.float32), params)
        tgrads = jax.tree.map(lambda x: torch.from_numpy(x), grads)
        jgrads = jax.tree.map(lambda x, p: jnp.asarray(x).astype(p.dtype), grads, params)
        tgrads = jax.tree.map(lambda x, p: x.to(p.dtype), tgrads, tparams, is_leaf=lambda x: isinstance(x, torch.Tensor))
        jp, jstate, jm = jax_adamw_update(jp, jgrads, jstate, jcfg, jnp.float32(0.5 + 0.1 * i))
        tp, tstate, tm = adamw_update(tp, tgrads, tstate, cfg, torch.tensor(0.5 + 0.1 * i, dtype=torch.float32))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
        for a, b in zip(tree_lib.leaves((tp, tstate)), jax.tree.leaves((jp, jstate))):
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
            np.testing.assert_allclose(f32(a), np.asarray(b, np.float32), rtol=2e-6, atol=1e-7)


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    for _ in range(200):
        params, state, _ = adamw_update(params, {"x": 2 * params["x"]}, state, cfg)
    assert float(params["x"].abs().max()) < 0.05 and int(state["step"]) == 200


def test_grad_clip_reports_the_unclipped_norm():
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    params = {"x": torch.zeros(4)}
    _, _, m = adamw_update(params, {"x": torch.full((4,), 1e6)}, adamw_init(params, cfg), cfg)
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_bf16_moments_shapes_and_dtype():
    cfg = AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.zeros((8, 8), dtype=torch.bfloat16)}
    state = adamw_init(params, cfg)
    assert state["mu"]["w"].dtype == torch.bfloat16
    p2, s2, _ = adamw_update(params, {"w": torch.ones((8, 8), dtype=torch.bfloat16)}, state, cfg)
    assert p2["w"].dtype == torch.bfloat16 and s2["nu"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_in_blocks_gives_the_whole_leafs_bits(moment_dtype, monkeypatch):
    """A leaf longer than the plain update's ``UPDATE_ELEMENTS`` goes in
    blocks (the last one ragged); a shorter one in one block, its results
    returned as they are."""
    from repro_torch.kernels.adamw import ops as adamw_ops

    gen = torch.Generator().manual_seed(5)
    params = {"a": torch.randn((6, 5), generator=gen), "b": torch.randn(7, generator=gen).bfloat16(),
              "c": torch.randn((), generator=gen)}
    grads = {k: (3 * torch.randn(v.shape, generator=gen)).to(v.dtype) for k, v in params.items()}
    cfg = AdamWConfig(lr=0.01, moment_dtype=moment_dtype, weight_decay=0.05)
    state = adamw_init(params, cfg)
    whole = adamw_update(params, grads, state, cfg)[:2]
    monkeypatch.setattr(adamw_ops, "UPDATE_ELEMENTS", 7)  # a: 5 blocks; b: one whole block; c: one
    blocks = adamw_update(params, grads, state, cfg)[:2]
    for x, y in zip(tree_lib.leaves(blocks), tree_lib.leaves(whole)):
        assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("pair", [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
                                  (torch.float32, torch.float32), (torch.float32, torch.bfloat16)],
                         ids=["bf16_f32", "bf16_bf16", "f32_f32", "f32_bf16"])
def test_adamw_ops_off_the_card_are_the_plain_versions(pair):
    """On the CPU (and any device but the card) the AdamW ops run the plain
    versions, and the kernel wrapper refuses the tensors."""
    from repro_torch.kernels.adamw import kernel, ops, ref

    pdt, mdt = pair
    gen = torch.Generator().manual_seed(9)
    p, g = torch.randn(301, generator=gen).to(pdt), (3 * torch.randn(301, generator=gen)).to(pdt)
    mu, nu = (0.01 * torch.randn(301, generator=gen)).to(mdt), (1e-4 * torch.rand(301, generator=gen)).to(mdt)
    step = torch.tensor([0.5, 0.271, 0.142625, 1e-3])
    consts = (0.9, 0.95, 1 - 0.9, 1 - 0.95, 1e-8, 0.1)
    for got, want in zip(ops.update(p, g, mu, nu, step, consts), ref.upd_block(p, g, mu, nu, step, consts)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(ops.sum_of_squares(g), torch.sum(torch.square(g.float())))
    with pytest.raises(ValueError, match="runs on cuda"):
        kernel.update(p, g, mu, nu, step, consts)
    with pytest.raises(ValueError, match="runs on cuda"):
        kernel.sum_of_squares(g)


@pytest.mark.parametrize("which", ["cosine", "warmup_cosine"])
def test_schedules_match_jax(which):
    if which == "cosine":
        fn, jfn = cosine_schedule(50, 0.2), jax_cosine(50, 0.2)
    else:
        fn, jfn = linear_warmup_cosine(10, 110, 0.1), jax_warmup_cosine(10, 110, 0.1)
    for step in [0, 1, 5, 9, 10, 11, 49, 50, 60, 109, 110, 1000]:
        got = fn(torch.tensor(step, dtype=torch.int32))
        want = jfn(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7, err_msg=str(step))


# ---------------------------------------------------------------------------
# The kernels' autograd Functions
# ---------------------------------------------------------------------------


def _plain_forward(monkeypatch, mod, plain, **plain_kw):
    """Make ``mod``'s Function run ``plain`` in its forward (the kernel cannot
    run on the CPU): ``prepare`` hands its arguments to ``launch``."""
    def prepare(*args, **kw):
        return args, {k: v for k, v in kw.items() if k in ("causal", "window", "q_offset")}

    def launch(job):
        args, kw = job
        out = plain(*args, **kw, **plain_kw)
        return tuple(o.detach() for o in out) if isinstance(out, tuple) else out.detach()

    monkeypatch.setattr(mod, "prepare", prepare)
    monkeypatch.setattr(mod, "launch", launch)


def _grads_of(fn, inputs, weights):
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o * w).sum() for o, w in zip(outs, weights) if w is not None)
    return torch.autograd.grad(total, xs)


@pytest.mark.parametrize("weight_last", [True, False])
def test_scan_functions_give_the_plain_gradients(monkeypatch, weight_last):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    log_a = -torch.nn.functional.softplus(t(2, 9, 5))
    gx, w_h, w_last = t(2, 9, 5), t(2, 9, 5), t(2, 5)
    weights = (w_h, w_last if weight_last else None)
    want = _grads_of(rglru_ref.rglru_scan, (log_a, gx), weights)
    _plain_forward(monkeypatch, rglru, rglru_ref.rglru_scan)
    got = _grads_of(lambda *a: rglru.RGLRUScan.apply(*a), (log_a, gx), weights)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)

    dtA, dBx, C = -torch.nn.functional.softplus(t(2, 7, 3, 4)), t(2, 7, 3, 4), t(2, 7, 4)
    weights = (t(2, 7, 3), t(2, 3, 4) if weight_last else None)
    want = _grads_of(ssm_ref.ssm_scan, (dtA, dBx, C), weights)
    _plain_forward(monkeypatch, ssm, ssm_ref.ssm_scan)
    got = _grads_of(lambda *a: ssm.SSMScan.apply(*a), (dtA, dBx, C), weights)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 5])
def test_flash_attention_function_gives_the_plain_gradients(monkeypatch, window):
    rng = np.random.default_rng(1)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    q, k, v, w = t(2, 12, 4, 16), t(2, 12, 2, 16), t(2, 12, 2, 16), t(2, 12, 4, 16)
    kw = dict(causal=True, window=window, q_offset=0, q_block=4, kv_block=4)
    want = _grads_of(lambda *a: flash_ref.block_attention(*a, **kw), (q, k, v), (w,))
    _plain_forward(monkeypatch, flash, flash_ref.block_attention, q_block=4, kv_block=4)
    got = _grads_of(lambda *a: flash.FlashAttention.apply(*a, True, window, 0, 4, 4), (q, k, v), (w,))
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, rtol=0, atol=0)


def test_only_inputs_that_need_grad_get_one(monkeypatch):
    rng = np.random.default_rng(2)
    dtA = torch.from_numpy(-np.abs(rng.standard_normal((1, 4, 2, 2))).astype(np.float32))
    dBx = torch.from_numpy(rng.standard_normal((1, 4, 2, 2)).astype(np.float32)).requires_grad_(True)
    C = torch.from_numpy(rng.standard_normal((1, 4, 2)).astype(np.float32))
    _plain_forward(monkeypatch, ssm, ssm_ref.ssm_scan)
    y, _ = ssm.SSMScan.apply(dtA, dBx, C)
    y.sum().backward()
    assert dBx.grad is not None and dtA.grad is None and C.grad is None


def test_check_graph_refuses_grad_inputs_outside_the_function():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="outside its autograd Function"):
        _launch.check_graph("k", x, torch.zeros(3))
    with torch.no_grad():
        _launch.check_graph("k", x)
    _launch.check_graph("k", torch.zeros(3))


def test_a_train_step_leaves_no_cycle_holding_tensors(monkeypatch):
    """Freed state must go when its last reference does, not at the next garbage
    collection: at full width an old state held by a cycle is 20 GB of the card.
    The kernels' Functions run with their plain forward (as above)."""
    import gc

    _plain_forward(monkeypatch, flash, flash_ref.block_attention, q_block=BLOCK, kv_block=BLOCK)
    monkeypatch.setattr(flash, "flash_attention", lambda q, k, v, *, causal=True, window=0, q_offset=0, q_block=1024,
                        kv_block=1024: flash.FlashAttention.apply(q, k, v, causal, window, q_offset, q_block, kv_block))
    cfg = get_smoke_config("glm4-9b")
    state = make_train_state(cfg, AdamWConfig(), seed=0, device="cpu")
    step = make_train_step(cfg, AdamWConfig(), remat=False, q_block=BLOCK, kv_block=BLOCK)
    p, s = state.params, state.opt_state
    del state
    gc.collect()
    gc.disable()
    try:
        gc.set_debug(gc.DEBUG_SAVEALL)
        for i in range(2):
            p, s, _ = step(p, s, batch(cfg, seed=i))
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []
