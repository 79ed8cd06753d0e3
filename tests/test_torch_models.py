"""The port's serving path (prefill + greedy decode) against the JAX package's, on the CPU.

For each ported architecture's smoke config, the JAX package's own random
init (``init_params(PRNGKey(0))``) is carried across with ``from_jax``; the
same prompt (numpy, from a seed) goes through JAX's ``prefill`` and the
port's, then four decode steps each fed the JAX run's greedy token (JAX's
``prefill`` and ``decode_step`` jitted, as ``repro.train.steps`` builds
them).  Compared:
the prefill logits, every cache entry (``k``, ``v``, ``len``, ``conv``, ``h``;
an encoder-decoder's ``self`` cache and ``cross_k`` / ``cross_v``) and each
step's logits; in float32 also every greedy token.  An encoder-decoder's
prompt comes with random ``frames``, a VLM's with random ``vision_embeds``
over the first ``vision_tokens`` positions of each row.

Tolerances: float32 1e-4 (the two sides differ by matmul and reduction
order only); bfloat16 2e-2, the tolerance of
``tests/models/test_archs_smoke.py`` (bf16 rounds at other places in XLA and
PyTorch: JAX rounds GELU's and SiLU's intermediates to bf16, PyTorch only
their result), and 3e-2 in bf16 for the hybrid, the enc-dec and the MoE
(``BF16_NOISY``): on these prompts each bf16 run lies about 0.02 from its
float32 run (the hybrid: JAX's 0.021, the port's 0.024 in the prefill logits,
the window cache's tolerance there; whisper: 0.017 and 0.019), so the two bf16
runs may lie up to twice that apart.  The bf16 MoE is further from its float32
run (0.04-0.05: the experts' activations are large, as their weights' fan-in
is the expert count), and its JAX side runs op by op (see :func:`jax_jit`),
where the port's experts round as JAX's do and only the dense MLP's SiLU
rounds elsewhere (0.025 in the prefill logits).

The JAX side runs on its default CPU path, except that the hybrid's windowed
attention goes through the TPU kernel in interpret mode: with a prompt longer
than the window, the JAX package's ``ref.block_attention`` skips kv tiles that
the first rows of a q tile see (see ``tests/test_torch_flash_attention.py``).
The hybrid prompt (24 tokens) is longer than its window (16), so the rolling
window cache is filled by prefill and wraps during decode.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.kernels.flash_attention import ops as jax_attn_ops
from repro.models import transformer as JT
from repro.train.steps import greedy_sample as jax_greedy_sample
from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax, state_from_jax
from repro_torch.train.steps import greedy_sample

PROMPT, DECODE_STEPS, BLOCK = 24, 4, 8
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BF16_NOISY, NOISY_BF16_TOL = ("hybrid", "encdec", "moe"), 3e-2


def f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, tol, what):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol, err_msg=what)


def jax_jit(cfg, dtype):
    """``jax.jit``, except for a bf16 MoE, whose JAX side runs op by op: XLA's
    fusions in a jitted bf16 MoE round elsewhere than each operation does, and
    its expert activations are large (the experts' fan-in is the expert count),
    so the jitted run lies 0.05 from the float32 run; op by op, the port's bf16
    operations round where JAX's do (``repro_torch.models.moe.silu``)."""
    return (lambda f: f) if (cfg.family, dtype) == ("moe", "bfloat16") else jax.jit


@functools.cache
def jax_init_f32(arch):
    cfg = dataclasses.replace(jax_get_smoke_config(arch), dtype="float32")
    return jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0)))


def carried(arch, dtype):
    """(jax config, port config, jax params, port params) of the smoke config.

    The JAX package's bf16 init draws float32 values and casts them, so the
    bf16 parameters are the float32 config's cast to the bf16 config's dtypes
    (one init per architecture).
    """
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jparams = jax.tree.map(lambda x, spec: x.astype(spec.dtype), jax_init_f32(arch), JT.abstract_params(jcfg))
    params = from_jax(cfg, jparams, "cpu")
    return jcfg, cfg, jparams, params


def prompt_batch(cfg, seed=1, b=2, s=PROMPT) -> dict:
    """Tokens (numpy, from a seed), with random ``frames`` for an
    encoder-decoder and ``vision_embeds`` over the first ``vision_tokens``
    positions for a VLM."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, cfg.encoder_positions, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
        batch["vision_mask"] = np.arange(s)[None, :].repeat(b, 0) < cfg.vision_tokens
    return batch


def close_cache(lc, jlc, tol, what):
    """Every entry of a layer's cache (nested for a decoder's ``self``)."""
    assert set(lc) == set(jlc), what
    for name in lc:
        if isinstance(lc[name], dict):
            close_cache(lc[name], jlc[name], tol, f"{what} {name}")
        elif name == "len":
            assert lc[name] == int(jlc[name])
        else:
            assert tuple(lc[name].shape) == jlc[name].shape, (what, name)
            close(lc[name], jlc[name], tol, f"{what} {name}")


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, monkeypatch):
    jcfg, cfg, jparams, params = carried(arch, dtype)
    tol = NOISY_BF16_TOL if cfg.family in BF16_NOISY and dtype == "bfloat16" else TOL[dtype]
    if cfg.family == "hybrid":
        assert PROMPT > cfg.window
        monkeypatch.setattr(jax_attn_ops, "_FORCE_IMPL", "interpret")
    batch = prompt_batch(cfg)
    max_len = PROMPT + 8

    jit = jax_jit(cfg, dtype)
    jax_prefill = jit(lambda p, b: JT.prefill(jcfg, p, b, max_len, q_block=BLOCK, kv_block=BLOCK))
    jlogits, jcache = jax_prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, cache = T.prefill(cfg, params, batch, max_len, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    assert logits.shape == (2, 1, cfg.padded_vocab) and str(logits.dtype) == f"torch.{dtype}"
    close(logits, jlogits, tol, "prefill logits")
    assert cache["len"] == int(jcache["len"]) == PROMPT
    for i, (lc, jlc) in enumerate(zip(cache["layers"], jcache["layers"], strict=True)):
        close_cache(lc, jlc, tol, f"layer {i} cache")

    tok = jax_greedy_sample(jlogits)
    if dtype == "float32":
        assert np.array_equal(greedy_sample(logits).numpy(), np.asarray(tok))
    jax_decode = jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c))
    for step in range(DECODE_STEPS):
        jlogits, jcache = jax_decode(jparams, tok, jcache)
        logits, cache = T.decode_step(cfg, params, np.array(tok), cache, device="cpu")
        close(logits, jlogits, tol, f"decode step {step} logits")
        tok = jax_greedy_sample(jlogits)
        if dtype == "float32":
            assert np.array_equal(greedy_sample(logits).numpy(), np.asarray(tok)), f"decode step {step} token"
    assert cache["len"] == PROMPT + DECODE_STEPS
    for lc, jlc in zip(cache["layers"], jcache["layers"]):
        lc, jlc = lc.get("self", lc), jlc.get("self", jlc)
        for name in ("h", "k"):
            if name in lc:
                close(lc[name], jlc[name], tol, f"cache {name} after decode")


def test_forward_matches_jax_and_prefill():
    jcfg, cfg, jparams, params = carried("glm4-9b", "float32")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jax_forward = jax.jit(lambda p, t: JT.forward(jcfg, p, {"tokens": t}, q_block=BLOCK, kv_block=BLOCK)[0])
    jlogits = jax_forward(jparams, jnp.asarray(tokens))
    logits = T.forward(cfg, params, {"tokens": tokens}, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    close(logits, jlogits, 1e-4, "forward logits")
    last, _ = T.prefill(cfg, params, {"tokens": tokens}, 24, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    close(last[:, 0], logits[:, -1], 1e-5, "prefill == forward at the last position")


def test_dense_variants_match_jax():
    """The dense family's other switches, as starcoder2's config sets some of
    them: LayerNorm, a plain GELU MLP, learned positions, tied embeddings and
    a logit soft-cap (float32)."""
    base = dataclasses.replace(
        jax_get_smoke_config("glm4-9b"), dtype="float32", norm="layernorm", act="gelu", gated_mlp=False,
        learned_pos=True, max_position=64, tie_embeddings=True, logit_softcap=30.0,
    )
    cfg = dataclasses.replace(get_smoke_config("glm4-9b"), **{
        f: getattr(base, f) for f in ("dtype", "norm", "act", "gated_mlp", "learned_pos", "max_position",
                                      "tie_embeddings", "logit_softcap")
    })
    jparams = jax.jit(JT.init_params, static_argnums=0)(base, jax.random.PRNGKey(0))
    params = from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, t: JT.prefill(base, p, {"tokens": t}, 16, q_block=BLOCK, kv_block=BLOCK))(
        jparams, jnp.asarray(tokens))
    logits, cache = T.prefill(cfg, params, {"tokens": tokens}, 16, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    close(logits, jlogits, 1e-4, "prefill logits")
    tok = jax_greedy_sample(jlogits)
    jlogits, _ = jax.jit(lambda p, t, c: JT.decode_step(base, p, t, c))(jparams, tok, jcache)
    logits, _ = T.decode_step(cfg, params, np.array(tok), cache, device="cpu")
    close(logits, jlogits, 1e-4, "decode logits")


def test_head_dim_112_matches_jax():
    """kimi-k2's head dim (7168 / 64 = 112) at a small width: 2 heads of 112 over
    1 kv head, prefill and two decode steps through the plain path against JAX
    (float32)."""
    base = dataclasses.replace(jax_get_smoke_config("kimi-k2-1t-a32b"), family="dense", d_model=224, n_heads=2,
                               n_kv_heads=1, d_head=0, d_ff=96, dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("kimi-k2-1t-a32b"), family="dense", d_model=224, n_heads=2,
                              n_kv_heads=1, d_head=0, d_ff=96, dtype="float32")
    assert cfg.d_head == base.d_head == 112
    jparams = jax.jit(JT.init_params, static_argnums=0)(base, jax.random.PRNGKey(0))
    params = from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, t: JT.prefill(base, p, {"tokens": t}, 24, q_block=BLOCK, kv_block=BLOCK))(
        jparams, jnp.asarray(tokens))
    logits, cache = T.prefill(cfg, params, {"tokens": tokens}, 24, q_block=BLOCK, kv_block=BLOCK, device="cpu")
    close(logits, jlogits, 1e-4, "prefill logits")
    close(cache["layers"][1]["k"], jcache["layers"][1]["k"], 1e-4, "cache k")
    for step in range(2):
        tok = jax_greedy_sample(jlogits)
        jlogits, jcache = jax.jit(lambda p, t, c: JT.decode_step(base, p, t, c))(jparams, tok, jcache)
        logits, cache = T.decode_step(cfg, params, np.array(tok), cache, device="cpu")
        close(logits, jlogits, 1e-4, f"decode step {step} logits")


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(jax_get_smoke_config(arch))


def test_every_jax_arch_is_registered():
    assert set(PORTED_ARCHS) == set(JAX_ARCH_IDS) and len(PORTED_ARCHS) == len(JAX_ARCH_IDS)


def test_unported_arch_and_family_raise():
    """Every arch and family of the JAX package is ported now: what raises is an
    arch or a family that neither package knows."""
    with pytest.raises(KeyError, match="unknown arch 'gpt-7'"):
        get_config("gpt-7")
    with pytest.raises(KeyError, match="unknown arch"):
        get_smoke_config("gpt-7")
    odd = dataclasses.replace(get_smoke_config("glm4-9b"), family="diffusion")
    with pytest.raises(ValueError, match="unknown family 'diffusion'"):
        T.init_params(odd, device="cpu")


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_random_init_has_the_jax_structure(arch):
    cfg = get_smoke_config(arch)
    jparams = JT.abstract_params(jax_get_smoke_config(arch))
    params = T.init_params(cfg, seed=3, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    lists = [name for name in ("layers", "encoder") if name in params]
    assert lists == (["layers", "encoder"] if cfg.family == "encdec" else ["layers"])
    assert len(params["encoder"] if "encoder" in lists else []) == cfg.encoder_layers
    assert len(flat) == sum(len(p) for name in lists for p in params[name]) + len(params) - len(lists)
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert tuple(node.shape) == leaf.shape and str(node.dtype).removeprefix("torch.") == str(leaf.dtype)
    again = T.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(params["embed.tokens"], again["embed.tokens"])
    w = params["layers"][0]["norm1.scale" if cfg.family != "ssm" else "mixer.in_proj"]
    assert torch.isfinite(w.float()).all()
    emb = params["embed.tokens"].float()  # scale 1: a unit normal cut at +-2
    assert emb.abs().max() <= 2.0 and 0.7 < emb.std() < 1.0


def test_from_jax_refuses_a_wrong_shape():
    cfg = dataclasses.replace(get_smoke_config("falcon-mamba-7b"), dtype="float32")
    jparams = jax.tree.map(np.copy, jax_init_f32("falcon-mamba-7b"))
    jparams["layers"][1]["mixer.A_log"] = jparams["layers"][1]["mixer.A_log"][:, :2]
    with pytest.raises(ValueError, match=r"layers\[1\]\.mixer\.A_log"):
        from_jax(cfg, jparams, "cpu")


def test_from_jax_carries_and_checks_the_encoder():
    cfg = dataclasses.replace(get_smoke_config("whisper-large-v3"), dtype="float32")
    jparams = jax.tree.map(np.copy, jax_init_f32("whisper-large-v3"))
    params = from_jax(cfg, jparams, "cpu")
    assert len(params["encoder"]) == cfg.encoder_layers
    assert np.array_equal(params["encoder"][1]["attn.wq"].numpy(), jparams["encoder"][1]["attn.wq"])
    assert np.array_equal(params["encoder_norm.bias"].numpy(), jparams["encoder_norm.bias"])
    bad = dict(jparams, encoder=[dict(p) for p in jparams["encoder"]])
    bad["encoder"][1]["mlp.wo"] = bad["encoder"][1]["mlp.wo"][:-1]
    with pytest.raises(ValueError, match=r"encoder\[1\]\.mlp\.wo"):
        from_jax(cfg, bad, "cpu")
    with pytest.raises(ValueError, match=r"encoder_norm\.scale"):
        from_jax(cfg, dict(jparams, **{"encoder_norm.scale": jparams["encoder_norm.scale"][:3]}), "cpu")
    with pytest.raises(ValueError, match="1 encoder, expected 2"):
        from_jax(cfg, dict(jparams, encoder=jparams["encoder"][:1]), "cpu")
    with pytest.raises(ValueError, match="no encoder, expected 2"):
        from_jax(cfg, {k: v for k, v in jparams.items() if k != "encoder"}, "cpu")


def test_state_from_jax_carries_the_encoders_moments():
    from repro.optim import AdamWConfig as JaxAdamWConfig
    from repro.optim import adamw_init as jax_adamw_init

    cfg = dataclasses.replace(get_smoke_config("whisper-large-v3"), dtype="float32")
    jparams = jax_init_f32("whisper-large-v3")
    opt = jax.tree.map(np.array, jax_adamw_init(jparams, JaxAdamWConfig(moment_dtype="float32")))
    opt["mu"]["encoder"][0]["attn.wk"] += 0.5
    params, state = state_from_jax(cfg, jparams, opt, "cpu")
    assert len(state["mu"]["encoder"]) == len(state["nu"]["encoder"]) == cfg.encoder_layers
    assert bool((state["mu"]["encoder"][0]["attn.wk"] == 0.5).all()) and "encoder_norm.scale" in state["nu"]
    opt["nu"]["encoder"][1]["attn.wk"] = opt["nu"]["encoder"][1]["attn.wk"][:, :1]
    with pytest.raises(ValueError, match=r"encoder\[1\]\.attn\.wk"):
        state_from_jax(cfg, jparams, opt, "cpu")


def test_entry_points_need_a_gpu_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    cfg = get_smoke_config("glm4-9b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(cfg)
    params = T.init_params(cfg, device="cpu")
    batch = {"tokens": np.zeros((1, 4), np.int32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.prefill(cfg, params, batch, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.forward(cfg, params, batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, 1, 8)
    _, cache = T.prefill(cfg, params, batch, 8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.decode_step(cfg, params, np.zeros((1, 1), np.int32), cache)
    with pytest.raises(ValueError, match="the parameters are on cpu"):
        T.prefill(cfg, params, batch, 8, device="meta")


def test_greedy_sample_matches_jax():
    logits = np.random.default_rng(4).standard_normal((3, 2, 50)).astype(np.float32)
    logits[1, -1, 7] = logits[1, -1, 9] = logits[1, -1].max() + 1  # a tie: the lower id wins
    got = greedy_sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jax_greedy_sample(jnp.asarray(logits))))
