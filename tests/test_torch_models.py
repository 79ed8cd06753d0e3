"""The port's serving path (prefill + greedy decode) against the JAX package's, on the CPU.

For each ported architecture's smoke config, the JAX package's own random
init (``init_params(PRNGKey(0))``) is carried across with ``from_jax``; the
same prompt (numpy, from a seed) goes through JAX's ``prefill`` and the
port's, then four decode steps each fed the JAX run's greedy token (JAX's
``prefill`` and ``decode_step`` jitted, as ``repro.train.steps`` builds
them).  Compared:
the prefill logits, every cache entry (``k``, ``v``, ``len``, ``conv``, ``h``)
and each step's logits; in float32 also every greedy token.

Tolerances: float32 1e-4 (the two sides differ by matmul and reduction
order only); bfloat16 2e-2, the tolerance of
``tests/models/test_archs_smoke.py`` (bf16 rounds at other places in XLA and
PyTorch: JAX rounds GELU's and SiLU's intermediates to bf16, PyTorch only
their result), and 3e-2 for the hybrid in bf16, the tolerance that file
takes for the hybrid's window cache: on this prompt each bf16 run lies about
0.02 from the float32 run (JAX's 0.021, the port's 0.024 in the prefill
logits), so the two bf16 runs may lie up to twice that apart.

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

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.kernels.flash_attention import ops as jax_attn_ops
from repro.models import transformer as JT
from repro.train.steps import greedy_sample as jax_greedy_sample
from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax
from repro_torch.train.steps import greedy_sample

PROMPT, DECODE_STEPS, BLOCK = 24, 4, 8
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
HYBRID_BF16_TOL = 3e-2


def f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, tol, what):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol, err_msg=what)


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


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, monkeypatch):
    jcfg, cfg, jparams, params = carried(arch, dtype)
    tol = HYBRID_BF16_TOL if (cfg.family, dtype) == ("hybrid", "bfloat16") else TOL[dtype]
    if cfg.family == "hybrid":
        assert PROMPT > cfg.window
        monkeypatch.setattr(jax_attn_ops, "_FORCE_IMPL", "interpret")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    max_len = PROMPT + 8

    jax_prefill = jax.jit(lambda p, t: JT.prefill(jcfg, p, {"tokens": t}, max_len, q_block=BLOCK, kv_block=BLOCK))
    jlogits, jcache = jax_prefill(jparams, jnp.asarray(tokens))
    logits, cache = T.prefill(cfg, params, {"tokens": tokens}, max_len, q_block=BLOCK, kv_block=BLOCK,
                              device="cpu")
    assert logits.shape == (2, 1, cfg.padded_vocab) and str(logits.dtype) == f"torch.{dtype}"
    close(logits, jlogits, tol, "prefill logits")
    assert cache["len"] == int(jcache["len"]) == PROMPT
    for i, (lc, jlc) in enumerate(zip(cache["layers"], jcache["layers"], strict=True)):
        assert set(lc) == set(jlc)
        for name in lc:
            if name == "len":
                assert lc[name] == int(jlc[name])
            else:
                assert tuple(lc[name].shape) == jlc[name].shape, (i, name)
                close(lc[name], jlc[name], tol, f"layer {i} cache {name}")

    tok = jax_greedy_sample(jlogits)
    if dtype == "float32":
        assert np.array_equal(greedy_sample(logits).numpy(), np.asarray(tok))
    jax_decode = jax.jit(lambda p, t, c: JT.decode_step(jcfg, p, t, c))
    for step in range(DECODE_STEPS):
        jlogits, jcache = jax_decode(jparams, tok, jcache)
        logits, cache = T.decode_step(cfg, params, np.array(tok), cache, device="cpu")
        close(logits, jlogits, tol, f"decode step {step} logits")
        tok = jax_greedy_sample(jlogits)
        if dtype == "float32":
            assert np.array_equal(greedy_sample(logits).numpy(), np.asarray(tok)), f"decode step {step} token"
    assert cache["len"] == PROMPT + DECODE_STEPS
    for lc, jlc in zip(cache["layers"], jcache["layers"]):
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


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_configs_are_the_jax_packages(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(jax_get_smoke_config(arch))


def test_unported_arch_and_family_raise():
    with pytest.raises(KeyError, match="not ported yet"):
        get_config("whisper-large-v3")
    moe = dataclasses.replace(get_smoke_config("glm4-9b"), family="moe")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.init_params(moe, device="cpu")


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_random_init_has_the_jax_structure(arch):
    cfg = get_smoke_config(arch)
    jparams = JT.abstract_params(jax_get_smoke_config(arch))
    params = T.init_params(cfg, seed=3, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == sum(len(p) for p in params["layers"]) + len(params) - 1
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
