"""The port's int8 error-feedback gradient compression against the JAX package's, on the CPU.

``repro_torch.optim.compress`` against ``repro.optim.compress`` on the same
seeded numpy gradient trees (ragged leaf sizes around the 256-element block,
an all-zero leaf, magnitudes from 1e-30 to 1e30, float32 and bfloat16
leaves), over several steps that carry the residual: the dequantized
gradients and the residuals are equal bit for bit, and so are the int8 ``q``
and the scales of every block.  Then the JAX package's own properties on the
port: the error-feedback sum (what was sent plus the residual is what was
given) and the convergence case of ``tests/train/test_optim.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as JC
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import compress as C

SHAPES = {"one": (1,), "block_less_1": (255,), "block": (256,), "block_plus_1": (257,), "ragged": (3, 5, 7),
          "two_blocks_ragged": (2, 300), "zeros": (40,)}


def bits(x) -> np.ndarray:
    """A float tensor / array as its raw bits (bf16 via its float32 widening)."""
    a = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x, jnp.float32))
    return a.view(np.uint32)


def grad_tree(rng, step: int) -> dict:
    """A gradient tree with the JAX package's layout (a top-level leaf and a
    list of per-layer dicts); magnitudes span 60 decades across the leaves."""
    tree = {"layers": [{}, {}]}
    for i, (name, shape) in enumerate(SHAPES.items()):
        scale = 10.0 ** rng.integers(-30, 31)
        x = rng.standard_normal(shape).astype(np.float32) * np.float32(scale) * (1 + step % 3)
        if name == "zeros":
            x = np.zeros(shape, np.float32)
        if i == 0:
            tree[name] = x
        else:
            tree["layers"][i % 2][name] = x
    return tree


def to_torch(tree, dtype):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v, dtype) for v in tree]
    return torch.from_numpy(tree).to(dt)


def to_jax(tree, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.dtype(dtype)), tree)


def jax_q_scale(x):
    """The int8 blocks and scales of the JAX package's ``_quantize_dequantize``
    (its expressions, which it keeps local)."""
    flat = x.reshape(-1)
    fp = jnp.pad(flat, (0, (-flat.shape[0]) % JC.BLOCK)).reshape(-1, JC.BLOCK)
    scale = jnp.maximum(jnp.max(jnp.abs(fp), axis=1, keepdims=True) / 127.0, 1e-12)
    return jnp.clip(jnp.round(fp / scale), -127, 127).astype(jnp.int8), scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compression_equals_jax_bit_for_bit(seed, dtype):
    rng = np.random.default_rng(seed)
    jstate = state = None
    for step in range(4):
        g_np = grad_tree(rng, step)
        if step == 0:
            jstate = JC.compress_gradients_init(to_jax(g_np, dtype))
            state = C.compress_gradients_init(to_torch(g_np, dtype))
        before = state.residual
        jg, jstate = JC.compressed_grad_transform(to_jax(g_np, dtype), jstate)
        g, state = C.compressed_grad_transform(to_torch(g_np, dtype), state)
        for path, want in jax.tree_util.tree_flatten_with_path(jg)[0]:
            got = _at(g, path)
            assert str(got.dtype).split(".")[-1] == str(want.dtype), path
            np.testing.assert_array_equal(bits(got), bits(want), err_msg=f"step {step} dq {path}")
            np.testing.assert_array_equal(bits(_at(state.residual, path)), bits(_at(jstate.residual, path)),
                                          err_msg=f"step {step} residual {path}")
            # the blocks this step quantized: the gradient plus the residual before it
            x = _at(to_torch(g_np, dtype), path).float() + _at(before, path)
            q, scale = C.quantize_blocks(x)
            jq, jscale = jax_q_scale(jnp.asarray(x.numpy()))
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=f"step {step} q {path}")
            np.testing.assert_array_equal(bits(scale), bits(jscale), err_msg=f"step {step} scale {path}")


def _at(tree, path):
    for key in path:
        tree = tree[key.key if hasattr(key, "key") else key.idx]
    return tree


def test_jax_q_scale_is_the_packages_quantization():
    x = jnp.asarray(np.random.default_rng(3).standard_normal(700).astype(np.float32))
    q, scale = jax_q_scale(x)
    dq, err = JC._quantize_dequantize(x)
    np.testing.assert_array_equal(np.asarray((q.astype(jnp.float32) * scale).reshape(-1)[:700]), np.asarray(dq))
    np.testing.assert_array_equal(np.asarray(x - dq), np.asarray(err))


def test_zero_blocks_and_rounding_ties():
    """An all-zero block has the 1e-12 scale and q 0; a value at k + 0.5 steps
    of its block's scale rounds to the even neighbour, as ``jnp.round`` does."""
    x = torch.zeros(512)
    x[256] = 127.0  # block 2: scale exactly 1
    x[257:261] = torch.tensor([0.5, 1.5, 2.5, -0.5])
    q, scale = C.quantize_blocks(x)
    assert scale[0, 0] == torch.tensor(1e-12, dtype=torch.float32) and not q[0].any()
    assert scale[1, 0] == 1.0 and q[1, :5].tolist() == [127, 0, 2, 2, 0]
    jq, jscale = jax_q_scale(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_error_feedback_preserves_sum():
    """What was sent plus the residual is what was given, over 50 steps."""
    state = C.compress_gradients_init({"w": torch.zeros(512)})
    rng = np.random.default_rng(0)
    true_sum = np.zeros(512)
    sent_sum = np.zeros(512)
    for i in range(50):
        g = {"w": torch.from_numpy((rng.normal(size=512) * (1 + i % 3)).astype(np.float32))}
        true_sum += g["w"].numpy()
        gq, state = C.compressed_grad_transform(g, state)
        sent_sum += gq["w"].numpy()
    resid = state.residual["w"].numpy()
    np.testing.assert_allclose(sent_sum + resid, true_sum, rtol=1e-5, atol=1e-4)
    assert np.abs(resid).max() < 0.2


def test_compressed_training_converges_close_to_exact():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, grad_clip=0.0)

    def run(compress):
        params = {"x": torch.from_numpy(np.linspace(-2, 2, 64).astype(np.float32))}
        state = adamw_init(params, cfg)
        comp = C.compress_gradients_init(params)
        for _ in range(100):
            g = {"x": 2 * params["x"]}
            if compress:
                g, comp = C.compressed_grad_transform(g, comp)
            params, state, _ = adamw_update(params, g, state, cfg)
        return float(params["x"].abs().max())

    exact, comp = run(False), run(True)
    assert comp < max(4 * exact, 0.08)


def test_residual_tree_must_match():
    state = C.compress_gradients_init({"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        C.compressed_grad_transform({"a": torch.zeros(3), "b": torch.zeros(2)}, state)
