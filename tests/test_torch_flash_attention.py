"""The port's attention (plain PyTorch, on the CPU) against the JAX package's.

The same numpy inputs from a seed go through the TPU kernel in interpret mode
(``flash_attention_tpu(..., interpret=True)``), the JAX oracle
``naive_attention`` and the port's ``flash_attention`` op / wrapper, which on
CPU tensors run the plain ``block_attention``.  Tolerances are the JAX tests'
own (``tests/kernels/test_flash_attention.py``): 2e-6 in float32, 2e-2 in
bfloat16 (both sides compute in float32 and round the output to bfloat16).

The window cases hold the port to the TPU kernel and the oracle.  The JAX
package's ``ref.block_attention`` skips a kv tile when its *last* query row
sees none of it, which drops keys its first rows see (``(1, 512, 2, 2, 64,
True, 128)`` with 64-blocks is such a case); the port skips a tile only when
no row sees it, as the kernel does.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_tpu
from repro.kernels.flash_attention.ref import block_attention as jax_block_attention
from repro.kernels.flash_attention.ref import decode_attention as jax_decode_attention
from repro.kernels.flash_attention.ref import naive_attention as jax_naive_attention
from repro_torch.kernels.flash_attention import kernel, ops, ref

SHAPES = [
    # (b, s, kv, g, d, causal, window) -- tests/kernels/test_flash_attention.py
    (2, 256, 2, 4, 64, True, 0),  # GQA causal
    (1, 256, 1, 8, 128, True, 0),  # MQA d=128
    (2, 256, 4, 1, 64, False, 0),  # MHA bidirectional (encoder)
    (1, 512, 2, 2, 64, True, 128),  # sliding window
    (1, 128, 2, 2, 64, True, 64),  # window == block
]
#: Head dims and groups of the served models that the JAX tests' shapes do not cover
SERVED_SHAPES = [
    (1, 192, 1, 8, 112, True, 0),  # kimi-k2: D = 112, G = 8
    (1, 128, 2, 4, 112, False, 0),  # D = 112 bidirectional
    (1, 128, 2, 9, 128, True, 0),  # starcoder2-7b: G = 9
    (1, 128, 1, 12, 128, True, 0),  # starcoder2-3b: G = 12
    (1, 128, 2, 7, 64, True, 0),  # internvl2-1b: G = 7
]
DTYPES = {"float32": (np.float32, torch.float32, 2e-6), "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 2e-2)}


def qkv_np(b, sq, kv, g, d, np_dtype, sk=None, seed=0):
    rng = np.random.default_rng(seed)
    sk = sk or sq
    q = rng.standard_normal((b, sq, kv * g, d), dtype=np.float32).astype(np_dtype)
    k = rng.standard_normal((b, sk, kv, d), dtype=np.float32).astype(np_dtype)
    v = rng.standard_normal((b, sk, kv, d), dtype=np.float32).astype(np_dtype)
    return q, k, v


def to_torch(*xs):
    out = []
    for x in xs:
        if x.dtype == ml_dtypes.bfloat16:
            out.append(torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(x.copy()))
    return out


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES + SERVED_SHAPES, ids=lambda s: "b{}s{}kv{}g{}d{}c{}w{}".format(*map(int, s)))
def test_port_matches_tpu_kernel_and_oracle(shape, dtype):
    b, s, kv, g, d, causal, window = shape
    np_dtype, torch_dtype, tol = DTYPES[dtype]
    q, k, v = qkv_np(b, s, kv, g, d, np_dtype)
    tpu = flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
        q_block=64, kv_block=64, interpret=True,
    )
    oracle = jax_naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window)
    tq, tk, tv = to_torch(q, k, v)
    port = ops.flash_attention(tq, tk, tv, causal=causal, window=window, q_block=64, kv_block=64)
    assert port.dtype == torch_dtype and tuple(port.shape) == q.shape
    np.testing.assert_allclose(as_f32(port), as_f32(tpu), atol=tol, rtol=tol)
    np.testing.assert_allclose(as_f32(port), as_f32(oracle), atol=tol, rtol=tol)
    naive = ref.naive_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(as_f32(naive), as_f32(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("blocks", [(32, 32), (64, 128), (128, 64), (256, 256), (48, 80)])
def test_block_shape_invariance(blocks):
    q, k, v = qkv_np(1, 256, 2, 2, 64, np.float32, seed=1)
    oracle = jax_naive_attention(q, k, v, causal=True, window=100)
    port = ref.block_attention(*to_torch(q, k, v), causal=True, window=100, q_block=blocks[0], kv_block=blocks[1])
    np.testing.assert_allclose(as_f32(port), as_f32(oracle), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length(causal):
    """S = 250 is no multiple of the 64-blocks: padded keys are masked and
    padded rows cut off."""
    q, k, v = qkv_np(2, 250, 2, 2, 64, np.float32, seed=2)
    port = ops.flash_attention(*to_torch(q, k, v), causal=causal, q_block=64, kv_block=64)
    oracle = jax_naive_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(as_f32(port), as_f32(oracle), atol=2e-6, rtol=2e-6)
    jax_ref = jax_block_attention(q, k, v, causal=causal, q_block=64, kv_block=64)
    np.testing.assert_allclose(as_f32(port), as_f32(jax_ref), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("window", [0, 96])
def test_q_offset_suffix_queries(window):
    """64 queries at absolute positions 192..255 against 256 keys."""
    q, k, v = qkv_np(1, 64, 2, 4, 32, np.float32, sk=256, seed=3)
    tpu = flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=window, q_block=32, kv_block=64,
        q_offset=192, interpret=True,
    )
    oracle = jax_naive_attention(q, k, v, causal=True, window=window, q_offset=192)
    port = ops.flash_attention(*to_torch(q, k, v), causal=True, window=window, q_block=32, kv_block=64, q_offset=192)
    np.testing.assert_allclose(as_f32(port), as_f32(tpu), atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(as_f32(port), as_f32(oracle), atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("window", [0, 40])
def test_decode_attention_matches_jax(window):
    b, s, kv, g, d = 2, 96, 2, 3, 64
    q, k, v = qkv_np(b, 1, kv, g, d, np.float32, sk=s + 32, seed=4)
    for cur in (1, 50, s):
        want = jax_decode_attention(q, k, v, jnp.asarray(cur), window=window)
        got = ref.decode_attention(*to_torch(q, k, v), cur, window=window)
        np.testing.assert_allclose(as_f32(got), as_f32(want), atol=2e-6, rtol=2e-6)


def test_decode_attention_equals_last_row_of_full():
    q, k, v = qkv_np(2, 96, 2, 3, 64, np.float32, seed=5)
    tq, tk, tv = to_torch(q, k, v)
    full = ref.naive_attention(tq, tk, tv, causal=True)
    dec = ref.decode_attention(tq[:, -1:], tk, tv, 96)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(), atol=2e-6, rtol=2e-6)


def test_plain_impl_and_unknown_impl():
    tq, tk, tv = to_torch(*qkv_np(1, 64, 1, 2, 16, np.float32, seed=6))
    a = ops.flash_attention(tq, tk, tv, causal=True, q_block=16, kv_block=16)
    b = ops.flash_attention(tq, tk, tv, causal=True, q_block=16, kv_block=16, impl="plain")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(tq, tk, tv, impl="pallas")


def test_kernel_prepare_refuses_cpu_tensors():
    tq, tk, tv = to_torch(*qkv_np(1, 8, 1, 2, 16, np.float32))
    before = kernel.launches
    with pytest.raises(ValueError, match="runs on cuda"):
        kernel.prepare(tq, tk, tv)
    with pytest.raises(ValueError, match="runs on cuda"):
        kernel.backward_prepare(tq, tk, tv, tq, tq[..., 0].transpose(1, 2), tq)
    ops.flash_attention(tq, tk, tv)  # the plain version: no launch
    with pytest.raises(ValueError, match="runs on cuda"):
        kernel.flash_attention(tq, tk, tv)
    assert kernel.launches == before


def test_tma_checks_refuse_what_a_tensor_map_cannot_take():
    """``check_tma`` (run by ``prepare`` before the bf16 TMA body) needs no card."""
    bf = dict(dtype=torch.bfloat16)
    q, k = torch.zeros((1, 16, 4, 64), **bf), torch.zeros((1, 16, 2, 64), **bf)
    kernel.check_tma(q, k, k)  # contiguous and aligned: taken
    kernel.check_tma(torch.zeros((1, 16, 4, 128), **bf)[..., :64], k, k)  # strides of whole 16-byte units
    shifted = torch.zeros(q.numel() + 8, **bf)[1 : 1 + q.numel()].view(q.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        kernel.check_tma(shifted, k, k)
    with pytest.raises(ValueError, match="strides"):
        kernel.check_tma(torch.zeros((1, 16, 4, 68), **bf)[..., :64], k, k)  # rows of 136 bytes
    kernel.check_tma(q, k, torch.zeros((1, 2, 16, 64), **bf).transpose(1, 2))  # heads outermost: a map takes it
    with pytest.raises(ValueError, match="unit stride"):
        kernel.check_tma(q, k, torch.zeros((1, 16, 64, 2), **bf).transpose(2, 3))
    meta = dict(device="meta", **bf)
    with pytest.raises(ValueError, match="q tiles"):  # G = 64: 2 positions a tile
        kernel.check_tma(torch.empty((1, 140000, 64, 64), **meta), torch.empty((1, 16, 1, 64), **meta),
                         torch.empty((1, 16, 1, 64), **meta))
    with pytest.raises(ValueError, match="32-bit"):
        kernel.check_tma(q, k, k, q_offset=2**31)
    q112, k112 = torch.zeros((1, 16, 8, 112), **bf), torch.zeros((1, 16, 1, 112), **bf)
    kernel.check_tma(q112, k112, k112)  # D = 112: rows of 224 bytes, 14 units of 16


def test_head_dims_cover_every_registered_config():
    """Every attention of every registered model (full and smoke config) takes a
    head dim the kernel is built for and a group within its rows."""
    from repro_torch.configs import PORTED_ARCHS, get_config, get_smoke_config

    for arch in PORTED_ARCHS:
        for cfg in (get_config(arch), get_smoke_config(arch)):
            if cfg.attention_free:
                continue
            assert cfg.d_head in kernel.HEAD_DIMS, (arch, cfg.d_head)
            assert cfg.n_heads % cfg.n_kv_heads == 0 and cfg.n_heads // cfg.n_kv_heads <= kernel.ROWS, arch
    assert set(kernel.TMA_HEAD_DIMS) <= set(kernel.HEAD_DIMS) and set(kernel.TMA_KV_TILE) == set(kernel.TMA_HEAD_DIMS)
    assert 112 in kernel.TMA_HEAD_DIMS


#: (b, sq, sk, kv, g, d, causal, window, q_offset) of the plain backward's cases: every
#: row sees a key (the backward's domain); blocks of 16 keep several tiles and ragged edges
BACKWARD_CASES = [
    (2, 40, 40, 2, 4, 16, True, 0, 0),  # causal GQA, G 4, ragged against the 16-blocks
    (1, 33, 33, 3, 1, 8, False, 0, 0),  # bidirectional, G 1
    (1, 48, 48, 1, 7, 16, True, 11, 0),  # window, G 7
    (1, 30, 57, 2, 2, 8, True, 9, 27),  # q_offset with a window, Sk > Sq
    (1, 21, 45, 1, 4, 8, True, 0, 24),  # q_offset, no window
    (2, 37, 37, 1, 1, 8, False, 13, 0),  # bidirectional with a window
]


@pytest.mark.parametrize("case", BACKWARD_CASES, ids=lambda c: "b{}q{}k{}kv{}g{}d{}c{}w{}o{}".format(*map(int, c)))
def test_plain_backward_gives_the_autograd_gradients(case):
    """``ref.attention_backward`` from O, the LSE ``block_attention`` returns and dO
    against autograd through ``block_attention`` and ``naive_attention`` (float32,
    atol 1e-5: the same sums in other orders); the LSE against a log-sum-exp of the
    naive scores."""
    b, sq, sk, n_kv, g, d, causal, window, q_offset = case
    rng = np.random.default_rng(sum(case))
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    q, k, v, w = t(b, sq, n_kv * g, d), t(b, sk, n_kv, d), t(b, sk, n_kv, d), t(b, sq, n_kv * g, d)
    assert kernel.sees_a_key(sq, sk, window, q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = ref.block_attention(q, k, v, q_block=16, kv_block=16, return_lse=True, **kw)
    assert torch.equal(o, ref.block_attention(q, k, v, q_block=16, kv_block=16, **kw))
    got = ref.attention_backward(q, k, v, o, lse, w, q_block=16, kv_block=16, **kw)
    for plain in (lambda *a: ref.block_attention(*a, q_block=16, kv_block=16, **kw),
                  lambda *a: ref.naive_attention(*a, **kw)):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        want = torch.autograd.grad((plain(*xs) * w).sum(), xs)
        for gx, wx in zip(got, want):
            torch.testing.assert_close(gx, wx, atol=1e-5, rtol=0)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(g, dim=2)) / d**0.5
    q_pos, k_pos = torch.arange(sq)[:, None] + q_offset, torch.arange(sk)[None, :]
    mask = (k_pos <= q_pos) if causal else torch.ones((sq, sk), dtype=torch.bool)
    if window:
        mask &= k_pos > q_pos - window
    torch.testing.assert_close(lse, torch.logsumexp(scores.masked_fill(~mask, ref.NEG_INF), dim=-1), atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "device, dtype, d, sq, sk, window, q_offset, path",
    [
        ("cuda", torch.bfloat16, 128, 4096, 4096, 0, 0, "kernel"),  # glm4-9b's train step
        ("cuda", torch.bfloat16, 64, 1500, 1500, 0, 0, "kernel"),  # whisper, internvl2-1b
        ("cuda", torch.bfloat16, 112, 333, 333, 0, 0, "kernel"),  # kimi-k2
        ("cuda", torch.bfloat16, 128, 200, 455, 100, 255, "kernel"),  # a window and q_offset, every row sees a key
        ("cuda", torch.bfloat16, 128, 200, 300, 50, 150, "plain"),  # the last rows see no key
        ("cuda", torch.bfloat16, 256, 4096, 4096, 0, 0, "plain"),  # recurrentgemma-9b's D 256
        ("cuda", torch.bfloat16, 16, 64, 64, 0, 0, "plain"),  # the smoke configs' D 16
        ("cuda", torch.bfloat16, 32, 64, 64, 0, 0, "plain"),
        ("cuda", torch.float32, 128, 4096, 4096, 0, 0, "plain"),  # float32: the plain recompute
        ("cpu", torch.bfloat16, 128, 4096, 4096, 0, 0, "plain"),  # no kernel on the CPU
        ("cpu", torch.float32, 64, 64, 64, 0, 0, "plain"),
    ],
)
def test_backward_dispatch_by_device_dtype_and_head_dim(device, dtype, d, sq, sk, window, q_offset, path):
    assert kernel.backward_path(device, dtype, d, sq=sq, sk=sk, window=window, q_offset=q_offset) == path


@pytest.mark.parametrize("batch, kv, g, sk, groups", [(2, 2, 16, 4096, 4), (1, 8, 4, 4096, 2), (2, 2, 16, 64, 16),
                                                      (1, 1, 1, 100, 1), (1, 4, 7, 512, 7), (4, 8, 8, 8192, 1)])
def test_backward_groups_fill_the_card(batch, kv, g, sk, groups):
    """The fewest groups (a divisor of G) that give three blocks an SM, else one a head."""
    assert kernel.backward_groups(batch, kv, g, sk) == groups


@pytest.mark.parametrize("needs_grad", [True, False])
def test_function_takes_the_kernel_backward_where_dispatched(monkeypatch, needs_grad):
    """The Function's wiring on the CPU, with ``backward_path`` forced to ``"kernel"``
    and the launches replaced by the plain versions: the forward asks for the LSE only
    when a gradient is needed, and the backward's dq / dk / dv are
    ``ref.attention_backward``'s, equal to the recompute's within 1e-5."""
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    q, k, v, w = t(1, 24, 4, 8), t(1, 24, 2, 8), t(1, 24, 2, 8), t(1, 24, 4, 8)
    kw = dict(causal=True, window=7, q_offset=0)
    asked = []

    def prepare(q, k, v, *, causal, window, q_offset, lse=False):
        asked.append(lse)
        out = ref.block_attention(q, k, v, causal=causal, window=window, q_offset=q_offset, q_block=8, kv_block=8,
                                  return_lse=True)
        return kernel.Launch(None, (), (), out if lse else out[:1])

    def backward_prepare(q, k, v, o, lse, do, **kw):
        return kernel.Launch(None, (), (), ref.attention_backward(q, k, v, o, lse, do, q_block=8, kv_block=8, **kw))

    monkeypatch.setattr(kernel, "backward_path", lambda *a, **k: "kernel")
    monkeypatch.setattr(kernel, "prepare", prepare)
    monkeypatch.setattr(kernel, "launch", lambda job: job.outs[0])
    monkeypatch.setattr(kernel, "backward_prepare", backward_prepare)
    monkeypatch.setattr(kernel, "backward_launch", lambda job: job.outs)
    xs = [x.clone().requires_grad_(needs_grad) for x in (q, k, v)]
    out = kernel.FlashAttention.apply(*xs, kw["causal"], kw["window"], kw["q_offset"], 8, 8)
    assert asked == [needs_grad]
    if not needs_grad:
        return
    got = torch.autograd.grad((out * w).sum(), xs)
    ys = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad((ref.block_attention(*ys, q_block=8, kv_block=8, **kw) * w).sum(), ys)
    for gx, wx in zip(got, want):
        torch.testing.assert_close(gx, wx, atol=1e-5, rtol=0)
