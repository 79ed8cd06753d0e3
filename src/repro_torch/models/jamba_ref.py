"""A plain float32 forward of the ``jamba`` family, written from its equations.

The yardstick the port's ``jamba`` layers are held to: straightforward
PyTorch in float32 with TF32 off, a Python loop over the layers and, in the
Mamba mixers, over time.  It imports no kernel, cache or other module of
:mod:`repro_torch`; it takes the port's configuration (read by its fields
alone) and parameter dict (the same names and layouts) and returns the
logits of every position::

    x      = embed[tokens]
    layer  : x = x + mixer(rms(x) * norm1);  x = x + ffn(rms(x) * norm2)
    logits = (rms(x) * final_norm) @ unembed

Mamba-1 mixer (``mixer.*``)::

    [x_in, z]      = x @ in_proj
    u              = silu(causal_conv(x_in) + conv_b)        (depthwise, width K)
    [dt_low, B, C] = u @ x_proj;  each RMS-normed (dt_norm, b_norm, c_norm)
    dt             = softplus(dt_low @ dt_proj + dt_bias)
    h_t            = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) B_t,   A = -exp(A_log), h_0 = 0
    y_t            = h_t C_t + D * u_t
    out            = (y * silu(z)) @ out_proj

Attention (``attn.*``): grouped-query causal softmax attention, query head
``h`` on key / value head ``h // (H / KV)``, scaled by ``1 / sqrt(D)``, with
no positional encoding.  Feed-forward: the SwiGLU ``(silu(y @ wi_gate) * (y @
wi_up)) @ wo`` (``mlp.*``), or a mixture of experts (``moe.*``): the softmax
of ``y @ router`` over the experts, the ``top_k`` largest (ties to the lower
expert), and the sum of those experts' SwiGLUs each times its probability,
unnormalised; no token is dropped.

Departures from the published model (ai21labs/AI21-Jamba2-Mini, as
transformers' ``modeling_jamba.py`` is recalled): the vocabulary is padded to
a multiple of 128 (the padded rows are the port's, and their logits count);
every RMSNorm's eps is 1e-6, the published ``rms_norm_eps``; the router's
load-balance loss, a training term, is left out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS) * scale


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _swiglu(y, gate, up, down):
    return (F.silu(y @ gate) * (y @ up)) @ down


def mamba(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The Mamba-1 mixer on a normed input ``(B, S, d)``."""
    di, n, r = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, cfg.dt_rank
    xz = x @ p["mixer.in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    w = p["mixer.conv_w"]
    k = w.shape[0]
    padded = F.pad(x_in, (0, 0, k - 1, 0))
    conv = p["mixer.conv_b"] + sum(padded[:, i:i + x_in.shape[1]] * w[i] for i in range(k))
    u = F.silu(conv)
    proj = u @ p["mixer.x_proj"]
    dt_low = _rms(proj[..., :r], p["mixer.dt_norm.scale"])
    bmat = _rms(proj[..., r:r + n], p["mixer.b_norm.scale"])
    cmat = _rms(proj[..., r + n:], p["mixer.c_norm.scale"])
    dt = _softplus(dt_low @ p["mixer.dt_proj"] + p["mixer.dt_bias"])
    a = -torch.exp(p["mixer.A_log"])
    h = torch.zeros((x.shape[0], di, n), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * u[:, t])[..., None] * bmat[:, t, None, :]
        ys.append((h * cmat[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) + p["mixer.D"] * u
    return (y * F.silu(z)) @ p["mixer.out_proj"]


def attention(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Grouped-query causal attention, no positional encoding, on a normed
    input ``(B, S, d)``."""
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["attn.wq"].reshape(d, h * dh)).reshape(b, s, h, dh)
    k = (x @ p["attn.wk"].reshape(d, kv * dh)).reshape(b, s, kv, dh)
    v = (x @ p["attn.wv"].reshape(d, kv * dh)).reshape(b, s, kv, dh)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return o.reshape(b, s, h * dh) @ p["attn.wo"].reshape(h * dh, d)


def experts(cfg, p: dict, y: torch.Tensor) -> torch.Tensor:
    """The mixture of experts on a normed input ``(B, S, d)``: every token's
    ``top_k`` experts, weighted by their unnormalised probabilities."""
    probs = torch.softmax(y @ p["moe.router"], dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    out = torch.zeros_like(y)
    for j in range(cfg.top_k):
        for e in range(cfg.n_experts):
            chosen = top_e[..., j] == e
            if chosen.any():
                ye = _swiglu(y[chosen], p["moe.wi_gate"][e], p["moe.wi_up"][e], p["moe.wo"][e])
                out[chosen] += top_w[..., j][chosen][:, None] * ye
    return out


def layer(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    """One layer on the residual stream ``(B, S, d)``; its kind from ``p``'s names."""
    y = _rms(x, p["norm1.scale"])
    x = x + (mamba(cfg, p, y) if "mixer.in_proj" in p else attention(cfg, p, y))
    y = _rms(x, p["norm2.scale"])
    if "moe.router" in p:
        return x + experts(cfg, p, y)
    return x + _swiglu(y, p["mlp.wi_gate"], p["mlp.wi_up"], p["mlp.wo"])


@torch.no_grad()
def forward(cfg, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Float32 logits ``(B, S, V_pad)`` of ``tokens (B, S)`` over the whole
    model, the parameters taken in float32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = params["embed.tokens"].float()[tokens.long()]
        for p in params["layers"]:
            x = layer(cfg, {k: v.float() for k, v in p.items()}, x)
        return _rms(x, params["final_norm.scale"].float()) @ params["unembed"].float()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
