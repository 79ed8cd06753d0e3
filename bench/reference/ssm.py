"""A Mamba-1 layer (falcon-mamba-7b's family): pre-norm RMSNorm, the input
projection into x and the gate z, a depthwise causal convolution with bias
and SiLU, the selective state-space scan, the skip ``D * x``, the gate
``SiLU(z)`` and the output projection.

    x_proj(x)     = [dt_low, B_t, C_t]         (dt_rank, N, N)
    dt            = softplus(dt_low @ dt_proj + dt_bias)
    h_t[d, n]     = exp(dt[d] * A[d, n]) * h_{t-1}[d, n] + dt[d] * x_t[d] * B_t[n],  A = -exp(A_log), h_0 = 0
    y_t[d]        = sum_n h_t[d, n] * C_t[n] + D[d] * x_t[d]

Parameter names and layouts are the configuration's: ``mixer.in_proj (d,
2 di)`` (x first, then z), ``mixer.conv_w (K, di)``, ``mixer.conv_b``,
``mixer.x_proj (di, dt_rank + 2N)``, ``mixer.dt_proj (dt_rank, di)``,
``mixer.dt_bias``, ``mixer.A_log (di, N)``, ``mixer.D``, ``mixer.out_proj (di,
d)``, ``norm.scale``.

The scan runs in blocks of channels, and over time in chunks: each chunk's
recurrence from a zero state (all chunks at once, step by step), then the
chunks' last states carried from chunk to chunk, then each position's state
completed by the carried state times the chunk's running product of decays.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import mm, rms_norm, softplus

#: Time steps of a scan chunk.
CHUNK = 128
#: State elements ``(B, S, channels, N)`` one block of channels holds at a time (2 GiB of float32).
BLOCK_ELEMENTS = 1 << 29


def scan(dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y ``(B, S, D)`` of the recurrence above: dt, u ``(B, S, D)``; a ``(D,
    N)`` (the negative A); bmat, cmat ``(B, S, N)``."""
    b, s, d = dt.shape
    n = a.shape[1]
    pad = (-s) % CHUNK
    if pad:  # padded steps decay by exp(0) and add nothing
        dt, u = F.pad(dt, (0, 0, 0, pad)), F.pad(u, (0, 0, 0, pad))
        bmat, cmat = F.pad(bmat, (0, 0, 0, pad)), F.pad(cmat, (0, 0, 0, pad))
    sp = s + pad
    chunks = sp // CHUNK
    ys = []
    width = max(1, min(d, BLOCK_ELEMENTS // (b * sp * n)))
    cm = cmat.reshape(b, chunks, CHUNK, n)
    for lo in range(0, d, width):
        hi = min(d, lo + width)
        decay = torch.exp(dt[..., lo:hi, None] * a[lo:hi]).reshape(b, chunks, CHUNK, hi - lo, n)
        push = ((dt[..., lo:hi] * u[..., lo:hi])[..., None] * bmat[:, :, None, :]).reshape(b, chunks, CHUNK,
                                                                                          hi - lo, n)
        state = torch.zeros((b, chunks, hi - lo, n), dtype=torch.float32, device=dt.device)
        prod = torch.ones_like(state)
        states, prods = [], []
        for t in range(CHUNK):  # within every chunk at once, from a zero state
            state = decay[:, :, t] * state + push[:, :, t]
            prod = prod * decay[:, :, t]
            states.append(state)
            prods.append(prod)
        del decay, push
        states, prods = torch.stack(states, dim=2), torch.stack(prods, dim=2)
        carry = torch.zeros((b, hi - lo, n), dtype=torch.float32, device=dt.device)
        carried = []
        for c in range(chunks):  # the state entering each chunk
            carried.append(carry)
            carry = prods[:, c, -1] * carry + states[:, c, -1]
        states = states + prods * torch.stack(carried, dim=1)[:, :, None]
        del prods
        ys.append(torch.einsum("bctdn,bctn->bctd", states, cm).reshape(b, sp, hi - lo))
        del states
    return torch.cat(ys, dim=-1)[:, :s]


def layer(m: dict, p: dict, x: torch.Tensor, eps: float, precision: str) -> torch.Tensor:
    """One layer on the float32 residual stream ``x (B, S, d)``; ``p``'s
    tensors are float32."""
    d = x.shape[-1]
    di, n = m.get("ssm_expand", 2) * d, m["ssm_state"]
    r = m.get("dt_rank") or math.ceil(d / 16)
    k = p["mixer.conv_w"].shape[0]
    xz = mm(rms_norm(x, p["norm.scale"], eps), p["mixer.in_proj"], precision)
    xi, z = xz[..., :di], xz[..., di:]
    padded = F.pad(xi, (0, 0, k - 1, 0))
    conv = sum(padded[:, i: i + xi.shape[1]] * p["mixer.conv_w"][i] for i in range(k)) + p["mixer.conv_b"]
    xa = F.silu(conv)
    proj = mm(xa, p["mixer.x_proj"], precision)
    dt = softplus(mm(proj[..., :r], p["mixer.dt_proj"], precision) + p["mixer.dt_bias"])
    y = scan(dt, -torch.exp(p["mixer.A_log"]), proj[..., r:r + n], proj[..., r + n:], xa)
    y = (y + p["mixer.D"] * xa) * F.silu(z)
    return x + mm(y, p["mixer.out_proj"], precision)
