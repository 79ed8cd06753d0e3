"""Plain PyTorch attention: the yardsticks of the CUDA flash-attention kernel.

The same three functions as :mod:`repro.kernels.flash_attention.ref`, in the
same layouts (q ``(B, S, H, D)``, k / v ``(B, Sk, KV, D)``, ``H = KV * G``):

  * :func:`naive_attention` materializes the full score matrix (the oracle
    of small tests);
  * :func:`block_attention` is the flash-style online softmax over (q-block,
    kv-block) tiles with Python loops, skipping tiles that are fully masked;
    it is what the CPU runs and what ``impl="plain"`` runs on the card;
  * :func:`decode_attention` is one query token against a KV cache.  It has
    no kernel in the JAX package either, so it stays plain on the card.

Beside them, :func:`attention_backward` is the gradient of the attention
written out from its output ``O``, its log-sum-exp (``block_attention(...,
return_lse=True)``) and ``dO``, as the backward kernel computes it: the
yardstick that kernel is held to.  The JAX package has no such function (it
differentiates its plain reference).

Masked scores are set to ``NEG_INF = -1e30`` (finite), as in the JAX package,
so a row whose keys are all masked inside a tile gets equal weights there.
Every function computes in float32 and returns q's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _split_heads(q, n_kv):
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Full-score oracle.  ``q_offset``: absolute position of ``q[:, 0]``."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    qg = _split_heads(q, kv).float()
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _tile_visible(qi, kj, q_block, kv_block, causal, window, q_offset):
    """Is tile (qi, kj) at least partially unmasked?

    The window test takes the tile's first query row, as the TPU kernel's
    does (``k_hi > q_lo - window``): a tile is skipped only when no row of it
    sees a key there.  (:func:`repro.kernels.flash_attention.ref.block_attention`
    tests the last row, ``k_hi <= q_hi - window``, and so drops keys that the
    first rows of a tile see; the port follows the kernel and
    :func:`naive_attention`.)
    """
    q_lo, q_hi = qi * q_block + q_offset, (qi + 1) * q_block - 1 + q_offset
    k_lo, k_hi = kj * kv_block, (kj + 1) * kv_block - 1
    if causal and k_lo > q_hi:
        return False
    if window and k_hi <= q_lo - window:
        return False
    return True


def block_attention(q, k, v, *, causal=True, window=0, q_block=1024, kv_block=1024, q_offset=0, kv_valid=None,
                    return_lse=False):
    """Flash-style tiled attention with Python tile loops.

    A length that is not a multiple of its block is padded up to one, the
    padded keys masked (``kv_valid``: the number of real keys) and the padded
    query rows cut off.  With ``return_lse`` it returns ``(out, lse)``: ``lse``
    ``(B, H, Sq)`` float32 is each row's ``m + log l`` over its scaled scores
    (natural log; ``l`` clamped to 1e-37 as the output's divisor is).
    """
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    q_block, kv_block = min(q_block, sq), min(kv_block, sk)
    if sq % q_block or sk % kv_block:
        pad_q, pad_k = (-sq) % q_block, (-sk) % kv_block
        out = block_attention(
            F.pad(q, (0, 0, 0, 0, 0, pad_q)), F.pad(k, (0, 0, 0, 0, 0, pad_k)), F.pad(v, (0, 0, 0, 0, 0, pad_k)),
            causal=causal, window=window, q_block=q_block, kv_block=kv_block, q_offset=q_offset, kv_valid=sk,
            return_lse=return_lse,
        )
        return (out[0][:, :sq], out[1][:, :, :sq]) if return_lse else out[:, :sq]
    nq, nk = sq // q_block, sk // kv_block
    g = h // n_kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for qi in range(nq):
        qb = q[:, qi * q_block : (qi + 1) * q_block].float().reshape(b, q_block, n_kv, g, d)
        m = torch.full((b, q_block, n_kv, g), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, q_block, n_kv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, q_block, n_kv, g, d), dtype=torch.float32, device=dev)
        q_pos = torch.arange(q_block, device=dev) + qi * q_block + q_offset
        for kj in range(nk):
            if not _tile_visible(qi, kj, q_block, kv_block, causal, window, q_offset):
                continue
            kb = kf[:, kj * kv_block : (kj + 1) * kv_block]
            vb = vf[:, kj * kv_block : (kj + 1) * kv_block]
            s = torch.einsum("bqkgd,bckd->bqkgc", qb, kb) * scale
            k_pos = torch.arange(kv_block, device=dev) + kj * kv_block
            mask = torch.ones((q_block, kv_block), dtype=torch.bool, device=dev)
            if kv_valid is not None:
                mask &= (k_pos < kv_valid)[None, :]
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-37)[..., None]
        outs.append(out.reshape(b, q_block, h, d))
        lses.append((m + torch.log(torch.clamp_min(l, 1e-37))).reshape(b, q_block, h))
    out = torch.cat(outs, dim=1).to(q.dtype)
    if return_lse:
        return out, torch.cat(lses, dim=1).permute(0, 2, 1).contiguous()
    return out


def attention_backward(q, k, v, o, lse, do, *, causal=True, window=0, q_offset=0, q_block=1024, kv_block=1024):
    """``(dq, dk, dv)`` of the attention, in q's dtype, from its output ``o``,
    its ``lse`` ``(B, H, Sq)`` and the output's gradient ``do``, in float32.

    Over (q block, kv block) tiles, skipping those no row sees:
    ``P = exp(S - lse)`` with ``S = q k^T / sqrt(D)`` (masked entries 0),
    ``D_i = rowsum(do * o)``, ``dV += P^T dO``, ``dS = P * (dO V^T - D_i)``,
    ``dQ += dS K / sqrt(D)``, ``dK += dS^T Q / sqrt(D)``; a kv head's ``dK`` and
    ``dV`` sum over its G query heads.  Equal to the gradient of
    :func:`block_attention` for every row that sees a key; a row that sees
    none (a window with ``q_offset`` past the keys' end) gets no gradient here,
    and the kernel's dispatch leaves such calls to the plain recompute.
    """
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    g = h // n_kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf, dof = (x.float().reshape(b, sq, n_kv, g, d) for x in (q, do))
    delta = (dof * o.float().reshape(b, sq, n_kv, g, d)).sum(dim=-1)
    lse_r = lse.float().permute(0, 2, 1).reshape(b, sq, n_kv, g)
    kf, vf = k.float(), v.float()
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, sq, q_block):
        q1 = min(q0 + q_block, sq)
        q_pos = torch.arange(q0, q1, device=dev) + q_offset
        for k0 in range(0, sk, kv_block):
            k1 = min(k0 + kv_block, sk)
            if (causal and k0 > q1 - 1 + q_offset) or (window and k1 - 1 <= q0 + q_offset - window):
                continue
            k_pos = torch.arange(k0, k1, device=dev)
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            qb, dob, kb, vb = qf[:, q0:q1], dof[:, q0:q1], kf[:, k0:k1], vf[:, k0:k1]
            s = torch.einsum("bqkgd,bckd->bqkgc", qb, kb) * scale
            p = torch.where(mask[None, :, None, None, :], torch.exp(s - lse_r[:, q0:q1, ..., None]), 0.0)
            dv[:, k0:k1] += torch.einsum("bqkgc,bqkgd->bckd", p, dob)
            dp = torch.einsum("bqkgd,bckd->bqkgc", dob, vb)
            ds = p * (dp - delta[:, q0:q1, ..., None])
            dq[:, q0:q1] += torch.einsum("bqkgc,bckd->bqkgd", ds, kb) * scale
            dk[:, k0:k1] += torch.einsum("bqkgc,bqkgd->bckd", ds, qb) * scale
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len: int, *, window=0):
    """One query token ``q (B, 1, H, D)`` against a ``(B, S_max, KV, D)`` cache.

    ``cur_len`` is the length after the append (the query sits at position
    ``cur_len - 1``); slots ``>= cur_len`` and, with a window, ``< cur_len -
    window`` are masked.
    """
    b, one, h, d = q.shape
    if one != 1:
        raise ValueError(f"decode_attention takes one query token, got {one}")
    _, s_max, n_kv, _ = k_cache.shape
    g = h // n_kv
    qg = q.reshape(b, n_kv, g, d).float()
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) * scale
    pos = torch.arange(s_max, device=q.device)
    mask = pos < cur_len
    if window:
        mask &= pos >= cur_len - window
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)
