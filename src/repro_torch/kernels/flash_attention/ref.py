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


def block_attention(q, k, v, *, causal=True, window=0, q_block=1024, kv_block=1024, q_offset=0, kv_valid=None):
    """Flash-style tiled attention with Python tile loops.

    A length that is not a multiple of its block is padded up to one, the
    padded keys masked (``kv_valid``: the number of real keys) and the padded
    query rows cut off.
    """
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    q_block, kv_block = min(q_block, sq), min(kv_block, sk)
    if sq % q_block or sk % kv_block:
        pad_q, pad_k = (-sq) % q_block, (-sk) % kv_block
        out = block_attention(
            F.pad(q, (0, 0, 0, 0, 0, pad_q)), F.pad(k, (0, 0, 0, 0, 0, pad_k)), F.pad(v, (0, 0, 0, 0, 0, pad_k)),
            causal=causal, window=window, q_block=q_block, kv_block=kv_block, q_offset=q_offset, kv_valid=sk,
        )
        return out[:, :sq]
    nq, nk = sq // q_block, sk // kv_block
    g = h // n_kv
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    kf, vf = k.float(), v.float()
    outs = []
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
    return torch.cat(outs, dim=1).to(q.dtype)


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
