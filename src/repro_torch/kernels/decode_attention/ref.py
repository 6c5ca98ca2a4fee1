"""Plain PyTorch versions of decode attention: single-token against a
contiguous cache or a page pool, and multi-token (speculative verify)
against a page pool (mirrors of ``repro/kernels/decode_attention/ref.py``).
The CPU path of the wrappers, and the oracles the CUDA kernels are held
against on the card."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """q (B,H,hd); k/v (B,W,K,hd); bias (B,W) additive slot mask.
    Returns (B,H,hd) in q's dtype. fp32 softmax over the cache axis."""
    B, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    scores = torch.einsum("bkgh,bwkh->bkgw", qg, k.float())
    scores = scores / math.sqrt(float(hd)) + bias[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgw,bwkh->bkgh", probs, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               page_table: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """Gather each row's pages into the contiguous (B, W, K, hd) layout,
    then run the dense version. q (B,H,hd); k_pool/v_pool (P, page, K, hd);
    page_table (B, n) int; bias (B, n*page)."""
    B = q.shape[0]
    n, page = page_table.shape[1], k_pool.shape[1]
    idx = page_table.long()
    k = k_pool[idx].reshape(B, n * page, *k_pool.shape[2:])
    v = v_pool[idx].reshape(B, n * page, *v_pool.shape[2:])
    return decode_attention_ref(q, k, v, bias)


def paged_verify_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               page_table: torch.Tensor,
                               bias: torch.Tensor) -> torch.Tensor:
    """Gather each row's pages into the contiguous layout, then dense
    grouped attention with a per-query additive bias, in float32.
    q (B,C,H,hd); k_pool/v_pool (P, page, K, hd); page_table (B, n) int;
    bias (B, C, n*page). Returns (B, C, H, hd) in q's dtype."""
    B, C, H, hd = q.shape
    n, page = page_table.shape[1], k_pool.shape[1]
    K = k_pool.shape[2]
    G = H // K
    idx = page_table.long()
    k = k_pool[idx].reshape(B, n * page, K, hd)
    v = v_pool[idx].reshape(B, n * page, K, hd)
    qg = q.reshape(B, C, K, G, hd).float()
    scores = torch.einsum("bckgh,bwkh->bkgcw", qg, k.float())
    scores = scores / math.sqrt(float(hd)) + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcw,bwkh->bckgh", probs, v.float())
    return out.reshape(B, C, H, hd).to(q.dtype)
