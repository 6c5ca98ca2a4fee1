"""Plain PyTorch version of single-token decode attention (mirror of
``repro/kernels/decode_attention/ref.py:decode_attention_ref``). The CPU
path of the wrapper, and the oracle the CUDA kernel is held against on the
card."""
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
