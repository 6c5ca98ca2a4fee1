"""Plain PyTorch version of blocked GQA flash attention (mirror of
``repro/kernels/flash_attention/ref.py``). The CPU path of the wrapper,
and the oracle the CUDA kernel is held against on the card."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,T,K,hd) with H % K == 0. Softmax in float32
    with the finite NEG_INF, probabilities kept in float32 through P.V,
    one rounding of the output to q's dtype."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    scores = scores / math.sqrt(float(hd))
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= j > i - window
    scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)
