"""Plain attention (counterpart of the ``dot_product_attention`` of
``deeplearning4j_tpu/parallel/longseq.py``). Blockwise and ring
attention are ROADMAP.md queue A, item 14b."""
from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def dot_product_attention(q, k, v, mask=None, causal: bool = False):
    """Plain attention over q/k/v ``[B, T, H, D]``, computed in f32.
    ``mask``: boolean, broadcastable to [B, H, Tq, Tk], True = keep."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        cm = (torch.arange(Tk, device=q.device)[None, :]
              <= torch.arange(Tq, device=q.device)[:, None])
        s = torch.where(cm[None, None], s, _NEG_INF)
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
