"""Plain PyTorch version of the flash attention forward (GQA, causal,
sliding window, softcap).

The counterpart of ``repro/kernels/flash_attention/ref.py``: the CPU path
runs it, the tests hold it against the reference, and ``chip_smoke.py``
holds the CUDA kernel (``csrc/flash_attention.cu``) against it on the
card. Scores, softmax and the product with v are float32; masked scores
take the reference's finite sentinel, so a row is never all ``-inf``.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B,Sq,Hq,D); k,v: (B,Skv,Hkv,D); Hq % Hkv == 0. Returns (B,Sq,Hq,D)
    in q's dtype. The causal mask is top-left aligned: query i sees keys
    0..i, whatever Skv is."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    f32 = torch.float32
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(f32), k.to(f32))
    s = s / math.sqrt(D)  # a Python scalar: no host-to-device copy
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window > 0:
        m &= kpos > (qpos - window)
    s = torch.where(m[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(f32))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)

