"""Plain PyTorch version of the WKV6 chunked scan.

The counterpart of ``repro/kernels/wkv6/ref.py``: the CPU path runs it, the
tests hold it against the reference, and ``chip_smoke.py`` holds the CUDA
kernel (``csrc/wkv6.cu``) against it on the card. All arithmetic is
float32, with the reference's ``clip(-60, 0)`` on every exponent of the
intra-chunk decay and its strict-lower mask (s < t).
"""

from __future__ import annotations

from typing import Tuple

import torch


def wkv6(r, k, v, w, u, state, *, chunk: int = 32
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,w: (B,S,H,K); v: (B,S,H,V); u: (H,K); state: (B,H,K,V).

    w is the pre-decay parameter: decay = exp(-exp(w)).
    Returns (y (B,S,H,V) f32, state_out (B,H,K,V) f32).
    """
    B, S, H, K = r.shape
    V = v.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    n = S // chunk
    f32 = torch.float32

    def resh(x):  # (B,S,H,*) -> (n, B, chunk, H, *)
        return x.reshape(B, n, chunk, H, x.shape[-1]).movedim(1, 0).to(f32)

    rc, kc, vc, wc = map(resh, (r, k, v, w))
    uf = u.to(f32)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=r.device), -1)
    S_in = state.to(f32)
    ys = []
    for i in range(n):
        rr, kk, vv, ww = rc[i], kc[i], vc[i], wc[i]
        logw = -torch.exp(ww)
        Li = torch.cumsum(logw, dim=1)  # inclusive
        Le = Li - logw  # exclusive
        A = torch.exp(torch.clamp(Le[:, :, None] - Li[:, None, :], -60.0, 0.0))
        A = torch.where(mask[None, :, :, None, None], A, 0.0)  # (B,t,s,H,K)
        tmp = torch.einsum("bthk,btshk,bshk->btsh", rr, A, kk)
        y = torch.einsum("btsh,bshv->bthv", tmp, vv)
        y = y + torch.einsum("bthk,hk,bthk,bthv->bthv", rr, uf, kk, vv)
        y = y + torch.einsum("bthk,bthk,bhkv->bthv", rr, torch.exp(Le), S_in)
        decay_all = torch.exp(Li[:, -1])  # (B,H,K)
        kd = kk * torch.exp(Li[:, -1, None] - Li)
        S_in = decay_all[..., None] * S_in + torch.einsum("bshk,bshv->bhkv",
                                                          kd, vv)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, V), S_in
