"""Plain PyTorch version of the Mamba2 SSD chunked scan.

The counterpart of ``repro/kernels/ssd/ref.py``: the CPU path runs it, the
tests hold it against the reference, and ``chip_smoke.py`` holds the CUDA
kernel (``csrc/ssd.cu``) against it on the card. All arithmetic is
float32, with the reference's ``clip(-60, 0)`` on every exponent of the
intra-chunk decay and its lower mask (s <= t).
"""

from __future__ import annotations

from typing import Tuple

import torch


def ssd(x, dt, B, C, A_log, D, state, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b,S,H,P); dt: (b,S,H); B,C: (b,S,N); state: (b,H,P,N) f32.

    Returns (y (b,S,H,P) f32, state_out (b,H,P,N) f32).
    """
    b, S, H, P = x.shape
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")
    n = S // chunk
    f32 = torch.float32
    A = -torch.exp(A_log.to(f32))

    def resh(z):  # (b,S,*) -> (n, b, chunk, *)
        return z.reshape(b, n, chunk, *z.shape[2:]).movedim(1, 0).to(f32)

    xc, dtc, Bc, Cc = map(resh, (x, dt, B, C))
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    h = state.to(f32)
    ys = []
    for i in range(n):
        xx, dd, BB, CC = xc[i], dtc[i], Bc[i], Cc[i]
        la = dd * A[None, None, :]
        Li = torch.cumsum(la, dim=1)
        cb = torch.einsum("btn,bsn->bts", CC, BB)
        G = torch.exp(torch.clamp(Li[:, :, None, :] - Li[:, None, :, :],
                                  -60.0, 0.0))
        M = cb[..., None] * G * dd[:, None, :, :]
        M = torch.where(mask[None, :, :, None], M, 0.0)
        y = torch.einsum("btsh,bshp->bthp", M, xx)
        y = y + torch.einsum("btn,bhpn,bth->bthp", CC, h, torch.exp(Li))
        decay_all = torch.exp(Li[:, -1])
        wgt = torch.exp(Li[:, -1, None] - Li) * dd
        h = decay_all[:, :, None, None] * h + torch.einsum(
            "bth,bthp,btn->bhpn", wgt, xx, BB)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, S, H, P)
    y = y + x.to(f32) * D.to(f32)[None, None, :, None]
    return y, h
