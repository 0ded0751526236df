"""The port's flash attention forward against the reference on the CPU.

The same seeded numpy inputs go through ``repro``'s Pallas kernel in
interpret mode and the port's ``ops.flash_attention`` (on CPU tensors: the
plain version), at the reference's sweep of shapes and a softcap case,
within the reference's own tolerances (2e-5 in float32, 2e-2 in bfloat16,
``tests/test_kernels.py``). The CUDA kernel itself is held against the
port's plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_attention import kernel as jax_kernel  # noqa: E402
from repro.kernels.flash_attention import ref as jax_ref  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CASES = [  # (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap)
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),
    (1, 512, 512, 8, 8, 128, True, 0, 0.0),
    (2, 256, 256, 4, 4, 64, False, 0, 0.0),
    (1, 512, 512, 4, 2, 64, True, 128, 0.0),
    (1, 256, 512, 4, 1, 64, False, 0, 0.0),  # Skv != Sq
    (1, 256, 256, 4, 2, 112, True, 0, 5.0),  # softcap, the serve's head_dim
]


def inputs(B, Sq, Skv, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return n(B, Sq, Hq, D), n(B, Skv, Hkv, D), n(B, Skv, Hkv, D)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,softcap", CASES)
def test_ops_matches_pallas_interpret(B, Sq, Skv, Hq, Hkv, D, causal, window,
                                      softcap, dtype):
    qkv = inputs(B, Sq, Skv, Hq, Hkv, D)
    # the same bf16 values on both sides: round once, then hand over
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in qkv)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), dtype) for t in (tq, tk, tv))
    out = ops.flash_attention(tq, tk, tv, causal, window, softcap)
    assert out.dtype == tq.dtype and out.shape == (B, Sq, Hq, D)
    want = jax_kernel.flash_attention_fwd(jq, jk, jv, causal=causal,
                                          window=window, softcap=softcap,
                                          interpret=True)
    close(out.float(), want, TOL[dtype])


def test_plain_version_matches_reference_ref():
    """Top-left causal with Skv != Sq, a window and a softcap at once."""
    qkv = inputs(2, 64, 96, 4, 2, 16, seed=1)
    out = ref.attention(*map(torch.from_numpy, qkv), causal=True, window=24,
                        softcap=3.0)
    want = jax_ref.attention(*map(jnp.asarray, qkv), causal=True, window=24,
                             softcap=3.0)
    close(out, want, TOL["float32"])


def test_kernel_path_on_cpu_tensors_raises():
    """``use_kernel=True`` on CPU tensors raises; the kernel wrapper never
    gives way to the plain version, and the count stays."""
    q, k, v = map(torch.from_numpy, inputs(1, 128, 128, 2, 2, 16))
    before = K.launches()
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, True, 0, 0.0, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_attention_fwd(q, k, v)
    assert K.launches() == before
    got = ops.flash_attention(q, k, v, True, 0, 0.0, use_kernel=False)
    assert torch.equal(got, ref.attention(q, k, v))


def test_kernel_path_refuses_inputs_that_require_grad():
    """Inputs that require grad now go through the kernel's autograd
    Function (its backward recomputes through the plain version): on CPU
    tensors the kernel path still refuses them, at the kernel, and never
    gives way to the plain version."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in inputs(1, 128, 128, 2, 2, 16))
    before = K.launches()
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, use_kernel=True)
    assert K.launches() == before


def test_kernel_shared_memory():
    """bf16: the q tile of 128 rows and two stages of a key and a value
    tile of 64, in bf16 with rows padded by 16 bytes: 90 KiB at D=112, so
    two blocks share an SM, as the design relies on. f32: q and k
    transposed, v and p in f32, 103 KiB, two blocks. Every D up to 128
    fits one block in both."""
    assert K.smem_bytes(112, 2) == (128 + 4 * 64) * 120 * 2 == 92160
    assert K.smem_bytes(112, 4) == 105664
    assert _build.blocks_per_sm(K.smem_bytes(112, 2)) == 2
    assert _build.blocks_per_sm(K.smem_bytes(128, 2)) == 2
    assert _build.blocks_per_sm(K.smem_bytes(112, 4)) == 2
    assert all(K.smem_bytes(d, e) <= K.SMEM_LIMIT
               for d in range(1, K.MAX_D + 1) for e in (2, 4))


@pytest.mark.parametrize("Sq,Skv", [(128, 128), (96, 96), (128, 48)])
def test_attention_auto_on_cpu_takes_the_dense_path(Sq, Skv, monkeypatch):
    """CPU tensors never reach the flash path, whether or not a flash block
    divides both lengths; the result is the reference's dense path."""
    def no_flash(*a, **kw):
        raise AssertionError("attention_auto took the flash path on the CPU")

    monkeypatch.setattr(attention.fa, "flash_attention", no_flash)
    q, k, v = inputs(1, Sq, Skv, 4, 2, 16, seed=3)
    out = attention.attention_auto(*map(torch.from_numpy, (q, k, v)),
                                   causal=True)
    want = jax_attention.attention_dense(*map(jnp.asarray, (q, k, v)),
                                         causal=True)
    close(out, want, TOL["float32"])


@pytest.mark.parametrize("window,q_chunk", [(0, 64), (64, 64), (0, 96)])
def test_attention_chunked_matches_reference(window, q_chunk):
    """The query-chunked path (the plain path from 2048 query tokens), with
    the window's kv slicing where window % q_chunk == 0, and its fallback to
    the dense path where q_chunk does not divide Sq."""
    q, k, v = inputs(1, 256, 256, 4, 2, 16, seed=4)
    out = attention.attention_chunked(*map(torch.from_numpy, (q, k, v)),
                                      causal=True, window=window,
                                      q_chunk=q_chunk)
    want = jax_attention.attention_chunked(*map(jnp.asarray, (q, k, v)),
                                           causal=True, window=window,
                                           q_chunk=q_chunk)
    close(out, want, TOL["float32"])


@pytest.mark.parametrize("window,pos", [(0, 40), (32, 40), (32, 20)])
def test_decode_attention_and_ring_layout_match_reference(window, pos):
    """One-token attention against a cache, full or a sliding-window ring
    buffer built by ring_layout from a prefill's kv."""
    rng = np.random.default_rng(5)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    kv_k, kv_v, q = n(2, pos, 2, 16), n(2, pos, 2, 16), n(2, 1, 4, 16)
    ck, cv = (attention.ring_layout(torch.from_numpy(a), window)
              for a in (kv_k, kv_v))
    jk, jv = (jax_attention.ring_layout(jnp.asarray(a), window)
              for a in (kv_k, kv_v))
    close(ck, jk, 0)
    out = attention.decode_attention(torch.from_numpy(q), ck, cv, pos - 1,
                                     window=window, softcap=2.0)
    want = jax_attention.decode_attention(jnp.asarray(q), jk, jv,
                                          jnp.int32(pos - 1), window=window,
                                          softcap=2.0)
    close(out, want, TOL["float32"])


def flash_tensor_core_emulation(q, k, v, *, causal, block=64):
    """csrc/flash_attention.cu's bf16 kernel in plain torch: bf16 q, k, v;
    q k^T exact into float32; the online softmax over key tiles of
    ``block`` in float32, p rounded to bf16 before p v, the row sums taken
    from the float32 p; the output rounded to bf16."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    f32 = torch.float32
    qf = q.float().transpose(1, 2)  # (B, Hq, Sq, D)
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
              for t in (k, v))
    m = torch.full((B, Hq, Sq, 1), -1e30, dtype=f32)
    l = torch.zeros((B, Hq, Sq, 1), dtype=f32)
    acc = torch.zeros((B, Hq, Sq, D), dtype=f32)
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, block):
        s = qf @ kf[:, :, k0:k0 + block].transpose(-1, -2) / D ** 0.5
        if causal:
            kpos = torch.arange(k0, min(k0 + block, Skv))[None, :]
            s = torch.where(kpos <= qpos, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + block]
        m = m_new
    return (acc / l).transpose(1, 2).to(torch.bfloat16)


def test_tensor_core_rounding_holds_the_bf16_tolerance():
    """The bf16 kernel's rounding, emulated at the smoke's causal GQA case
    at the serve's head_dim: within 2e-2 + 2e-2 |ref| of the plain
    version, the tolerance chip_smoke.py holds the kernel to, with most of
    it to spare."""
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in inputs(1, 512, 512, 4, 2, 112, seed=7))
    got = flash_tensor_core_emulation(tq, tk, tv, causal=True).float()
    want = ref.attention(tq, tk, tv, causal=True).float()
    tol = TOL["bfloat16"]
    share = ((got - want).abs() / (tol + tol * want.abs())).max().item()
    assert share <= 0.5, share
