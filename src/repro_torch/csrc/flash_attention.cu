// Flash attention forward: online-softmax attention with GQA, a causal
// mask aligned top-left, a sliding window and a logit softcap.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention_fwd, the
// Pallas TPU kernel (grid (B, Hq, Sq/256, Skv/256) with the kv axis
// sequential and (m, l, acc) in VMEM scratch; fully masked blocks skipped).
// Host API: repro_torch/kernels/flash_attention/ops.py. For each query row
// i of head h (kv head h / (Hq / Hkv)), over the admissible keys j:
//
//   s_ij = q_i . k_j / sqrt(D);  s_ij = c tanh(s_ij / c) if c > 0
//   admissible: j <= i if causal (top-left: row i sees keys 0..i whatever
//   Skv is), and j > i - window if window > 0; else s_ij = -1e30
//   o_i  = sum_j softmax_j(s_i) v_j, in float32, written in q's dtype
//
// What bounds it on an H100: at the serve's shape (B=4, S=1024, Hq=Hkv=32,
// D=112, causal, bf16) it moves 117 MB (q, k, v and o once each), 0.035 ms
// at 3.35 TB/s, and does 30.1 GFLOP in the products of the causal half,
// 0.030 ms at the tensor cores' bf16 rate: the bytes bound it, as long as
// the products run on the tensor cores.
//
// bf16 inputs (the serve) take flash_fwd_bf16_kernel, FlashAttention-2's
// form on the tensor cores. One block of 8 warps per (query tile of 128
// rows, head, batch); each warp owns 16 query rows. The q tile and two
// stages of key and value tiles of 64 stay bf16 in shared memory:
// cp.async brings tile j+1 while tile j computes. Rows are padded by 16
// bytes, so ldmatrix reads them without bank conflicts (at D = 112 a row
// is 224 + 16 bytes). S = q k^T and o += p v are mma.sync.m16n8k16 (bf16
// in, float32 accumulate), the q and k fragments by ldmatrix, v's by
// ldmatrix.trans. The online softmax runs in registers: each row's max
// and sum over the 4 threads that share it, the scale folded into exp2f;
// p becomes bf16 in registers and is the A operand of p v directly. Only
// tiles on the causal diagonal, the window's edge or past Skv pay the
// per-element mask, and the longest causal query tiles start first. D is
// zero-padded to a multiple of 16 in shared memory and dispatched to a
// template on the padded width, so the accumulators (D / 2 floats a
// thread) stay in registers. Each warp reads its q fragments again at
// every key tile rather than holding them: that keeps a thread at 128
// registers up to D = 112, so two blocks (16 warps, 92,160 bytes each at
// D = 112) run on an SM; at D = 128 the accumulators need more, and one
// block runs on an SM rather than spill. Copy loops step their indices
// without a division a chunk.
// Precision: q, k, v are bf16 already, so S is exact to float32
// accumulation; p is rounded to bf16 once before p v, which keeps the
// output within a quarter of the bf16 tolerance (2e-2 + 2e-2 |ref|;
// tests/test_torch_flash_attention.py emulates it).
//
// float32 inputs take flash_fwd_kernel, the CUDA-core form: the
// tolerance there is 2e-5, which no single TF32 or bf16 pass holds. One
// block of 256 threads per (query tile of 64 rows, head, batch) holds q
// transposed in shared memory and walks the key tiles of 64; each thread
// forms a 4x4 register tile of scores (4 rows, 4 keys 16 apart), takes
// the rows' maxima and sums with warp shuffles, and adds p v through
// shared memory (106 KB a block at D = 112, two an SM).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // the float32 kernel's block
constexpr int kMmaWarps = 8;  // the bf16 kernel's block: 16 rows a warp
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int BQM = 16 * kMmaWarps;  // its query rows
constexpr int BQ = 64;        // query rows of a float32 block
constexpr int BKV = 64;       // keys of a tile
constexpr int QS = BQ + 4;    // row stride of q^T and p^T (16-byte rows)
constexpr int KS = BKV + 1;   // row stride of k^T
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;  // the reference's masked score
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;  // what one H100 block may have

// Offset in floats of p^T in shared memory, rounded up to 16 bytes for
// its float4 rows, and the floats of dynamic shared memory for one block
// of the float32 kernel (kernels/flash_attention/kernel.py's smem_bytes
// computes the same).
__host__ __device__ __forceinline__ int p_offset(int D) {
  return (D * QS + D * KS + BKV * D + 3) / 4 * 4;
}
size_t smem_floats(int D) {
  return static_cast<size_t>(p_offset(D)) + static_cast<size_t>(BKV) * QS;
}

// Bytes of dynamic shared memory for one block of the bf16 kernel at a
// padded width DP: the q tile and two stages of a key and a value tile,
// rows of DP + 8.
size_t bf16_smem_bytes(int DP) {
  return (BQM + 4ull * BKV) * (DP + 8) * sizeof(bf16);
}

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
                 int Hq, int Hkv, int D, int causal, int window, float scale,
                 float softcap) {
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows r0 .. r0+3
  const int cg = tid % 16;  // keys and output columns cg + 16 j
  const int r0 = rg * 4;
  const int nj = (D + 15) / 16;

  extern __shared__ __align__(16) float smem[];
  float* qT = smem;            // D x QS: q[r][d] at qT[d][r]
  float* kT = qT + D * QS;     // D x KS: k[c][d] at kT[d][c]
  float* vs = kT + D * KS;     // BKV x D
  float* pT = smem + p_offset(D);  // BKV x QS: p[r][c] at pT[c][r]

  const size_t qrow = static_cast<size_t>(Hq) * D;   // token stride of q, o
  const size_t kvrow = static_cast<size_t>(Hkv) * D;  // token stride of k, v
  const float* qb = q + static_cast<size_t>(b) * Sq * qrow + static_cast<size_t>(h) * D;
  const float* kb = k + static_cast<size_t>(b) * Skv * kvrow + static_cast<size_t>(hk) * D;
  const float* vb = v + static_cast<size_t>(b) * Skv * kvrow + static_cast<size_t>(hk) * D;
  float* ob = o + static_cast<size_t>(b) * Sq * qrow + static_cast<size_t>(h) * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qpos = q_start + r;
    qT[d * QS + r] = qpos < Sq ? (qb[qpos * qrow + d]) : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int kv_start = 0; kv_start < Skv; kv_start += BKV) {
    // the Pallas kernel's skip of wholly masked blocks (kernel.py:46-52)
    if (causal && kv_start > q_start + BQ - 1) break;
    if (window > 0 && kv_start + BKV - 1 <= q_start - window) continue;
    __syncthreads();  // the last tile's readers are done (and q is in)
    for (int i = tid; i < BKV * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int kpos = kv_start + c;
      const bool in = kpos < Skv;
      kT[d * KS + c] = in ? (kb[kpos * kvrow + d]) : 0.f;
      vs[c * D + d] = in ? (vb[kpos * kvrow + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qT + d * QS + r0);
      const float* kr = kT + d * KS + cg;
      const float kv[4] = {kr[0], kr[16], kr[32], kr[48]};
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kv_start + cg + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        // a key past the end weighs nothing; a masked one takes the
        // reference's finite sentinel
        x = kpos >= Skv ? -INFINITY : (ok ? x : kNegInf);
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pT + (cg + 16 * j) * QS + r0) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    for (int c = 0; c < BKV; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(pT + c * QS + r0);
      const float* vr = vs + c * D + cg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nj && cg + 16 * j < D) {
          const float x = vr[16 * j];
          acc[0][j] += pv.x * x;
          acc[1][j] += pv.y * x;
          acc[2][j] += pv.z * x;
          acc[3][j] += pv.w * x;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_start + r0 + i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = cg + 16 * j;
      if (j < nj && d < D) ob[qpos * qrow + d] = acc[i][j] * inv;
    }
  }
}

// Rows [row0, row0 + ROWS) of a (rows, D) slab with a row stride of ld
// elements into shared memory (row stride DP + 8); rows at or past
// nrows are zeros. 16-byte cp.async where rows are whole 16-byte units,
// plain loads otherwise (the __syncthreads before the tile's use covers
// both).
template <int DP, int ROWS = BKV>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t ld, int row0, int nrows,
                                          int D) {
  constexpr int S = DP + 8;
  if (D % 8 == 0) {
    mma::for_each_rc<kMmaThreads>(ROWS, D / 8, [&](int r, int c) {
      const bool in = row0 + r < nrows;
      const bf16* from = in ? src + static_cast<size_t>(row0 + r) * ld + 8 * c : src;
      mma::cp_async16(dst + r * S + 8 * c, from, in ? 16 : 0);
    });
  } else {
    mma::for_each_rc<kMmaThreads>(ROWS, D, [&](int r, int c) {
      dst[r * S + c] = row0 + r < nrows
                           ? src[static_cast<size_t>(row0 + r) * ld + c]
                           : __float2bfloat16(0.f);
    });
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads, DP <= 112 ? 2 : 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                      int window, float scale, float softcap) {
  constexpr int S = DP + 8;   // shared-memory row stride, elements
  constexpr int KD = DP / 16;  // k-steps of q k^T
  constexpr int ND = DP / 8;   // n-tiles of o
  // the longest causal rows first, so that the short ones fill the tail
  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);  // BQM rows
  // stage i: its key tile at kst(i), its value tile at kst(i) + BKV * S
  auto kst = [&](int i) { return qs + BQM * S + i * 2 * BKV * S; };

  const size_t qrow = static_cast<size_t>(Hq) * D;
  const size_t kvrow = static_cast<size_t>(Hkv) * D;
  const bf16* qb = q + static_cast<size_t>(b) * Sq * qrow + static_cast<size_t>(h) * D;
  const bf16* kb = k + static_cast<size_t>(b) * Skv * kvrow + static_cast<size_t>(hk) * D;
  const bf16* vb = v + static_cast<size_t>(b) * Skv * kvrow + static_cast<size_t>(hk) * D;
  bf16* ob = o + static_cast<size_t>(b) * Sq * qrow + static_cast<size_t>(h) * D;

  if (D != DP) {  // the padded columns stay zero: no copy writes them
    uint4* p = reinterpret_cast<uint4*>(smem_raw);
    for (int i = threadIdx.x; i < (BQM + 4 * BKV) * S / 8; i += kMmaThreads)
      p[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  // the key tiles that the causal mask and the window leave partly open
  // (the Pallas kernel's skip of wholly masked blocks, kernel.py:46-52)
  int t_lo = 0, t_hi = (Skv + BKV - 1) / BKV;
  if (causal) t_hi = min(t_hi, (q_start + BQM - 1) / BKV + 1);
  if (window > 0) {
    const int last_closed = q_start - window - (BKV - 1);
    t_lo = last_closed < 0 ? 0 : last_closed / BKV + 1;
  }

  load_rows<DP, BQM>(qs, qb, qrow, q_start, Sq, D);
  if (t_lo < t_hi) {
    load_rows<DP>(kst(0), kb, kvrow, t_lo * BKV, Skv, D);
    load_rows<DP>(kst(0) + BKV * S, vb, kvrow, t_lo * BKV, Skv, D);
  }
  mma::cp_commit();

  const bf16* qw = qs + warp * 16 * S;  // this warp's 16 rows
  const int row0 = q_start + warp * 16 + g;  // this thread's rows
  const int row1 = row0 + 8;
  float m0 = kNegInf * kLog2e, m1 = kNegInf * kLog2e;  // running max, log2
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the running sums
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      load_rows<DP>(kst(st ^ 1), kb, kvrow, (t + 1) * BKV, Skv, D);
      load_rows<DP>(kst(st ^ 1) + BKV * S, vb, kvrow, (t + 1) * BKV, Skv, D);
      mma::cp_commit();
      mma::cp_wait<1>();
    } else {
      mma::cp_wait<0>();
    }
    __syncthreads();
    const int kv0 = t * BKV;

    // s = q k^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* ks = kst(st);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      mma::ldsm_x4(a, qw + (lane & 15) * S + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        mma::ldsm_x4(r, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * np], a, r[0], r[1]);
        mma::mma_bf16(s[2 * np + 1], a, r[2], r[3]);
      }
    }

    // scale, softcap, mask (only where the tile needs it), in log2 units
    const bool masked = kv0 + BKV > Skv ||
                        (causal && kv0 + BKV - 1 > q_start) ||
                        (window > 0 && kv0 <= q_start + BQM - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (masked) {
          const int kpos = kv0 + j * 8 + 2 * qd + (e & 1);
          const int qpos = e < 2 ? row0 : row1;
          bool ok = true;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          // a key past the end weighs nothing; a masked one takes the
          // reference's finite sentinel
          x = kpos >= Skv ? -INFINITY : (ok ? x : kNegInf);
        }
        s[j][e] = x * kLog2e;
      }
    }

    // the online softmax, rows g and g + 8 over the quad that shares them
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // o += p v: p from the score registers as bf16 A fragments, v by
    // transposed ldmatrix
    const bf16* vs = kst(st) + BKV * S;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < KD; ++dp) {
        uint32_t r[4];
        mma::ldsm_x4_t(r, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                              dp * 16 + (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * dp], a, r[0], r[1]);
        mma::mma_bf16(acc[2 * dp + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = j * 8 + 2 * qd;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = half ? row1 : row0;
      const float inv = half ? inv1 : inv0;
      if (qpos >= Sq) continue;
      bf16* out = ob + qpos * qrow + d;
      const float x0 = acc[j][2 * half] * inv, x1 = acc[j][2 * half + 1] * inv;
      if (d + 1 < D && D % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < D) out[0] = __float2bfloat16(x0);
        if (d + 1 < D) out[1] = __float2bfloat16(x1);
      }
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int Hq, int Hkv, int D, int causal,
               int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, Hq,
      Hkv, D, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                int window, float softcap, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQM - 1) / BQM, Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_bf16_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, Hq, Hkv,
      D, causal, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); o: (B, Sq, Hq, D), written; all
// float32 (is_bf16 = 0) or all bfloat16 (is_bf16 = 1), contiguous on the
// current device. Hq a multiple of Hkv, 1 <= D <= 128, B and Hq at most
// 65535. causal: 0 or 1; window: 0 for none; softcap: 0 for none. Launches
// once on `stream`, does not synchronise, and returns a CUDA error code
// (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int Hq, int Hkv, int D,
                                      int causal, int window, float softcap,
                                      int is_bf16, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      D < 1 || D > kMaxD || B > 65535 || Hq > 65535 || window < 0 ||
      !(softcap >= 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    return launch_f32(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window,
                      softcap, st);
  }
  switch ((D + 15) / 16) {  // the width padded to the MMA's k of 16
#define FLASH_BF16(n)                                                       \
  case n:                                                                   \
    return launch_bf16<16 * n>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, \
                               window, softcap, st);
    FLASH_BF16(1) FLASH_BF16(2) FLASH_BF16(3) FLASH_BF16(4)
    FLASH_BF16(5) FLASH_BF16(6) FLASH_BF16(7) FLASH_BF16(8)
#undef FLASH_BF16
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
