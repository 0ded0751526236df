// RWKV6 chunked linear attention (WKV6), forward, with the (K,V) state
// carried across chunks.
//
// Replaces repro/kernels/wkv6/kernel.py:wkv6_chunked, the Pallas TPU kernel
// (grid (B, H, S/chunk) with the chunk axis sequential, the state in VMEM
// scratch, the decay tensor A (C, C, K) materialised in VMEM). Host API:
// repro_torch/kernels/wkv6/ops.py. For each (batch b, head h), walking the
// chunks of C tokens in order, with all arithmetic in float32:
//
//   logw = -exp(w);  Li = inclusive cumsum of logw over t;  Le = Li - logw
//   tmp[t,s] = sum_k r[t,k] k[s,k] exp(clip(Le[t,k] - Li[s,k], -60, 0)), s < t
//   y[t]     = sum_{s<t} tmp[t,s] v[s] + (sum_k r[t,k] u[k] k[t,k]) v[t]
//              + sum_k r[t,k] exp(Le[t,k]) S[k,:]
//   S        = exp(Li[C-1]) (.) S + sum_s (k[s] (.) exp(Li[C-1] - Li[s])) v[s]^T
//
// What bounds it on an H100: at the serve's shape (B=4, S=1024, H=64,
// K=V=64, C=32, bf16 in) it moves 210 MB (bf16 r, k, v, w in; f32 y and
// the state), 0.063 ms at 3.35 TB/s. Its four products (r k^T under the
// decays, tmp v, (r exp(Le)) S, kd^T v) are 5.4 GFLOP, 0.005 ms at the
// tensor cores' bf16 rate; the rest (the exponentials of the decays, the
// cumulative sums, the scaling) 1.6 GFLOP, 0.024 ms at the CUDA cores'
// 67 TFLOP/s (chip_smoke.py's wkv6_work). The bytes bound it.
//
// bf16 inputs (the serve) take wkv6_kernel_tc, on the tensor cores. One
// block of 8 warps per (b, h) walks the chunks; the next chunk's r, k, v,
// w load by cp.async into a second stage while this one computes. A chunk
// is cut into segments of 8 tokens (tmp's diagonal unit) and mma tiles of
// 16. Per chunk:
//   - a lane per (channel, segment) takes -exp(w) and its sum within the
//     segment; then, all segments' sums in shared memory, Li, Le and three
//     scaled copies of r and k, each split into bf16 high + remainder:
//     r exp(Le) (the state term), k exp(Li_last - Li) (the state update)
//     and k exp(Li_j - Li), j the last token of k's own segment (a warp
//     takes 32 channels of one segment, so that its lanes read and write
//     neighbouring words);
//   - tmp, s < t in one segment (the diagonal): one pair per two lanes,
//     the per-pair clipped difference as before, and the u bonus
//     sum_k r u k on tmp's diagonal, so that tmp v carries it;
//   - tmp, t after s's segment: factored about j, that segment's last token,
//       q[t,k] = r[t,k] exp(Le[t,k] - Li[j,k]),  k~[s,k] = k[s,k] exp(Li[j,k] - Li[s,k]),
//     both exponents <= 0 (Le_t <= Li_j <= Li_s), so nothing overflows
//     under any decay, and tmp = q k~^T runs on mma.sync, a warp per
//     (t-tile, s-segment) (exp(Le_t) and exp(-Li_s) over a whole chunk
//     would overflow under strong decay). Both exponents are clipped at 0
//     as the reference clips its one: Le_t - Li_{t-1} can round above 0,
//     and under strong decay exp of that rounding alone is the largest
//     difference from the reference;
//   - y = tmp v + (r exp(Le)) S and S = exp(Li_last) S + kd^T v on
//     mma.sync.m16n8k16, bf16 in, float32 accumulate. v is a bf16 input
//     and enters exactly. Every float32 operand (q, k~, tmp, r exp(Le),
//     the state, kd) is split into bf16 high + remainder: one bf16
//     rounding of each misses the 1e-4 tolerance twentyfold, the split
//     holds y and the state to about 5e-6 of their scale
//     (tests/test_torch_wkv6.py emulates both). A product of two split
//     operands takes three mma (hi hi, hi lo, lo hi), of one two. On the
//     card the cumulative sums, taken in another order than the plain
//     version's torch.cumsum, move y by about 1.3e-5 of its scale under
//     strong decay (chip_smoke.py's wkv6_kernel lines).
// Segments of 8 rather than tiles of 16 halve the per-pair exponentials
// (7,168 a chunk at C = 32 instead of 15,360; the factored q costs 4,096
// more); the diagonal pairs were the kernel's largest part. The state
// stays float32 in shared memory, transposed (V x K, rows padded by 8
// floats) and split on the fly. K, V and the chunk are zero-padded to
// multiples of 16; padded tokens get logw = 0, so every exponent stays
// <= 0. logw's exponential is the accurate expf, since its rounding adds
// up along the cumulative sum; the others, all of differences <= 0, are
// ex2.approx (exp_e). 107,056 bytes of shared memory a block at the
// serve's shape: two an SM.
//
// float32 inputs take wkv6_kernel, the CUDA-core form (so do bf16 shapes
// with K or V not a multiple of 8, whose rows cp.async cannot move in
// 16-byte pieces, or whose padded tiles would not fit a block). One block
// of 256 threads per (b, h) holds the 64x64 f32 state in shared memory
// and walks the chunks; one chunk's r, k, Li, Le (rows padded to K+1
// floats so that threads on neighbouring rows hit different banks), v,
// tmp and the state fit in 62.5 KB at C=32, K=V=64. A is never
// materialised (it would be 256 KB): each of the C(C-1)/2 pairs (t, s < t)
// is one thread's loop over k, which takes the difference Le - Li before
// the exponential, so every exponent stays <= 0 as the reference's clip
// keeps it. The products with v and S are plain loops over shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // what one H100 block may have

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Floats of dynamic shared memory for one block.
size_t smem_floats(int K, int V, int C) {
  const size_t KP = static_cast<size_t>(K) + 1;
  return 4 * C * KP + static_cast<size_t>(C) * V + static_cast<size_t>(C) * (C + 1) +
         static_cast<size_t>(K) * V + C + K;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sout,
            int S, int H, int K, int V, int C) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int KP = K + 1;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* sr = smem;                  // C x KP: r, then r * exp(Le)
  float* sk = sr + C * KP;           // C x KP: k, then k * exp(Li_last - Li)
  float* sLi = sk + C * KP;          // C x KP: inclusive cumsum of logw
  float* sLe = sLi + C * KP;         // C x KP: w, then Le
  float* sv = sLe + C * KP;          // C x V
  float* stmp = sv + C * V;          // C x (C+1): tmp[t][s], s < t
  float* sS = stmp + C * (C + 1);    // K x V: the state
  float* sd = sS + K * V;            // C: the diagonal bonus sum_k r u k
  float* su = sd + C;                // K

  const size_t state0 = static_cast<size_t>(bh) * K * V;
  for (int i = tid; i < K * V; i += kThreads) sS[i] = s0[state0 + i];
  for (int i = tid; i < K; i += kThreads) su[i] = u[static_cast<size_t>(h) * K + i];

  const size_t rowK = static_cast<size_t>(H) * K;  // token stride of r, k, w
  const size_t rowV = static_cast<size_t>(H) * V;  // token stride of v, y
  const int npairs = C * (C - 1) / 2;

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();  // the last chunk's readers are done
    const size_t tok0 = static_cast<size_t>(b) * S + c0;
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      const size_t g = (tok0 + t) * rowK + static_cast<size_t>(h) * K + kk;
      sr[t * KP + kk] = to_f32(r[g]);
      sk[t * KP + kk] = to_f32(k[g]);
      sLe[t * KP + kk] = to_f32(w[g]);
    }
    for (int i = tid; i < C * V; i += kThreads) {
      const int t = i / V, vv = i % V;
      sv[t * V + vv] = to_f32(v[(tok0 + t) * rowV + static_cast<size_t>(h) * V + vv]);
    }
    __syncthreads();

    // Cumulative log-decay, one channel per thread, in token order (the
    // low threads); the diagonal bonus, one token per thread (the high).
    for (int kk = tid; kk < K; kk += kThreads) {
      float li = 0.f;
      for (int t = 0; t < C; ++t) {
        const float logw = -expf(sLe[t * KP + kk]);
        li += logw;
        sLi[t * KP + kk] = li;
        sLe[t * KP + kk] = li - logw;
      }
    }
    for (int t = kThreads - 1 - tid; t < C; t += kThreads) {
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        acc += sr[t * KP + kk] * su[kk] * sk[t * KP + kk];
      }
      sd[t] = acc;
    }
    __syncthreads();

    // Intra-chunk weights, one pair (t, s < t) per thread and step:
    // p = t(t-1)/2 + s.
    for (int p = tid; p < npairs; p += kThreads) {
      int t = static_cast<int>((1.f + sqrtf(1.f + 8.f * p)) * 0.5f);
      while (t * (t - 1) / 2 > p) --t;
      while ((t + 1) * t / 2 <= p) ++t;
      const int s = p - t * (t - 1) / 2;
      const float* rt = sr + t * KP;
      const float* let = sLe + t * KP;
      const float* ks = sk + s * KP;
      const float* lis = sLi + s * KP;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const float a = fminf(fmaxf(let[kk] - lis[kk], -60.f), 0.f);
        acc += rt[kk] * expf(a) * ks[kk];
      }
      stmp[t * (C + 1) + s] = acc;
    }
    __syncthreads();

    // r <- r * exp(Le) for the state's term of y; k <- k * exp(Li_last - Li)
    // for the state update.
    for (int i = tid; i < C * K; i += kThreads) {
      const int t = i / K, kk = i % K;
      sr[t * KP + kk] *= expf(sLe[t * KP + kk]);
      sk[t * KP + kk] *= expf(sLi[(C - 1) * KP + kk] - sLi[t * KP + kk]);
    }
    __syncthreads();

    for (int i = tid; i < C * V; i += kThreads) {
      const int t = i / V, vv = i % V;
      float acc = 0.f;
      for (int s = 0; s < t; ++s) acc += stmp[t * (C + 1) + s] * sv[s * V + vv];
      acc += sd[t] * sv[t * V + vv];
      float from_state = 0.f;
      for (int kk = 0; kk < K; ++kk) from_state += sr[t * KP + kk] * sS[kk * V + vv];
      y[(tok0 + t) * rowV + static_cast<size_t>(h) * V + vv] = acc + from_state;
    }
    __syncthreads();

    for (int i = tid; i < K * V; i += kThreads) {
      const int kk = i / V, vv = i % V;
      float acc = 0.f;
      for (int s = 0; s < C; ++s) acc += sk[s * KP + kk] * sv[s * V + vv];
      sS[i] = expf(sLi[(C - 1) * KP + kk]) * sS[i] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * V; i += kThreads) sout[state0 + i] = sS[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* sout, int B, int S,
           int H, int K, int V, int C, cudaStream_t stream) {
  const size_t smem = smem_floats(K, V, C) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sout), S, H, K, V, C);
  return static_cast<int>(cudaGetLastError());
}

// ---- the bf16 kernel, on the tensor cores --------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTc = 256;           // threads of a block: 8 warps
constexpr int kWarps = kTc / 32;
constexpr int kTile = 16;          // tokens of an mma tile
constexpr int kSeg = 8;            // tokens of a segment: tmp's diagonal unit
constexpr int kPairs = kSeg * (kSeg + 1) / 2;  // (t, s <= t) in a segment
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) / 16 * 16; }

// The block's shared memory, in bytes from its start (kernels/wkv6/
// kernel.py's tensor_core_smem_bytes computes the total). Row strides:
// bf16 rows 8 elements longer than the padded width (conflict-free
// ldmatrix), Li and Le rows 4 floats longer, the state's rows 8.
struct TcLayout {
  int Kp, Vp, Cp, KS, VS, TS, KF, ST;
  size_t st, li, le, u, dec, tot, stage, stage_bytes, rE, kd, kt, tmp, pairs, total;
  __host__ __device__ TcLayout(int K, int V, int C) {
    Kp = pad16(K);
    Vp = pad16(V);
    Cp = pad16(C);
    KS = Kp + 8;
    VS = Vp + 8;
    TS = Cp + 8;
    KF = Kp + 4;
    ST = Kp + 8;
    const size_t f = sizeof(float), e = sizeof(bf16);
    st = 0;                                          // Vp x ST f32: S^T
    li = st + f * Vp * ST;                           // Cp x KF f32
    le = li + f * Cp * KF;                           // Cp x KF f32
    u = le + f * Cp * KF;                            // Kp f32
    dec = u + f * Kp;                                // Kp f32: exp(Li_last)
    tot = dec + f * Kp;                              // Cp/8 x Kp f32: segment sums
    stage = tot + f * (Cp / kSeg) * Kp;              // 2 x {r, k, w, v}
    stage_bytes = e * (3 * Cp * KS + Cp * VS);
    rE = stage + 2 * stage_bytes;                    // hi, lo: Cp x KS each
    kd = rE + 2 * e * Cp * KS;
    kt = kd + 2 * e * Cp * KS;
    tmp = kt + 2 * e * Cp * KS;                      // hi, lo: Cp x TS each
    pairs = tmp + 2 * e * Cp * TS;                   // kPairs bytes
    total = pairs + (kPairs + 15) / 16 * 16;
  }
};

// exp(x), x <= 0, as ex2.approx(x log2 e): a multiply and one MUFU.EX2
// rather than expf's longer range reduction. ex2.approx is within 2^-22
// of 2^y; rounding x log2 e moves the result by |x| 2^-24 of itself, an
// absolute |x| e^x 2^-24 < 2^-25; results below 2^-126 flush to 0.
__device__ __forceinline__ float exp_e(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

__device__ __forceinline__ void store_split(bf16* hi, bf16* lo, float x) {
  const bf16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
}

__global__ void __launch_bounds__(kTc, 2)
wkv6_kernel_tc(const bf16* __restrict__ r, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ sout,
               int S, int H, int K, int V, int C) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const TcLayout L(K, V, C);
  const int Kp = L.Kp, Vp = L.Vp, Cp = L.Cp;
  const int KS = L.KS, VS = L.VS, TS = L.TS, KF = L.KF, STR = L.ST;
  const int T = Cp / kTile;

  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* const sS = reinterpret_cast<float*>(tc_smem + L.st);   // S[k][v] at sS[v][k]
  float* const sLi = reinterpret_cast<float*>(tc_smem + L.li);
  float* const sLe = reinterpret_cast<float*>(tc_smem + L.le);
  float* const su = reinterpret_cast<float*>(tc_smem + L.u);
  float* const sdec = reinterpret_cast<float*>(tc_smem + L.dec);
  float* const stot = reinterpret_cast<float*>(tc_smem + L.tot);
  bf16* const rEh = reinterpret_cast<bf16*>(tc_smem + L.rE);
  bf16* const rEl = rEh + Cp * KS;
  bf16* const kdh = reinterpret_cast<bf16*>(tc_smem + L.kd);
  bf16* const kdl = kdh + Cp * KS;
  bf16* const kth = reinterpret_cast<bf16*>(tc_smem + L.kt);
  bf16* const ktl = kth + Cp * KS;
  bf16* const tmph = reinterpret_cast<bf16*>(tc_smem + L.tmp);
  bf16* const tmpl = tmph + Cp * TS;
  uint8_t* const pairs = tc_smem + L.pairs;  // (t << 3) | s, s <= t in a segment
  auto stage_r = [&](int st) {
    return reinterpret_cast<bf16*>(tc_smem + L.stage + st * L.stage_bytes);
  };

  // zeros everywhere first: padded rows and columns, and tmp above the
  // diagonal, are never written
  {
    const size_t words = L.total / 16;
    uint4* p = reinterpret_cast<uint4*>(tc_smem);
    for (size_t i = tid; i < words; i += kTc) p[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  for (int t = tid; t < kSeg; t += kTc) {
    for (int s = 0; s <= t; ++s) pairs[t * (t + 1) / 2 + s] = static_cast<uint8_t>((t << 3) | s);
  }
  for (int i = tid; i < K; i += kTc) su[i] = u[static_cast<size_t>(h) * K + i];
  const size_t state0 = static_cast<size_t>(bh) * K * V;
  for (int i = tid; i < K * V; i += kTc) sS[(i % V) * STR + i / V] = s0[state0 + i];

  const size_t rowK = static_cast<size_t>(H) * K;  // token stride of r, k, w
  const size_t rowV = static_cast<size_t>(H) * V;  // token stride of v, y
  auto load = [&](int c0, int st) {
    bf16* sr = stage_r(st);
    const size_t tok0 = static_cast<size_t>(b) * S + c0;
    const bf16* src[3] = {r, k, w};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      bf16* dst = sr + a * Cp * KS;
      const bf16* base = src[a] + tok0 * rowK + static_cast<size_t>(h) * K;
      mma::for_each_rc<kTc>(C, K / 8, [&](int t, int c) {
        mma::cp_async16(dst + t * KS + 8 * c, base + t * rowK + 8 * c);
      });
    }
    bf16* dv = sr + 3 * Cp * KS;
    const bf16* vb = v + tok0 * rowV + static_cast<size_t>(h) * V;
    mma::for_each_rc<kTc>(C, V / 8, [&](int t, int c) {
      mma::cp_async16(dv + t * VS + 8 * c, vb + t * rowV + 8 * c);
    });
    mma::cp_commit();
  };

  // pass A's tasks: a segment of 8 tokens of 32 channels, a lane each
  const int nseg = Cp / kSeg;
  const int ntask = (Kp + 31) / 32 * nseg;

  load(0, 0);
  for (int c0 = 0, it = 0; c0 < S; c0 += C, ++it) {
    const int cur = it & 1;
    if (c0 + C < S) {
      load(c0 + C, cur ^ 1);
      mma::cp_wait<1>();
    } else {
      mma::cp_wait<0>();
    }
    __syncthreads();  // this chunk's inputs are in
    const bf16* sr = stage_r(cur);
    const bf16* sk = sr + Cp * KS;
    const bf16* sw = sk + Cp * KS;
    const bf16* sv = sw + Cp * KS;

    // A: logw = -exp(w) (the accurate expf: its rounding adds up along
    // the cumulative sum) and its sum within each segment; then, the
    // segments' sums in hand, Li, Le and the split copies of r and k
    for (int task = warp; task < ntask; task += kWarps) {
      const int sg = task % nseg, kc = task / nseg * 32 + lane;
      if (kc >= Kp) continue;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const int t = sg * kSeg + i;
        const float lw = (t < C && kc < K) ? -expf(__bfloat162float(sw[t * KS + kc])) : 0.f;
        acc += lw;
        sLi[t * KF + kc] = acc;
        sLe[t * KF + kc] = lw;
      }
      stot[sg * Kp + kc] = acc;
    }
    __syncthreads();
    for (int task = warp; task < ntask; task += kWarps) {
      const int sg = task % nseg, kc = task / nseg * 32 + lane;
      if (kc >= Kp) continue;
      // the segments before this one, in order; the chunk's end the same
      // way as its own lane sums it, so that Llast is bit for bit the Li
      // stored there
      float carry = 0.f, carry_last = 0.f;
      for (int q = 0; q < nseg - 1; ++q) {
        const float tq = stot[q * Kp + kc];
        if (q < sg) carry += tq;
        carry_last += tq;
      }
      const float Llast = carry_last + stot[(nseg - 1) * Kp + kc];
      const float Lj = carry + stot[sg * Kp + kc];  // the end of this segment
      if (sg == 0) sdec[kc] = exp_e(Llast);
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const int t = sg * kSeg + i;
        const float Li = carry + sLi[t * KF + kc];
        const float Le = Li - sLe[t * KF + kc];
        sLi[t * KF + kc] = Li;
        sLe[t * KF + kc] = Le;
        const float rv = __bfloat162float(sr[t * KS + kc]);
        const float kv = __bfloat162float(sk[t * KS + kc]);
        store_split(rEh + t * KS + kc, rEl + t * KS + kc, rv * exp_e(Le));
        store_split(kdh + t * KS + kc, kdl + t * KS + kc, kv * exp_e(Llast - Li));
        store_split(kth + t * KS + kc, ktl + t * KS + kc, kv * exp_e(fminf(Lj - Li, 0.f)));
      }
    }
    __syncthreads();

    // B1: tmp in the diagonal segments, s <= t: a pair (t, s) per two
    // lanes, each lane half the channels; s = t is the u bonus
    {
      const int items = nseg * kPairs * 2;
      const int half = Kp / 2;
      for (int base = warp * 32; base < items; base += kTc) {
        const int i = base + lane;
        float acc = 0.f;
        int t = 0, s = 0;
        if (i < items) {
          const int pr = i >> 1, seg = pr / kPairs;
          const int ts = pairs[pr % kPairs];
          t = seg * kSeg + (ts >> 3);
          s = seg * kSeg + (ts & 7);
          const int k0 = (i & 1) * half;
          const bf16* rt = sr + t * KS;
          const bf16* ks = sk + s * KS;
          if (s < t) {
            const float* let = sLe + t * KF;
            const float* lis = sLi + s * KF;
            for (int kk = k0; kk < k0 + half; kk += 4) {
              const float4 a = *reinterpret_cast<const float4*>(let + kk);
              const float4 c = *reinterpret_cast<const float4*>(lis + kk);
              const uint2 rr = *reinterpret_cast<const uint2*>(rt + kk);
              const uint2 kv = *reinterpret_cast<const uint2*>(ks + kk);
              const float2 r0 = mma::unpack_bf16(rr.x), r1 = mma::unpack_bf16(rr.y);
              const float2 k0v = mma::unpack_bf16(kv.x), k1v = mma::unpack_bf16(kv.y);
              acc += r0.x * exp_e(fminf(fmaxf(a.x - c.x, -60.f), 0.f)) * k0v.x;
              acc += r0.y * exp_e(fminf(fmaxf(a.y - c.y, -60.f), 0.f)) * k0v.y;
              acc += r1.x * exp_e(fminf(fmaxf(a.z - c.z, -60.f), 0.f)) * k1v.x;
              acc += r1.y * exp_e(fminf(fmaxf(a.w - c.w, -60.f), 0.f)) * k1v.y;
            }
          } else {
            for (int kk = k0; kk < k0 + half; kk += 4) {
              const float4 uu = *reinterpret_cast<const float4*>(su + kk);
              const uint2 rr = *reinterpret_cast<const uint2*>(rt + kk);
              const uint2 kv = *reinterpret_cast<const uint2*>(ks + kk);
              const float2 r0 = mma::unpack_bf16(rr.x), r1 = mma::unpack_bf16(rr.y);
              const float2 k0v = mma::unpack_bf16(kv.x), k1v = mma::unpack_bf16(kv.y);
              acc += r0.x * uu.x * k0v.x;
              acc += r0.y * uu.y * k0v.y;
              acc += r1.x * uu.z * k1v.x;
              acc += r1.y * uu.w * k1v.y;
            }
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (i < items && (i & 1) == 0) store_split(tmph + t * TS + s, tmpl + t * TS + s, acc);
      }
    }

    // B2: tmp below the diagonal segments, a warp per (t-tile, s-segment
    // sg <= the tile's first): q k~^T, factored about j, the last token of
    // sg; q formed in registers, both split. Rows of the t-tile in sg
    // itself are the diagonal's (B1): their q is 0 and they are not
    // written.
    for (int job = warp; job < T * T; job += kWarps) {
      int ti = 0;
      while ((ti + 1) * (ti + 1) <= job) ++ti;
      const int sg = job - ti * ti;  // 0 .. 2 ti
      const bool upper_diag = sg == 2 * ti;  // rows g are segment sg
      const int j = sg * kSeg + kSeg - 1;
      const int t0 = ti * kTile + g, t1 = t0 + 8;
      float acc[4] = {};
      for (int kk = 0; kk < Kp; kk += 16) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a0 (t0, kk+2q), a1 (t1, ..), a2, a3 (.., kk+8+2q)
          const int t = (e & 1) ? t1 : t0;
          const int kc = kk + 2 * qd + ((e & 2) ? 8 : 0);
          if (upper_diag && !(e & 1)) {
            ah[e] = al[e] = 0u;
            continue;
          }
          const float2 rv = mma::unpack_bf16(*reinterpret_cast<const uint32_t*>(sr + t * KS + kc));
          const float2 le = *reinterpret_cast<const float2*>(sLe + t * KF + kc);
          const float2 lj = *reinterpret_cast<const float2*>(sLi + j * KF + kc);
          mma::split_bf16(rv.x * exp_e(fminf(le.x - lj.x, 0.f)),
                          rv.y * exp_e(fminf(le.y - lj.y, 0.f)), ah[e], al[e]);
        }
        uint32_t bh[2], bl[2];
        const int off = (sg * kSeg + (lane & 7)) * KS + kk + ((lane >> 3) & 1) * 8;
        mma::ldsm_x2(bh, kth + off);
        mma::ldsm_x2(bl, ktl + off);
        mma::mma_bf16(acc, ah, bh[0], bh[1]);
        mma::mma_bf16(acc, ah, bl[0], bl[1]);
        mma::mma_bf16(acc, al, bh[0], bh[1]);
      }
      const int s = sg * kSeg + 2 * qd;
      uint32_t hi, lo;
      if (!upper_diag) {
        mma::split_bf16(acc[0], acc[1], hi, lo);
        *reinterpret_cast<uint32_t*>(tmph + t0 * TS + s) = hi;
        *reinterpret_cast<uint32_t*>(tmpl + t0 * TS + s) = lo;
      }
      mma::split_bf16(acc[2], acc[3], hi, lo);
      *reinterpret_cast<uint32_t*>(tmph + t1 * TS + s) = hi;
      *reinterpret_cast<uint32_t*>(tmpl + t1 * TS + s) = lo;
    }
    __syncthreads();

    // C: y = tmp v + (r exp(Le)) S, a warp per (t-tile, 16 columns of v)
    {
      const int VB = Vp / 16;
      const size_t ybase = (static_cast<size_t>(b) * S + c0) * rowV +
                           static_cast<size_t>(h) * V;
      for (int item = warp; item < T * VB; item += kWarps) {
        const int ti = item / VB, vb = (item % VB) * 16;
        const int nn = 2;  // n-tiles of 8 columns
        float acc[4][4] = {};
        for (int sj = 0; sj <= ti; ++sj) {
          uint32_t ah[4], al[4];
          const int arow = ti * kTile + (lane & 15), acol = sj * kTile + (lane >> 4) * 8;
          mma::ldsm_x4(ah, tmph + arow * TS + acol);
          mma::ldsm_x4(al, tmpl + arow * TS + acol);
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            if (2 * pp >= nn) break;
            uint32_t rv[4];
            mma::ldsm_x4_t(rv, sv + (sj * kTile + (lane & 7) + ((lane >> 3) & 1) * 8) * VS +
                                   vb + pp * 16 + (lane >> 4) * 8);
            mma::mma_bf16(acc[2 * pp], ah, rv[0], rv[1]);
            mma::mma_bf16(acc[2 * pp], al, rv[0], rv[1]);
            mma::mma_bf16(acc[2 * pp + 1], ah, rv[2], rv[3]);
            mma::mma_bf16(acc[2 * pp + 1], al, rv[2], rv[3]);
          }
        }
        for (int kk = 0; kk < Kp; kk += 16) {
          uint32_t ah[4], al[4];
          const int arow = ti * kTile + (lane & 15), acol = kk + (lane >> 4) * 8;
          mma::ldsm_x4(ah, rEh + arow * KS + acol);
          mma::ldsm_x4(al, rEl + arow * KS + acol);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (nt >= nn) break;
            const float* sp = sS + (vb + nt * 8 + g) * STR + kk + 2 * qd;
            const float2 x0 = *reinterpret_cast<const float2*>(sp);
            const float2 x1 = *reinterpret_cast<const float2*>(sp + 8);
            uint32_t bh0, bl0, bh1, bl1;
            mma::split_bf16(x0.x, x0.y, bh0, bl0);
            mma::split_bf16(x1.x, x1.y, bh1, bl1);
            mma::mma_bf16(acc[nt], ah, bh0, bh1);
            mma::mma_bf16(acc[nt], ah, bl0, bl1);
            mma::mma_bf16(acc[nt], al, bh0, bh1);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= nn) break;
          const int vv = vb + nt * 8 + 2 * qd;
          if (vv >= V) continue;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int t = ti * kTile + g + 8 * hf;
            if (t >= C) continue;
            *reinterpret_cast<float2*>(y + ybase + t * rowV + vv) =
                make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
          }
        }
      }
    }
    __syncthreads();  // the state is read

    // D: S^T = exp(Li_last) S^T + v^T kd, a warp per (16 rows of v, 32
    // channels); each thread rewrites only its fragment
    {
      const int KB = (Kp + 31) / 32;
      for (int item = warp; item < (Vp / 16) * KB; item += kWarps) {
        const int vt = item / KB, kb = (item % KB) * 32;
        const int nn = min(4, (Kp - kb) / 8);
        float acc[4][4] = {};
        for (int ks = 0; ks < Cp; ks += 16) {
          uint32_t a[4];
          mma::ldsm_x4_t(a, sv + (ks + (lane & 7) + ((lane >> 4) << 3)) * VS + vt * 16 +
                                ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            if (2 * pp >= nn) break;
            const int off = (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * KS + kb + pp * 16 +
                            (lane >> 4) * 8;
            uint32_t bh[4], bl[4];
            mma::ldsm_x4_t(bh, kdh + off);
            mma::ldsm_x4_t(bl, kdl + off);
            mma::mma_bf16(acc[2 * pp], a, bh[0], bh[1]);
            mma::mma_bf16(acc[2 * pp], a, bl[0], bl[1]);
            mma::mma_bf16(acc[2 * pp + 1], a, bh[2], bh[3]);
            mma::mma_bf16(acc[2 * pp + 1], a, bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= nn) break;
          const int kc = kb + nt * 8 + 2 * qd;
          const float2 d = *reinterpret_cast<const float2*>(sdec + kc);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float2* p = reinterpret_cast<float2*>(sS + (vt * 16 + g + 8 * hf) * STR + kc);
            float2 sv2 = *p;
            sv2.x = d.x * sv2.x + acc[nt][2 * hf];
            sv2.y = d.y * sv2.y + acc[nt][2 * hf + 1];
            *p = sv2;
          }
        }
      }
    }
    __syncthreads();  // this stage, Li, Le, the splits and tmp are free
  }
  for (int i = tid; i < K * V; i += kTc) sout[state0 + i] = sS[(i % V) * STR + i / V];
}

size_t tc_smem_bytes(int K, int V, int C) { return TcLayout(K, V, C).total; }

bool takes_tc(int K, int V, int C) {
  return K % 8 == 0 && V % 8 == 0 && tc_smem_bytes(K, V, C) <= kMaxSmem;
}

int launch_tc(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* sout, int B, int S,
              int H, int K, int V, int C, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(K, V, C);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel_tc<<<B * H, kTc, smem, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(sout), S, H, K, V, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, w: (B, S, H, K) and v: (B, S, H, V), float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); u: (H, K) float32; s0: (B, H, K, V) float32;
// y: (B, S, H, V) float32 and sout: (B, H, K, V) float32, written. All
// contiguous on the current device, S a multiple of C. bf16 with K and V
// multiples of 8 runs on the tensor cores where its tiles fit a block,
// everything else on the CUDA cores. Launches once on `stream`, does not
// synchronise, and returns a CUDA error code (0 on success).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* sout, int B, int S, int H, int K,
                           int V, int C, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || V < 1 || C < 1 || S % C != 0 ||
      static_cast<long long>(B) * H >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && takes_tc(K, V, C)) {
    return launch_tc(r, k, v, w, u, s0, y, sout, B, S, H, K, V, C, st);
  }
  if (is_bf16) {
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sout, B, S, H, K, V, C, st);
  }
  return launch<float>(r, k, v, w, u, s0, y, sout, B, S, H, K, V, C, st);
}
