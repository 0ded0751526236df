// Mamba2 SSD (state-space duality) chunked scan, forward, with the (P, N)
// state carried across chunks.
//
// Replaces repro/kernels/ssd/kernel.py:ssd_chunked, the Pallas TPU kernel
// (grid (b, H, S/chunk) with the chunk axis sequential, the state in VMEM
// scratch, the C x C decay matrix M an MXU operand). Host API:
// repro_torch/kernels/ssd/ops.py. For each (batch b, head h), walking the
// chunks of C tokens in order, with all arithmetic in float32:
//
//   A = -exp(A_log[h]);  Li = inclusive cumsum of dt * A over t
//   M[t,s] = (C_t . B_s) exp(clip(Li_t - Li_s, -60, 0)) dt_s,   s <= t
//   y[t]   = sum_s M[t,s] x[s] + exp(Li_t) (h C_t) + D[h] x[t]
//   h      = exp(Li_{C-1}) h + sum_t (exp(Li_{C-1} - Li_t) dt_t x[t]) B_t^T
//
// B and C are shared by all heads: they are indexed by (b, t) only.
//
// What bounds it on an H100: at the serve's shape (b=4, S=1024, H=112,
// P=N=64, C=128, bf16 in) it moves 194 MB (the f32 y is 117 MB of it),
// 0.058 ms at 3.35 TB/s, and needs 11.7 GFLOP, counting only the s <= t
// half of the C x C products and C.B^T once per (b, chunk), since B and C
// are shared by the heads: 0.012 ms at the tensor cores' bf16 rate,
// 0.175 ms at the 67 TFLOP/s the card has for float32 outside them. This
// kernel runs in float32 on the CUDA cores and forms C.B^T once per head
// (15.4 GFLOP in all), so the operations bound it.
//
// What this design does about that: it is the simple form. One block of
// 256 threads per (b, h) keeps the state transposed (N x P f32, 16 KB) in
// shared memory and walks the chunks. A chunk's x (C x P), B and C
// (transposed, N x C) stay in the input's dtype in shared memory, so the
// bf16 serve holds 48 KB of them instead of 96; with the whole of M
// (transposed, C x C f32, 64 KB) one block takes 130 KB (178 KB for f32
// inputs) of the 227 KB. Every product is a register tile per thread:
// M 8x8 (t, s) over N, y 8x4 (t, p) over s and n, the state 4x4 (p, n) over
// t, with 16-byte shared-memory loads along the contiguous axis. Tiles of M
// above the diagonal are never formed. Every exponent of a decay within
// the chunk is of the difference Li_t - Li_s, clipped as the reference
// clips it: exp(Li_t) * exp(-Li_s) would overflow under strong decay.
// expf is the accurate one: no fast math. Sharing C.B^T across the heads
// of a batch, tensor cores and overlapping the next chunk's loads are
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // what one H100 block may have

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 consecutive values at a 16-byte-aligned shared-memory address.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 4 consecutive values at an address aligned to 4 elements.
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// Bytes of dynamic shared memory for one block (kernels/ssd/kernel.py's
// smem_bytes computes the same).
size_t smem_bytes(int P, int N, int C, size_t esize) {
  const size_t c = static_cast<size_t>(C);
  return esize * (c * P + 2 * c * N) +
         sizeof(float) * (c * c + static_cast<size_t>(N) * P + 4 * c + 32);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const float* __restrict__ A_log, const float* __restrict__ Dv,
           const float* __restrict__ s0, float* __restrict__ y,
           float* __restrict__ sout, int S, int H, int P, int N, int C) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // C x P: x[t][p]
  T* Bt = xs + C * P;                   // N x C: B[t][n] at Bt[n][t]
  T* Ct = Bt + N * C;                   // N x C: C[t][n] at Ct[n][t]
  float* Mt = reinterpret_cast<float*>(Ct + N * C);  // C x C: M[t][s] at Mt[s][t]
  float* hT = Mt + C * C;               // N x P: the state h[p][n] at hT[n][p]
  float* Li = hT + N * P;               // C: inclusive cumsum of dt * A
  float* eLi = Li + C;                  // C: exp(Li)
  float* wgt = eLi + C;                 // C: exp(Li_last - Li) dt
  float* dts = wgt + C;                 // C: dt
  float* red = dts + C;                 // 32: the scan's warp totals

  const float A = -expf(A_log[h]);
  const float Dh = Dv[h];
  const size_t state0 = static_cast<size_t>(bh) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    hT[n * P + p] = s0[state0 + i];
  }

  const int T8 = C / 8;       // tiles of 8 tokens
  const int P4 = P / 4;       // tiles of 4 head channels
  const int N4 = N / 4;       // tiles of 4 state channels

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();  // the last chunk's readers and the state's writers are done
    const size_t tok0 = static_cast<size_t>(b) * S + c0;
    for (int i = tid; i < C * P; i += kThreads) {
      const int t = i / P, p = i % P;
      xs[i] = x[((tok0 + t) * H + h) * P + p];
    }
    for (int i = tid; i < C * N; i += kThreads) {
      const int t = i / N, n = i % N;
      Bt[n * C + t] = Bm[(tok0 + t) * N + n];
      Ct[n * C + t] = Cm[(tok0 + t) * N + n];
    }
    for (int t = tid; t < C; t += kThreads) dts[t] = dt[(tok0 + t) * H + h];
    __syncthreads();

    // Li: an inclusive scan of dt * A over the chunk (C <= kThreads), by
    // warp shuffles and then the totals of the warps before.
    float v = tid < C ? dts[tid] * A : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) red[warp] = v;
    __syncthreads();
    if (tid < C) {
      for (int w = 0; w < warp; ++w) v += red[w];
      Li[tid] = v;
    }
    __syncthreads();
    const float Llast = Li[C - 1];
    for (int t = tid; t < C; t += kThreads) {
      eLi[t] = expf(Li[t]);
      wgt[t] = expf(Llast - Li[t]) * dts[t];
    }

    // M, one 8x8 (t, s) tile per thread and step, s-tiles up to the
    // diagonal only; within the diagonal tile, s > t is 0.
    for (int tile = tid; tile < T8 * T8; tile += kThreads) {
      const int ti = tile / T8, si = tile % T8;
      if (si > ti) continue;
      const int t0 = ti * 8, s0i = si * 8;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
        load8(Ct + n * C + t0, cv);
        load8(Bt + n * C + s0i, bv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = s0i + j;
        const float Ls = Li[s], ds = dts[s];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = t0 + i;
          float m = 0.f;
          if (s <= t) {
            const float g = expf(fminf(fmaxf(Li[t] - Ls, -60.f), 0.f));
            m = acc[i][j] * g * ds;
          }
          Mt[s * C + t] = m;
        }
      }
    }
    __syncthreads();

    // y, one 8x4 (t, p) tile per thread and step: M x over s <= t, the
    // incoming state's exp(Li_t) (h C_t), and D x.
    for (int tile = tid; tile < T8 * P4; tile += kThreads) {
      const int ti = tile / P4, pi = tile % P4;
      const int t0 = ti * 8, p0 = pi * 4;
      float acc[8][4], accs[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = accs[i][j] = 0.f;
      for (int s = 0; s < t0 + 8; ++s) {
        float mv[8], xv[4];
        load8(Mt + s * C + t0, mv);
        load4(xs + s * P + p0, xv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += mv[i] * xv[j];
      }
      for (int n = 0; n < N; ++n) {
        float cv[8], hv[4];
        load8(Ct + n * C + t0, cv);
        load4(hT + n * P + p0, hv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) accs[i][j] += cv[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + i;
        float xv[4];
        load4(xs + t * P + p0, xv);
        const float e = eLi[t];
        float4 out;
        out.x = acc[i][0] + e * accs[i][0] + Dh * xv[0];
        out.y = acc[i][1] + e * accs[i][1] + Dh * xv[1];
        out.z = acc[i][2] + e * accs[i][2] + Dh * xv[2];
        out.w = acc[i][3] + e * accs[i][3] + Dh * xv[3];
        *reinterpret_cast<float4*>(y + ((tok0 + t) * H + h) * P + p0) = out;
      }
    }
    __syncthreads();

    // The state, one 4x4 (p, n) tile per thread and step; each thread
    // rewrites only its own tile.
    const float decay = eLi[C - 1];
    for (int tile = tid; tile < P4 * N4; tile += kThreads) {
      const int pi = tile % P4, ni = tile / P4;
      const int p0 = pi * 4, n0 = ni * 4;
      float acc[4][4];
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jn][i] = 0.f;
      for (int t = 0; t < C; ++t) {
        float xv[4], bv[4];
        load4(xs + t * P + p0, xv);
        const float w = wgt[t];
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) bv[jn] = to_f32(Bt[(n0 + jn) * C + t]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xw = w * xv[i];
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) acc[jn][i] += xw * bv[jn];
        }
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        float* row = hT + (n0 + jn) * P + p0;
#pragma unroll
        for (int i = 0; i < 4; ++i) row[i] = decay * row[i] + acc[jn][i];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    sout[state0 + i] = hT[n * P + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* Bm, const void* Cm,
           const void* A_log, const void* Dv, const void* s0, void* y,
           void* sout, int b, int S, int H, int P, int N, int C,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, C, sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<T><<<b * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(A_log), static_cast<const float*>(Dv),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(sout), S, H, P, N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, S, H, P), B and C: (b, S, N), all float32 (is_bf16 = 0) or all
// bfloat16 (is_bf16 = 1); dt: (b, S, H), A_log and D: (H,), s0: (b, H, P,
// N), float32; y: (b, S, H, P) and sout: (b, H, P, N), float32, written.
// All contiguous on the current device; S a multiple of C, C a multiple of
// 8 and at most 256, P and N multiples of 4. Launches once on `stream`,
// does not synchronise, and returns a CUDA error code (0 on success).
extern "C" int ssd_launch(const void* x, const void* dt, const void* Bm,
                          const void* Cm, const void* A_log, const void* Dv,
                          const void* s0, void* y, void* sout, int b, int S,
                          int H, int P, int N, int C, int is_bf16,
                          void* stream) {
  if (b < 1 || S < 1 || H < 1 || P < 4 || N < 4 || C < 8 || C > kThreads ||
      S % C != 0 || C % 8 != 0 || P % 4 != 0 || N % 4 != 0 ||
      static_cast<long long>(b) * H >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, dt, Bm, Cm, A_log, Dv, s0, y, sout, b, S,
                                 H, P, N, C, st);
  }
  return launch<float>(x, dt, Bm, Cm, A_log, Dv, s0, y, sout, b, S, H, P, N,
                       C, st);
}
