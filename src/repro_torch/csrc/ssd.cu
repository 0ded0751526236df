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
// half of the C x C products and C.B^T once per (b, chunk): 0.012 ms at
// the tensor cores' bf16 rate. The bytes bound it.
//
// bf16 inputs (the serve) take ssd_kernel_bf16, on the tensor cores. One
// block of 4 warps per (b, pair of heads) walks the chunks. A chunk's B
// and C, and x of both heads, stay bf16 in shared memory (rows padded by
// 16 bytes for conflict-free ldmatrix), the two states f32 (64 x 72 each).
// Every product is mma.sync.m16n8k16, bf16 in and float32 accumulate:
//   - C.B^T: a warp forms, for each of its tiles of 16 tokens t, the
//     16 x 16 tiles up to the diagonal in registers, once for both heads
//     (C.B^T is formed once per (b, chunk, pair of heads), half as
//     often as one head at a time would);
//   - M x: each tile of C.B^T is multiplied by its decays
//     exp(clip(Li_t - Li_s, -60, 0)) dt_s in registers, split into bf16
//     high + remainder, and fed at once as the A operand of two products
//     with x, as flash attention feeds p: M is never stored, so any chunk
//     up to 256 fits;
//   - exp(Li_t) (C h^T): C as it is, the state split high + remainder;
//   - the state update: the weighted x (exp(Li_last - Li_t) dt_t x_t)
//     split high + remainder, B as it is.
// One bf16 rounding of M alone misses the 2e-4 tolerance tenfold at the
// smoke's largest shape; the split holds each operand to about 2^-17 of
// its size, y and the state to about 4e-6 (tests/test_torch_ssd.py
// emulates both). Products of two bf16 inputs are exact into the
// float32 accumulator. Decays are exponentials of clipped differences
// with the accurate expf: exp(Li_t) * exp(-Li_s) would overflow under
// strong decay. P, N and C are zero-padded to multiples of 16. The next chunk's C loads by cp.async while the states
// update, its x and B while its decays are scanned; the other block on
// the SM covers the rest: 114,688 bytes a block at the serve's shape, two
// an SM.
//
// float32 inputs take ssd_kernel, the CUDA-core form (so do
// bf16 shapes whose padded tiles would not fit a block, such as a very
// wide P over a narrow N). One block of 256 threads per (b, h) keeps the
// state transposed (N x P f32) in shared memory and walks the chunks; x,
// B and C stay in the input's dtype, M (C x C f32) is formed whole, and
// every product is a register tile per thread with 16-byte shared-memory
// loads: 178 KB a block for f32 inputs at the serve's shape.
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

// Bytes of dynamic shared memory for one block of ssd_kernel
// (kernels/ssd/kernel.py's smem_bytes computes the same).
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

// ---- the bf16 kernel, on the tensor cores --------------------------------

using bf16 = __nv_bfloat16;

constexpr int kG = 2;            // heads of a block: C.B^T is shared by them
constexpr int kMmaThreads = 128;  // 4 warps

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) / 16 * 16; }

// Bytes of dynamic shared memory for one block of ssd_kernel_bf16
// (kernels/ssd/kernel.py's smem_bytes computes the same): x of kG heads,
// B and C in bf16 with rows padded by 8 elements, the kG states in f32
// with rows of Np + 8 floats, and four f32 vectors of Cp per head.
__host__ __device__ size_t bf16_smem_bytes(int P, int N, int C) {
  const size_t Pp = pad16(P), Np = pad16(N), Cp = pad16(C);
  return 2 * (kG * Cp * (Pp + 8) + 2 * Cp * (Np + 8)) +
         4 * (kG * Pp * (Np + 8) + kG * 4 * Cp);
}

// rows x cols bf16 (cols a multiple of 4) from global (row stride ss) to
// shared memory (row stride ds), asynchronously.
__device__ __forceinline__ void copy_rows(bf16* dst, int ds, const bf16* src,
                                          size_t ss, int rows, int cols) {
  if (cols % 8 == 0) {
    mma::for_each_rc<kMmaThreads>(rows, cols / 8, [&](int r, int c) {
      mma::cp_async16(dst + r * ds + 8 * c, src + r * ss + 8 * c);
    });
  } else {
    mma::for_each_rc<kMmaThreads>(rows, cols / 4, [&](int r, int c) {
      mma::cp_async8(dst + r * ds + 4 * c, src + r * ss + 4 * c);
    });
  }
}

__global__ void __launch_bounds__(kMmaThreads, 2)
ssd_kernel_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                const float* __restrict__ A_log, const float* __restrict__ Dv,
                const float* __restrict__ s0, float* __restrict__ y,
                float* __restrict__ sout, int S, int H, int P, int N, int C) {
  const int groups = (H + kG - 1) / kG;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * kG;
  const int nh = min(kG, H - h0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const int Pp = pad16(P), Np = pad16(N), Cp = pad16(C);
  const int XS = Pp + 8, BS = Np + 8, HS = Np + 8;  // row strides
  const int T16 = Cp / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const xs = reinterpret_cast<bf16*>(smem);    // kG x Cp x XS
  bf16* const Bs = xs + kG * Cp * XS;                // Cp x BS
  bf16* const Cs = Bs + Cp * BS;                     // Cp x BS
  float* const hs = reinterpret_cast<float*>(Cs + Cp * BS);  // kG x Pp x HS
  float* const vec = hs + kG * Pp * HS;  // kG x {Li, eLi, wgt, dt} x Cp
  auto Li = [&](int hh) { return vec + (hh * 4 + 0) * Cp; };
  auto eLi = [&](int hh) { return vec + (hh * 4 + 1) * Cp; };
  auto wgt = [&](int hh) { return vec + (hh * 4 + 2) * Cp; };
  auto dts = [&](int hh) { return vec + (hh * 4 + 3) * Cp; };

  // zeros everywhere first: padded rows and columns are never copied to
  {
    const size_t words = bf16_smem_bytes(P, N, C) / 16;
    uint4* p = reinterpret_cast<uint4*>(smem);
    for (size_t i = threadIdx.x; i < words; i += kMmaThreads)
      p[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  for (int hh = 0; hh < nh; ++hh) {
    const float* src = s0 + (static_cast<size_t>(b) * H + h0 + hh) * P * N;
    for (int i = threadIdx.x; i < P * N; i += kMmaThreads)
      hs[(hh * Pp + i / N) * HS + i % N] = src[i];
  }

  const size_t xrow = static_cast<size_t>(H) * P;  // token stride of x, y
  auto load_c = [&](int c0) {
    copy_rows(Cs, BS, Cm + (static_cast<size_t>(b) * S + c0) * N, N, C, N);
    mma::cp_commit();
  };
  auto load_dt = [&](int c0) {
    for (int i = threadIdx.x; i < nh * C; i += kMmaThreads) {
      const int hh = i / C, t = i % C;
      mma::cp_async4(dts(hh) + t,
                     dt + (static_cast<size_t>(b) * S + c0 + t) * H + h0 + hh);
    }
    mma::cp_commit();
  };
  auto load_xb = [&](int c0) {
    const size_t tok0 = static_cast<size_t>(b) * S + c0;
    for (int hh = 0; hh < nh; ++hh)
      copy_rows(xs + hh * Cp * XS, XS, x + tok0 * xrow + (h0 + hh) * P, xrow,
                C, P);
    copy_rows(Bs, BS, Bm + tok0 * N, N, C, N);
    mma::cp_commit();
  };
  load_c(0);
  load_dt(0);
  load_xb(0);

  for (int c0 = 0; c0 < S; c0 += C) {
    const bool more = c0 + C < S;
    mma::cp_wait<1>();  // C and dt are in; x and B may be on their way
    __syncthreads();

    // Li: an inclusive scan of dt * A over the chunk, a warp per head, in
    // rounds of 32 tokens; padded tokens have dt = 0
    if (warp < nh) {
      const int hh = warp;
      const float A = -expf(A_log[h0 + hh]);
      float carry = 0.f;
      for (int base = 0; base < Cp; base += 32) {
        float v = base + lane < Cp ? dts(hh)[base + lane] * A : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (base + lane < Cp) Li(hh)[base + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      __syncwarp();
      const float Llast = Li(hh)[C - 1];
      for (int t = lane; t < Cp; t += 32) {
        eLi(hh)[t] = expf(Li(hh)[t]);
        wgt(hh)[t] = expf(Llast - Li(hh)[t]) * dts(hh)[t];
      }
    }
    mma::cp_wait<0>();
    __syncthreads();

    // y: each warp takes tiles of 16 tokens, alternately from either end
    // of the chunk so that the warps' tiles up to the diagonal balance
    for (int k = 0; 4 * k < T16; ++k) {
      const int ti = 4 * k + ((k & 1) ? 3 - warp : warp);
      if (ti >= T16) continue;
      const int t0 = ti * 16 + g, t1 = t0 + 8;  // this thread's rows
      const int nsg = ti / 8 + 1;  // groups of 8 s-tiles up to the diagonal
      for (int pb = 0; pb < Pp; pb += 64) {
        const int np8 = min(8, (Pp - pb) / 8);  // n-tiles of 8 p
        float cb[8][2][4];  // C.B^T, s-tiles 8 sg .. 8 sg + 7 of this t-tile
        auto form_cb = [&](int sg) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e) cb[jj][u][e] = 0.f;
          for (int kk = 0; kk < Np; kk += 16) {
            uint32_t a[4];
            mma::ldsm_x4(a, Cs + (ti * 16 + (lane & 15)) * BS + kk + (lane >> 4) * 8);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int j = 8 * sg + jj;
              if (j > ti) break;
              uint32_t r[4];
              mma::ldsm_x4(r, Bs + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * BS +
                                  kk + ((lane >> 3) & 1) * 8);
              mma::mma_bf16(cb[jj][0], a, r[0], r[1]);
              mma::mma_bf16(cb[jj][1], a, r[2], r[3]);
            }
          }
        };
        if (nsg == 1) form_cb(0);  // once for both heads
        for (int hh = 0; hh < nh; ++hh) {
          const bf16* xh = xs + hh * Cp * XS;
          const float* L = Li(hh);
          const float* dd = dts(hh);
          float acc[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
          // exp(Li_t) (C h^T): the state split high + remainder
          const float* hsh = hs + (hh * Pp + pb) * HS;
          for (int kk = 0; kk < Np; kk += 16) {
            uint32_t a[4];
            mma::ldsm_x4(a, Cs + (ti * 16 + (lane & 15)) * BS + kk + (lane >> 4) * 8);
#pragma unroll
            for (int pt = 0; pt < 8; ++pt) {
              if (pt >= np8) break;
              const float* hr = hsh + (pt * 8 + g) * HS + kk + 2 * qd;
              const float2 u0 = *reinterpret_cast<const float2*>(hr);
              const float2 u1 = *reinterpret_cast<const float2*>(hr + 8);
              uint32_t hi0, lo0, hi1, lo1;
              mma::split_bf16(u0.x, u0.y, hi0, lo0);
              mma::split_bf16(u1.x, u1.y, hi1, lo1);
              mma::mma_bf16(acc[pt], a, hi0, hi1);
              mma::mma_bf16(acc[pt], a, lo0, lo1);
            }
          }
          const float Lt0 = L[t0], Lt1 = L[t1];
          {
            const float e0 = eLi(hh)[t0], e1 = eLi(hh)[t1];
#pragma unroll
            for (int pt = 0; pt < 8; ++pt) {
              acc[pt][0] *= e0;
              acc[pt][1] *= e0;
              acc[pt][2] *= e1;
              acc[pt][3] *= e1;
            }
          }
          // M x over s <= t, M formed tile by tile in registers
          for (int sg = 0; sg < nsg; ++sg) {
            if (nsg > 1) form_cb(sg);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int j = 8 * sg + jj;
              if (j > ti) break;
              uint32_t ahi[4], alo[4];
#pragma unroll
              for (int u = 0; u < 2; ++u) {  // s = 16 j + 8 u + 2 qd (+1)
                const int s = j * 16 + 8 * u + 2 * qd;
                const float2 Ls = *reinterpret_cast<const float2*>(L + s);
                const float2 ds = *reinterpret_cast<const float2*>(dd + s);
                const float* c = cb[jj][u];
                float m[4];
                m[0] = s <= t0 ? c[0] * expf(fminf(fmaxf(Lt0 - Ls.x, -60.f), 0.f)) * ds.x : 0.f;
                m[1] = s + 1 <= t0 ? c[1] * expf(fminf(fmaxf(Lt0 - Ls.y, -60.f), 0.f)) * ds.y : 0.f;
                m[2] = s <= t1 ? c[2] * expf(fminf(fmaxf(Lt1 - Ls.x, -60.f), 0.f)) * ds.x : 0.f;
                m[3] = s + 1 <= t1 ? c[3] * expf(fminf(fmaxf(Lt1 - Ls.y, -60.f), 0.f)) * ds.y : 0.f;
                mma::split_bf16(m[0], m[1], ahi[2 * u], alo[2 * u]);
                mma::split_bf16(m[2], m[3], ahi[2 * u + 1], alo[2 * u + 1]);
              }
#pragma unroll
              for (int pp = 0; pp < 4; ++pp) {
                if (2 * pp >= np8) break;
                uint32_t r[4];
                mma::ldsm_x4_t(r, xh + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
                                      pb + pp * 16 + (lane >> 4) * 8);
                mma::mma_bf16(acc[2 * pp], ahi, r[0], r[1]);
                mma::mma_bf16(acc[2 * pp], alo, r[0], r[1]);
                mma::mma_bf16(acc[2 * pp + 1], ahi, r[2], r[3]);
                mma::mma_bf16(acc[2 * pp + 1], alo, r[2], r[3]);
              }
            }
          }
          // + D x, and out
          const float Dh = Dv[h0 + hh];
          const size_t ybase = (static_cast<size_t>(b) * S + c0) * xrow +
                               static_cast<size_t>(h0 + hh) * P;
#pragma unroll
          for (int pt = 0; pt < 8; ++pt) {
            if (pt >= np8) break;
            const int p = pb + pt * 8 + 2 * qd;
            if (p >= P) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int t = half ? t1 : t0;
              if (t >= C) continue;
              const float2 xv = mma::unpack_bf16(
                  *reinterpret_cast<const uint32_t*>(xh + t * XS + p));
              float2 out;
              out.x = acc[pt][2 * half] + Dh * xv.x;
              out.y = acc[pt][2 * half + 1] + Dh * xv.y;
              *reinterpret_cast<float2*>(y + ybase + t * xrow + p) = out;
            }
          }
        }
      }
    }
    __syncthreads();  // C and the states are read
    if (more) load_c(c0 + C);

    // the states: h = exp(Li_last) h + (weighted x)^T B, a warp per
    // (head, 16 p, 64 n) tile; each thread rewrites only its fragment
    const int P16 = Pp / 16, NB = (Np + 63) / 64;
    for (int item = warp; item < nh * P16 * NB; item += 4) {
      const int hh = item / (P16 * NB);
      const int pt16 = (item / NB) % P16;
      const int nb = (item % NB) * 64;
      const int nn8 = min(8, (Np - nb) / 8);
      const bf16* xh = xs + hh * Cp * XS;
      const float* w = wgt(hh);
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int ts = 0; ts < Cp; ts += 16) {
        uint32_t r[4];
        mma::ldsm_x4_t(r, xh + (ts + (lane & 7) + ((lane >> 4) << 3)) * XS +
                              pt16 * 16 + ((lane >> 3) & 1) * 8);
        const float2 w0 = *reinterpret_cast<const float2*>(w + ts + 2 * qd);
        const float2 w8 = *reinterpret_cast<const float2*>(w + ts + 8 + 2 * qd);
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 xv = mma::unpack_bf16(r[i]);
          const float2 wv = i < 2 ? w0 : w8;
          mma::split_bf16(wv.x * xv.x, wv.y * xv.y, ahi[i], alo[i]);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (2 * np >= nn8) break;
          uint32_t rb[4];
          mma::ldsm_x4_t(rb, Bs + (ts + (lane & 7) + ((lane >> 3) & 1) * 8) * BS +
                                 nb + np * 16 + (lane >> 4) * 8);
          mma::mma_bf16(acc[2 * np], ahi, rb[0], rb[1]);
          mma::mma_bf16(acc[2 * np], alo, rb[0], rb[1]);
          mma::mma_bf16(acc[2 * np + 1], ahi, rb[2], rb[3]);
          mma::mma_bf16(acc[2 * np + 1], alo, rb[2], rb[3]);
        }
      }
      const float decay = eLi(hh)[C - 1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nn8) break;
        const int n = nb + j * 8 + 2 * qd;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2* hp = reinterpret_cast<float2*>(
              hs + (hh * Pp + pt16 * 16 + g + 8 * half) * HS + n);
          float2 hv = *hp;
          hv.x = decay * hv.x + acc[j][2 * half];
          hv.y = decay * hv.y + acc[j][2 * half + 1];
          *hp = hv;
        }
      }
    }
    __syncthreads();  // x, B and the vectors are read
    if (more) {
      load_dt(c0 + C);
      load_xb(c0 + C);
    }
  }
  __syncthreads();
  for (int hh = 0; hh < nh; ++hh) {
    float* dst = sout + (static_cast<size_t>(b) * H + h0 + hh) * P * N;
    for (int i = threadIdx.x; i < P * N; i += kMmaThreads)
      dst[i] = hs[(hh * Pp + i / N) * HS + i % N];
  }
}

int launch_bf16(const void* x, const void* dt, const void* Bm, const void* Cm,
                const void* A_log, const void* Dv, const void* s0, void* y,
                void* sout, int b, int S, int H, int P, int N, int C,
                cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes(P, N, C);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = b * ((H + kG - 1) / kG);
  ssd_kernel_bf16<<<blocks, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
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
  if (is_bf16 && bf16_smem_bytes(P, N, C) <= kMaxSmem) {
    return launch_bf16(x, dt, Bm, Cm, A_log, Dv, s0, y, sout, b, S, H, P, N,
                       C, st);
  }
  if (is_bf16) {  // padded tiles too wide for a block: the CUDA-core form
    return launch<__nv_bfloat16>(x, dt, Bm, Cm, A_log, Dv, s0, y, sout, b, S,
                                 H, P, N, C, st);
  }
  return launch<float>(x, dt, Bm, Cm, A_log, Dv, s0, y, sout, b, S, H, P, N,
                       C, st);
}
