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
// What bounds it on an H100: operations. At the serve's shape (B=4,
// S=1024, H=64, K=V=64, C=32) it does about 7 GFLOP of float32 work,
// a quarter of it in the C(C-1)/2 * K exponentials of tmp, against 210 MB
// of bf16 inputs and f32 outputs: 0.10 ms of the card's 67 TFLOP/s
// non-tensor rate against 0.06 ms of its 3.35 TB/s.
//
// What this design does about that: it is the simple form. One block of
// 256 threads per (b, h) holds the 64x64 f32 state in shared memory and
// walks the chunks; one chunk's r, k, Li, Le (rows padded to K+1 floats so
// that threads on neighbouring rows hit different banks), v, tmp and the
// state fit in 62.5 KB of dynamic shared memory at C=32, K=V=64. A is never
// materialised (it would be 256 KB): each of the C(C-1)/2 pairs (t, s < t)
// is one thread's loop over k, which takes the difference Le - Li before
// the exponential, so every exponent stays <= 0 as the reference's clip
// keeps it (factoring exp(Le_t) * exp(-Li_s) would overflow under strong
// decay). expf is the accurate one: no fast math. The products with v and
// S are plain loops over shared memory; wgmma, TMA and splitting V across
// blocks for small batches are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

}  // namespace

// r, k, w: (B, S, H, K) and v: (B, S, H, V), float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); u: (H, K) float32; s0: (B, H, K, V) float32;
// y: (B, S, H, V) float32 and sout: (B, H, K, V) float32, written. All
// contiguous on the current device, S a multiple of C. Launches once on
// `stream`, does not synchronise, and returns a CUDA error code (0 on
// success).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* y, void* sout, int B, int S, int H, int K,
                           int V, int C, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || V < 1 || C < 1 || S % C != 0 ||
      static_cast<long long>(B) * H >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sout, B, S, H, K, V, C, st);
  }
  return launch<float>(r, k, v, w, u, s0, y, sout, B, S, H, K, V, C, st);
}
