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
// the products run on the tensor cores. This kernel runs them on the CUDA
// cores in float32 (67 TFLOP/s), where they take at least 0.45 ms.
//
// What this design does about that: it is the simple form. One block of
// 256 threads per (query tile of 64 rows, head, batch) holds its q tile
// (transposed, D x 64) in shared memory and walks the key tiles of 64,
// skipping every tile that the causal mask or the window leaves wholly
// masked, as the Pallas kernel does. For each tile it loads k (transposed)
// and v as float32, then each thread forms a 4x4 register tile of scores
// (4 rows, 4 keys 16 apart), takes the rows' maxima and sums across the 16
// threads that share its rows with warp shuffles, rescales its part of the
// output (4 rows x up to 8 columns 16 apart, float32 in registers) and
// adds p v through shared memory. Columns and keys 16 apart keep the 16
// threads of a row group on 16 different banks; the padded strides of q,
// k and p do the same for the transposed stores. D is a runtime value up
// to 128; 112 fills 7 of the 8 columns a thread may hold. At D = 112 one
// block takes 106 KB, so two run on an SM. Tensor cores (wgmma), TMA and
// a pipeline of key tiles are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py does this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;        // query rows of a block
constexpr int BKV = 64;       // keys of a tile
constexpr int QS = BQ + 4;    // row stride of q^T and p^T (16-byte rows)
constexpr int KS = BKV + 1;   // row stride of k^T
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;  // the reference's masked score
constexpr size_t kMaxSmem = 232448;  // what one H100 block may have

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Offset in floats of p^T in shared memory, rounded up to 16 bytes for
// its float4 rows, and the floats of dynamic shared memory for one block
// (kernels/flash_attention/kernel.py's smem_bytes computes the same).
__host__ __device__ __forceinline__ int p_offset(int D) {
  return (D * QS + D * KS + BKV * D + 3) / 4 * 4;
}
size_t smem_floats(int D) {
  return static_cast<size_t>(p_offset(D)) + static_cast<size_t>(BKV) * QS;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
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
  const T* qb = q + static_cast<size_t>(b) * Sq * qrow + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * Skv * kvrow + static_cast<size_t>(hk) * D;
  const T* vb = v + static_cast<size_t>(b) * Skv * kvrow + static_cast<size_t>(hk) * D;
  T* ob = o + static_cast<size_t>(b) * Sq * qrow + static_cast<size_t>(h) * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qpos = q_start + r;
    qT[d * QS + r] = qpos < Sq ? to_f32(qb[qpos * qrow + d]) : 0.f;
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
      kT[d * KS + c] = in ? to_f32(kb[kpos * kvrow + d]) : 0.f;
      vs[c * D + d] = in ? to_f32(vb[kpos * kvrow + d]) : 0.f;
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
      if (j < nj && d < D) store(ob + qpos * qrow + d, acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
           float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats(D) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, D,
      causal, window, scale, softcap);
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
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                                 window, softcap, st);
  }
  return launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal, window,
                       softcap, st);
}
