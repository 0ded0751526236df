// Journal block checksum: h[b] = sum_i words[b][i] * pows[i]  (mod 2^32).
//
// Replaces repro/kernels/blockhash/kernel.py:blockhash_batch, the Pallas
// TPU kernel (one grid step per block, u32 multiply-accumulate on the
// VPU). Host API: repro_torch/kernels/blockhash/ops.py.
//
// What bounds it on an H100: device-memory bytes. Each call reads
// nblocks * wpb * 4 bytes of words (plus wpb * 4 of powers, which stay in
// L2) and does two integer operations per word, far below the card's
// integer rate. For the small batches of the journal path (one commit is
// at most 63 blocks) the launch itself and the host<->device copies
// around it cost more than the kernel.
//
// What this design does about that: nothing yet. It is the simple form:
// one thread block per hashed block, 256 threads, each thread summing
// uint32_t products over a strided loop (neighbouring threads on
// neighbouring words, so every warp load is coalesced), then a
// warp-shuffle reduction and a shared-memory reduction across the eight
// warps. Addition mod 2^32 is associative and commutative, so the result
// is bit-exact in any summation order. Any wpb >= 1 is taken.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/_build.py does this).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
blockhash_kernel(const uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ pows,
                 uint32_t* __restrict__ out, int wpb) {
  const uint32_t* row = words + static_cast<size_t>(blockIdx.x) * wpb;
  uint32_t acc = 0;
  for (int i = threadIdx.x; i < wpb; i += kThreads) {
    acc += row[i] * pows[i];
  }
  acc = warp_sum(acc);

  __shared__ uint32_t partial[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? partial[lane] : 0u;
    acc = warp_sum(acc);
    if (lane == 0) out[blockIdx.x] = acc;
  }
}

}  // namespace

// words: (nblocks, wpb) u32, pows: (wpb,) u32, out: (nblocks,) u32, all
// contiguous on the current device. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int blockhash_launch(const void* words, const void* pows, void* out,
                                int nblocks, int wpb, void* stream) {
  if (nblocks < 1 || wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  blockhash_kernel<<<nblocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(pows),
      static_cast<uint32_t*>(out), wpb);
  return static_cast<int>(cudaGetLastError());
}
