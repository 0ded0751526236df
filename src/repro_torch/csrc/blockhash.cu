// Journal block checksum: h[b] = sum_i words[b][i] * pows[i]  (mod 2^32).
//
// Replaces repro/kernels/blockhash/kernel.py:blockhash_batch, the Pallas
// TPU kernel (one grid step per block, u32 multiply-accumulate on the
// VPU). Host API: repro_torch/kernels/blockhash/ops.py.
//
// What bounds it on an H100: on words in device memory, device-memory
// bytes (nblocks * wpb * 4 of words; the wpb * 4 of powers stay in L2)
// at two integer operations a word, far below the card's integer rate.
// On the journal's path (blockhash_pinned below) the words cross the host
// link instead.
//
// The kernel is the simple form: one thread block per hashed block, 256
// threads, each thread summing uint32_t products over a strided loop
// (neighbouring threads on neighbouring words, so every warp load is
// coalesced), then a warp-shuffle reduction and a shared-memory reduction
// across the eight warps. Addition mod 2^32 is associative and
// commutative, so the result is bit-exact in any summation order. Any
// wpb >= 1 is taken. At one commit (63 x 1024 words) on an H100 80GB HBM3
// at 700 W it takes 0.002 ms on device words and 0.012 ms on the mapped
// pinned words, a third of the host link's bound (chip_smoke.py's kernel
// lines); builds with the loop unrolled four ways or with 16-byte loads
// were no faster on the mapped words, so its body stays as it is.
//
// What the journal path pays is the call around it: building the words
// block by block, a pageable copy to the device, the launch and a copy
// back through PyTorch took 0.16-0.37 ms of host time a commit on an
// H100 80GB HBM3 at 700 W, from one host to another (chip_smoke.py's
// blockhash_call, parent_call_ms). blockhash_pinned takes the device's
// part of a call in one host call: the kernel reads the words from a
// reusable pinned host buffer and writes the hashes to another, both
// mapped into the device's address space, so no copy is launched; then
// the wait for the stream. repro_torch/kernels/blockhash/ops.py's
// _Staging owns the buffers. What is left of a commit's host time is the
// words' join and staging, this call and the conversion to Python ints
// (blockhash_call splits it).
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

int launch_kernel(const void* words, const void* pows, void* out,
                  int nblocks, int wpb, cudaStream_t stream) {
  blockhash_kernel<<<nblocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(pows),
      static_cast<uint32_t*>(out), wpb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words: (nblocks, wpb) u32, pows: (wpb,) u32, out: (nblocks,) u32, all
// contiguous on the current device. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int blockhash_launch(const void* words, const void* pows, void* out,
                                int nblocks, int wpb, void* stream) {
  if (nblocks < 1 || wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel(words, pows, out, nblocks, wpb,
                       static_cast<cudaStream_t>(stream));
}

// One checksum batch's device work in one call: the kernel reads
// nblocks * wpb u32 words straight from pinned host memory (host_words)
// and writes the nblocks hashes to pinned host memory (host_out), both
// through their device addresses (pinned memory is mapped into the
// device's address space), with pows (wpb,) on the device; it launches
// on `stream` of the current device and, when `wait` is not 0, waits for
// the stream. Returns the first CUDA error (0 on success).
extern "C" int blockhash_pinned(const void* host_words, const void* pows,
                                void* host_out, int nblocks, int wpb,
                                void* stream, int wait) {
  if (nblocks < 1 || wpb < 1) return static_cast<int>(cudaErrorInvalidValue);
  void* words = nullptr;
  void* out = nullptr;
  cudaError_t err =
      cudaHostGetDevicePointer(&words, const_cast<void*>(host_words), 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaHostGetDevicePointer(&out, host_out, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = launch_kernel(words, pows, out, nblocks, wpb, st);
  if (rc != 0 || !wait) return rc;
  return static_cast<int>(cudaStreamSynchronize(st));
}
