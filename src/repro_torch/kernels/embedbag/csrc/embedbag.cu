// EmbeddingBag (sum) over lookups sorted by bag, for Hopper: kernel B6.
//
// Replaces the TPU kernel repro/kernels/embedbag/embedbag.py:
// embedding_bag_sorted with its body _bag_kernel.  That kernel walks a
// sequential Pallas grid, one lookup per step: the table row idx[i] is
// DMAed in by the input BlockSpec and added into output row bags[i],
// which is zeroed at the bag's first lookup.  Here bags run in parallel:
// one warp per (bag, chunk of 128 columns).  The warp reads its run of
// lookups offsets[bag] .. offsets[bag+1] (bag offsets over the sorted
// bags, computed on the device by the wrapper), and lane l owns columns
// c0 + l + 32 t, t < 4, so each row is read by the warp as 32 contiguous
// elements at a time.  Rows are added in sorted order into f32 registers
// and rounded once to the table's dtype at the single store; no atomics.
// A bag with no lookup stores zeros.
//
// Address arithmetic: a row offset idx * D exceeds 2^31 at DLRM's
// largest table (39,979,771 x 128), so it is computed in 64 bits.
//
// Bound on the H100: bytes.  Each lookup reads one row (D elements) and
// does D additions; the least traffic is every distinct row read once,
// the two index arrays, and the output written once.  Rows reused by
// several bags may come from L2; the design relies on no reuse.
//
// Exact against the plain PyTorch version: the same f32 additions in the
// same order (acc += row, no products, so no contraction into FMAs), then
// the same round-to-nearest-even conversion.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPerLane = 4;
constexpr int kChunk = 32 * kPerLane;  // columns per warp

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void embedding_bag_kernel(
    const T* __restrict__ table,            // (R, D)
    const int32_t* __restrict__ idx,        // (N,) rows, sorted by bag
    const int32_t* __restrict__ offsets,    // (n_bags + 1,)
    T* __restrict__ out,                    // (n_bags, D)
    int n_bags, int d, int n_chunks) {
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= (int64_t)n_bags * n_chunks) return;
  const int bag = (int)(warp / n_chunks);
  const int c0 = (int)(warp % n_chunks) * kChunk + lane;
  const int lo = offsets[bag];
  const int hi = offsets[bag + 1];

  float acc[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) acc[t] = 0.0f;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const T* row = table + (int64_t)idx[i] * d;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int col = c0 + 32 * t;
      if (col < d) acc[t] += to_float(row[col]);
    }
  }
  T* o = out + (int64_t)bag * d;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int col = c0 + 32 * t;
    if (col < d) o[col] = from_float<T>(acc[t]);
  }
}

template <typename T>
int launch(const void* table, const void* idx, const void* offsets, void* out, int n_bags,
           int d, void* stream) {
  const int n_chunks = (d + kChunk - 1) / kChunk;
  const int64_t n_warps = (int64_t)n_bags * n_chunks;
  const int64_t n_blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (n_blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  embedding_bag_kernel<T><<<(unsigned)n_blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
      (const T*)table, (const int32_t*)idx, (const int32_t*)offsets, (T*)out, n_bags, d,
      n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// B6 on a float32 table.  Returns cudaGetLastError() after the launch.
extern "C" int embedding_bag_f32(const void* table, const void* idx, const void* offsets,
                                 void* out, int n_bags, int d, void* stream) {
  return launch<float>(table, idx, offsets, out, n_bags, d, stream);
}

// B6 on a bfloat16 table: f32 sums, one rounding to bf16.
extern "C" int embedding_bag_bf16(const void* table, const void* idx, const void* offsets,
                                  void* out, int n_bags, int d, void* stream) {
  return launch<__nv_bfloat16>(table, idx, offsets, out, n_bags, d, stream);
}
