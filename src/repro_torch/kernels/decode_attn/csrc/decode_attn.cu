// GQA flash decoding, for Hopper: kernel B7.
//
// Replaces the TPU kernel repro/kernels/decode_attn/decode_attn.py:
// flash_decode_gqa with its body _decode_kernel.  That kernel runs a
// grid of (batch x kv group, kv block); the kv-block axis is sequential
// on the TPU and carries the running max, sum and f32 accumulator of an
// online softmax in VMEM scratch across it.  Here one CTA owns one
// (batch, kv group) and walks the kv positions itself, in tiles of
// kTile: the sequential grid axis becomes a loop inside the CTA.
//
// Per tile the CTA stages K and V (kTile x Dh, converted to f32; K rows
// padded to Dh + 1 floats so that threads reading the same column of
// neighbouring rows hit distinct banks) in shared memory with 16-byte
// loads.  Scores: thread (pos, half) computes the dot products of kv
// position pos with q rows half, half + 2, ... of the group's r = H / G
// rows (q in shared memory, a broadcast), times 1/sqrt(Dh); positions at
// or past kv_len score -1e30 exactly as _decode_kernel masks them.  The
// running statistics of row i live in warp i % 4: it takes the tile's
// max by shuffles, p = exp(s - m_new), the sum of p in f32, and
// corr = exp(m_old - m_new); p is rounded to V's dtype before P.V, as
// repro casts it, and the f32 sum uses the unrounded p, as repro does.
// P.V: thread t owns output dims t and t + 128 for all r rows, in
// registers.  The output is acc / max(l, 1e-30) in q's dtype.
//
// kv_len is read from device memory: no host sync.  With kv_len >= 1 the
// CTA stops at position kv_len: every later position would add
// exp(-1e30 - m) = 0 to the sum and 0 * v to the accumulator, and
// multiply both by corr = 1, so stopping changes no bit.  With
// kv_len <= 0 every score is -1e30 and it walks all S positions, so the
// result is V's mean over the cache, as repro's.
//
// Offsets: B * S * G * Dh reaches 4.3e9 at decode_32k, so element
// offsets are 64-bit.
//
// Bound on the H100: bytes.  Each K and V element of the kv_len prefix is
// read once and takes 2 FMAs per q row of its group (r = 5 at qwen3-14b),
// far below the card's flops per byte.  This first version uses CUDA
// cores in f32, one CTA per (batch, group) and no split over kv: with
// batch 1 only G CTAs run.  Split-KV with a combine pass, cp.async or TMA
// double buffering, and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;        // kv positions per tile; kThreads == 2 * kTile
constexpr int kMaxR = 16;        // q rows per kv group
constexpr int kMaxDh = 256;
constexpr int kDimsPerThread = kMaxDh / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Copy n_rows rows of dh elements (row stride `stride` elements) into
// shared memory as f32, row stride `dst_stride`, with 16-byte loads.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int64_t stride, int n_rows,
                                           int dh, float* dst, int dst_stride) {
  constexpr int kPerVec = 16 / sizeof(T);
  const int n_vec = dh / kPerVec;
  for (int i = threadIdx.x; i < n_rows * n_vec; i += kThreads) {
    const int row = i / n_vec, c = i % n_vec;
    const uint4 raw = reinterpret_cast<const uint4*>(src + (int64_t)row * stride)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kPerVec; ++u) dst[row * dst_stride + c * kPerVec + u] = to_float(e[u]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q,              // (B, H, Dh)
    const T* __restrict__ k,              // (B, S, G, Dh)
    const T* __restrict__ v,              // (B, S, G, Dh)
    const int32_t* __restrict__ kv_len_ptr,
    T* __restrict__ out,                  // (B, H, Dh)
    int seq, int n_groups, int r, int dh, float scale) {
  extern __shared__ float smem[];
  const int ks = dh + 1;
  float* q_s = smem;                       // r x dh
  float* k_s = q_s + r * dh;               // kTile x (dh + 1)
  float* v_s = k_s + kTile * ks;           // kTile x dh
  float* p_s = v_s + kTile * dh;           // r x kTile: scores, then p in V's dtype
  float* corr_s = p_s + r * kTile;         // r
  float* l_s = corr_s + r;                 // r

  const int b = blockIdx.x / n_groups;
  const int g = blockIdx.x % n_groups;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t row_stride = (int64_t)n_groups * dh;  // between kv positions
  const T* kb = k + ((int64_t)b * seq * n_groups + g) * dh;
  const T* vb = v + ((int64_t)b * seq * n_groups + g) * dh;
  const int64_t q_off = ((int64_t)b * n_groups + g) * r * dh;  // rows g*r .. g*r+r-1 of head axis

  stage_rows(q + q_off, dh, r, dh, q_s, dh);
  const int kv_len = *kv_len_ptr;
  const int n_pos = kv_len >= 1 ? min(kv_len, seq) : seq;

  float m_run[kMaxR / kWarps], l_run[kMaxR / kWarps];  // rows warp + kWarps * j
#pragma unroll
  for (int j = 0; j < kMaxR / kWarps; ++j) { m_run[j] = kMasked; l_run[j] = 0.0f; }
  float acc[kMaxR][kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxR; ++i)
#pragma unroll
    for (int e = 0; e < kDimsPerThread; ++e) acc[i][e] = 0.0f;

  for (int p0 = 0; p0 < n_pos; p0 += kTile) {
    const int n_t = min(kTile, n_pos - p0);
    __syncthreads();  // the previous tile's reads of k_s, v_s, p_s are done
    stage_rows(kb + (int64_t)p0 * row_stride, row_stride, n_t, dh, k_s, ks);
    stage_rows(vb + (int64_t)p0 * row_stride, row_stride, n_t, dh, v_s, dh);
    __syncthreads();

    {  // scores of position pos against rows hv, hv + 2, ...
      const int pos = tid % kTile, hv = tid / kTile;
      float dot[kMaxR / 2];
#pragma unroll
      for (int j = 0; j < kMaxR / 2; ++j) dot[j] = 0.0f;
      if (pos < n_t) {
        for (int d = 0; d < dh; ++d) {
          const float kv = k_s[pos * ks + d];
#pragma unroll
          for (int j = 0; j < kMaxR / 2; ++j)
            if (hv + 2 * j < r) dot[j] = fmaf(q_s[(hv + 2 * j) * dh + d], kv, dot[j]);
        }
      }
      const bool masked = p0 + pos >= kv_len;
#pragma unroll
      for (int j = 0; j < kMaxR / 2; ++j)
        if (hv + 2 * j < r) p_s[(hv + 2 * j) * kTile + pos] = masked ? kMasked : dot[j] * scale;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxR / kWarps; ++j) {  // the online softmax of row warp + 4j
      const int row = warp + kWarps * j;
      if (row >= r) continue;  // the same for the whole warp
      float* s = p_s + row * kTile;
      const bool in0 = lane < n_t, in1 = lane + 32 < n_t;
      const float s0 = in0 ? s[lane] : kMasked, s1 = in1 ? s[lane + 32] : kMasked;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[j], mx);
      const float e0 = in0 ? expf(s0 - m_new) : 0.0f, e1 = in1 ? expf(s1 - m_new) : 0.0f;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m_run[j] - m_new);
      l_run[j] = l_run[j] * corr + sum;
      m_run[j] = m_new;
      s[lane] = to_float(from_float<T>(e0));  // p in V's dtype
      s[lane + 32] = to_float(from_float<T>(e1));
      if (lane == 0) corr_s[row] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < kDimsPerThread; ++e) {  // P.V into dims tid + 128 e
      const int d = tid + kThreads * e;
      if (d >= dh) continue;
#pragma unroll
      for (int i = 0; i < kMaxR; ++i)
        if (i < r) acc[i][e] *= corr_s[i];
      for (int pos = 0; pos < n_t; ++pos) {
        const float vv = v_s[pos * dh + d];
#pragma unroll
        for (int i = 0; i < kMaxR; ++i)
          if (i < r) acc[i][e] = fmaf(p_s[i * kTile + pos], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxR / kWarps; ++j) {
    const int row = warp + kWarps * j;
    if (row < r && lane == 0) l_s[row] = l_run[j];
  }
  __syncthreads();
  T* o = out + q_off;
#pragma unroll
  for (int e = 0; e < kDimsPerThread; ++e) {
    const int d = tid + kThreads * e;
    if (d >= dh) continue;
#pragma unroll
    for (int i = 0; i < kMaxR; ++i)
      if (i < r) o[(int64_t)i * dh + d] = from_float<T>(acc[i][e] / fmaxf(l_s[i], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* out,
           int batch, int seq, int n_groups, int r, int dh, float scale, void* stream) {
  if (r < 1 || r > kMaxR || dh < 8 || dh > kMaxDh || dh % 8) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)r * dh + (size_t)kTile * (dh + 1) + (size_t)kTile * dh +
                       (size_t)r * kTile + 2 * (size_t)r);
  // Raise the kernel's dynamic shared memory limit once per size, on the
  // first launch: a later launch may be inside a CUDA graph capture.
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  decode_kernel<T><<<batch * n_groups, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)kv_len, (T*)out, seq, n_groups, r,
      dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// B7 on float32 q, k, v.  Returns cudaGetLastError() after the launch.
extern "C" int decode_attn_f32(const void* q, const void* k, const void* v, const void* kv_len,
                               void* out, int batch, int seq, int n_groups, int r, int dh,
                               float scale, void* stream) {
  return launch<float>(q, k, v, kv_len, out, batch, seq, n_groups, r, dh, scale, stream);
}

// B7 on bfloat16 q, k, v: f32 statistics and accumulator, output in bf16.
extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v, const void* kv_len,
                                void* out, int batch, int seq, int n_groups, int r, int dh,
                                float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, out, batch, seq, n_groups, r, dh, scale, stream);
}
