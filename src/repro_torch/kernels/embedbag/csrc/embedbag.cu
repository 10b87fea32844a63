// EmbeddingBag (sum) over lookups sorted by bag, for Hopper: kernel B6.
//
// Replaces the TPU kernel repro/kernels/embedbag/embedbag.py:
// embedding_bag_sorted with its body _bag_kernel.  That kernel walks a
// sequential Pallas grid, one lookup per step: the table row idx[i] is
// DMAed in by the input BlockSpec and added into output row bags[i] of
// the table's dtype, which is zeroed at the bag's first lookup.  So a
// bag sums its rows in sorted order, and a bf16 sum is rounded to bf16
// after every lookup.  This kernel computes the same sums in the same
// order: f32 tables add in f32, and on bf16 tables
//     acc = __float2bfloat16_rn(__bfloat162float(acc) + __bfloat162float(row))
// after every lookup.  Every bag is written; a bag no lookup visits gets
// zeros.
//
// Bound on the H100: bytes.  Each lookup reads one row and does D
// additions, far below the card's rate.  The least traffic is every
// distinct row read once, the two index arrays and the output written
// once; the gathered rows, at 32-byte sectors, are what a walk in sorted
// order moves when the table is many times the 50 MB L2.  A one-lookup
// bag's row is one load and one store, so the body must keep many rows
// in flight and pay no chain of dependent loads per bag.
//
// Design.
// * Work is split by lookups, not by bags: no offsets array, no second
//   launch.  A unit is a group of G lanes (G a power of two up to 32)
//   that owns the lookups [s, s + per_unit) (the last unit also owns
//   position n).  It sums every bag whose first lookup lies in its range,
//   reading past the range's end to finish its last bag, so the sum
//   order is the sorted order and no atomics are needed.  At each bag's
//   first lookup q it also writes zeros for the empty bag ids between
//   bags[q-1] (or -1) and bags[q]; position n stands for a last bag
//   n_bags, so the owner of n writes the ids after the last bag, and with
//   n = 0 all of them.
// * The unit reads its lookups a window of G at a time: lane g loads
//   idx and bags of position base + g in one coalesced evict-first load
//   (__ldcs), and the next window is loaded before this one is summed.
//   Bag starts and the end of the unit's stream come from two ballots;
//   rows and bag ids are handed out by __shfl_sync.
// * Lane g owns a vector of kVec columns (16 bytes where the row allows,
//   else 8, 4 or 2), so a row is one load per lane: D = 100 f32 is 25
//   lanes of float4, D = 128 bf16 16 lanes, two one-lookup bags per warp
//   instruction.  The vector width divides D and the table's alignment,
//   so no load leaves its row; lanes past D are masked.  Wider rows take
//   more column chunks (blockIdx.y), each a walk of its own.
// * kInFlight (4) rows are loaded before the first of them is added; the
//   adds then run in sorted order in registers.  Eight cost registers,
//   so resident warps, and ran slower at ogb_products: there more warps
//   serve better than more rows a warp.
// * Outputs are written with evict-first stores (__stcs); table rows go
//   through the read-only path and keep L2 for reuse.
// No shared memory is used, so no launch needs a raised limit.
//
// Reuse: a row looked up by several bags comes from L2 only if it is
// still there.  At ogb_products (a 0.98 GB table, ~25 lookups a row in
// random order) it almost never is, so the gathered sectors bound the
// time.  Walking 32-byte feature slices of a slice-major copy, one pass
// per slice over an array of ~1.6 L2s, kept the sum order but measured
// five times slower on the H100 (PERF.md §6), so rows are gathered
// whole.
//
// Address arithmetic: a row offset idx * d exceeds 2^31 at DLRM's
// largest table (39,979,771 x 128), so it is computed in 64 bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kInFlight = 4;  // rows loaded before the first of them is added

template <int Bytes> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

// an element's bits, its value as f32, and one lookup's add in the
// table's dtype
template <typename T> struct Elem;
template <> struct Elem<float> {
  using bits = float;
  static __device__ __forceinline__ float value(float b) { return b; }
  static __device__ __forceinline__ float pack(float x) { return x; }
  static __device__ __forceinline__ float add(float acc, float x) { return acc + x; }
};
template <> struct Elem<__nv_bfloat16> {
  using bits = unsigned short;
  static __device__ __forceinline__ float value(unsigned short b) {
    return __uint_as_float((unsigned int)b << 16);
  }
  static __device__ __forceinline__ unsigned short pack(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float add(float acc, float x) {
    return __bfloat162float(__float2bfloat16_rn(acc + x));
  }
};

template <typename T, int VecBytes, int G>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const T* __restrict__ table,          // (R, d)
    const int32_t* __restrict__ idx,      // (n,) rows, sorted by bag
    const int32_t* __restrict__ bags,     // (n,) non-decreasing bag ids in [0, n_bags)
    T* __restrict__ out,                  // (n_bags, d)
    int n, int n_bags, int d, int per_unit) {
  using E = Elem<T>;
  using V = typename Vec<VecBytes>::type;
  constexpr int kVec = VecBytes / (int)sizeof(T);
  constexpr int K = G < kInFlight ? G : kInFlight;
  constexpr unsigned kLow = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  union Pack {
    V v;
    typename E::bits e[kVec];
  };

  const int lane = threadIdx.x % 32;
  const int g = lane % G;
  const int shift = lane / G * G;
  const unsigned mask = kLow << shift;
  const int64_t unit = (int64_t)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (unit > (int64_t)n / per_unit) return;  // whole groups leave together
  const int s = (int)(unit * per_unit);
  const int e = (int)min((int64_t)s + per_unit, (int64_t)n + 1);

  const int col = blockIdx.y * (G * kVec) + g * kVec;
  const bool has_cols = col < d;
  const T* tab = table + col;
  T* o = out + col;

  auto store = [&](int bag, const float* acc) {
    if (!has_cols) return;
    Pack p;
#pragma unroll
    for (int v = 0; v < kVec; ++v) p.e[v] = E::pack(acc[v]);
    __stcs(reinterpret_cast<V*>(o + (int64_t)bag * d), p.v);
  };
  auto zero_rows = [&](int lo, int hi) {  // bags lo .. hi - 1
    if (!has_cols) return;
    Pack p;
#pragma unroll
    for (int v = 0; v < kVec; ++v) p.e[v] = E::pack(0.0f);
    for (int b = lo; b < hi; ++b) __stcs(reinterpret_cast<V*>(o + (int64_t)b * d), p.v);
  };
  auto load_window = [&](int base, int& w_idx, int& w_bag) {
    const int q = base + g;
    w_idx = 0;
    w_bag = n_bags;  // position n and past: the last bag's stand-in
    if (q < n) {
      w_idx = __ldcs(idx + q);
      w_bag = __ldcs(bags + q);
    }
  };

  float acc[kVec];
  int cur = -1;  // the bag summed in acc
  bool have = false, started = false;
  int base = s;
  int prev = s > 0 ? __ldcs(bags + s - 1) : -1;  // bag of position base - 1
  int w_idx, w_bag;
  load_window(base, w_idx, w_bag);
  auto advance = [&](int nx_idx, int nx_bag) {
    prev = __shfl_sync(mask, w_bag, G - 1, G);
    base += G;
    w_idx = nx_idx;
    w_bag = nx_bag;
  };
  // one window; true once the group's walk is over
  auto window = [&]() -> bool {
    int nx_idx, nx_bag;
    load_window(base + G, nx_idx, nx_bag);
    const int q = base + g;
    int up = __shfl_up_sync(mask, w_bag, 1, G);
    if (g == 0) up = prev;
    const bool is_start = w_bag != up;
    const unsigned starts = (__ballot_sync(mask, is_start) >> shift) & kLow;
    const unsigned stops = (__ballot_sync(mask, q >= n || (is_start && q >= e)) >> shift) & kLow;
    int j = 0;
    if (!started) {
      if (starts == 0) {  // the previous unit's bag goes on
        if (base + G >= e) return true;
        advance(nx_idx, nx_bag);
        return false;
      }
      j = __ffs(starts) - 1;
      if (base + j >= e) return true;  // no bag starts in this unit's range
      started = true;
    }
    const int stop = stops ? __ffs(stops) - 1 : G;
    for (; j < stop; j += K) {
      const int cnt = min(K, stop - j);
      Pack rows[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = __shfl_sync(mask, w_idx, (j + k) & (G - 1), G);
        if (k < cnt && has_cols) rows[k].v = __ldg(reinterpret_cast<const V*>(tab + (int64_t)r * d));
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k < cnt) {
          const int b = __shfl_sync(mask, w_bag, j + k, G);
          const int before = __shfl_sync(mask, up, j + k, G);
          if ((starts >> (j + k)) & 1u) {
            if (have) store(cur, acc);
            zero_rows(before + 1, b);
            cur = b;
            have = true;
#pragma unroll
            for (int v = 0; v < kVec; ++v) acc[v] = 0.0f;
          }
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[v] = E::add(acc[v], E::value(rows[k].e[v]));
        }
      }
    }
    if (stop < G) {
      if (have) store(cur, acc);
      if (base + stop == n && n < e) zero_rows(__shfl_sync(mask, up, stop, G) + 1, n_bags);
      return true;
    }
    advance(nx_idx, nx_bag);
    return false;
  };
  // The lane groups of a warp take their windows in step: the vote joins
  // them again after every window, where walks that had parted would
  // otherwise run one group after another.
  bool done = false;
  do {
    if (!done) done = window();
  } while (!__all_sync(0xffffffffu, done));
}

template <typename T, int VecBytes, int G>
int launch_g(const void* table, const void* idx, const void* bags, void* out, int n, int n_bags,
             int d, int n_chunks, int per_unit, cudaStream_t stream) {
  const int64_t n_units = (int64_t)n / per_unit + 1;
  const int64_t n_blocks = (n_units + kThreads / G - 1) / (kThreads / G);
  if (n_blocks > 0x7fffffff || n_chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  embedding_bag_kernel<T, VecBytes, G><<<dim3((unsigned)n_blocks, n_chunks), kThreads, 0, stream>>>(
      (const T*)table, (const int32_t*)idx, (const int32_t*)bags, (T*)out, n, n_bags, d, per_unit);
  return (int)cudaGetLastError();
}

template <typename T, int VecBytes>
int launch_v(int lanes, const void* table, const void* idx, const void* bags, void* out, int n,
             int n_bags, int d, int n_chunks, int per_unit, cudaStream_t stream) {
  switch (lanes) {
#define B6_LANES(G)                                                                         \
  case G:                                                                                   \
    return launch_g<T, VecBytes, G>(table, idx, bags, out, n, n_bags, d, n_chunks, per_unit, \
                                    stream);
    B6_LANES(2) B6_LANES(4) B6_LANES(8) B6_LANES(16) B6_LANES(32)
#undef B6_LANES
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(int vec_bytes, int lanes, const void* table, const void* idx, const void* bags,
           void* out, int n, int n_bags, int d, int n_chunks, int per_unit, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (per_unit < lanes || per_unit % lanes != 0) return (int)cudaErrorInvalidValue;
  switch (vec_bytes) {
#define B6_VEC(B)                                                                            \
  case B:                                                                                    \
    return launch_v<T, B>(lanes, table, idx, bags, out, n, n_bags, d, n_chunks, per_unit, st);
    B6_VEC(16) B6_VEC(8) B6_VEC(4)
#undef B6_VEC
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_v<T, 2>(lanes, table, idx, bags, out, n, n_bags, d, n_chunks, per_unit, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// B6 on a float32 table: lanes (G) and vec_bytes (16, 8 or 4) as the
// wrapper chose them, n_chunks column chunks of lanes x vec_bytes bytes.
// Returns cudaGetLastError() after the launch.
extern "C" int embedding_bag_f32(const void* table, const void* idx, const void* bags, void* out,
                                 int n, int n_bags, int d, int n_chunks, int vec_bytes, int lanes,
                                 int per_unit, void* stream) {
  return launch<float>(vec_bytes, lanes, table, idx, bags, out, n, n_bags, d, n_chunks, per_unit,
                       stream);
}

// B6 on a bfloat16 table, rounded to bf16 after every lookup; vec_bytes
// may also be 2.
extern "C" int embedding_bag_bf16(const void* table, const void* idx, const void* bags, void* out,
                                  int n, int n_bags, int d, int n_chunks, int vec_bytes, int lanes,
                                  int per_unit, void* stream) {
  return launch<__nv_bfloat16>(vec_bytes, lanes, table, idx, bags, out, n, n_bags, d, n_chunks,
                               per_unit, stream);
}
