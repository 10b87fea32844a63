// GQA flash decoding, for Hopper: kernel B7.
//
// Replaces the TPU kernel repro/kernels/decode_attn/decode_attn.py:
// flash_decode_gqa with its body _decode_kernel.  That kernel runs a
// grid of (batch x kv group, kv block); the kv-block axis is sequential
// on the TPU and carries the running max, sum and f32 accumulator of an
// online softmax in VMEM scratch across it, with all r = H / G q rows of
// the group in one tile.
//
// Bound on the H100: bytes.  Each K and V element of the kv_len prefix is
// read once (2 bytes in bf16) and takes 2 multiply-adds per q row of its
// group: at qwen3-14b's r = 5, 5 flops per byte, far below the card's
// 295 bf16 tensor-core flops per byte, but above what CUDA cores reach in
// f32 (decode_32k's 2.75e11 flops are 4.1 ms at the 67 TFLOP/s f32 peak,
// most of its 5.13 ms byte bound).  So the design has to keep HBM busy
// all the time, with the products off the CUDA cores:
//
// - Split-KV.  The grid is (B * G, n_split): CTA (bg, s) walks positions
//   [s * L, min(S, (s + 1) * L)) of one (batch, kv group).  The wrapper
//   picks n_split and L from B, G and S alone (never from kv_len, which
//   stays on the device), so that the grid holds >= 264 CTAs, twice the
//   132 SMs: long_500k's 8 groups run as 8 x 33 CTAs.
//   Each split writes f32 partials (m, l, acc) to a scratch tensor that
//   the wrapper allocates, and decode_combine_kernel merges the splits of
//   each (batch, group) in the fixed order 0 .. n_split-1:
//   m* = max m_s, l = sum l_s e^(m_s - m*), out = sum acc_s e^(m_s - m*) /
//   max(l, 1e-30), in q's dtype.  With n_split = 1 (decode_32k: 1,024
//   CTAs already) the main kernel writes the output itself.
// - An async ring.  K and V tiles arrive in shared memory by 16-byte
//   cp.async, in a ring of 3 stages, so that two tiles load while the CTA
//   computes on the third: one __syncthreads per tile, no register
//   staging, and rows past the split's end are zero-filled, never read.
// - bf16 on tensor cores (decode_bf16_kernel).  K and V stay bf16 in
//   shared memory (64 positions x Dh, 16-byte chunks XOR-swizzled by row
//   so that ldmatrix reads are free of bank conflicts): 100 KB a CTA at
//   Dh = 128, two CTAs an SM, each with two tiles in flight (staging in
//   f32 would double the bytes per tile).  The swizzle c ^ (row % 8) is a
//   bijection on a row's chunk slots only when their count is a multiple
//   of 8, so a row holds Dh / 8 chunks rounded up to one: at Dh = 112
//   (kimi-k2) 14 chunks in 16 slots, of which two per row are never loaded
//   or read, and the tile is as large as at Dh = 128.  Q.K^T and P.V run as
//   mma.sync.m16n8k16 bf16 -> f32: the group's r <= 16 q rows pad the
//   16-row A operand (read from shared memory by ldmatrix), K comes
//   through ldmatrix and V through ldmatrix.trans.  mma.sync rather than
//   wgmma: wgmma's 64-row side would be the kv positions, which needs the
//   P.V product with P as the B operand from shared memory; at r <= 16
//   the padded m16 tile wastes at most 3.2x of a tensor rate that is 60x
//   above what the bytes allow, so the simpler instruction costs nothing
//   that shows.  Each of the 4 warps owns 16 positions of every tile and
//   keeps its own online softmax in registers on the accumulator
//   fragments (f32 statistics, one quad shuffle for the row max), so the
//   warps never wait on each other inside a tile; they merge in shared
//   memory once, at the end, in the fixed order warp 0 .. 3.  As in
//   repro, p is rounded to bf16 before P.V and l sums the unrounded p.
// - f32 (decode_f32_kernel): the same grid, split and ring, with the
//   products as FMAs on CUDA cores: TF32 would break repro's 2e-5 f32
//   tolerance.  Tiles of 32 positions; K rows padded to Dh + 4 floats so
//   that float4 reads of neighbouring positions hit distinct banks (at
//   Dh = 112 a row is 116 floats, 20 banks on: the 8 lanes of a phase
//   still start 4 banks apart, and rows stay 16-byte aligned).
//
// Masking, as _decode_kernel: a position at or past kv_len scores -1e30.
// With kv_len >= 1 a split stops at kv_len: every later position would
// add exp(-1e30 - m) = 0 to the sum and 0 * v to the accumulator, so
// stopping changes no bit, and a split that starts at or past kv_len does
// no work and writes m = -1e30, l = 0, acc = 0 (merge weight 0).  With
// kv_len <= 0 every split walks all its positions with every score at
// -1e30, so the merge gives V's mean over all S positions, as in repro.
// Positions a tile holds past the end of its split (or of kv_len) are
// absent: they score -inf and weigh exactly 0.
//
// A cache sharded along the sequence (the seq-sharded decode over ranks):
// each rank holds positions [kv_offset, kv_offset + S) of the global
// cache and runs the split kernel on them with the global kv_len and its
// kv_offset.  A split's valid end is then kv_len - kv_offset (in shard
// positions) and "all masked" is still kv_len <= 0, so a shard that lies
// wholly past kv_len does no work and writes m = -1e30, l = 0, acc = 0:
// weight 0 in the merge.  (A local kv_len of 0 for it would read as all
// masked: it would walk its whole shard and report l = S at m = -1e30.)
// decode_partials_* write every split's partials, even one split's, and
// decode_combine_* merge any number of them: the ranks' partials are
// gathered and laid out as one split axis, rank-major.  At kv_offset 0
// and one rank, partials then combine are this file's own two launches.
//
// A rank of a tensor-parallel layer (models/transformer.py) holds some
// of the q heads and the whole cache: its heads read kv groups
// [g_offset, g_offset + n_groups) of the cache's kv_groups.  The grid and
// the q rows are the rank's (B * n_groups CTAs, r rows each); a CTA of
// group g reads cache group g_offset + g, whose positions lie
// kv_groups * Dh elements apart.  No slice of the cache is copied.
//
// Offsets: B * S * G * Dh reaches 4.3e9 at decode_32k, so element
// offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 16;      // q rows per kv group
constexpr int kStages = 3;     // ring depth
constexpr float kMasked = -1e30f;

// ---- PTX helpers ------------------------------------------------------------

// 16-byte async copy to shared memory; with ok false, 16 zero bytes and
// no read of src.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// What CTA (bg, split) reads and how it scores.
struct Split {
  int64_t row_stride;  // elements between kv positions: kv_groups * Dh
  int64_t kv_off;      // element offset of (b, position 0, g_offset + g, 0)
  int64_t q_off;       // element offset of q row g * r of batch b, = bg * r * Dh
  int p_lo;            // first position of the split
  int valid_end;       // positions at or past it are absent
  bool all_masked;     // kv_len <= 0: every present position scores -1e30
};

__device__ __forceinline__ Split split_of(int seq, int n_groups, int r, int dh, int split_len,
                                          int kv_len, int kv_offset, int kv_groups, int g_offset) {
  Split s;
  const int bg = blockIdx.x;
  const int b = bg / n_groups, g = bg % n_groups;
  s.row_stride = (int64_t)kv_groups * dh;
  s.kv_off = ((int64_t)b * seq * kv_groups + g_offset + g) * dh;
  s.q_off = (int64_t)bg * r * dh;
  s.p_lo = blockIdx.y * split_len;
  const int p_hi = min(seq, s.p_lo + split_len);
  s.all_masked = kv_len <= 0;
  // kv_len counts global positions; this cache's position p is kv_offset + p
  s.valid_end = s.all_masked ? p_hi : min(kv_len - kv_offset, p_hi);
  return s;
}

// Row i of the group's output (n_split == 1), or the split's partials:
// m at [0, N), l at [N, 2N), acc at 2N + ((bg * n_split + split) * r + i) * Dh
// with N = B * G * n_split * r.
template <typename T>
__device__ __forceinline__ void write_result(T* out, float* part, int64_t part_rows, int r,
                                             int dh, int i, int d, float m, float l, float acc) {
  const int64_t bg = blockIdx.x;
  if (part == nullptr) {
    out[(bg * r + i) * dh + d] = from_float<T>(acc / fmaxf(l, 1e-30f));
    return;
  }
  const int64_t row = (bg * gridDim.y + blockIdx.y) * r + i;
  if (d == 0) {
    part[row] = m;
    part[part_rows + row] = l;
  }
  part[2 * part_rows + row * dh + d] = acc;
}

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int kTile = 64;  // kv positions per tile; 16 per warp

// bf16 elements a shared row holds: Dh rounded up to 64 (8 chunk slots)
template <int Dh>
constexpr int kRowElems = (Dh + 63) / 64 * 64;

// Shared offset (in elements) of 16-byte chunk c of row `row` in a
// row-major tile of kRowElems<Dh> bf16 per row, chunks XOR-swizzled by
// row % 8: a bijection on the row's slots, of which chunks 0 .. Dh/8 - 1
// are used.
template <int Dh>
__device__ __forceinline__ int swz(int row, int c) {
  return row * kRowElems<Dh> + ((c ^ (row & 7)) << 3);
}

template <int Dh>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                             const __nv_bfloat16* k, const __nv_bfloat16* v,
                                             const Split& sp, int start) {
  constexpr int kChunks = Dh / 8;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int row = i / kChunks, c = i % kChunks;
    const int pos = start + row;
    const bool ok = pos < sp.valid_end;
    const int64_t off = sp.kv_off + (ok ? (int64_t)pos * sp.row_stride + c * 8 : 0);
    cp_async16(ks + swz<Dh>(row, c), k + off, ok);
    cp_async16(vs + swz<Dh>(row, c), v + off, ok);
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads) decode_bf16_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, H, Dh)
    const __nv_bfloat16* __restrict__ k,  // (B, S, G, Dh)
    const __nv_bfloat16* __restrict__ v,  // (B, S, G, Dh)
    const int32_t* __restrict__ kv_len_ptr,
    __nv_bfloat16* __restrict__ out,      // (B, H, Dh), when part is null
    float* __restrict__ part,             // split partials, or null
    int seq, int n_groups, int r, int split_len, int kv_offset, int kv_groups, int g_offset,
    float scale) {
  constexpr int kTileElems = kTile * kRowElems<Dh>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // stages x (K, V)
  __nv_bfloat16* q_s = ring + kStages * 2 * kTileElems;               // 16 rows

  const Split sp = split_of(seq, n_groups, r, Dh, split_len, *kv_len_ptr, kv_offset, kv_groups,
                            g_offset);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // q rows 0 .. r-1 of the group, zero rows up to 16
  for (int i = tid; i < kMaxR * (Dh / 8); i += kThreads) {
    const int row = i / (Dh / 8), c = i % (Dh / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < r) val = *reinterpret_cast<const uint4*>(q + sp.q_off + (int64_t)row * Dh + c * 8);
    *reinterpret_cast<uint4*>(q_s + swz<Dh>(row, c)) = val;
  }

  const int n_tiles = sp.valid_end > sp.p_lo ? (sp.valid_end - sp.p_lo + kTile - 1) / kTile : 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      load_kv_tile<Dh>(ring + st * 2 * kTileElems, ring + (st * 2 + 1) * kTileElems, k, v, sp,
                       sp.p_lo + st * kTile);
    cp_async_commit();
  }

  // this thread's rows of the accumulator fragments: g and g + 8
  const int g_row = lane / 4, quad = lane % 4;
  float m_run[2] = {kMasked, kMasked}, l_run[2] = {0.0f, 0.0f};
  float o[Dh / 8][4];
#pragma unroll
  for (int n = 0; n < Dh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for all; tile t-1's slot is free
    {
      const int nt = t + kStages - 1;
      const int slot = nt % kStages;
      if (nt < n_tiles)
        load_kv_tile<Dh>(ring + slot * 2 * kTileElems, ring + (slot * 2 + 1) * kTileElems, k, v,
                         sp, sp.p_lo + nt * kTile);
      cp_async_commit();
    }
    const __nv_bfloat16* ks = ring + (t % kStages) * 2 * kTileElems;
    const __nv_bfloat16* vs = ks + kTileElems;
    const int p0 = warp * 16;  // this warp's positions in the tile

    // S = Q K^T on 16 positions: two n8 tiles
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    const int mi = lane / 8, mrow = lane % 8;
#pragma unroll
    for (int kk = 0; kk < Dh / 16; ++kk) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, q_s + swz<Dh>((mi & 1) * 8 + mrow, kk * 2 + (mi >> 1)));
      ldmatrix_x4(b, ks + swz<Dh>(p0 + (mi >> 1) * 8 + mrow, kk * 2 + (mi & 1)));
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }

    // scale and mask; online softmax of rows g_row (e = 0, 1) and g_row + 8 (e = 2, 3)
    const int start = sp.p_lo + t * kTile + p0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = start + n * 8 + quad * 2 + (e & 1);
        float x = s[n][e];
        x = pos < sp.valid_end ? (sp.all_masked ? kMasked : x * scale) : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      corr[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;  // l sums the unrounded p
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + sum[h];
#pragma unroll
    for (int n = 0; n < Dh / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P, rounded to bf16, is the A operand straight from S's
    // accumulator fragments; V through ldmatrix.trans, two dh tiles a load
    uint32_t pa[4];
    pa[0] = pack_bf16(s[0][0], s[0][1]);
    pa[1] = pack_bf16(s[0][2], s[0][3]);
    pa[2] = pack_bf16(s[1][0], s[1][1]);
    pa[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int d2 = 0; d2 < Dh / 16; ++d2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + swz<Dh>(p0 + (mi & 1) * 8 + mrow, d2 * 2 + (mi >> 1)));
      mma_bf16(o[2 * d2], pa, b[0], b[1]);
      mma_bf16(o[2 * d2 + 1], pa, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the warps' merge

  // per warp: m, l of rows 0..15, and its accumulator rows in f32
  float* m_s = reinterpret_cast<float*>(smem_raw);  // kWarps x 16
  float* l_s = m_s + kWarps * kMaxR;                // kWarps x 16
  float* o_s = l_s + kWarps * kMaxR;                // kWarps x 16 x Dh
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    if (quad == 0) {
      m_s[warp * kMaxR + g_row + 8 * h] = m_run[h];
      l_s[warp * kMaxR + g_row + 8 * h] = l_run[h];
    }
  }
#pragma unroll
  for (int n = 0; n < Dh / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g_row + 8 * (e >> 1), d = n * 8 + quad * 2 + (e & 1);
      o_s[(warp * kMaxR + row) * Dh + d] = o[n][e];
    }
  __syncthreads();

  const int64_t part_rows = (int64_t)gridDim.x * gridDim.y * r;
  for (int idx = tid; idx < r * Dh; idx += kThreads) {
    const int i = idx / Dh, d = idx % Dh;
    float m = m_s[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, m_s[w * kMaxR + i]);
    float l = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {  // fixed order
      const float e = expf(m_s[w * kMaxR + i] - m);
      l += l_s[w * kMaxR + i] * e;
      acc += o_s[(w * kMaxR + i) * Dh + d] * e;
    }
    write_result<__nv_bfloat16>(out, part, part_rows, r, Dh, i, d, m, l, acc);
  }
}

// ---- f32: CUDA cores --------------------------------------------------------

constexpr int kTile32 = 32;  // kv positions per tile

template <int Dh>
__device__ __forceinline__ void load_kv_tile_f32(float* ks, float* vs, const float* k,
                                                 const float* v, const Split& sp, int start) {
  constexpr int kVecs = Dh / 4;
  for (int i = threadIdx.x; i < kTile32 * kVecs; i += kThreads) {
    const int row = i / kVecs, c = i % kVecs;
    const int pos = start + row;
    const bool ok = pos < sp.valid_end;
    const int64_t off = sp.kv_off + (ok ? (int64_t)pos * sp.row_stride + c * 4 : 0);
    cp_async16(ks + row * (Dh + 4) + c * 4, k + off, ok);
    cp_async16(vs + row * Dh + c * 4, v + off, ok);
  }
}

template <int Dh>
__global__ void __launch_bounds__(kThreads) decode_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int32_t* __restrict__ kv_len_ptr, float* __restrict__ out, float* __restrict__ part,
    int seq, int n_groups, int r, int split_len, int kv_offset, int kv_groups, int g_offset,
    float scale) {
  constexpr int kKs = Dh + 4;                       // padded K row
  constexpr int kStageFloats = kTile32 * (kKs + Dh);
  constexpr int kDims = (Dh + kThreads - 1) / kThreads;
  constexpr int kRowsPerWarp = kMaxR / kWarps;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                // stages x (K, V)
  float* q_s = ring + kStages * kStageFloats;        // r x Dh
  float* p_s = q_s + kMaxR * Dh;                     // 16 x kTile32: scores, then p
  float* corr_s = p_s + kMaxR * kTile32;             // 16
  float* m_s = corr_s + kMaxR;                       // 16
  float* l_s = m_s + kMaxR;                          // 16

  const Split sp = split_of(seq, n_groups, r, Dh, split_len, *kv_len_ptr, kv_offset, kv_groups,
                            g_offset);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < r * Dh; i += kThreads) q_s[i] = q[sp.q_off + i];

  const int n_tiles =
      sp.valid_end > sp.p_lo ? (sp.valid_end - sp.p_lo + kTile32 - 1) / kTile32 : 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      load_kv_tile_f32<Dh>(ring + st * kStageFloats, ring + st * kStageFloats + kTile32 * kKs, k,
                           v, sp, sp.p_lo + st * kTile32);
    cp_async_commit();
  }

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];  // rows warp + kWarps * j
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m_run[j] = kMasked;
    l_run[j] = 0.0f;
  }
  float acc[kMaxR][kDims];
#pragma unroll
  for (int i = 0; i < kMaxR; ++i)
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; tile t-1's slot and p_s are free
    {
      const int nt = t + kStages - 1;
      float* slot = ring + (nt % kStages) * kStageFloats;
      if (nt < n_tiles) load_kv_tile_f32<Dh>(slot, slot + kTile32 * kKs, k, v, sp, sp.p_lo + nt * kTile32);
      cp_async_commit();
    }
    const float* ks = ring + (t % kStages) * kStageFloats;
    const float* vs = ks + kTile32 * kKs;
    const int start = sp.p_lo + t * kTile32;

    {  // scores of position `lane` against rows warp, warp + 4, ...
      float dot[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) dot[j] = 0.0f;
      for (int d = 0; d < Dh; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + lane * kKs + d);
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int row = warp + kWarps * j;
          if (row < r) {
            const float4 qv = *reinterpret_cast<const float4*>(q_s + row * Dh + d);
            dot[j] = fmaf(qv.x, kv.x, dot[j]);
            dot[j] = fmaf(qv.y, kv.y, dot[j]);
            dot[j] = fmaf(qv.z, kv.z, dot[j]);
            dot[j] = fmaf(qv.w, kv.w, dot[j]);
          }
        }
      }
      const int pos = start + lane;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int row = warp + kWarps * j;
        if (row >= r) continue;
        // the online softmax of row `row`, one position per lane
        const float x =
            pos < sp.valid_end ? (sp.all_masked ? kMasked : dot[j] * scale) : -INFINITY;
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[j], mx);
        const float p = expf(x - m_new);
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float corr = expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * corr + sum;
        m_run[j] = m_new;
        p_s[row * kTile32 + lane] = p;
        if (lane == 0) corr_s[row] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < kDims; ++e) {  // P.V into dims tid + 128 e
      const int d = tid + kThreads * e;
      if (d >= Dh) continue;
#pragma unroll
      for (int i = 0; i < kMaxR; ++i)
        if (i < r) acc[i][e] *= corr_s[i];
      for (int pos = 0; pos < kTile32; ++pos) {
        const float vv = vs[pos * Dh + d];
#pragma unroll
        for (int i = 0; i < kMaxR; ++i)
          if (i < r) acc[i][e] = fmaf(p_s[i * kTile32 + pos], vv, acc[i][e]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int row = warp + kWarps * j;
    if (row < r && lane == 0) {
      m_s[row] = m_run[j];
      l_s[row] = l_run[j];
    }
  }
  __syncthreads();
  const int64_t part_rows = (int64_t)gridDim.x * gridDim.y * r;
#pragma unroll
  for (int e = 0; e < kDims; ++e) {
    const int d = tid + kThreads * e;
    if (d >= Dh) continue;
#pragma unroll
    for (int i = 0; i < kMaxR; ++i)
      if (i < r) write_result<float>(out, part, part_rows, r, Dh, i, d, m_s[i], l_s[i], acc[i][e]);
  }
}

// ---- the merge of the splits --------------------------------------------------

// One CTA per (batch, group), one thread per output dim: for each q row,
// the splits merge in the fixed order 0 .. n_split-1.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                                      int n_split, int r, int dh) {
  const int64_t bg = blockIdx.x;
  const int64_t part_rows = (int64_t)gridDim.x * n_split * r;
  const float* m_p = part;
  const float* l_p = part + part_rows;
  const float* acc_p = part + 2 * part_rows;
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    for (int i = 0; i < r; ++i) {
      float m = kMasked;
      for (int s = 0; s < n_split; ++s) m = fmaxf(m, m_p[(bg * n_split + s) * r + i]);
      float l = 0.0f, acc = 0.0f;
      for (int s = 0; s < n_split; ++s) {
        const int64_t row = (bg * n_split + s) * r + i;
        const float e = expf(m_p[row] - m);
        l += l_p[row] * e;
        acc += acc_p[row * dh + d] * e;
      }
      out[(bg * r + i) * dh + d] = from_float<T>(acc / fmaxf(l, 1e-30f));
    }
  }
}

// A kernel attribute is set per device, so launch state is kept per
// device: one process that drives several cards raises each card's limit.
constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared memory limit once per kernel and device,
// on its first launch there: a later launch may be inside a CUDA graph
// capture.  `raised` holds each device's limit so far (0: the default
// 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t (&raised)[kMaxDevices]) {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (smem <= (raised[dev] ? raised[dev] : 48 * 1024)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) raised[dev] = smem;
  return err;
}

// The merge of n_split partials per (batch, group) into out.
template <typename T>
int launch_combine(const void* part, void* out, int batch_groups, int n_split, int r, int dh,
                   cudaStream_t stream) {
  decode_combine_kernel<T><<<batch_groups, dh, 0, stream>>>((const float*)part, (T*)out, n_split,
                                                            r, dh);
  return (int)cudaGetLastError();
}

// The split kernel, then the merge when it wrote partials; with
// partials_only the partials are the result, even of one split.
template <typename T, int Dh>
int launch_dh(const void* q, const void* k, const void* v, const void* kv_len, void* out,
              void* part, int batch, int seq, int n_groups, int r, int n_split, int split_len,
              int kv_offset, int kv_groups, int g_offset, bool partials_only, float scale,
              cudaStream_t stream) {
  const dim3 grid(batch * n_groups, n_split);
  float* partials = n_split > 1 || partials_only ? (float*)part : nullptr;
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = sizeof(__nv_bfloat16) * (kStages * 2 * kTile + kMaxR) * kRowElems<Dh>;
    if ((err = allow_smem(decode_bf16_kernel<Dh>, smem, allowed)) != cudaSuccess) return (int)err;
    decode_bf16_kernel<Dh><<<grid, kThreads, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const int32_t*)kv_len, (__nv_bfloat16*)out, partials, seq, n_groups, r, split_len,
        kv_offset, kv_groups, g_offset, scale);
  } else {
    const size_t smem = sizeof(float) * (kStages * kTile32 * (2 * Dh + 4) + kMaxR * Dh +
                                         kMaxR * kTile32 + 3 * kMaxR);
    if ((err = allow_smem(decode_f32_kernel<Dh>, smem, allowed)) != cudaSuccess) return (int)err;
    decode_f32_kernel<Dh><<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const int32_t*)kv_len, (float*)out,
        partials, seq, n_groups, r, split_len, kv_offset, kv_groups, g_offset, scale);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || partials == nullptr || partials_only)
    return (int)err;
  return launch_combine<T>(part, out, batch * n_groups, n_split, r, Dh, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* out, void* part,
           int batch, int seq, int n_groups, int r, int dh, int n_split, int split_len,
           int kv_offset, int kv_groups, int g_offset, bool partials_only, float scale,
           void* stream) {
  if (r < 1 || r > kMaxR || n_split < 1 || split_len < 1 || split_len % kTile ||
      kv_offset < 0 || g_offset < 0 || n_groups < 1 || g_offset + n_groups > kv_groups ||
      ((n_split > 1 || partials_only) && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 64:
      return launch_dh<T, 64>(q, k, v, kv_len, out, part, batch, seq, n_groups, r, n_split,
                              split_len, kv_offset, kv_groups, g_offset, partials_only, scale, s);
    case 112:
      return launch_dh<T, 112>(q, k, v, kv_len, out, part, batch, seq, n_groups, r, n_split,
                               split_len, kv_offset, kv_groups, g_offset, partials_only, scale, s);
    case 128:
      return launch_dh<T, 128>(q, k, v, kv_len, out, part, batch, seq, n_groups, r, n_split,
                               split_len, kv_offset, kv_groups, g_offset, partials_only, scale, s);
    case 256:
      return launch_dh<T, 256>(q, k, v, kv_len, out, part, batch, seq, n_groups, r, n_split,
                               split_len, kv_offset, kv_groups, g_offset, partials_only, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int combine(const void* part, void* out, int batch, int n_groups, int r, int dh, int n_split,
            void* stream) {
  if (batch < 1 || n_groups < 1 || r < 1 || r > kMaxR || n_split < 1 || dh < 1 || dh > 1024)
    return (int)cudaErrorInvalidValue;
  return launch_combine<T>(part, out, batch * n_groups, n_split, r, dh, (cudaStream_t)stream);
}

}  // namespace

// B7 on float32 q, k, v.  part: B * G * n_split * r * (Dh + 2) f32 of
// scratch when n_split > 1.  The heads read groups [g_offset, g_offset +
// n_groups) of a cache of kv_groups.  Returns cudaGetLastError() after
// the launches.
extern "C" int decode_attn_f32(const void* q, const void* k, const void* v, const void* kv_len,
                               void* out, void* part, int batch, int seq, int n_groups, int r,
                               int dh, int n_split, int split_len, int kv_groups, int g_offset,
                               float scale, void* stream) {
  return launch<float>(q, k, v, kv_len, out, part, batch, seq, n_groups, r, dh, n_split,
                       split_len, 0, kv_groups, g_offset, false, scale, stream);
}

// B7 on bfloat16 q, k, v: tensor-core products, f32 statistics and
// accumulator, output in bf16.
extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v, const void* kv_len,
                                void* out, void* part, int batch, int seq, int n_groups, int r,
                                int dh, int n_split, int split_len, int kv_groups, int g_offset,
                                float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, out, part, batch, seq, n_groups, r, dh, n_split,
                               split_len, 0, kv_groups, g_offset, false, scale, stream);
}

// B7's split kernel alone on a cache that holds the global positions
// [kv_offset, kv_offset + seq), against the global kv_len: every split's
// f32 partials in part (B * G * n_split * r * (Dh + 2) floats: m, then l,
// then acc), even with one split.
extern "C" int decode_partials_f32(const void* q, const void* k, const void* v,
                                   const void* kv_len, void* part, int batch, int seq,
                                   int n_groups, int r, int dh, int n_split, int split_len,
                                   int kv_offset, int kv_groups, int g_offset, float scale,
                                   void* stream) {
  return launch<float>(q, k, v, kv_len, nullptr, part, batch, seq, n_groups, r, dh, n_split,
                       split_len, kv_offset, kv_groups, g_offset, true, scale, stream);
}

extern "C" int decode_partials_bf16(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* part, int batch, int seq,
                                    int n_groups, int r, int dh, int n_split, int split_len,
                                    int kv_offset, int kv_groups, int g_offset, float scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, nullptr, part, batch, seq, n_groups, r, dh,
                               n_split, split_len, kv_offset, kv_groups, g_offset, true, scale,
                               stream);
}

// B7's combine kernel alone: n_split partials per (batch, group) in
// part's layout merged into out (B, G * r, Dh), in q's type.
extern "C" int decode_combine_f32(const void* part, void* out, int batch, int n_groups, int r,
                                  int dh, int n_split, void* stream) {
  return combine<float>(part, out, batch, n_groups, r, dh, n_split, stream);
}

extern "C" int decode_combine_bf16(const void* part, void* out, int batch, int n_groups, int r,
                                   int dh, int n_split, void* stream) {
  return combine<__nv_bfloat16>(part, out, batch, n_groups, r, dh, n_split, stream);
}
