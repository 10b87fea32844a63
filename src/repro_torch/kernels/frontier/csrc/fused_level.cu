// One fused BFS level of the S2 frontier path, on f32 frontier rows, for
// Hopper: kernel B1 on f32 tiles, kernel B3 on bit-plane tiles.
//
// Replaces the TPU kernel repro/kernels/frontier/frontier.py:
// fused_level_blocks with its bodies _fused_level_kernel (f32 tiles) and
// _fused_level_kernel_u32 (uint32 bit-plane tiles, unpacked by
// _unpack_tile_bits).  That kernel walks a sequential Pallas grid, one
// step per (output block, tile), and keeps the output block in VMEM
// across the consecutive steps of its run.  Here blocks run in parallel,
// so the grid is one CTA per run: the steps of output block k are
// run_ptr[k] .. run_ptr[k+1] (sorted by (o_row, o_col), exactly one run
// per output block, built by Stage B).
//
// A CTA has B * G threads in G groups of B, G = min(8, 1024 / B) rounded
// down to a power of two, so G divides B.  Thread j of group g owns
// output column j for the 8 stacked query rows and rows [g*B/G, (g+1)*B/G)
// of every tile; it keeps its 8 partial sums in registers across the
// whole run.  For each valid step the CTA stages the 8 x B frontier block
// in shared memory, then each thread walks its B/G tile rows: row v of
// the tile is contiguous, so neighbouring threads read neighbouring
// addresses, and f[r][v] is a shared-memory broadcast.  Splitting the rows
// over G groups puts G times as many tile loads in flight per step as one
// thread per column would, which is what a long run waits on.  At the end
// the groups' partial sums meet in shared memory and group 0 adds them in
// the fixed order g = 0 .. G-1 and stores the block once, with no atomics,
// so the result is deterministic.  A run made only of cover steps
// (valids == 0) stores zeros.
//
// The two kernels differ only in how thread j reads tile element (v, j):
// B1 reads the f32 value; B3 reads word j / 32 of bit-plane row v (the
// same word for the 32 threads of a warp: one broadcast load) and takes
// bit j % 32 as 0 or 1.  Columns past B in the last word are pad bits
// and are never read.  The FMAs and the fixed-order sum are the same.
//
// Bound on the H100: bytes.  A B1 level reads each real tile once (B*B*4
// bytes) and does 2*8 flops per tile element, 4 flops per byte, far below
// the card's ratio of flops to bytes.  B3 reads 1/32 of the tile bytes
// for the same flops, so its bound moves towards the frontier blocks and
// the output.  The design reads every tile byte once and the frontier
// block once per step; tensor cores, TMA and persistent CTAs are left for
// later work.
//
// Exact: operands are {0,1} and sums are integers below 2^24, so fp32 is
// exact in any order and equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQPad = 8;

// Tile element (v, j) as f32, given the start of tile row v.
__device__ __forceinline__ float tile_value(const float* row, int j) { return row[j]; }
__device__ __forceinline__ float tile_value(const uint32_t* row, int j) {
  return (float)((row[j >> 5] >> (j & 31)) & 1u);
}

// TileT = float: rows of B f32 values; TileT = uint32_t: rows of
// row_len = ceil(B / 32) bit-plane words.
template <typename TileT>
__global__ void fused_level_kernel(
    const float* __restrict__ frontier,   // (n_rows * 8, v_pad)
    const TileT* __restrict__ tiles,      // (n_tiles, B, row_len)
    const int32_t* __restrict__ valids,   // (n_steps,)
    const int32_t* __restrict__ tile_ids, // (n_steps,)
    const int32_t* __restrict__ f_rows,   // (n_steps,)
    const int32_t* __restrict__ f_cols,   // (n_steps,)
    const int32_t* __restrict__ o_rows,   // (n_steps,)
    const int32_t* __restrict__ o_cols,   // (n_steps,)
    const int32_t* __restrict__ run_ptr,  // (n_runs + 1,)
    float* __restrict__ out,              // (n_out_rows, v_pad)
    int v_pad, int block_size, int row_len) {
  // f_s: the 8 x B frontier block; part: the partial sums of groups 1..G-1
  extern __shared__ float smem[];
  float* f_s = smem;
  float* part = smem + kQPad * block_size;
  const int n_groups = blockDim.x / block_size;
  const int j = threadIdx.x % block_size;
  const int g = threadIdx.x / block_size;
  const int n_v = block_size / n_groups;
  const int v0 = g * n_v;
  const int lo = run_ptr[blockIdx.x];
  const int hi = run_ptr[blockIdx.x + 1];

  float acc[kQPad];
#pragma unroll
  for (int r = 0; r < kQPad; ++r) acc[r] = 0.0f;

  for (int i = lo; i < hi; ++i) {
    if (valids[i] == 0) continue;  // the same i for every thread: uniform
    const float* f_blk = frontier + (size_t)f_rows[i] * kQPad * v_pad +
                         (size_t)f_cols[i] * block_size;
    __syncthreads();  // the previous step's reads of f_s are done
    for (int k = threadIdx.x; k < kQPad * block_size; k += blockDim.x)
      f_s[k] = f_blk[(size_t)(k / block_size) * v_pad + k % block_size];
    __syncthreads();
    const TileT* tile = tiles + ((size_t)tile_ids[i] * block_size + v0) * row_len;
#pragma unroll 16
    for (int v = 0; v < n_v; ++v) {
      const float a = tile_value(tile + (size_t)v * row_len, j);
#pragma unroll
      for (int r = 0; r < kQPad; ++r) acc[r] = fmaf(f_s[r * block_size + v0 + v], a, acc[r]);
    }
  }

  if (g > 0) {
#pragma unroll
    for (int r = 0; r < kQPad; ++r) part[((g - 1) * kQPad + r) * block_size + j] = acc[r];
  }
  __syncthreads();
  if (g > 0) return;
  for (int h = 1; h < n_groups; ++h) {
#pragma unroll
    for (int r = 0; r < kQPad; ++r) acc[r] += part[((h - 1) * kQPad + r) * block_size + j];
  }
  float* o_blk = out + (size_t)o_rows[lo] * kQPad * v_pad + (size_t)o_cols[lo] * block_size;
#pragma unroll
  for (int r = 0; r < kQPad; ++r) o_blk[(size_t)r * v_pad + j] = acc[r];
}

// Launches one CTA of B * G threads per run on `stream`.  Returns
// cudaGetLastError() after the launch: nonzero means the launch was refused.
template <typename TileT>
int launch(const void* frontier, const void* tiles, const void* valids, const void* tile_ids,
           const void* f_rows, const void* f_cols, const void* o_rows, const void* o_cols,
           const void* run_ptr, void* out, int n_runs, int v_pad, int block_size, int row_len,
           void* stream) {
  int n_groups = 1;
  while (n_groups < 8 && block_size * n_groups * 2 <= 1024) n_groups *= 2;
  const size_t smem = sizeof(float) * kQPad * (size_t)block_size * n_groups;
  fused_level_kernel<TileT><<<n_runs, block_size * n_groups, smem, (cudaStream_t)stream>>>(
      (const float*)frontier, (const TileT*)tiles, (const int32_t*)valids,
      (const int32_t*)tile_ids, (const int32_t*)f_rows, (const int32_t*)f_cols,
      (const int32_t*)o_rows, (const int32_t*)o_cols, (const int32_t*)run_ptr,
      (float*)out, v_pad, block_size, row_len);
  return (int)cudaGetLastError();
}

}  // namespace

// B1: tiles (n_tiles, B, B) f32.
extern "C" int fused_level_f32(
    const void* frontier, const void* tiles, const void* valids, const void* tile_ids,
    const void* f_rows, const void* f_cols, const void* o_rows, const void* o_cols,
    const void* run_ptr, void* out, int n_runs, int v_pad, int block_size, void* stream) {
  return launch<float>(frontier, tiles, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
                       run_ptr, out, n_runs, v_pad, block_size, block_size, stream);
}

// B3: tiles (n_tiles, B, ceil(B / 32)) uint32 bit-planes.
extern "C" int fused_level_f32_u32tiles(
    const void* frontier, const void* tiles, const void* valids, const void* tile_ids,
    const void* f_rows, const void* f_cols, const void* o_rows, const void* o_cols,
    const void* run_ptr, void* out, int n_runs, int v_pad, int block_size, void* stream) {
  return launch<uint32_t>(frontier, tiles, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
                          run_ptr, out, n_runs, v_pad, block_size, (block_size + 31) / 32,
                          stream);
}
