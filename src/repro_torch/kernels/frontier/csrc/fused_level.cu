// One fused BFS level of the S2 frontier path, on f32 tiles, for Hopper.
//
// Replaces the TPU kernel repro/kernels/frontier/frontier.py:
// fused_level_blocks with its f32 body _fused_level_kernel.  That kernel
// walks a sequential Pallas grid, one step per (output block, tile), and
// keeps the output block in VMEM across the consecutive steps of its run.
// Here blocks run in parallel, so the grid is one CTA per run: the steps
// of output block k are run_ptr[k] .. run_ptr[k+1] (sorted by
// (o_row, o_col), exactly one run per output block, built by Stage B).
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
// Bound on the H100: bytes.  A level reads each real tile once (B*B*4
// bytes) and does 2*8 flops per tile element, 4 flops per byte, far below
// the card's ratio of flops to bytes.  The design reads every tile byte
// once and the frontier block once per step; tensor cores, TMA and
// persistent CTAs are left for later work.
//
// Exact: operands are {0,1} and sums are integers below 2^24, so fp32 is
// exact in any order and equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQPad = 8;

__global__ void fused_level_f32_kernel(
    const float* __restrict__ frontier,   // (n_rows * 8, v_pad)
    const float* __restrict__ tiles,      // (n_tiles, B, B)
    const int32_t* __restrict__ valids,   // (n_steps,)
    const int32_t* __restrict__ tile_ids, // (n_steps,)
    const int32_t* __restrict__ f_rows,   // (n_steps,)
    const int32_t* __restrict__ f_cols,   // (n_steps,)
    const int32_t* __restrict__ o_rows,   // (n_steps,)
    const int32_t* __restrict__ o_cols,   // (n_steps,)
    const int32_t* __restrict__ run_ptr,  // (n_runs + 1,)
    float* __restrict__ out,              // (n_out_rows, v_pad)
    int v_pad, int block_size) {
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
    const float* tile = tiles + (size_t)tile_ids[i] * block_size * block_size +
                        (size_t)v0 * block_size + j;
#pragma unroll 16
    for (int v = 0; v < n_v; ++v) {
      const float a = tile[(size_t)v * block_size];
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

}  // namespace

// Launches one CTA of B * G threads per run on `stream`.  Returns
// cudaGetLastError() after the launch: nonzero means the launch was refused.
extern "C" int fused_level_f32(
    const void* frontier, const void* tiles, const void* valids, const void* tile_ids,
    const void* f_rows, const void* f_cols, const void* o_rows, const void* o_cols,
    const void* run_ptr, void* out, int n_runs, int v_pad, int block_size, void* stream) {
  int n_groups = 1;
  while (n_groups < 8 && block_size * n_groups * 2 <= 1024) n_groups *= 2;
  const size_t smem = sizeof(float) * kQPad * (size_t)block_size * n_groups;
  fused_level_f32_kernel<<<n_runs, block_size * n_groups, smem, (cudaStream_t)stream>>>(
      (const float*)frontier, (const float*)tiles, (const int32_t*)valids,
      (const int32_t*)tile_ids, (const int32_t*)f_rows, (const int32_t*)f_cols,
      (const int32_t*)o_rows, (const int32_t*)o_cols, (const int32_t*)run_ptr,
      (float*)out, v_pad, block_size);
  return (int)cudaGetLastError();
}
