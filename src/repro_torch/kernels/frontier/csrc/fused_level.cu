// One fused BFS level of the S2 frontier path, on f32 frontier rows, for
// Hopper: kernel B1 on f32 tiles, kernel B3 on bit-plane tiles; and B1's
// device code on the trivial schedule of one label store: kernel B5, the
// per-transition step of the baseline path.
//
// B1 and B3 replace the TPU kernel repro/kernels/frontier/frontier.py:
// fused_level_blocks with its bodies _fused_level_kernel (f32 tiles) and
// _fused_level_kernel_u32 (uint32 bit-plane tiles, unpacked by
// _unpack_tile_bits).  That kernel walks a sequential Pallas grid, one
// step per (output block, tile), and keeps the output block in VMEM
// across the consecutive steps of its run.
//
// B1 (fused_level_kernel): blocks run in parallel, so the grid is one CTA
// per run: the steps of output block k are run_ptr[k] .. run_ptr[k+1]
// (sorted by (o_row, o_col), exactly one run per output block, built by
// Stage B).  A CTA has B * G threads in G groups of B, G = min(8, 1024 /
// B) rounded down to a power of two, so G divides B.  Thread j of group g
// owns output column j for the 8 stacked query rows and rows
// [g*B/G, (g+1)*B/G) of every tile; it keeps its 8 partial sums in
// registers across the whole run.  For each valid step the CTA stages the
// 8 x B frontier block in shared memory, then each thread walks its B/G
// tile rows: row v of the tile is contiguous, so neighbouring threads read
// neighbouring addresses, and f[r][v] is a shared-memory broadcast.  At
// the end the groups' partial sums meet in shared memory and group 0 adds
// them in the fixed order g = 0 .. G-1 and stores the block once, with no
// atomics.  A run made only of cover steps (valids == 0) stores zeros.
//
// B5 replaces repro/kernels/frontier/frontier.py: frontier_step_blocks
// with its body _frontier_kernel, which walks one step per tile i of one
// label store and adds F[:, rows[i]] @ tiles[i] into output column block
// cols[i], zeroing the block at its first visit (cols is non-decreasing,
// so the tiles of one output block are consecutive).  Its schedule is
// trivial: step i reads frontier column block rows[i] and tile i, every
// step is valid, and run k (run_ptr[k] .. run_ptr[k+1], built once on the
// host with the store) writes column block cols[run_ptr[k]].  Its frontier
// has m_pad rows, any multiple of 8 (the baseline fills row 0 of 8), so
// the grid is one CTA per (run, 8-row block): blockIdx.y picks the rows
// the CTA reads and writes.  Column blocks that no run visits are never
// written: the wrapper allocates the output zeroed.  A Schedule type says
// where a step reads and where a run writes; the kernel body is the same
// for B1 and B5.
//
// Bound on the H100, B1: bytes.  A B1 level reads each real tile once
// (B*B*4 bytes) and does 2*8 flops per tile element, 4 flops per byte,
// far below the card's ratio of flops to bytes.
//
// B3 (bitplane_level_kernel) has a design of its own.  Its bound is bytes
// too, but its bytes are few: a q1 level of the Alibaba twin reads 0.5 MB
// of bit-plane tiles and writes a 6.4 MB output, 2.1 us at 3.35 TB/s.
// What held B1's design at ~100 us there is latency, not bytes: 19 runs
// carry all 241 valid steps, the longest 24, and each step was a chain
// of dependent global loads (schedule, frontier block, tile word) behind
// a __syncthreads, while 1,545 cover-only CTAs stored zeros.  So B3
// trades the run for parallelism:
//
// - Stage B cuts every run's valid steps into chunks of at most C (= 2,
//   ops.WORK_CHUNK) steps, each chunk inside one run; cover steps get no
//   entry (ops.level_work, the plan's `work`, built once per plan).  The
//   grid is one CTA of <= 256 threads per chunk: 121-190 CTAs at q1-q12.
// - A CTA reads its chunk's schedule entries (tile, frontier block,
//   output block of each step) in one pass, one thread per step, then
//   issues every frontier block (8 x B f32) and every bit-plane tile
//   (B x ceil(B/32) words, 2 KB at B = 128) of the chunk into shared
//   memory with 16-byte cp.async, before any compute: three dependent
//   global round trips per CTA in all, whatever the run's length.  (At
//   B > 512 the operands of a chunk exceed 96 KB and are staged in
//   passes of as many steps as fit.)
// - Thread (g, j) of G groups owns column j and tile rows
//   [g*B/G, (g+1)*B/G); it reads four frontier columns per row as one
//   float4 broadcast and takes bit j % 32 of word j / 32 of each tile
//   row in registers (the 32 threads of a warp read the same word).
// - Each thread adds its 8 nonzero sums into the output with atomicAdd.
//   The wrapper zeroes the output, so cover-only blocks need no CTA.
//
// Exact in any order: B3's callers (reach_fixpoint, multi_query_reach)
// pass {0,1} frontiers, and repro's counting path refuses bit-plane tiles
// (_require_f32_tiles, ROADMAP A9), so every operand is 0 or 1 and every
// sum an integer below 2^24, which f32 adds exactly in any order.  The
// atomics therefore give the plain PyTorch version's result bit for bit,
// every run.  Tensor cores buy nothing here: a q1 level is 63 MFLOP.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kQPad = 8;

// Tile element (v, j) as f32, given the start of tile row v.
__device__ __forceinline__ float tile_value(const float* row, int j) { return row[j]; }

// B1: Stage B's schedule over all transitions.  Step i is valid
// when valids[i] != 0 and reads tile tile_ids[i] and frontier block
// (f_rows[i], f_cols[i]); the run that starts at step lo writes output
// block (o_rows[lo], o_cols[lo]).  Row blocks hold 8 rows, column blocks B.
struct LevelSchedule {
  const int32_t* __restrict__ valids;
  const int32_t* __restrict__ tile_ids;
  const int32_t* __restrict__ f_rows;
  const int32_t* __restrict__ f_cols;
  const int32_t* __restrict__ o_rows;
  const int32_t* __restrict__ o_cols;
  __device__ bool valid(int i) const { return valids[i] != 0; }
  __device__ size_t tile(int i) const { return (size_t)tile_ids[i]; }
  __device__ size_t f_row(int i) const { return (size_t)f_rows[i]; }
  __device__ size_t f_col(int i) const { return (size_t)f_cols[i]; }
  __device__ size_t o_row(int lo) const { return (size_t)o_rows[lo]; }
  __device__ size_t o_col(int lo) const { return (size_t)o_cols[lo]; }
};

// B5: tile i of one label store, on the frontier's 8-row block blockIdx.y.
struct StepSchedule {
  const int32_t* __restrict__ rows;
  const int32_t* __restrict__ cols;
  __device__ bool valid(int) const { return true; }
  __device__ size_t tile(int i) const { return (size_t)i; }
  __device__ size_t f_row(int) const { return blockIdx.y; }
  __device__ size_t f_col(int i) const { return (size_t)rows[i]; }
  __device__ size_t o_row(int) const { return blockIdx.y; }
  __device__ size_t o_col(int lo) const { return (size_t)cols[lo]; }
};

// TileT = float: rows of B f32 values (row_len = B).
template <typename TileT, typename Schedule>
__global__ void fused_level_kernel(
    const float* __restrict__ frontier,   // (n_rows * 8, v_pad)
    const TileT* __restrict__ tiles,      // (n_tiles, B, row_len)
    const Schedule sched,
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
    if (!sched.valid(i)) continue;  // the same i for every thread: uniform
    const float* f_blk = frontier + sched.f_row(i) * kQPad * v_pad + sched.f_col(i) * block_size;
    __syncthreads();  // the previous step's reads of f_s are done
    for (int k = threadIdx.x; k < kQPad * block_size; k += blockDim.x)
      f_s[k] = f_blk[(size_t)(k / block_size) * v_pad + k % block_size];
    __syncthreads();
    const TileT* tile = tiles + (sched.tile(i) * block_size + v0) * row_len;
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
  float* o_blk = out + sched.o_row(lo) * kQPad * v_pad + sched.o_col(lo) * block_size;
#pragma unroll
  for (int r = 0; r < kQPad; ++r) o_blk[(size_t)r * v_pad + j] = acc[r];
}

// Launches one CTA of B * G threads per cell of `grid` on `stream`.
// Returns cudaGetLastError() after the launch: nonzero means the launch
// was refused.
template <typename TileT, typename Schedule>
int launch(const void* frontier, const void* tiles, const Schedule& sched, const void* run_ptr,
           void* out, dim3 grid, int v_pad, int block_size, int row_len, void* stream) {
  int n_groups = 1;
  while (n_groups < 8 && block_size * n_groups * 2 <= 1024) n_groups *= 2;
  const size_t smem = sizeof(float) * kQPad * (size_t)block_size * n_groups;
  fused_level_kernel<TileT, Schedule><<<grid, block_size * n_groups, smem, (cudaStream_t)stream>>>(
      (const float*)frontier, (const TileT*)tiles, sched, (const int32_t*)run_ptr, (float*)out,
      v_pad, block_size, row_len);
  return (int)cudaGetLastError();
}

// ---- B3 ------------------------------------------------------------------

constexpr int kB3Threads = 256;
constexpr int kB3StageBytes = 96 * 1024;  // operands staged at once, at most

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One CTA per chunk of the work list.  Shared memory: per_pass staged
// steps of (8 x B frontier floats, then B x row_len tile words), then
// the chunk's entries: 3 ints per step (tile, frontier row block,
// frontier column block), the output block (row, column) and the step
// count.
__global__ void __launch_bounds__(kB3Threads) bitplane_level_kernel(
    const float* __restrict__ frontier,   // (n_rows * 8, v_pad)
    const uint32_t* __restrict__ tiles,   // (n_tiles, B, row_len)
    const int32_t* __restrict__ tile_ids, const int32_t* __restrict__ f_rows,
    const int32_t* __restrict__ f_cols, const int32_t* __restrict__ o_rows,
    const int32_t* __restrict__ o_cols,
    const int32_t* __restrict__ work,     // (n_chunks, chunk), -1 past the end
    float* __restrict__ out,              // (n_out_rows, v_pad), zeroed
    int v_pad, int block_size, int row_len, int chunk, int per_pass, int n_groups) {
  extern __shared__ __align__(16) float b3_smem[];
  const int f_floats = kQPad * block_size;
  const int step_floats = f_floats + block_size * row_len;  // a multiple of 8
  float* stage = b3_smem;
  int* entry = reinterpret_cast<int*>(stage + (size_t)per_pass * step_floats);
  const int tid = threadIdx.x;

  // the chunk's schedule entries, in one pass
  const int32_t* w = work + (size_t)blockIdx.x * chunk;
  if (tid < chunk) {
    const int i = w[tid];
    if (i >= 0) {
      entry[3 * tid] = tile_ids[i];
      entry[3 * tid + 1] = f_rows[i];
      entry[3 * tid + 2] = f_cols[i];
      if (tid == 0) {
        entry[3 * chunk] = o_rows[i];
        entry[3 * chunk + 1] = o_cols[i];
      }
    }
  }
  if (tid == 0) {  // steps fill a chunk from its start: the first -1 ends it
    int n = 0;
    while (n < chunk && w[n] >= 0) ++n;
    entry[3 * chunk + 2] = n;
  }
  __syncthreads();
  const int n = entry[3 * chunk + 2];
  float* o_blk = out + (size_t)entry[3 * chunk] * kQPad * v_pad +
                 (size_t)entry[3 * chunk + 1] * block_size;

  const int f_vecs = f_floats / 4, step_vecs = step_floats / 4;
  const int row_vecs = block_size / 4;
  const int cols = blockDim.x / n_groups;  // threads per group
  const int g = tid / cols;
  const int n_v = block_size / n_groups;   // tile rows per group, a multiple of 4
  const int v0 = g * n_v;
  for (int s0 = 0; s0 < n; s0 += per_pass) {
    const int m = min(per_pass, n - s0);
    if (s0 > 0) __syncthreads();  // the previous pass's reads are done
    for (int k = tid; k < m * step_vecs; k += blockDim.x) {
      const int s = k / step_vecs, c = k % step_vecs;
      const int* e = entry + 3 * (s0 + s);
      float* dst = stage + (size_t)s * step_floats + 4 * c;
      if (c < f_vecs) {
        const int r = c / row_vecs, q = c % row_vecs;
        cp_async16(dst, frontier + ((size_t)e[1] * kQPad + r) * v_pad +
                            (size_t)e[2] * block_size + 4 * q);
      } else {
        cp_async16(dst, tiles + (size_t)e[0] * block_size * row_len + 4 * (c - f_vecs));
      }
    }
    cp_async_wait_all();
    __syncthreads();

    for (int j = tid % cols; j < block_size; j += cols) {
      const uint32_t bit = 1u << (j & 31);
      const int wj = j >> 5;
      float acc[kQPad];
#pragma unroll
      for (int r = 0; r < kQPad; ++r) acc[r] = 0.0f;
      for (int s = 0; s < m; ++s) {
        const float* f = stage + (size_t)s * step_floats;
        const uint32_t* t = reinterpret_cast<const uint32_t*>(f + f_floats) + wj;
#pragma unroll 4
        for (int v = v0; v < v0 + n_v; v += 4) {
          const float a0 = (t[(v + 0) * row_len] & bit) ? 1.0f : 0.0f;
          const float a1 = (t[(v + 1) * row_len] & bit) ? 1.0f : 0.0f;
          const float a2 = (t[(v + 2) * row_len] & bit) ? 1.0f : 0.0f;
          const float a3 = (t[(v + 3) * row_len] & bit) ? 1.0f : 0.0f;
#pragma unroll
          for (int r = 0; r < kQPad; ++r) {
            const float4 fv = *reinterpret_cast<const float4*>(f + r * block_size + v);
            acc[r] = fmaf(fv.x, a0, acc[r]);
            acc[r] = fmaf(fv.y, a1, acc[r]);
            acc[r] = fmaf(fv.z, a2, acc[r]);
            acc[r] = fmaf(fv.w, a3, acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kQPad; ++r)
        if (acc[r] != 0.0f) atomicAdd(o_blk + (size_t)r * v_pad + j, acc[r]);
    }
  }
}

LevelSchedule level_schedule(const void* valids, const void* tile_ids, const void* f_rows,
                             const void* f_cols, const void* o_rows, const void* o_cols) {
  return {(const int32_t*)valids, (const int32_t*)tile_ids, (const int32_t*)f_rows,
          (const int32_t*)f_cols, (const int32_t*)o_rows, (const int32_t*)o_cols};
}

}  // namespace

// B1: tiles (n_tiles, B, B) f32; one CTA per run.
extern "C" int fused_level_f32(
    const void* frontier, const void* tiles, const void* valids, const void* tile_ids,
    const void* f_rows, const void* f_cols, const void* o_rows, const void* o_cols,
    const void* run_ptr, void* out, int n_runs, int v_pad, int block_size, void* stream) {
  return launch<float>(frontier, tiles,
                       level_schedule(valids, tile_ids, f_rows, f_cols, o_rows, o_cols), run_ptr,
                       out, dim3(n_runs), v_pad, block_size, block_size, stream);
}

// B3: tiles (n_tiles, B, ceil(B / 32)) uint32 bit-planes; one CTA per
// chunk of the work list (n_chunks, chunk), out zeroed by the caller.
extern "C" int fused_level_f32_u32tiles(
    const void* frontier, const void* tiles, const void* tile_ids, const void* f_rows,
    const void* f_cols, const void* o_rows, const void* o_cols, const void* work, void* out,
    int n_chunks, int chunk, int v_pad, int block_size, void* stream) {
  if (n_chunks < 1 || chunk < 1 || chunk > 8 || block_size % 8) return (int)cudaErrorInvalidValue;
  const int row_len = (block_size + 31) / 32;
  const size_t step_bytes = sizeof(float) * ((size_t)kQPad * block_size + (size_t)block_size * row_len);
  const int per_pass = (int)std::max<size_t>(1, std::min<size_t>(chunk, kB3StageBytes / step_bytes));
  const size_t smem = per_pass * step_bytes + sizeof(int) * (3 * chunk + 3);
  // Raise the dynamic shared memory limit once per size, on the first
  // launch: a later launch may be inside a CUDA graph capture.
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        bitplane_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  // G groups of threads split the tile rows; B / G stays a multiple of 4
  int n_groups = 1;
  while (n_groups < 8 && block_size * n_groups * 2 <= kB3Threads && block_size % (8 * n_groups) == 0)
    n_groups *= 2;
  const int threads = std::min(kB3Threads, block_size * n_groups);
  bitplane_level_kernel<<<n_chunks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)frontier, (const uint32_t*)tiles, (const int32_t*)tile_ids,
      (const int32_t*)f_rows, (const int32_t*)f_cols, (const int32_t*)o_rows,
      (const int32_t*)o_cols, (const int32_t*)work, (float*)out, v_pad, block_size, row_len,
      chunk, per_pass, n_groups);
  return (int)cudaGetLastError();
}

// B5: frontier (m_pad, v_pad) with m_pad a multiple of 8, tiles (nnz, B, B)
// f32 of one label store, out (m_pad, v_pad) zeroed by the caller; one
// CTA per (run, 8-row block).
extern "C" int frontier_step_f32(
    const void* frontier, const void* tiles, const void* rows, const void* cols,
    const void* run_ptr, void* out, int n_runs, int m_pad, int v_pad, int block_size,
    void* stream) {
  const StepSchedule sched{(const int32_t*)rows, (const int32_t*)cols};
  return launch<float>(frontier, tiles, sched, run_ptr, out, dim3(n_runs, m_pad / kQPad), v_pad,
                       block_size, block_size, stream);
}
