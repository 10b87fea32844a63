// One lane-packed BFS level of the S2 frontier path, for Hopper: kernel
// B2 on f32 tiles, kernel B4 on bit-plane tiles.
//
// Replaces the TPU kernel repro/kernels/frontier/frontier.py:
// packed_level_blocks with its bodies _packed_level_kernel (f32 tiles,
// thresholded a != 0) and _packed_level_kernel_u32 (uint32 bit-plane
// tiles, unpacked by _unpack_tile_bits).  The frontier carries 256 query
// lanes per automaton state: lane q is bit q % 32 of word row q // 32 of
// the state's 8 rows.  For each output block the kernel folds, over the
// valid steps of its run,
//
//     out[r][j] |= OR over v of (a[v][j] != 0 ? f[r][v] : 0)
//
// for the 8 word rows r: 32 lanes per word, each an independent query.
//
// The grid and the thread layout are those of fused_level.cu (B1): one
// CTA per output block over its run (run_ptr from Stage B), G groups of B
// threads splitting each tile's rows, the 8 x B block of lane words in
// shared memory, one store per block and no atomics.  Only the inner
// product differs.  Thread j keeps its column's 8 words in registers; per
// tile row v it builds mask = a ? 0xffffffff : 0 from the tile element
// (B2: the f32 value != 0; B4: bit j % 32 of word j / 32 of the bit-plane
// row, one broadcast word per warp, pad bits past column B never read)
// and ORs f[r][v] & mask into each word.  The groups' words meet in
// shared memory and are ORed: OR is exact in any order, so the result is
// deterministic and equals the plain PyTorch version bit for bit.
//
// Bound on the H100: B2 reads each real f32 tile once (B*B*4 bytes) for
// 2*8 int32 operations per tile element; B4 reads 1/32 of those bytes for
// the same operations.  Integer AND/OR run on the CUDA cores at half the
// FP32 lane count, so B4 is the first of the level kernels that can be
// bound by operations rather than bytes.  Bit-sliced tensor-core products
// (b1 mma) and TMA are left for later work.
//
// Lane words and bit-plane tiles arrive as torch int32 tensors with the
// same bits; they are read here as uint32_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQPad = 8;

// Whether tile element (v, j) is set, given the start of tile row v.
__device__ __forceinline__ bool tile_bit(const float* row, int j) { return row[j] != 0.0f; }
__device__ __forceinline__ bool tile_bit(const uint32_t* row, int j) {
  return (row[j >> 5] >> (j & 31)) & 1u;
}

// TileT = float: rows of B f32 values; TileT = uint32_t: rows of
// row_len = ceil(B / 32) bit-plane words.
template <typename TileT>
__global__ void packed_level_kernel(
    const uint32_t* __restrict__ frontier, // (n_rows * 8, v_pad) lane words
    const TileT* __restrict__ tiles,       // (n_tiles, B, row_len)
    const int32_t* __restrict__ valids,    // (n_steps,)
    const int32_t* __restrict__ tile_ids,  // (n_steps,)
    const int32_t* __restrict__ f_rows,    // (n_steps,)
    const int32_t* __restrict__ f_cols,    // (n_steps,)
    const int32_t* __restrict__ o_rows,    // (n_steps,)
    const int32_t* __restrict__ o_cols,    // (n_steps,)
    const int32_t* __restrict__ run_ptr,   // (n_runs + 1,)
    uint32_t* __restrict__ out,            // (n_out_rows, v_pad) lane words
    int v_pad, int block_size, int row_len) {
  // f_s: the 8 x B block of lane words; part: the words of groups 1..G-1
  extern __shared__ uint32_t smem_words[];
  uint32_t* f_s = smem_words;
  uint32_t* part = smem_words + kQPad * block_size;
  const int n_groups = blockDim.x / block_size;
  const int j = threadIdx.x % block_size;
  const int g = threadIdx.x / block_size;
  const int n_v = block_size / n_groups;
  const int v0 = g * n_v;
  const int lo = run_ptr[blockIdx.x];
  const int hi = run_ptr[blockIdx.x + 1];

  uint32_t acc[kQPad];
#pragma unroll
  for (int r = 0; r < kQPad; ++r) acc[r] = 0u;

  for (int i = lo; i < hi; ++i) {
    if (valids[i] == 0) continue;  // the same i for every thread: uniform
    const uint32_t* f_blk = frontier + (size_t)f_rows[i] * kQPad * v_pad +
                            (size_t)f_cols[i] * block_size;
    __syncthreads();  // the previous step's reads of f_s are done
    for (int k = threadIdx.x; k < kQPad * block_size; k += blockDim.x)
      f_s[k] = f_blk[(size_t)(k / block_size) * v_pad + k % block_size];
    __syncthreads();
    const TileT* tile = tiles + ((size_t)tile_ids[i] * block_size + v0) * row_len;
#pragma unroll 16
    for (int v = 0; v < n_v; ++v) {
      const uint32_t mask = 0u - (uint32_t)tile_bit(tile + (size_t)v * row_len, j);
#pragma unroll
      for (int r = 0; r < kQPad; ++r) acc[r] |= f_s[r * block_size + v0 + v] & mask;
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
    for (int r = 0; r < kQPad; ++r) acc[r] |= part[((h - 1) * kQPad + r) * block_size + j];
  }
  uint32_t* o_blk = out + (size_t)o_rows[lo] * kQPad * v_pad + (size_t)o_cols[lo] * block_size;
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
  const size_t smem = sizeof(uint32_t) * kQPad * (size_t)block_size * n_groups;
  packed_level_kernel<TileT><<<n_runs, block_size * n_groups, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)frontier, (const TileT*)tiles, (const int32_t*)valids,
      (const int32_t*)tile_ids, (const int32_t*)f_rows, (const int32_t*)f_cols,
      (const int32_t*)o_rows, (const int32_t*)o_cols, (const int32_t*)run_ptr,
      (uint32_t*)out, v_pad, block_size, row_len);
  return (int)cudaGetLastError();
}

}  // namespace

// B2: tiles (n_tiles, B, B) f32.
extern "C" int packed_level_f32tiles(
    const void* frontier, const void* tiles, const void* valids, const void* tile_ids,
    const void* f_rows, const void* f_cols, const void* o_rows, const void* o_cols,
    const void* run_ptr, void* out, int n_runs, int v_pad, int block_size, void* stream) {
  return launch<float>(frontier, tiles, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
                       run_ptr, out, n_runs, v_pad, block_size, block_size, stream);
}

// B4: tiles (n_tiles, B, ceil(B / 32)) uint32 bit-planes.
extern "C" int packed_level_u32tiles(
    const void* frontier, const void* tiles, const void* valids, const void* tile_ids,
    const void* f_rows, const void* f_cols, const void* o_rows, const void* o_cols,
    const void* run_ptr, void* out, int n_runs, int v_pad, int block_size, void* stream) {
  return launch<uint32_t>(frontier, tiles, valids, tile_ids, f_rows, f_cols, o_rows, o_cols,
                          run_ptr, out, n_runs, v_pad, block_size, (block_size + 31) / 32,
                          stream);
}
