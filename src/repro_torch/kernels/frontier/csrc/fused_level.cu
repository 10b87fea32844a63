// The BFS levels of the S2 frontier path on Hopper, and the baseline's
// per-transition step, on two kernel bodies that walk a work list:
//
//   f32_chunk_kernel<Schedule, Combine>  (f32 tiles)
//     B1 <LevelSchedule, AddF32>   fused level, f32 frontier rows
//     B2 <LevelSchedule, OrLanes>  packed level, int32 lane words
//     B5 <StepSchedule, AddF32>    baseline step on one label store
//   bitplane_level_kernel<Combine>       (uint32 bit-plane tiles)
//     B3 <AddF32>                  fused level, f32 frontier rows
//     B4 <OrLanes>                 packed level, int32 lane words
//
// B1 and B3 replace the TPU kernel repro/kernels/frontier/frontier.py:
// fused_level_blocks with its bodies _fused_level_kernel (f32 tiles) and
// _fused_level_kernel_u32 (uint32 bit-plane tiles, unpacked by
// _unpack_tile_bits).  B2 and B4 replace packed_level_blocks of the same
// file with its bodies _packed_level_kernel and _packed_level_kernel_u32.
// Those kernels walk a sequential Pallas grid, one step per (output
// block, tile), and keep the output block in VMEM across the consecutive
// steps of its run.  B5 replaces frontier_step_blocks of the same file
// with its body _frontier_kernel, which walks one step per tile i of one
// label store and adds F[:, rows[i]] @ tiles[i] into output column block
// cols[i], zeroing the block at its first visit (cols is non-decreasing,
// so the tiles of one output block are consecutive).
//
// The combine policy is all that tells a fused level from a packed one.
// AddF32: the frontier is f32 rows (8 stacked queries), each step adds
// f[r][v] * a[v][j], and each nonzero sum goes into the output by
// atomicAdd.  OrLanes: the frontier is uint32 lane words (32 query lanes
// per word, lane q at bit q % 32 of word row q / 32), each step ORs
// f[r][v] & mask with mask = a[v][j] != 0 ? ~0 : 0 (one LOP3 per word),
// and each nonzero word goes into the output by atomicOr.  Lane words and
// bit-plane tiles arrive as torch int32 tensors with the same bits (bit
// 31 the sign) and are read here as uint32_t.
//
// Why the grid is not one CTA per run.  A level of the Alibaba twin (q1)
// holds 241 valid steps, all in 19 runs, the longest 24 steps; a baseline
// store's hub column runs as long.  Walking a run step by step in one CTA
// makes every step a chain of dependent global loads (schedule, frontier
// block, tile) behind a barrier, so the longest run set the time (~100 us
// a level, 17-52x the bound).  So Stage B cuts each run into chunks and
// the grid is one CTA per chunk (the work list: ops.level_work, built once
// per plan or per store on the host; cover steps get no entry).
//
// f32_chunk_kernel (B1, B2, B5):
//
// - Bound on the H100: bytes.  A step reads one B x B f32 tile (64 KB at
//   B = 128) and an 8 x B frontier block, and does 8 * B * B FMAs (B1, B5)
//   or AND/ORs (B2): 4 operations per byte, far below the card's ratio,
//   so tensor cores buy nothing.
// - Chunk length: 1 step for f32 tiles (ops.WORK_CHUNK_F32), so a q1-q12
//   level is 241-370 CTAs of 68 KB of shared memory, three per SM: one wave
//   on 132 SMs, every CTA's operands in flight at once.  A longer chunk
//   (a hand-built work list) is taken too: its steps run through the same
//   ring, each output block's steps combined in registers.
// - Entries first: the CTA reads its chunk's schedule entries (tile,
//   frontier block, and the output block of its first step) in one pass.
// - Prefetch: each step's tile is cut into slabs of R rows (R = 64 at
//   B = 128: 32 KB of tile, 2 KB of frontier), and the (step, slab) stages
//   run through a ring of two slots in shared memory, filled by 16-byte
//   cp.async: stage t + 1's copy is in flight while stage t is computed.
//   Slabs keep a slot under 36 KB, so any B up to 1024 fits.
// - Column parts: a grid far below three CTAs per SM (a baseline store of
//   6-23 tiles, the B5 launches of a q1 level) splits each tile's columns
//   over 2 or 4 CTAs (grid.z), so each moves and multiplies a part of the
//   tile and the launch's latency falls; their outputs are disjoint.  A
//   level's grid (241-370 CTAs) keeps whole tiles.
// - Compute: thread (g, q) of G row groups owns output columns 4q..4q+3
//   of its part for the 8 stacked frontier rows (32 words in registers)
//   and every G-th row quad of each slab; per tile row it reads one float4
//   (a warp reads 512 contiguous bytes), turns it into four operands (the
//   values, or four masks), reads eight frontier broadcasts and does 32
//   updates.  Rows go one at a time, so the kernel stays within 80
//   registers (three CTAs of 256 threads per SM) with no spill.
// - Meeting of the words: the G groups' words meet in shared memory (the
//   ring, reused), are combined in the order g = 0 .. G-1, and each
//   nonzero word goes into the output by one atomic.  The wrapper zeroes
//   the output, so cover-only blocks need no CTA, and a plan with no
//   valid step launches nothing.
//
// B1's and B2's schedule is Stage B's level schedule (step i reads tile
// tile_ids[i] and frontier block (f_rows[i], f_cols[i]), output block
// (o_rows[i], o_cols[i])); B5's is trivial: step i reads tile i and
// frontier column block rows[i] and writes column block cols[i], on the
// frontier's 8-row block blockIdx.y (m_pad is any multiple of 8; the
// baseline fills row 0 of 8).
//
// The site-sharded backend launches B1 and B3 on a shape bucket's
// schedule (frontier.py bucket_level_blocks): the member sites' step
// arrays and tile stacks flattened, tile ids offset into the stack, and
// one work list that concatenates the members' (ops.bucket_work).  A
// chunk still lies inside one member's run, but chunks of several
// members may then write the same output block.  Every chunk already
// goes into the zeroed output by atomicAdd, so such a launch sums the
// members' levels with no change to either body.
//
// bitplane_level_kernel (B3, B4) walks the same kind of work list, in
// chunks of at most 2 (ops.WORK_CHUNK).  Its bytes are few: a q1 level
// reads 0.5 MB of bit-plane tiles and writes a 6.4 MB output, 2.1 us at
// 3.35 TB/s.  B4's operations are as many as B2's, on int32 lanes at half
// the f32 rate: 2.90 us at q9, where they bind.
//
// - A CTA reads its chunk's schedule entries (tile, frontier block,
//   output block of each step) in one pass, one thread per step, then
//   issues every frontier block (8 x B words) and every bit-plane tile
//   (B x ceil(B/32) words, 2 KB at B = 128) of the chunk into shared
//   memory with 16-byte cp.async, before any compute: three dependent
//   global round trips per CTA in all, whatever the run's length.  (At
//   B > 512 the operands of a chunk exceed 96 KB and are staged in
//   passes of as many steps as fit.)
// - Thread (g, j) of G groups owns column j and tile rows
//   [g*B/G, (g+1)*B/G); it reads four frontier columns per row as one
//   16-byte broadcast and takes bit j % 32 of word j / 32 of each tile
//   row in registers (the 32 threads of a warp read the same word).
// - Each thread puts its 8 nonzero words into the output by atomics.
//
// Exact in any order, for all five kernels.  OR is exact in any order,
// so B2 and B4 give the plain PyTorch version's bits every run.  The sums
// of B1, B3 and B5 are exact when every frontier entry and every tile
// entry is a non-negative integer and every output sum is below 2^24:
// then every partial sum is an integer below 2^24 too, which f32 adds
// exactly in any order.  That is repro's own caveat for counts
// (repro/kernels/frontier/ops.py count_paths_bounded: "exact f32 integers
// only below 2**24").  The BFS levels (reach_fixpoint, the S2
// executors, expand_level) pass {0,1}; count_paths_bounded passes run
// counts, exact while its length bound keeps them below 2^24, and, as
// repro's, refuses bit-plane tiles (_require_f32_tiles).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kQPad = 8;

// A kernel attribute and the SM count belong to one device, so launch
// state is kept per device: one process that drives several cards reads
// and raises each card's own.
constexpr int kMaxDevices = 64;

// The current device, or -1 when it cannot index the per-device tables.
int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return -1;
  return dev;
}

// The current device's SM count, read once per device (0: no device).
int sm_count() {
  static int n_sms[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0) return 0;
  if (n_sms[dev] == 0) cudaDeviceGetAttribute(&n_sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return n_sms[dev];
}

// Raise `kernel`'s dynamic shared memory limit to `smem` once per size and
// device, on the first launch that needs it: a later launch may be inside
// a CUDA graph capture.  `raised` holds each device's limit so far (0: the
// default 48 KB).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t (&raised)[kMaxDevices]) {
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  if (smem <= (raised[dev] ? raised[dev] : 48 * 1024)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) raised[dev] = smem;
  return err;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- combine policies ----------------------------------------------------
//
// Word: one frontier and output element; Word4: four of them in 16 bytes.
// operand(a): the f32 tile element as the update's tile operand;
// operand_bit(w, b): bit b of bit-plane word w as the same.  update(acc,
// f, x) folds one frontier element f and tile operand x into acc;
// merge() combines two accumulators; write() puts a nonzero one into the
// zeroed output.

// B1, B3, B5: f32 rows, sums of products, atomicAdd.
struct AddF32 {
  using Word = float;
  using Word4 = float4;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float operand(float a) { return a; }
  static __device__ __forceinline__ float operand_bit(uint32_t w, int b) {
    return ((w >> b) & 1u) ? 1.0f : 0.0f;
  }
  static __device__ __forceinline__ float update(float acc, float f, float x) {
    return fmaf(f, x, acc);
  }
  static __device__ __forceinline__ float merge(float x, float y) { return x + y; }
  static __device__ __forceinline__ void write(float* o, float x) {
    if (x != 0.0f) atomicAdd(o, x);
  }
};

// B2, B4: uint32 lane words, OR of (f & mask), atomicOr.
struct OrLanes {
  using Word = uint32_t;
  using Word4 = uint4;
  static __device__ __forceinline__ uint32_t zero() { return 0u; }
  static __device__ __forceinline__ uint32_t operand(float a) { return a != 0.0f ? ~0u : 0u; }
  static __device__ __forceinline__ uint32_t operand_bit(uint32_t w, int b) {
    return 0u - ((w >> b) & 1u);
  }
  static __device__ __forceinline__ uint32_t update(uint32_t acc, uint32_t f, uint32_t m) {
    return acc | (f & m);
  }
  static __device__ __forceinline__ uint32_t merge(uint32_t x, uint32_t y) { return x | y; }
  static __device__ __forceinline__ void write(uint32_t* o, uint32_t x) {
    if (x != 0u) atomicOr(o, x);
  }
};

// ---- B1, B2 and B5 -------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32SlotBytes = 36 * 1024;  // one ring slot: a tile slab and its frontier slice

// B1, B2: Stage B's schedule over all transitions.  step() writes the
// tile, frontier row block and frontier column block of step i;
// out_block() the output block (row, column) of step i.
struct LevelSchedule {
  const int32_t* __restrict__ tile_ids;
  const int32_t* __restrict__ f_rows;
  const int32_t* __restrict__ f_cols;
  const int32_t* __restrict__ o_rows;
  const int32_t* __restrict__ o_cols;
  __device__ void step(int i, int* e) const {
    e[0] = tile_ids[i];
    e[1] = f_rows[i];
    e[2] = f_cols[i];
  }
  __device__ void out_block(int i, int* e) const {
    e[0] = o_rows[i];
    e[1] = o_cols[i];
  }
};

// B5: tile i of one label store, on the frontier's 8-row block blockIdx.y.
struct StepSchedule {
  const int32_t* __restrict__ rows;
  const int32_t* __restrict__ cols;
  __device__ void step(int i, int* e) const {
    e[0] = i;
    e[1] = blockIdx.y;
    e[2] = rows[i];
  }
  __device__ void out_block(int i, int* e) const {
    e[0] = blockIdx.y;
    e[1] = cols[i];
  }
};

// Starts the copies of stage t (step t / n_slabs, tile rows [r0, r0 + nr)
// of its slab, columns [c0, c0 + C) of the CTA's column part) into ring
// slot t % 2 and commits them as one copy group: the frontier slice
// (8 x nr 4-byte words, row stride R in the slot), then the nr x C tile
// rows (row stride C).
__device__ __forceinline__ void start_stage(
    float* smem, const int* entry, const void* __restrict__ frontier_words,
    const float* __restrict__ tiles, int t, int n_slabs, int R, int C, int c0, int slot_floats,
    int v_pad, int block_size) {
  const float* frontier = static_cast<const float*>(frontier_words);  // bits, copied as they are
  const int s = t / n_slabs, r0 = (t % n_slabs) * R;
  const int nr = min(R, block_size - r0);
  const int* e = entry + 3 * s;
  float* f_s = smem + (t & 1) * slot_floats;
  float* t_s = f_s + kQPad * R;
  const float* f_src = frontier + (size_t)e[1] * kQPad * v_pad + (size_t)e[2] * block_size + r0;
  const float* t_src = tiles + ((size_t)e[0] * block_size + r0) * block_size + c0;
  const int row_vecs = nr / 4, c_vecs = C / 4;
  for (int k = threadIdx.x; k < kQPad * row_vecs; k += blockDim.x) {
    const int r = k / row_vecs, x = k % row_vecs;
    cp_async16(f_s + r * R + 4 * x, f_src + (size_t)r * v_pad + 4 * x);
  }
  // tile row v, 16-byte column x: (v, x) steps by blockDim.x vectors
  // without a division in the loop
  const int dv = blockDim.x / c_vecs, dx = blockDim.x % c_vecs;
  for (int v = threadIdx.x / c_vecs, x = threadIdx.x % c_vecs; v < nr;) {
    cp_async16(t_s + v * C + 4 * x, t_src + (size_t)v * block_size + 4 * x);
    v += dv;
    x += dx;
    if (x >= c_vecs) {
      x -= c_vecs;
      ++v;
    }
  }
  cp_async_commit();
}

// One CTA per chunk of the work list (grid.x), frontier row block (grid.y,
// B5 only) and column part (grid.z: columns [z * C, (z + 1) * C) of every
// tile).  Shared memory: up to two ring slots of (8 x R frontier words,
// R x C tile floats), also the G x 8 x C words at the end, then the
// chunk's entries: 3 ints per step (tile, frontier row block, frontier
// column block), the output block (row, column), the step count.
template <typename Schedule, typename Combine>
__global__ void __launch_bounds__(kF32Threads, 3) f32_chunk_kernel(
    const typename Combine::Word* __restrict__ frontier,  // (n_rows * 8, v_pad)
    const float* __restrict__ tiles,                      // (n_tiles, B, B)
    const Schedule sched,
    const int32_t* __restrict__ work,                     // (n_chunks, chunk), -1 past the end
    typename Combine::Word* __restrict__ out,             // (n_out_rows, v_pad), zeroed
    int v_pad, int block_size, int chunk, int slab_rows, int part_cols, int n_groups,
    int ring_floats) {
  using Word = typename Combine::Word;
  extern __shared__ __align__(16) float f32_smem[];
  const int R = slab_rows, C = part_cols, c0 = blockIdx.z * part_cols;
  const int slot_floats = kQPad * R + R * C;  // a multiple of 4
  int* entry = reinterpret_cast<int*>(f32_smem + ring_floats);
  const int tid = threadIdx.x;

  // the chunk's schedule entries, in one pass
  const int32_t* w = work + (size_t)blockIdx.x * chunk;
  for (int s = tid; s < chunk; s += blockDim.x) {
    const int i = w[s];
    if (i >= 0) {
      sched.step(i, entry + 3 * s);
      if (s == 0) sched.out_block(i, entry + 3 * chunk);
    }
  }
  if (tid == 0) {  // steps fill a chunk from its start: the first -1 ends it
    int n = 0;
    while (n < chunk && w[n] >= 0) ++n;
    entry[3 * chunk + 2] = n;
  }
  __syncthreads();
  const int n = entry[3 * chunk + 2];
  if (n == 0) return;

  const int n_slabs = (block_size + R - 1) / R;
  const int n_stages = n * n_slabs;
  const int quads = C / 4;
  const int q = tid % quads, g = tid / quads;  // blockDim.x = quads * n_groups
  Word acc[kQPad][4];
#pragma unroll
  for (int r = 0; r < kQPad; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = Combine::zero();

  start_stage(f32_smem, entry, frontier, tiles, 0, n_slabs, R, C, c0, slot_floats, v_pad,
              block_size);
  if (n_stages > 1)
    start_stage(f32_smem, entry, frontier, tiles, 1, n_slabs, R, C, c0, slot_floats, v_pad,
                block_size);
  for (int t = 0; t < n_stages; ++t) {
    // stage t has landed; stage t + 1, where there is one, stays in flight
    if (t + 1 < n_stages)
      cp_async_wait_group<1>();
    else
      cp_async_wait_group<0>();
    __syncthreads();
    const int nr = min(R, block_size - (t % n_slabs) * R);
    const float* slot = f32_smem + (t & 1) * slot_floats;
    const Word* f_s = reinterpret_cast<const Word*>(slot);
    const float* t_s = slot + kQPad * R;
    // one tile row at a time (not unrolled: 32 words, the row's operands
    // and the 8 frontier values stay within 80 registers, three CTAs per SM)
    for (int vq = g; vq < nr / 4; vq += n_groups) {
#pragma unroll 1
      for (int v = 4 * vq; v < 4 * vq + 4; ++v) {
        const float4 a = *reinterpret_cast<const float4*>(t_s + v * C + 4 * q);
        const Word x0 = Combine::operand(a.x), x1 = Combine::operand(a.y);
        const Word x2 = Combine::operand(a.z), x3 = Combine::operand(a.w);
#pragma unroll
        for (int r = 0; r < kQPad; ++r) {
          const Word f = f_s[r * R + v];
          acc[r][0] = Combine::update(acc[r][0], f, x0);
          acc[r][1] = Combine::update(acc[r][1], f, x1);
          acc[r][2] = Combine::update(acc[r][2], f, x2);
          acc[r][3] = Combine::update(acc[r][3], f, x3);
        }
      }
    }
    __syncthreads();  // every read of slot t % 2 is done: refill it
    if (t + 2 < n_stages)
      start_stage(f32_smem, entry, frontier, tiles, t + 2, n_slabs, R, C, c0, slot_floats,
                  v_pad, block_size);
  }

  // the groups' words meet in the ring (every copy landed, every read done)
  using Word4 = typename Combine::Word4;
  Word* red = reinterpret_cast<Word*>(f32_smem);
#pragma unroll
  for (int r = 0; r < kQPad; ++r)
    *reinterpret_cast<Word4*>(red + (g * kQPad + r) * C + 4 * q) =
        Word4{acc[r][0], acc[r][1], acc[r][2], acc[r][3]};
  __syncthreads();
  Word* o_blk = out + (size_t)entry[3 * chunk] * kQPad * v_pad +
                (size_t)entry[3 * chunk + 1] * block_size + c0;
  for (int o = tid; o < kQPad * C; o += blockDim.x) {
    const int r = o / C, j = o % C;
    Word x = Combine::zero();
    for (int h = 0; h < n_groups; ++h) x = Combine::merge(x, red[(h * kQPad + r) * C + j]);
    Combine::write(o_blk + (size_t)r * v_pad + j, x);
  }
}

// Launches one CTA per (chunk, frontier row block, column part) of the
// work list (n_chunks, chunk) on `stream`.  Returns cudaGetLastError()
// after the launch: nonzero means the launch was refused.  Each
// instantiation is its own kernel function, so its raised shared-memory
// limits (one per device) are its own.
template <typename Schedule, typename Combine>
int launch_f32(const void* frontier, const void* tiles, const Schedule& sched, const void* work,
               void* out, int n_chunks, int chunk, int row_blocks, int v_pad, int block_size,
               void* stream) {
  static_assert(sizeof(typename Combine::Word) == sizeof(float), "4-byte frontier words");
  if (n_chunks < 1 || chunk < 1 || chunk > 8 || row_blocks < 1 || row_blocks > 65535 ||
      block_size % 8 || block_size < 8 || block_size > 1024)
    return (int)cudaErrorInvalidValue;
  const int n_sms = sm_count();
  if (n_sms == 0) return (int)cudaErrorInvalidDevice;
  // Column parts: a grid far smaller than the card (a baseline store of
  // 6-23 tiles) splits each tile's columns over up to 4 CTAs, which write
  // disjoint outputs, so each CTA moves and multiplies a quarter of the
  // tile; a level's grid (241-370 CTAs) already fills three CTAs per SM
  // and keeps whole tiles.
  int parts = 1;
  while (parts < 4 && 2L * parts * n_chunks * row_blocks <= 3L * n_sms &&
         (block_size / (2 * parts)) % 4 == 0)
    parts *= 2;
  const int part_cols = block_size / parts;
  // slabs of R rows, R a multiple of 4, as even as the slot's size allows:
  // R = 64 at B = 128 in one part, 8 at B = 1024
  const int max_rows = kF32SlotBytes / (int)sizeof(float) / (kQPad + part_cols) / 4 * 4;
  const int n_slabs = (block_size + max_rows - 1) / max_rows;
  const int slab_rows = ((block_size + n_slabs - 1) / n_slabs + 3) / 4 * 4;
  const int quads = part_cols / 4;
  const int n_groups = std::min(kF32Threads / quads, slab_rows / 4);
  const int slots = std::min(2, chunk * n_slabs);
  const int ring_floats = std::max(slots * (kQPad * slab_rows + slab_rows * part_cols),
                                   n_groups * kQPad * part_cols);
  const size_t smem = sizeof(float) * ring_floats + sizeof(int) * (3 * chunk + 3);
  static size_t smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(f32_chunk_kernel<Schedule, Combine>, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  using Word = typename Combine::Word;
  f32_chunk_kernel<Schedule, Combine><<<dim3(n_chunks, row_blocks, parts), quads * n_groups,
                                        smem, (cudaStream_t)stream>>>(
      (const Word*)frontier, (const float*)tiles, sched, (const int32_t*)work, (Word*)out, v_pad,
      block_size, chunk, slab_rows, part_cols, n_groups, ring_floats);
  return (int)cudaGetLastError();
}

// ---- B3 and B4 -----------------------------------------------------------

constexpr int kB3Threads = 256;
constexpr int kB3StageBytes = 96 * 1024;  // operands staged at once, at most

// One CTA per chunk of the work list.  Shared memory: per_pass staged
// steps of (8 x B frontier words, then B x row_len tile words), then
// the chunk's entries: 3 ints per step (tile, frontier row block,
// frontier column block), the output block (row, column) and the step
// count.
template <typename Combine>
__global__ void __launch_bounds__(kB3Threads) bitplane_level_kernel(
    const typename Combine::Word* __restrict__ frontier,  // (n_rows * 8, v_pad)
    const uint32_t* __restrict__ tiles,                   // (n_tiles, B, row_len)
    const int32_t* __restrict__ tile_ids, const int32_t* __restrict__ f_rows,
    const int32_t* __restrict__ f_cols, const int32_t* __restrict__ o_rows,
    const int32_t* __restrict__ o_cols,
    const int32_t* __restrict__ work,                     // (n_chunks, chunk), -1 past the end
    typename Combine::Word* __restrict__ out,             // (n_out_rows, v_pad), zeroed
    int v_pad, int block_size, int row_len, int chunk, int per_pass, int n_groups) {
  using Word = typename Combine::Word;
  using Word4 = typename Combine::Word4;
  extern __shared__ __align__(16) uint32_t b3_smem[];
  const int f_words = kQPad * block_size;
  const int step_words = f_words + block_size * row_len;  // a multiple of 8
  uint32_t* stage = b3_smem;
  int* entry = reinterpret_cast<int*>(stage + (size_t)per_pass * step_words);
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
  Word* o_blk = out + (size_t)entry[3 * chunk] * kQPad * v_pad +
                (size_t)entry[3 * chunk + 1] * block_size;

  const int f_vecs = f_words / 4, step_vecs = step_words / 4;
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
      uint32_t* dst = stage + (size_t)s * step_words + 4 * c;
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
      const int b = j & 31;
      const int wj = j >> 5;
      Word acc[kQPad];
#pragma unroll
      for (int r = 0; r < kQPad; ++r) acc[r] = Combine::zero();
      for (int s = 0; s < m; ++s) {
        const Word* f = reinterpret_cast<const Word*>(stage + (size_t)s * step_words);
        const uint32_t* t = stage + (size_t)s * step_words + f_words + wj;
#pragma unroll 4
        for (int v = v0; v < v0 + n_v; v += 4) {
          const Word a0 = Combine::operand_bit(t[(v + 0) * row_len], b);
          const Word a1 = Combine::operand_bit(t[(v + 1) * row_len], b);
          const Word a2 = Combine::operand_bit(t[(v + 2) * row_len], b);
          const Word a3 = Combine::operand_bit(t[(v + 3) * row_len], b);
#pragma unroll
          for (int r = 0; r < kQPad; ++r) {
            const Word4 fv = *reinterpret_cast<const Word4*>(f + r * block_size + v);
            acc[r] = Combine::update(acc[r], fv.x, a0);
            acc[r] = Combine::update(acc[r], fv.y, a1);
            acc[r] = Combine::update(acc[r], fv.z, a2);
            acc[r] = Combine::update(acc[r], fv.w, a3);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kQPad; ++r) Combine::write(o_blk + (size_t)r * v_pad + j, acc[r]);
    }
  }
}

// Launches one CTA per chunk of the work list (n_chunks, chunk) on
// `stream`; returns cudaGetLastError() after the launch.  Its statics are
// per instantiation, as launch_f32's.
template <typename Combine>
int launch_bitplane(const void* frontier, const void* tiles, const void* tile_ids,
                    const void* f_rows, const void* f_cols, const void* o_rows, const void* o_cols,
                    const void* work, void* out, int n_chunks, int chunk, int v_pad, int block_size,
                    void* stream) {
  static_assert(sizeof(typename Combine::Word) == sizeof(uint32_t), "4-byte frontier words");
  if (n_chunks < 1 || chunk < 1 || chunk > 8 || block_size % 8) return (int)cudaErrorInvalidValue;
  const int row_len = (block_size + 31) / 32;
  const size_t step_bytes =
      sizeof(uint32_t) * ((size_t)kQPad * block_size + (size_t)block_size * row_len);
  const int per_pass = (int)std::max<size_t>(1, std::min<size_t>(chunk, kB3StageBytes / step_bytes));
  const size_t smem = per_pass * step_bytes + sizeof(int) * (3 * chunk + 3);
  static size_t smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(bitplane_level_kernel<Combine>, smem, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  // G groups of threads split the tile rows; B / G stays a multiple of 4
  int n_groups = 1;
  while (n_groups < 8 && block_size * n_groups * 2 <= kB3Threads && block_size % (8 * n_groups) == 0)
    n_groups *= 2;
  const int threads = std::min(kB3Threads, block_size * n_groups);
  using Word = typename Combine::Word;
  bitplane_level_kernel<Combine><<<n_chunks, threads, smem, (cudaStream_t)stream>>>(
      (const Word*)frontier, (const uint32_t*)tiles, (const int32_t*)tile_ids,
      (const int32_t*)f_rows, (const int32_t*)f_cols, (const int32_t*)o_rows,
      (const int32_t*)o_cols, (const int32_t*)work, (Word*)out, v_pad, block_size, row_len,
      chunk, per_pass, n_groups);
  return (int)cudaGetLastError();
}

LevelSchedule level_schedule(const void* tile_ids, const void* f_rows, const void* f_cols,
                             const void* o_rows, const void* o_cols) {
  return {(const int32_t*)tile_ids, (const int32_t*)f_rows, (const int32_t*)f_cols,
          (const int32_t*)o_rows, (const int32_t*)o_cols};
}

}  // namespace

// The four level entry points share one C signature: frontier (n_rows * 8,
// v_pad), the level's tiles, Stage B's five schedule columns, the work
// list (n_chunks, chunk) and the output (n_out_rows, v_pad), zeroed by the
// caller; one CTA per chunk.

// B1: f32 frontier rows, tiles (n_tiles, B, B) f32.
extern "C" int fused_level_f32(
    const void* frontier, const void* tiles, const void* tile_ids, const void* f_rows,
    const void* f_cols, const void* o_rows, const void* o_cols, const void* work, void* out,
    int n_chunks, int chunk, int v_pad, int block_size, void* stream) {
  return launch_f32<LevelSchedule, AddF32>(
      frontier, tiles, level_schedule(tile_ids, f_rows, f_cols, o_rows, o_cols), work, out,
      n_chunks, chunk, 1, v_pad, block_size, stream);
}

// B3: f32 frontier rows, tiles (n_tiles, B, ceil(B / 32)) uint32 bit-planes.
extern "C" int fused_level_f32_u32tiles(
    const void* frontier, const void* tiles, const void* tile_ids, const void* f_rows,
    const void* f_cols, const void* o_rows, const void* o_cols, const void* work, void* out,
    int n_chunks, int chunk, int v_pad, int block_size, void* stream) {
  return launch_bitplane<AddF32>(frontier, tiles, tile_ids, f_rows, f_cols, o_rows, o_cols, work,
                                 out, n_chunks, chunk, v_pad, block_size, stream);
}

// B2: uint32 lane words, tiles (n_tiles, B, B) f32.
extern "C" int packed_level_f32tiles(
    const void* frontier, const void* tiles, const void* tile_ids, const void* f_rows,
    const void* f_cols, const void* o_rows, const void* o_cols, const void* work, void* out,
    int n_chunks, int chunk, int v_pad, int block_size, void* stream) {
  return launch_f32<LevelSchedule, OrLanes>(
      frontier, tiles, level_schedule(tile_ids, f_rows, f_cols, o_rows, o_cols), work, out,
      n_chunks, chunk, 1, v_pad, block_size, stream);
}

// B4: uint32 lane words, tiles (n_tiles, B, ceil(B / 32)) uint32 bit-planes.
extern "C" int packed_level_u32tiles(
    const void* frontier, const void* tiles, const void* tile_ids, const void* f_rows,
    const void* f_cols, const void* o_rows, const void* o_cols, const void* work, void* out,
    int n_chunks, int chunk, int v_pad, int block_size, void* stream) {
  return launch_bitplane<OrLanes>(frontier, tiles, tile_ids, f_rows, f_cols, o_rows, o_cols, work,
                                  out, n_chunks, chunk, v_pad, block_size, stream);
}

// B5: frontier (m_pad, v_pad) with m_pad a multiple of 8, tiles (nnz, B, B)
// f32 of one label store, out (m_pad, v_pad) zeroed by the caller; one
// CTA per (chunk of the store's work list, 8-row block).
extern "C" int frontier_step_f32(
    const void* frontier, const void* tiles, const void* rows, const void* cols,
    const void* work, void* out, int n_chunks, int chunk, int m_pad, int v_pad, int block_size,
    void* stream) {
  const StepSchedule sched{(const int32_t*)rows, (const int32_t*)cols};
  return launch_f32<StepSchedule, AddF32>(frontier, tiles, sched, work, out, n_chunks, chunk,
                                          m_pad / kQPad, v_pad, block_size, stream);
}
