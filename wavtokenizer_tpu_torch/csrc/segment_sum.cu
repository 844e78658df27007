// Segment sum of the VQ's training statistics: out[c] = sum of rows[i] over
// the rows with ids[i] == c, for c in [0, C), out (C, D) f32, in the fixed
// order of ascending row index i, without float atomics.
//
// Replaces no Pallas kernel.  The JAX package sums these statistics with
// jax.ops.segment_sum (wavtokenizer_tpu/train/vq_train.py:54, the k-means
// sums, and :111, the EMA's embed_sum), whose scatter-add XLA runs in one
// fixed order, so its training step repeats.  The port's plain version is
// index_add_, which on CUDA lowers to float atomicAdd: the order of the adds,
// and so the rounding of every sum, changes from run to run, and AdamW turns
// that rounding into moves of up to the learning rate.  This kernel gives the
// card the order of the CPU's index_add_ (and XLA:CPU's scatter): each sum
// starts from +0.0 and adds its rows one by one in ascending row order, in
// fp32, so for the same inputs the card's sums equal the CPU's bit for bit.
//
// The wrapper (ops/kernels.py::segment_sum) hands it the order: perm, a
// stable sort of the rows by id (a unique permutation, so deterministic),
// and offsets (C + 1,), the exclusive prefix sum of the ids' counts, so code
// c's rows are perm[offsets[c] .. offsets[c + 1]) in ascending row order.
//
// What bounds it on an H100 at the training shape (N = 9000 rows, C = 4096
// codes, D = 512): the bytes, (N D 4 + N 8 + C D 4) / 3.35 TB/s = 8.0 us,
// when the rows spread over the codes.  Under random weights nearly every
// row goes to one code, and then a sum is one chain of N dependent fp32
// adds per column (~4 cycles each: ~20 us at 9000 rows), which no split of
// the rows may shorten without changing the order; the 512 columns of that
// one code are all the parallelism there is, so the loads have to keep up
// with the chain from few SMs.
//
// The design:
// * One warp per (group of CODES consecutive codes, 32 columns): lane l
//   owns column l of the slice, for each of the group's codes in turn.  The
//   group's rows are one contiguous run of perm, so the warp streams it
//   from start to end and, at each code's boundary, stores its sum and
//   starts the next from +0.0; every code of the group is stored once (an
//   empty code as +0.0), so the output needs no memset.  A code's rows are
//   never split between warps.
// * The rows are gathered by cp.async into a ring of STAGES stages of ROWS
//   rows x 32 columns in shared memory (32 KB), so that STAGES x 4 KB of
//   loads per warp are in flight while the lanes add: enough to feed the
//   add chain of a skewed code from 16 SMs.  The perm indices a stage's
//   gather needs are themselves brought STAGES stages ahead into a second
//   ring, so no gather waits for its indices; each lane reads one of them
//   and shuffles pass them round, so a stage's 32 copies go out back to back
//   (with each copy's address loaded from shared memory behind the copy
//   before it, the skewed case took 0.374 ms on an H100).
// * Commit group g holds the rows of chunk g and the indices of chunk
//   g + STAGES; before chunk k is summed, wait_group(STAGES - 1) completes
//   group k.  Every lane commits every group (empty ones too), so the count
//   stays uniform across the warp.
// * Grouping CODES codes per warp keeps the grid at C / CODES x D / 32
//   warps (4 096 at the training shape), so that spread ids do not pay a
//   warp's start-up per code.

#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;     // columns of a warp (lane = column)
constexpr int ROWS = 32;     // rows of a stage
constexpr int STAGES = 8;    // stages of the row ring
constexpr int CODES = 16;    // codes of a warp (CODES + 1 <= 32 offsets in lanes)
constexpr unsigned FULL = 0xffffffffu;

// No "memory" clobber: it would pin every shared-memory load of an index
// behind the copy before it.  Nothing reads a copy's destination before the
// wait that completes it, and the wait carries the clobber.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(32) segment_sum_kernel(
    const float* __restrict__ rows, const int* __restrict__ perm,
    const int* __restrict__ offsets, int D, int C, float* __restrict__ out) {
  __shared__ float ring[STAGES][ROWS][COLS];
  __shared__ int pring[2 * STAGES][ROWS];
  const int lane = threadIdx.x;
  const int col = blockIdx.x * COLS + lane;
  const bool live = col < D;
  const int c0 = blockIdx.y * CODES;
  const int c1 = min(C, c0 + CODES);
  // Lane l holds offsets[c0 + l] (clamped to the group's end).
  const int off = offsets[min(c0 + lane, c1)];
  const int j0 = __shfl_sync(FULL, off, 0);
  const int j1 = __shfl_sync(FULL, off, c1 - c0);
  const int n = j1 - j0;
  const int chunks = (n + ROWS - 1) / ROWS;

  // Indices of chunk q into the index ring.
  auto fetch_perm = [&](int q) {
    const int j = j0 + q * ROWS + lane;
    if (q < chunks && j < j1) cp_async4(&pring[q % (2 * STAGES)][lane], perm + j);
  };
  // Rows of chunk g (this lane's column of each) into the row ring; needs
  // chunk g's indices complete and visible to the warp.  Each lane reads
  // one index and the warp passes them round by shuffles, so the 32 copies
  // go out back to back.  Called by the whole warp.
  auto fetch_rows = [&](int g) {
    if (g >= chunks) return;
    const int valid = min(ROWS, n - g * ROWS);
    const int mine = pring[g % (2 * STAGES)][lane];
    float* dst = &ring[g % STAGES][0][lane];
    const float* src = rows + col;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = __shfl_sync(FULL, mine, i);
      if (i < valid && live) cp_async4(dst + i * COLS, src + (size_t)r * D);
    }
  };

  for (int q = 0; q < STAGES; ++q) fetch_perm(q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  for (int g = 0; g < STAGES; ++g) {
    fetch_rows(g);
    fetch_perm(g + STAGES);
    cp_async_commit();
  }

  int cur = c0;                             // the code being summed
  int end = __shfl_sync(FULL, off, 1);      // its first row past the end (in perm)
  float acc = 0.0f;
  auto flush = [&]() {
    if (live) out[(size_t)cur * D + col] = acc;
    acc = 0.0f;
    ++cur;
    end = __shfl_sync(FULL, off, cur - c0 + 1);
  };
  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<STAGES - 1>();            // group k: chunk k's rows
    __syncwarp();
    const float* s = &ring[k % STAGES][0][lane];
    const int jb = j0 + k * ROWS;
    const int valid = min(ROWS, n - k * ROWS);
    if (valid == ROWS && end >= jb + ROWS) {
      // No code ends inside this chunk: one unbroken chain.
#pragma unroll
      for (int i = 0; i < ROWS; ++i) acc += s[i * COLS];
    } else {
      for (int i = 0; i < valid; ++i) {
        while (jb + i == end) flush();      // uniform over the warp
        acc += s[i * COLS];
      }
    }
    __syncwarp();                           // every lane is done with stage k
    fetch_rows(k + STAGES);
    fetch_perm(k + 2 * STAGES);
    cp_async_commit();
  }
  while (cur < c1) flush();
}

}  // namespace

extern "C" int wt_segment_sum(const float* rows, const int* perm, const int* offsets,
                              float* out, int C, int D, void* stream) {
  const dim3 grid((D + COLS - 1) / COLS, (C + CODES - 1) / CODES);
  segment_sum_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(rows, perm, offsets, D, C, out);
  return (int)cudaGetLastError();
}
