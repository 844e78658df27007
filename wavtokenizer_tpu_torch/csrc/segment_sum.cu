// Segment sum of the VQ's training statistics: out[c] = sum of rows[i] over
// the rows with ids[i] == c, for c in [0, C), out (C, D) f32, in the fixed
// order of ascending row index i, without float atomics.  Two kernels: the
// order (segment_order_kernel) and the sums (segment_sum_kernel).
//
// Replaces no Pallas kernel.  The JAX package sums these statistics with
// jax.ops.segment_sum (wavtokenizer_tpu/train/vq_train.py:54, the k-means
// sums, and :111, the EMA's embed_sum), whose scatter-add XLA runs in one
// fixed order, so its training step repeats.  The port's plain version is
// index_add_, which on CUDA lowers to float atomicAdd: the order of the adds,
// and so the rounding of every sum, changes from run to run, and AdamW turns
// that rounding into moves of up to the learning rate.  These kernels give
// the card the order of the CPU's index_add_ (and XLA:CPU's scatter): each
// sum starts from +0.0 and adds its rows one by one in ascending row order,
// in fp32, so for the same inputs the card's sums equal the CPU's bit for bit.
//
// What bounds the function on an H100 at the training shape (N = 9000 rows,
// C = 4096 codes, D = 512):
// * the bytes, (N D 4 + N 8 + C D 4) / 3.35 TB/s = 8.0 us
//   (utils/profiling.py::segment_sum_bound), what bounds it when the rows
//   spread over the codes;
// * the chain: a code's sum is one chain of dependent fp32 adds per column,
//   as long as the code's count of rows, 4 cycles an add
//   (utils/profiling.py::segment_chain_ms), which no split of the rows may
//   shorten without changing the order.  Under random weights every row goes
//   to one code: 9000 adds, 36 000 cycles, 0.018 ms at 1980 MHz, 2.3x the
//   bytes.  The 512 columns of that one code are all the parallelism there
//   is, so the copies have to keep up with the chain from the few SMs that
//   hold its column slices.
//
// segment_order_kernel: the rows' order in one launch, a stable counting
// sort in integers only (so its result is unique): perm (N,) int32, seg (N,)
// int32 (each ordered row's code) and offsets (C + 1,) int32, code c's rows
// being perm[offsets[c] .. offsets[c + 1]) in ascending row order.  One
// block of OWARPS warps per OCODES consecutive codes; warp w owns one
// contiguous run of the rows.  (A) each warp counts its run's rows of each
// of the block's codes (integer shared atomics: the counts, not their order,
// matter) and its rows of ids below the block's first code; (B) the block
// turns those counts into each code's offset and each warp's first slot in
// each code; (C) each warp walks its run again in ascending order, 32 rows
// at a time, and ranks each row among the earlier rows of its code in the
// same 32 by __match_any_sync.  It reads the ids twice per block, 2 (C /
// OCODES) N 8 bytes from L2 (2.3 MB at the training shape), and needs no
// counts from the caller; block 0 counts the ids outside [0, C), which the
// wrapper reads back only when the caller gave no counts (as torch.bincount
// did).  An id outside [0, C) is in no code: its row is left out of perm,
// and offsets[C] counts only the rest.
//
// segment_sum_kernel: one block per (group of `codes` consecutive codes,
// slice of S = 32 columns).  A code's rows are never split between blocks or
// threads.  Warp-specialised:
// * P = 2 producer warps copy the group's rows (one contiguous run of perm)
//   stage by stage, ROWS rows x S columns a stage, into a ring of STAGES
//   stages in shared memory, by 16-byte cp.async.cg (4-byte cp.async.ca
//   where the rows are not 16-byte aligned: D % 4 != 0 or an unaligned
//   base; masked at the ragged last slice), with the stage's codes beside
//   them, and mark each stage with cp.async.mbarrier.arrive.noinc on its
//   full barrier.  Warp p fills stages p, p + P, ...: one warp alone did not
//   issue the gathers as fast as the chain adds.  Each holds the perm
//   indices of its next LOOK stages in registers (lane l the index of a
//   stage's row l), so no copy waits on its index; a stage's row indices
//   reach the lanes that copy them by shuffles.  A producer waiting for a
//   free slot sleeps between polls, leaving the SM's issue slots to the
//   consumer.  Last, the producers store +0.0 for the group's empty codes.
// * warp P is the consumer: lane l owns column l of the slice and only
//   reads shared memory and adds (and stores its sums).  While a stage's
//   adds run from registers, the next stage is read into a second set of
//   registers, so the chain does not wait on the reads; a stage whose rows
//   are all the current code's (the common case under skewed ids) is one
//   unrolled run of 32 adds.  Where a code begins inside a stage (known from
//   its last row's code) it walks the stage's rows and codes from the slot
//   and stores each finished sum.  The next stage's full barrier is probed
//   without waiting one stage ahead, and each slot's empty barrier gets
//   every consumer lane's arrival when it is done.
// * Occupancy: the wrapper sizes `codes` so that the grid fits the card in
//   one wave (ops/kernels.py::segment_plan, with the occupancy calculator's
//   blocks an SM), so a block's start-up is paid once per SM.
// * The sizes follow the ids the training path gives it (chip_smoke.py
//   [12] (c), PERF.md §6): the first step's k-means iterations spread their
//   rows (at most ~80 on a code of 4096), and there the call's time is the
//   host's, not the kernels'; the EMA of every later step sends every row
//   to one code, and there the sum kernel is the call's time.  So S, the
//   ring and the producers are those fastest on one heavy code: wider
//   slices (64, 128 columns) were faster on spread ids and slower on a
//   heavy code, and a 32 KB ring with two producers balanced the feed.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// The order
// ---------------------------------------------------------------------------

constexpr int OWARPS = 16;   // warps of an order block (16 runs of the rows)
constexpr int OCODES = 256;  // codes of an order block
constexpr int OUNROLL = 4;   // 32-row steps whose ids a warp loads together

__device__ __forceinline__ long long load_id(const void* ids, int is64, int i) {
  return is64 ? static_cast<const long long*>(ids)[i]
              : static_cast<long long>(static_cast<const int*>(ids)[i]);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__global__ void __launch_bounds__(OWARPS * 32) segment_order_kernel(
    const void* __restrict__ ids, int is64, int N, int C, int* __restrict__ perm,
    int* __restrict__ seg, int* __restrict__ offsets, int* __restrict__ outside) {
  __shared__ int cnt[OWARPS][OCODES];   // (A) counts, then (B) first slots
  __shared__ int below[OWARPS], bad[OWARPS], wsum[OWARPS];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * OCODES;
  const int G = min(OCODES, C - c0);
  // Warp w's run of rows: [a, b), a multiple of 32 rows long.
  const int run = ((N + OWARPS - 1) / OWARPS + 31) / 32 * 32;
  const int a = min(N, w * run), b = min(N, a + run);
  for (int t = tid; t < OWARPS * OCODES; t += blockDim.x) (&cnt[0][0])[t] = 0;
  __syncthreads();

  // (A) counts.
  int n_below = 0, n_bad = 0;
  for (int base = a; base < b; base += 32 * OUNROLL) {
    long long v[OUNROLL];
#pragma unroll
    for (int u = 0; u < OUNROLL; ++u) {
      const int i = base + u * 32 + lane;
      v[u] = i < b ? load_id(ids, is64, i) : -1;
    }
#pragma unroll
    for (int u = 0; u < OUNROLL; ++u) {
      const bool ok = base + u * 32 + lane < b;
      n_below += __popc(__ballot_sync(FULL, ok && v[u] >= 0 && v[u] < c0));
      n_bad += __popc(__ballot_sync(FULL, ok && (v[u] < 0 || v[u] >= C)));
      if (ok && v[u] >= c0 && v[u] < c0 + G) atomicAdd(&cnt[w][v[u] - c0], 1);
    }
  }
  if (lane == 0) {
    below[w] = n_below;
    bad[w] = n_bad;
  }
  __syncthreads();

  // (B) thread t < G: code c0 + t's count over the warps, its offset, and
  // each warp's first slot in it.  The codes' exclusive prefix sum is a scan
  // over the first G / 32 warps.
  int total = 0;
  if (tid < G) {
    for (int v = 0; v < OWARPS; ++v) {
      const int c = cnt[v][tid];
      cnt[v][tid] = total;
      total += c;
    }
  }
  int incl = total;   // inclusive scan within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  if (tid < G) {
    int start = incl - total;
    for (int v = 0; v < w; ++v) start += wsum[v];
    for (int v = 0; v < OWARPS; ++v) start += below[v];
    offsets[c0 + tid] = start;
    if (c0 + tid == C - 1) offsets[C] = start + total;
    for (int v = 0; v < OWARPS; ++v) cnt[v][tid] += start;
  }
  if (blockIdx.x == 0 && tid == 0) {
    int s = 0;
    for (int v = 0; v < OWARPS; ++v) s += bad[v];
    *outside = s;
  }
  __syncthreads();

  // (C) ranks, in ascending row order.  A lane outside the block's codes
  // gets a key no code has (OCODES + lane), so it matches only itself.
  const unsigned lt = lanemask_lt();
  for (int base = a; base < b; base += 32 * OUNROLL) {
    long long v[OUNROLL];
#pragma unroll
    for (int u = 0; u < OUNROLL; ++u) {
      const int i = base + u * 32 + lane;
      v[u] = i < b ? load_id(ids, is64, i) : -1;
    }
#pragma unroll
    for (int u = 0; u < OUNROLL; ++u) {
      const int i = base + u * 32 + lane;
      const bool in = i < b && v[u] >= c0 && v[u] < c0 + G;
      const int k = in ? static_cast<int>(v[u] - c0) : OCODES + lane;
      const unsigned peers = __match_any_sync(FULL, k);
      if (in) {
        const int pos = cnt[w][k] + __popc(peers & lt);
        perm[pos] = i;
        seg[pos] = c0 + k;
      }
      __syncwarp();
      if (in && (peers >> lane) == 1u) cnt[w][k] += __popc(peers);   // the last peer
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// The sums
// ---------------------------------------------------------------------------

constexpr int S = 32;         // columns of a block: one consumer warp's
constexpr int ROWS = 32;      // rows of a stage
constexpr int STAGES = 8;     // stages of the ring (32 KB of rows)
constexpr int LOOK = 2;       // stages of its own whose perm indices a producer holds ahead
constexpr int P = 2;          // producer warps of a block
constexpr unsigned NAP = 256; // ns a producer sleeps between polls of a full slot
constexpr int THREADS = 32 * P + S;
// Warp p fills stages p, p + P, ..., so with P dividing the stages every
// slot is filled by one warp in order, and its empty barrier's parity is
// never waited on a phase early.
static_assert(STAGES % P == 0, "a slot's stages must all be one producer's");
static_assert(STAGES >= 2, "a consumer holds one slot while it waits on the next");

__device__ __forceinline__ void cp_async16(uint32_t s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(g));
}

__device__ __forceinline__ void cp_async4(uint32_t s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(g));
}

// The arrival on `bar` happens when this thread's earlier cp.asyncs have
// landed; .noinc: it is one of the arrivals the barrier was initialised for.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// Shared memory of a block: the ring of rows [stages][ROWS][S] f32, the
// ring of their codes [stages][ROWS] int, full and empty barriers [stages]
// each, the group's offsets [codes + 1].
constexpr int smem_bytes(int codes) {
  return STAGES * (ROWS * S * 4 + ROWS * 4 + 16) + (codes + 1) * 4;
}

__global__ void __launch_bounds__(THREADS) segment_sum_kernel(
    const float* __restrict__ rows, const int* __restrict__ perm, const int* __restrict__ seg,
    const int* __restrict__ offsets, int D, int C, int codes, int vec,
    float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  int* sring = reinterpret_cast<int*>(ring + STAGES * ROWS * S);
  uint64_t* full = reinterpret_cast<uint64_t*>(sring + STAGES * ROWS);
  uint64_t* empty = full + STAGES;
  int* soff = reinterpret_cast<int*>(empty + STAGES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.x * S;
  const int live_cols = min(S, D - col0);
  const int c0 = blockIdx.y * codes;
  const int c1 = min(C, c0 + codes);
  for (int t = tid; t <= c1 - c0; t += blockDim.x) soff[t] = offsets[c0 + t];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(hopper::smem_u32(&full[s]), 32);   // the filling warp's lanes
      hopper::mbar_init(hopper::smem_u32(&empty[s]), S);   // the consumers' lanes
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int j0 = soff[0], j1 = soff[c1 - c0];
  const int n = j1 - j0;
  const int chunks = (n + ROWS - 1) / ROWS;

  if (warp < P) {
    // Producer warp p fills stages p, p + P, ...  Lane l's index of row l of
    // stage g (0 past the run).
    auto index_of = [&](int g) {
      const int j = j0 + g * ROWS + lane;
      return g < chunks && j < j1 ? perm[j] : 0;
    };
    int idx[LOOK];
#pragma unroll
    for (int u = 0; u < LOOK; ++u) idx[u] = index_of(warp + u * P);
    for (int g0 = warp; g0 < chunks; g0 += LOOK * P) {
#pragma unroll
      for (int u = 0; u < LOOK; ++u) {
        const int g = g0 + u * P;
        if (g >= chunks) break;
        const int s = g % STAGES;
        if (g >= STAGES)
          hopper::mbar_wait(hopper::smem_u32(&empty[s]), (g / STAGES - 1) & 1, NAP);
        const int valid = min(ROWS, n - g * ROWS);
        const uint32_t dst = hopper::smem_u32(ring + s * ROWS * S);
        const float* src = rows + col0;
        if (vec) {
          // Flat copy f = 32 t + lane: row f / (S / 4), 16-byte chunk f % (S / 4).
#pragma unroll
          for (int t = 0; t < S / 4; ++t) {
            const int f = t * 32 + lane, i = f / (S / 4), q = f % (S / 4);
            const int r = __shfl_sync(FULL, idx[u], i);
            if (i < valid && q * 4 < live_cols)
              cp_async16(dst + (i * S + q * 4) * 4, src + (size_t)r * D + q * 4);
          }
        } else {
          // Flat copy f = 32 t + lane: row f / S, column f % S.
#pragma unroll 8
          for (int t = 0; t < S; ++t) {
            const int f = t * 32 + lane, i = f / S, q = f % S;
            const int r = __shfl_sync(FULL, idx[u], i);
            if (i < valid && q < live_cols) cp_async4(dst + (i * S + q) * 4, src + (size_t)r * D + q);
          }
        }
        // The rows' codes.
        if (lane < valid)
          cp_async4(hopper::smem_u32(sring + s * ROWS + lane), seg + j0 + g * ROWS + lane);
        cp_async_arrive(hopper::smem_u32(&full[s]));
        idx[u] = index_of(g + LOOK * P);
      }
    }
    // The group's empty codes: +0.0 in this slice.
    for (int c = c0 + warp; c < c1; c += P)
      if (soff[c - c0 + 1] == soff[c - c0])
        for (int q = lane; q < live_cols; q += 32) out[(size_t)c * D + col0 + q] = 0.0f;
    return;
  }

  // Consumer: adds each code's rows and stores its sum when the next code's
  // rows begin (codes ascend along perm) and at the end.
  const int lc = (warp - P) * 32 + lane;   // column within the slice
  const bool live = lc < live_cols;
  float* dst = out + col0 + lc;
  int cur = -1;                             // the code being summed
  float acc = 0.0f;
  auto next_code = [&](int c) {
    if (live && cur >= 0) dst[(size_t)cur * D] = acc;
    acc = 0.0f;
    cur = c;
  };
  auto slot = [&](int k) { return ring + (k % STAGES) * ROWS * S + lc; };
  auto codes_of = [&](int k) { return sring + (k % STAGES) * ROWS; };
  auto full_of = [&](int k) { return hopper::smem_u32(&full[k % STAGES]); };
  // Every lane arrives once it has read the slot for the last time.
  auto release = [&](int k) { hopper::mbar_arrive(hopper::smem_u32(&empty[k % STAGES])); };
  // Stage k: its values are in registers v and its last row's code in
  // last_v (read during stage k - 1); both are also in its slot, which it
  // releases at the end.  Reads stage k + 1 into w and returns its last
  // row's code (the last stage reads its own slot again).  `ready` says
  // whether stage k + 1 has landed; the step probes stage k + 2 without
  // waiting, so that the probe's latency hides behind the adds, and returns
  // the answer.
  struct Next {
    int last;
    bool ready;
  };
  auto step = [&](float (&v)[ROWS], float (&w)[ROWS], int last_v, int k, bool ready) {
    const bool more = k + 1 < chunks;
    if (more && !ready) hopper::mbar_wait(full_of(k + 1), ((k + 1) / STAGES) & 1);
    const bool probe = k + 2 >= chunks || hopper::mbar_test(full_of(k + 2), ((k + 2) / STAGES) & 1);
    const int nk = more ? k + 1 : k;
    const int valid = min(ROWS, n - k * ROWS);
    if (valid == ROWS && last_v == cur) {
      // Every row of this stage is the current code's: one unbroken chain
      // over registers, beside the reads of the next stage.  The reads are
      // asm, so that the compiler keeps them here between the adds instead
      // of merging them with the other path's reads after the branch (the
      // chain's first add would then wait on them).
      const uint32_t a = hopper::smem_u32(slot(nk));
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        w[i] = lds(a + i * S * 4);
        acc += v[i];
      }
    } else {
      // A code begins inside: row by row from the slot, 8 rows a read (a
      // short loop, so that this path stays small beside the chain's).
      const float* here = slot(k);
      const int* hc = codes_of(k);
#pragma unroll 1
      for (int i0 = 0; i0 < valid; i0 += 8) {
        float t[8];
        int c[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          t[j] = here[(i0 + j) * S];
          c[j] = hc[i0 + j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (i0 + j < valid) {
            if (c[j] != cur) next_code(c[j]);   // uniform over the warp
            acc += t[j];
          }
        }
      }
      const float* nxt = slot(nk);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) w[i] = nxt[i * S];
    }
    const int last_w = codes_of(nk)[ROWS - 1];
    release(k);
    return Next{last_w, probe};
  };
  float va[ROWS], vb[ROWS];
  Next nx{-1, false};
  if (chunks > 0) {
    hopper::mbar_wait(full_of(0), 0);
    const float* s0 = slot(0);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) va[i] = s0[i * S];
    nx.last = codes_of(0)[ROWS - 1];
  }
  for (int k = 0; k < chunks; k += 2) {
    nx = step(va, vb, nx.last, k, nx.ready);
    if (k + 1 < chunks) nx = step(vb, va, nx.last, k + 1, nx.ready);
  }
  if (chunks > 0) next_code(-1);
}

std::atomic<unsigned long long> smem_opted;

}  // namespace

// perm (N,), seg (N,) (the code of each row of perm), offsets (C + 1,) and
// the count of ids outside [0, C) (one int) of ids (N,) int64 (is64 = 1) or
// int32.
extern "C" int wt_segment_order(const void* ids, int is64, int N, int C, int* perm, int* seg,
                                int* offsets, int* outside, void* stream) {
  const int grid = (C + OCODES - 1) / OCODES;
  segment_order_kernel<<<grid, OWARPS * 32, 0, (cudaStream_t)stream>>>(ids, is64, N, C, perm, seg,
                                                                      offsets, outside);
  return (int)cudaGetLastError();
}

// Blocks of the sum kernel at `codes` codes a block that one SM of the
// current device holds at once.
extern "C" int wt_segment_sum_occupancy(int codes, int* blocks) {
  const int rc = hopper::allow_smem(segment_sum_kernel, 232448, &smem_opted);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, segment_sum_kernel, THREADS,
                                                            smem_bytes(codes));
}

// out (C, D) from rows (N, D) and the order; `codes` codes a block; vec:
// rows 16-byte aligned.
extern "C" int wt_segment_sum(const float* rows, const int* perm, const int* seg,
                              const int* offsets, float* out, int C, int D, int codes, int vec,
                              void* stream) {
  const int rc = hopper::allow_smem(segment_sum_kernel, 232448, &smem_opted);
  if (rc != 0) return rc;
  const dim3 grid((D + S - 1) / S, (C + codes - 1) / codes);
  segment_sum_kernel<<<grid, THREADS, smem_bytes(codes), (cudaStream_t)stream>>>(
      rows, perm, seg, offsets, D, C, codes, vec, out);
  return (int)cudaGetLastError();
}
