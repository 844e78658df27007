// Nearest-codebook search for the single-codebook VQ: for every row x_n of
// x (N, D) return argmax_c -(||x_n||^2 - 2 x_n . e_c + ||e_c||^2), the lowest
// index winning ties.
//
// Replaces the Pallas TPU kernel wavtokenizer_tpu/ops/kernels.py:151
// vq_nearest_fused (_vq_kernel), which runs the contraction on the MXU at
// Precision.HIGHEST (a multi-pass split-bf16 product) and keeps the (N, C)
// distance matrix in VMEM.  Here too the distances never leave registers:
// the argmax is fused into the epilogue of every (row tile, code tile).
//
// What bounds it on an H100 at N = 28 800, C = 4096, D = 512:
// * The products.  The tokens are the contract, so the product needs fp32
//   accuracy.  It runs as 3xTF32 on the tensor cores: every operand is split
//   into a TF32 head and tail, and hi.hi + hi.lo + lo.hi are summed in f32
//   (lo.lo, ~2^-22 relative, is dropped).  That is 3 x 2NCD = 362 GFLOP at
//   the 495 TFLOP/s TF32 peak: 0.732 ms, the bound.  The same work as fp32
//   FMAs on the CUDA cores (67 TFLOP/s) would take 1.803 ms.
// * L2 -> SM traffic.  Each 192-row x 128-code tile streams its x rows
//   (fp32) and the codebook's head and tail (fp32 each) through 32-deep
//   k-blocks: 56 KB for 2.36 M multiply-adds, 4.4 GB over the 150 x 32
//   tiles, the same order as the products at the ~6 TB/s the L2 delivered
//   to the ConvNeXt GEMMs.  The bytes from device memory (x once, the 16 MB
//   pack once) are ~0.03 ms.
// Measured on the card (PERF.md; tools/bench_vq.py): with 128-row tiles, halving the
// codebook's share of that traffic by TMA multicast across a cluster of two
// blocks did not help, while a third consumer warpgroup (192-row tiles) did:
// what remains is the tensor cores' issue rate between k-blocks, not L2.
//
// The design:
// * wgmma.mma_async m64n128k8 .tf32, f32 accumulators in registers.  A block
//   has three consumer warpgroups, each owning 64 rows of a 192 x 128 tile
//   (64 accumulators a thread), and one producer warp.
// * A (x) comes from registers: TMA brings the fp32 x tile to shared memory
//   and each thread splits its fragment there, so no pre-pass writes and
//   re-reads split copies of x.  B (the codebook) is split once, when the
//   model is built (ops/kernels.py::pack_vq_codebook), into a head and a
//   tail that TMA brings in as they lie: both operands are K-major, as
//   wgmma's TF32 form requires.
// * The split rounds with integer ops (half an ulp of TF32 added, the 13 low
//   bits cleared), at full rate; cvt.rna.tf32 runs at an eighth of it.  The
//   tail is rounded the same way, so every value the tensor cores read is
//   exact in TF32.
// * Per k-block the two small products go first, then hi.hi, all into one
//   f32 accumulator chain: its distance error stays ~1e-6 relative even if
//   the tensor cores round toward zero (emulated in
//   tests/test_torch_vq_split.py), far inside the 1e-5 near-tie rule.
//   Partial sums per k-block added on the CUDA cores (as the encoder
//   front's last conv does) cost ~30-40 more registers and 6-13% of the
//   time, and changed no code on the card.
// * A 4-stage ring of 56 KB stages (x, head, tail), full/empty mbarriers,
//   128-byte swizzle; ragged N, C and D are zero-filled by TMA and masked in
//   the epilogue.  One block per SM, persistent over the (row tile, code
//   tile) pairs with the code tile varying fastest, so the blocks in flight
//   share a few x row tiles and the whole 16 MB pack in L2, and the 4 800
//   pairs fill 132 SMs to 98%.
// * Epilogue: |x|^2 is summed in fp32 from the same fragments, the reference
//   formula is rounded op by op, and each thread keeps a running (max, index)
//   over its codes.  A pair's winner per row goes out as a 64-bit atomicMax
//   of (order-preserving key of the distance) << 32 | (0xFFFFFFFF - index),
//   so the largest distance wins and, among equal ones, the lowest index;
//   -0.0 is keyed as +0.0.  A second small launch unpacks the indices.
//
// Plain C interface, bound from Python with ctypes
// (wavtokenizer_tpu_torch/ops/kernels.py::vq_nearest).

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CONSUMERS = 3;              // warpgroups of 64 rows each
constexpr int BM = 64 * CONSUMERS;        // rows of x per tile
constexpr int BN = 128;                   // codes per tile
constexpr int BK = 32;     // depth of a k-block: one 128-byte swizzle row of fp32
constexpr int STAGES = 4;
constexpr int X_BYTES = BM * BK * 4;      // the x tile
constexpr int E_BYTES = BN * BK * 4;      // 16 KB: the head or the tail tile
constexpr int STAGE_BYTES = X_BYTES + 2 * E_BYTES;
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp
// The ring, its barriers, and slack to align the ring to 1024 bytes (the
// period of the 128-byte swizzle).
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(SMEM <= 232448, "one block's shared memory");

// fp32 -> TF32, rounded half away from zero with integer ops.
__device__ __forceinline__ uint32_t tf32_round(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// d (+)= a b for one m64n128k8 TF32 product: A (64 x 8) from registers, B
// (128 codes x 8) from shared memory.  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Distance and index as one 64-bit key whose unsigned order is "larger
// distance, then lower index": the float's bits mapped to an order-preserving
// unsigned (negative floats inverted, the sign bit set on the others), -0.0
// first canonicalised to +0.0.
__device__ __forceinline__ unsigned long long order_key(float d, int idx) {
  uint32_t u = __float_as_uint(__fadd_rn(d, 0.f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)idx);
}

__global__ void __launch_bounds__(THREADS, 1)
vq_kernel(const __grid_constant__ CUtensorMap map_x,
          const __grid_constant__ CUtensorMap map_hi,
          const __grid_constant__ CUtensorMap map_lo, const float* __restrict__ esq,
          unsigned long long* __restrict__ keys, int N, int C, int D) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t full = ring + STAGES * STAGE_BYTES;   // STAGES barriers
  const uint32_t empty = full + STAGES * 8;            // STAGES barriers
  const int kblocks = (D + BK - 1) / BK;
  const int ntiles_n = (C + BN - 1) / BN;
  const int ntiles = (N + BM - 1) / BM * ntiles_n;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Persistent: block b takes pairs b, b + grid, ...; one running k-block
  // count across the pairs drives the ring's stage and phase.
  if (wg == CONSUMERS) {
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = tile / ntiles_n * BM, n0 = tile % ntiles_n * BN;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);   // round 0 passes
          const uint32_t st = ring + s * STAGE_BYTES;
          mbar_expect_tx(full + 8 * s, STAGE_BYTES);
          tma_load(st, &map_x, full + 8 * s, kb * BK, m0);
          tma_load(st + X_BYTES, &map_hi, full + 8 * s, kb * BK, n0);
          tma_load(st + X_BYTES + E_BYTES, &map_lo, full + 8 * s, kb * BK, n0);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows 64 wg .. + 63 of each tile.  This thread's A
  // fragment rows are r and r + 8 (r = rl within the tile), its columns
  // t and t + 4 of every 8-deep step; its accumulator i sits at row
  // r + 8 ((i / 2) % 2) and code 8 (i / 4) + 2 t + i % 2.
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rl = wg * 64 + warp * 16 + g;
  float acc[64];   // overwritten by each tile's first product
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = tile / ntiles_n * BM, n0 = tile % ntiles_n * BN;
    float xsq[2] = {0.f, 0.f};
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t st = ring + s * STAGE_BYTES;
      const uint8_t* xt = ring_ptr + s * STAGE_BYTES;
      // This thread's x fragments split into TF32 heads and tails; element
      // (row, k) of the swizzled x tile lies in 16-byte chunk (k / 4) ^
      // (row % 8) of the row's 128 bytes.
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = rl + 8 * (q & 1);
          const int chunk = (2 * ks + (q >> 1)) ^ g;
          const float v = *reinterpret_cast<const float*>(xt + row * 128 + chunk * 16 + 4 * t);
          xsq[q & 1] = __fadd_rn(xsq[q & 1], __fmul_rn(v, v));
          ah[ks][q] = tf32_round(v);
          al[ks][q] = tf32_round(__fsub_rn(v, __uint_as_float(ah[ks][q])));
        }
      }
      // The 12 products of the 4 steps, the small ones first: lo.hi and
      // hi.lo, then hi.hi.
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_tf32(acc, al[ks], smem_desc(st + X_BYTES + 32 * ks), kb > 0 || ks > 0);
        wgmma_tf32(acc, ah[ks], smem_desc(st + X_BYTES + E_BYTES + 32 * ks), 1);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_tf32(acc, ah[ks], smem_desc(st + X_BYTES + 32 * ks), 1);
      wgmma_commit();
      wgmma_wait<0>();
      if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * s);
    }
    fence_acc(acc);

    // |x|^2 of rows r and r + 8: the quad's four partial sums (every lane
    // ends with the same value: float addition commutes).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      xsq[h] += __shfl_xor_sync(0xffffffffu, xsq[h], 1);
      xsq[h] += __shfl_xor_sync(0xffffffffu, xsq[h], 2);
    }
    // The reference formula -(xsq - 2 xe + esq), rounded op by op, then a
    // running argmax; codes arrive in increasing order within a thread, so
    // "strictly greater" keeps the lowest index of a tie.
    float best[2] = {-INFINITY, -INFINITY};
    int bidx[2] = {INT_MAX, INT_MAX};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = n0 + 8 * j + 2 * t + i;
        if (c < C) {
          const float ec = __ldg(esq + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d =
                -__fadd_rn(__fsub_rn(xsq[h], __fmul_rn(2.f, acc[4 * j + 2 * h + i])), ec);
            if (d > best[h]) { best[h] = d; bidx[h] = c; }
          }
        }
      }
    }
    // The quad's winner per row, then one atomic per row and pair.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[h], o);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[h], o);
        if (ov > best[h] || (ov == best[h] && oi < bidx[h])) { best[h] = ov; bidx[h] = oi; }
      }
      const int row = m0 + rl + 8 * h;
      if (t == 0 && row < N && bidx[h] != INT_MAX)
        atomicMax(keys + row, order_key(best[h], bidx[h]));
    }
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ keys,
                              int* __restrict__ out, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n < N) {
    const unsigned long long k = keys[n];
    out[n] = k == 0 ? 0 : (int)(0xFFFFFFFFu - (uint32_t)k);
  }
}

}  // namespace

// out (N,) int32 = argmax_c -(|x|^2 - 2 x.e_c + |e_c|^2) for x (N, D) f32,
// with the codebook given as pack (2, C, D) f32 = its TF32 head and tail and
// esq (C,) = |e_c|^2.  keys (N,) 64-bit is scratch.  Needs D > 0, D % 4 == 0
// (the TMA row stride) and 16-byte aligned x and pack.
extern "C" int wt_vq_nearest(const float* x, const float* pack, const float* esq,
                             void* keys, int* out, int N, int C, int D, void* stream) {
  static std::atomic<unsigned long long> configured{0};
  if (const int e = allow_smem(vq_kernel, SMEM, &configured)) return e;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap map_x, map_hi, map_lo;
  if (!make_map(&map_x, f32, 4, x, N, D, BK, BM) ||
      !make_map(&map_hi, f32, 4, pack, C, D, BK, BN) ||
      !make_map(&map_lo, f32, 4, pack + (size_t)C * D, C, D, BK, BN))
    return kMapError;
  int sms = 0;
  if (const int e = sm_count(&sms)) return e;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* k = static_cast<unsigned long long*>(keys);
  cudaError_t e = cudaMemsetAsync(k, 0, (size_t)N * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (N + BM - 1) / BM * ((C + BN - 1) / BN);
  const int grid = tiles < sms ? tiles : sms;
  vq_kernel<<<grid, THREADS, SMEM, s>>>(map_x, map_hi, map_lo, esq, k, N, C, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  unpack_kernel<<<(N + 255) / 256, 256, 0, s>>>(k, out, N);
  return (int)cudaGetLastError();
}
