// One ConvNeXt block of the Vocos backbone, inference only, in three
// launches:
//   (a) wt_convnext_dwln:  depthwise conv k7 (zero pad 3,3) + bias ->
//       LayerNorm (eps 1e-6) -> resolved scale/shift, written as bf16 h,
//       one warp per row, float4 loads, shuffle-only reductions;
//   (b) wt_convnext_gemm1: g = GELU_exact(h @ W1 + b1), bf16 operands,
//       f32 accumulation, written as bf16;
//   (c) wt_convnext_gemm2: out = x + gamma * (g @ W2 + b2), bf16 operands,
//       f32 accumulation, written as f32.
//
// Replaces the Pallas TPU kernel wavtokenizer_tpu/ops/kernels.py
// convnext_block_fused (_convnext_kernel), which runs the whole block per
// batch row out of VMEM.  The function is the same (bf16 operands, f32
// sums, exact GELU); the blocking is not: a Hopper block has 227 KB of
// shared memory, not the TPU's tens of MB, so the two products are tiled
// GEMMs over all B*T rows and the bf16 intermediates (h, g) go through
// device memory.
//
// What bounds it on an H100: the two products, 4*M*C*I bf16 FLOPs (204
// GFLOP at M=28 800, C=768, I=2304) against the 989 TFLOP/s dense bf16
// tensor-core peak, ~0.21 ms; the bytes (x and out in f32, h and g in bf16,
// 7 MB of weights) are ~0.1 ms at 3.35 TB/s.  So (b) and (c) are built
// around Hopper's own tensor-core path:
//
// * wgmma.mma_async m64n128k16, bf16 in, f32 accumulators in registers.
//   A block computes a 128 x 128 output tile; two consumer warpgroups each
//   own 64 rows of it (64 accumulator registers a thread).
// * TMA (cp.async.bulk.tensor.2d) brings 128 x 64 tiles of A and of B^T into
//   a ring of 3 shared-memory stages (32 KB each, dynamic shared memory),
//   with the 128-byte swizzle that the wgmma descriptors name.  One producer
//   warp keeps the ring full; "full" mbarriers count the bytes in, "empty"
//   mbarriers the two consumers out.  A consumer keeps one k-block of
//   products in flight while it waits for the next stage.  The blocks are
//   persistent, two per SM (96 KB of shared memory and <= 113 registers a
//   thread each), and walk the output tiles: the producer fills the next
//   tile's stages during the epilogue, and one block's epilogue overlaps the
//   other's products.  TMA zero-fills rows and K columns past the tensor's
//   edge, so ragged M, N and K need no special path; the epilogue masks its
//   stores.
// * Both operands are K-major, as the descriptors expect: A is h or g
//   (row-major, K contiguous) and B is the weight transposed to (N, K),
//   repacked once when the model is built (api/pretrained.py, w1t / w2t).
// * The epilogue runs from the accumulator registers: bias, then the exact
//   GELU to bf16 (b) or the f32 residual x + gamma * y (c), stored as
//   bf16x2 / float2 pairs, with nothing staged through shared memory.
//
// The tensor maps are encoded on the host for every call (h and g are
// allocated per call) through cuTensorMapEncodeTiled, a driver-API call
// fetched with cudaGetDriverEntryPoint so that the library links only the
// CUDA runtime, and passed as __grid_constant__ kernel parameters.  The
// mbarrier, TMA and descriptor helpers are shared with vq_nearest.cu
// (hopper.cuh).
//
// Plain C interface, bound from Python with ctypes
// (wavtokenizer_tpu_torch/ops/kernels.py::convnext_block).

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------- (a)

constexpr int LN_THREADS = 256;
constexpr int LN_ROWS = LN_THREADS / 32;   // one warp per (b, t) row
constexpr int LN_VEC = 8;                  // float4 per lane: C <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y), fmaf(a.z, b.z, c.z),
                     fmaf(a.w, b.w, c.w));
}

// One warp per (b, t) row; lane l keeps channels 4 (l + 32 q) .. + 3 in
// registers as float4 and reads the 7 rows around t as float4 (the rows
// around it are the neighbouring warps' rows, so they come from L1/L2).  The
// LayerNorm's two sums are warp shuffles: no block-wide barrier.  Needs
// C % 4 == 0 and C <= 1024.
__global__ void __launch_bounds__(LN_THREADS)
dwln_kernel(const float* __restrict__ x, const float* __restrict__ dw,
            const float* __restrict__ dwb, const float* __restrict__ scale,
            const float* __restrict__ shift, __nv_bfloat16* __restrict__ h,
            int M, int T, int C) {
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;   // b * T + t
  if (row >= M) return;
  const int lane = threadIdx.x % 32, C4 = C / 4;
  const int t = row % T;
  const float4* xb = reinterpret_cast<const float4*>(x + (size_t)(row - t) * C);
  const float4* dw4 = reinterpret_cast<const float4*>(dw);
  float4 v[LN_VEC];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < LN_VEC; ++q) {
    const int c = lane + 32 * q;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < C4) {
      acc = __ldg(reinterpret_cast<const float4*>(dwb) + c);
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int tt = t + k - 3;
        if (tt >= 0 && tt < T) acc = fma4(__ldg(xb + (size_t)tt * C4 + c), __ldg(dw4 + k * C4 + c), acc);
      }
      s += (acc.x + acc.y) + (acc.z + acc.w);
    }
    v[q] = acc;
  }
  const float mean = warp_sum(s) / (float)C;
  float s2 = 0.f;
#pragma unroll
  for (int q = 0; q < LN_VEC; ++q) {
    if (lane + 32 * q < C4) {
      const float a = v[q].x - mean, b = v[q].y - mean, c = v[q].z - mean, d = v[q].w - mean;
      s2 += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float inv = rsqrtf(warp_sum(s2) / (float)C + 1e-6f);
  uint2* hrow = reinterpret_cast<uint2*>(h + (size_t)row * C);
#pragma unroll
  for (int q = 0; q < LN_VEC; ++q) {
    const int c = lane + 32 * q;
    if (c < C4) {
      const float4 sc = __ldg(reinterpret_cast<const float4*>(scale) + c);
      const float4 sh = __ldg(reinterpret_cast<const float4*>(shift) + c);
      const __nv_bfloat162 lo = __floats2bfloat162_rn((v[q].x - mean) * inv * sc.x + sh.x,
                                                      (v[q].y - mean) * inv * sc.y + sh.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn((v[q].z - mean) * inv * sc.z + sh.z,
                                                      (v[q].w - mean) * inv * sc.w + sh.w);
      hrow[c] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                           *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

// ---------------------------------------------------------------- (b), (c)

constexpr int BM = 128, BN = 128, BK = 64;   // BK: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int TILE_BYTES = BM * BK * 2;      // 16 KB, A and B tiles alike
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows each
constexpr int GEMM_THREADS = CONSUMERS * 128 + 32;   // + one producer warp
// The ring, its barriers, and slack to align the ring to 1024 bytes (the
// period of the 128-byte swizzle).
constexpr int GEMM_SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(BM == BN, "one box shape serves A and B");

enum Epilogue { kGelu = 0, kResidual = 1 };

__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// C (M, N) = A (M, K) @ B (K, N), with A given as the tensor map of the
// (M, K) bf16 matrix and B as that of its transpose (N, K), both K-major.
template <int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            const float* __restrict__ bias, const float* __restrict__ gamma,
            const float* __restrict__ resid, void* __restrict__ out,
            int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;   // STAGES barriers
  const uint32_t empty = full + STAGES * 8;            // STAGES barriers
  const int kblocks = (K + BK - 1) / BK;
  const int ntiles_n = (N + BN - 1) / BN;
  const int ntiles = (M + BM - 1) / BM * ntiles_n;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Persistent: block b takes tiles b, b + grid, ...; N varies fastest, so
  // the blocks in flight share their A rows in L2.  One running k-block
  // count across the tiles drives the ring's stage and phase.
  if (wg == CONSUMERS) {
    // Producer warp: one thread issues every load, running ahead into the
    // next tile while the consumers finish the current one.
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = tile / ntiles_n * BM, n0 = tile % ntiles_n * BN;
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);   // round 0 passes
          const uint32_t a = ring + s * STAGE_BYTES;
          mbar_expect_tx(full + 8 * s, STAGE_BYTES);
          tma_load(a, &map_a, full + 8 * s, kb * BK, m0);
          tma_load(a + TILE_BYTES, &map_b, full + 8 * s, kb * BK, n0);
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows m0 + 64 wg .. + 63 of each tile.
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = tile / ntiles_n * BM, n0 = tile % ntiles_n * BN;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + 8 * s, (it / STAGES) & 1);
      const uint32_t a = ring + s * STAGE_BYTES + wg * 64 * 128;
      const uint32_t b = ring + s * STAGE_BYTES + TILE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)   // 16 K-columns = 32 bytes a step
        wgmma_128(d, smem_desc(a + 32 * k), smem_desc(b + 32 * k), 1);
      wgmma_commit();
      // Keep this k-block's products in flight; the previous one is done, so
      // its stage goes back to the producer.
      wgmma_wait<1>();
      fence_acc(d);
      if (kb > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));

    // Epilogue from the registers.  Accumulator i of this thread sits at row
    // 16 warp + lane/4 + 8 ((i/2) % 2) and column 8 (i/4) + 2 (lane % 4) + i % 2
    // of the warpgroup's 64 x 128 slice.
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * (lane % 4);
      if (col >= N) continue;   // N is even: col + 1 < N too
      const float2 bv = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= M) continue;
        const float y0 = d[4 * j + 2 * h] + bv.x, y1 = d[4 * j + 2 * h + 1] + bv.y;
        const size_t o = (size_t)row * N + col;
        if (EPI == kGelu) {
          const float g0 = 0.5f * y0 * (1.f + erff(y0 * 0.70710678118654752f));
          const float g1 = 0.5f * y1 * (1.f + erff(y1 * 0.70710678118654752f));
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(g0, g1);
        } else {
          const float2 gv = *reinterpret_cast<const float2*>(gamma + col);
          const float2 xv = *reinterpret_cast<const float2*>(resid + o);
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + o) =
              make_float2(xv.x + gv.x * y0, xv.y + gv.y * y1);
        }
      }
    }
  }
}

// Tensor map of a row-major (rows, K) bf16 matrix: boxes of 64 K-columns x
// 128 rows, 128-byte swizzle, zeros past the edges.  Needs K % 8 == 0.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int K) {
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows, K, BK, BM);
}

template <int EPI>
int launch_gemm(const void* a, const void* bt, const float* bias, const float* gamma,
                const float* resid, void* out, int M, int K, int N, cudaStream_t stream) {
  static std::atomic<unsigned long long> configured{0};
  if (const int e = allow_smem(gemm_kernel<EPI>, GEMM_SMEM, &configured)) return e;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, M, K) || !make_map(&map_b, bt, N, K)) return kMapError;
  int sms = 0;
  if (const int e = sm_count(&sms)) return e;
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  const int grid = tiles < 2 * sms ? tiles : 2 * sms;   // two blocks per SM
  gemm_kernel<EPI><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(map_a, map_b, bias, gamma,
                                                               resid, out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wt_convnext_dwln(const float* x, const float* dw,
                                const float* dwb, const float* scale,
                                const float* shift, void* h, int B, int T,
                                int C, void* stream) {
  const int M = B * T;
  dwln_kernel<<<(M + LN_ROWS - 1) / LN_ROWS, LN_THREADS, 0, (cudaStream_t)stream>>>(
      x, dw, dwb, scale, shift, reinterpret_cast<__nv_bfloat16*>(h), M, T, C);
  return (int)cudaGetLastError();
}

// g (M, N) bf16 = GELU(h (M, K) @ w1 + b1), with w1t = w1^T (N, K) bf16.
extern "C" int wt_convnext_gemm1(const void* h, const void* w1t,
                                 const float* b1, void* g, int M, int K,
                                 int N, void* stream) {
  return launch_gemm<kGelu>(h, w1t, b1, nullptr, nullptr, g, M, K, N,
                            (cudaStream_t)stream);
}

// out (M, N) f32 = x + gamma * (g (M, K) @ w2 + b2), with w2t = w2^T (N, K).
extern "C" int wt_convnext_gemm2(const void* g, const void* w2t,
                                 const float* b2, const float* gamma,
                                 const float* x, float* out, int M, int K,
                                 int N, void* stream) {
  return launch_gemm<kResidual>(g, w2t, b2, gamma, x, out, M, K, N,
                                (cudaStream_t)stream);
}
