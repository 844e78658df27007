// SEANet encoder front, layers 0-6 of the small-320 geometry, in fp32:
//
//   conv k7 1->32 -> resblock(32: ELU, k3 32->16, ELU, k1 16->32, plus a
//   k1 32->32 shortcut on the un-ELU'd input) -> ELU -> down k4 s2 32->64
//   -> resblock(64: k3 64->32, k1 32->64, k1 shortcut) -> ELU
//   -> down k8 s4 64->128
//
// audio (B, T) -> (B, T/8, 128), for T % 8 == 0 (no extra right padding at
// any of these layers) and T >= 1024 (the gate of the JAX kernel,
// models/seanet.py and ops/encoder_front.py::front_geometry_matches).
//
// Replaces the Pallas TPU kernel wavtokenizer_tpu/ops/encoder_front.py
// encoder_front_fused (_kernel).  That kernel emulates fp32 with bf16 hi/lo
// three-term products on the MXU, carries activations phase-major because
// Mosaic cannot interleave rows, and splices the 8 edge frames on each side
// from the plain path.  None of that carries over: layers 0-5 are plain
// fp32 FMAs on the CUDA cores, ELU is expm1f as F.elu computes it, and the
// last conv runs as 3xTF32 on the tensor cores (below), an fp32-class route
// like the reference's own Precision.HIGH (bf16 x3): the tokens are the
// contract, and plain TF32 would not hold them.
//
// One launch.  A block owns NT = 62 final positions [n0, n0 + NT) of one
// batch row and computes layers 0-6 for their receptive field entirely in
// shared memory, so no intermediate reaches device memory.  Each activation
// is held channel-major as "slots" over a range of logical positions that
// runs a few positions past the tile on each side (the halo: the k8 s4 conv
// needs x3 at 4n-2 .. 4n+5, and so on down to the audio):
//
//   array        origin (logical)  slots  channels  region
//   audio        8 n0 - 11         518    1         sa
//   x0 / h       8 n0 - 8          512    32        R0
//   z            8 n0 - 7          510    16        R1
//   x1e          8 n0 - 7          510    32        R2
//   x2 / h2      4 n0 - 3          254    64        R0
//   z2           4 n0 - 2          252    32        R1
//   x3e          4 n0 - 2          252    64        R2
//
// (rate-T rows are 512 floats apart, rate-T/2 rows 257.)
//
// The origins are chosen so that output slot s of every conv reads input
// slots S*s + k (+1 for the two k1 shortcuts).  Every conv of this stack
// reflect-pads its own input; a slot whose logical position lies outside
// the sequence must hold the activation at the reflected position.  So a
// conv first computes every slot as if the sequence had no edge, then the
// slots past an edge are overwritten by copies of their reflected slots
// ("fixup"), before the next conv reads them.  In the interior that costs
// nothing; the edges are exact with no splice.  Slots far past the right
// edge of a last, partial tile hold values no valid output reads.
//
// Work split, layers 0-5: each conv hands (positions x channels) units to
// the 8 warps; a lane keeps an 8 x 8 (positions x output channels) register
// tile, 4 x 8 for the two k3 convs, whose narrow outputs would leave warps
// idle at 8 x 8.  A warp's lanes read consecutive slots of one channel row
// (conflict-free) and the weights as float4 broadcasts.
//
// Layer 6 (65 536 weights, 38% of the multiply-adds) is an im2col GEMM of
// the block's 64 (62 valid) positions x 512 x 128 on the tensor cores with
// mma.sync m16n8k8 TF32: every operand is split into a TF32 head and tail
// and three products are summed in f32 (3xTF32), ~2^-21 relative per
// product, the accuracy class of fp32.
//
// Weights: the two packs of layers 0-5 (45.6 KB and 48.6 KB) are staged in
// shared memory with cp.async, one after the other; the last conv's weights
// (256 KB) stream through a 3-slot ring of 17 KB K-slices (cp.async, two
// slices in flight), whose first two load while the resblock's last conv
// still runs.  216 KB of shared memory: one block per SM.
//
// What bounds it on an H100: 21 728 multiply-adds per audio sample, i.e.
// ~0.40 TFLOP at B=128 x 3 s: ~6.0 ms at the 67 TFLOP/s fp32 CUDA-core peak
// with every product an fp32 FMA; with layer 6 as 3xTF32 (3 x 0.151 TFLOP
// at 495 TFLOP/s, 0.9 ms) beside layers 0-5 on the CUDA cores (0.25 TFLOP,
// 3.7 ms), ~3.7 ms.  The bytes are ~37 MB in and ~590 MB out (~0.19 ms at
// 3.35 TB/s): arithmetic.  Not in either bound: ~160 ELUs (expm1f) per
// sample, and the halos, which recompute ~5% of layers 0-5.
//
// Plain C interface, bound from Python with ctypes
// (wavtokenizer_tpu_torch/ops/kernels.py::encoder_front).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NT = 62;                 // final positions per block

// Offsets (floats) of the packed weights; ops/encoder_front.py builds the
// packs in this order.  Every conv is (C_in, K, C_out), then its bias.
constexpr int A_W0 = 0, A_B0 = A_W0 + 1 * 7 * 32;           // conv0 k7 1->32
constexpr int A_W3 = A_B0 + 32, A_B3 = A_W3 + 32 * 3 * 16;   // k3 32->16
constexpr int A_W1 = A_B3 + 16, A_B1 = A_W1 + 16 * 1 * 32;   // k1 16->32
constexpr int A_WS = A_B1 + 32, A_BS = A_WS + 32 * 1 * 32;   // shortcut 32->32
constexpr int A_WD = A_BS + 32, A_BD = A_WD + 32 * 4 * 64;   // down k4 s2
constexpr int A_SIZE = A_BD + 64;
constexpr int B_W3 = 0, B_B3 = B_W3 + 64 * 3 * 32;           // k3 64->32
constexpr int B_W1 = B_B3 + 32, B_B1 = B_W1 + 32 * 1 * 64;   // k1 32->64
constexpr int B_WS = B_B1 + 64, B_BS = B_WS + 64 * 1 * 64;   // shortcut 64->64
constexpr int B_SIZE = B_BS + 64;
static_assert(A_SIZE == 11664 && B_SIZE == 12448, "pack layout");
static_assert(A_SIZE % 4 == 0 && B_SIZE % 4 == 0, "packs copy as float4");

// Slot counts and leading dimensions (floats) of the arrays above.
constexpr int NA = 8 * NT + 22;        // audio
constexpr int N0 = 8 * NT + 16;        // x0
constexpr int N1 = 8 * NT + 14;        // z, x1e
constexpr int N2 = 4 * NT + 6;         // x2
constexpr int N3 = 4 * NT + 4;         // z2, x3e
// Rate-T/2 rows are 257 floats: the tensor-core fragments of the last conv
// read 4 channel rows x 8 positions at once, conflict-free only when a row
// shifts the bank by one.
constexpr int LD1 = 512, LD2 = 257;    // rate T and rate T/2 arrays
static_assert(N0 <= LD1 && N2 <= LD2, "arrays fit their rows");
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int R0_FLOATS = cmax(32 * LD1, 64 * LD2);   // x0, then x2, then the ring
constexpr int R1_FLOATS = cmax(16 * LD1, 32 * LD2);   // z, then z2
constexpr int R2_FLOATS = cmax(32 * LD1, 64 * LD2);   // x1e, then x3e
static_assert(R0_FLOATS % 4 == 0 && R1_FLOATS % 4 == 0 && R2_FLOATS % 4 == 0,
              "regions stay 16-byte aligned");

constexpr int WB_FLOATS = B_SIZE;      // weight buffer: the larger pack

// The last conv's weights stream through a ring of K-slices in R0: 32 rows
// of the (512, 128) weight each, rows padded to 136 floats so that the B
// fragments (4 rows x 8 columns) hit 32 distinct banks.
constexpr int SLICE_ROWS = 32, SLICES = 512 / SLICE_ROWS, RING = 3, RS = 136;
constexpr int SLICE_FLOATS = SLICE_ROWS * RS;
static_assert(RING * SLICE_FLOATS <= R0_FLOATS, "ring fits in R0");

constexpr int AUDIO_FLOATS = (NA + 3) / 4 * 4;
constexpr int SLACK_FLOATS = 32;       // unclamped reads run a few slots past
constexpr int SMEM_FLOATS =
    R0_FLOATS + R1_FLOATS + R2_FLOATS + WB_FLOATS + AUDIO_FLOATS + SLACK_FLOATS;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
static_assert(SMEM_BYTES <= 232448, "one block per SM");

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expm1f(x); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy n floats (n % 4 == 0, both ends 16-byte aligned) into shared memory.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i);
}

// One conv over slots.  in[ci * ldi + slot] and out[co * ldo + slot] are
// channel-major; w is (CIN, K, COUT) and bias (COUT,), both in shared
// memory.  Output slot s (< n) reads input slots S * s + in_off + k.
// Epilogue: EPI 0 stores acc + b, EPI 1 ELU(acc + b), EPI 2 ELU(out + acc
// + b).  A warp's unit is PL * PT slots x (32 / PL) * PC channels; lane
// (pl, cl) holds slots s0 + pl + PL * j and channels c0 + cl * PC + c.
template <int CIN, int COUT, int K, int S, int PL, int PT, int PC, int EPI>
__device__ __forceinline__ void conv(const float* in, int ldi, int in_off,
                                     const float* w, const float* bias, float* out,
                                     int ldo, int n) {
  constexpr int CL = 32 / PL, WP = PL * PT, WC = CL * PC, G = COUT / WC;
  static_assert(COUT % WC == 0 && PC % 4 == 0, "channel groups");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pl = lane % PL, cl = lane / PL;
  const int units = (n + WP - 1) / WP * G;
  for (int u = warp; u < units; u += WARPS) {
    const int s0 = (u / G) * WP, c0 = (u % G) * WC + cl * PC;
    // Slots past n read whatever follows in shared memory (the next row or
    // region); their outputs are not stored.  Unclamped, the PT reads of a
    // tap are one base register plus immediate offsets.
    const int base = S * (s0 + pl) + in_off;
    float acc[PT][PC];
#pragma unroll
    for (int j = 0; j < PT; ++j)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[j][c] = 0.f;
    const float* wc = w + c0;
#pragma unroll 2
    for (int ci = 0; ci < CIN; ++ci) {
      const float* row = in + ci * ldi;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float a[PT], wv[PC];
#pragma unroll
        for (int j = 0; j < PT; ++j) a[j] = row[base + S * PL * j + k];
        const float4* w4 = reinterpret_cast<const float4*>(wc + (ci * K + k) * COUT);
#pragma unroll
        for (int c = 0; c < PC / 4; ++c) {
          const float4 v = w4[c];
          wv[4 * c] = v.x; wv[4 * c + 1] = v.y; wv[4 * c + 2] = v.z; wv[4 * c + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < PT; ++j)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[j][c] = fmaf(a[j], wv[c], acc[j][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      const float b = bias[c0 + c];
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const int s = s0 + pl + PL * j;
        if (s < n) {
          float* o = out + (c0 + c) * ldo + s;
          float v = acc[j][c] + b;
          if (EPI == 2) v = *o + v;
          if (EPI >= 1) v = elu(v);
          *o = v;
        }
      }
    }
  }
}

// ELU over every slot of a region's rows (the slots past n are never read).
template <int LD, int CHANNELS>
__device__ __forceinline__ void elu_inplace(float* buf) {
  float4* b4 = reinterpret_cast<float4*>(buf);
  for (int i = threadIdx.x; i < CHANNELS * LD / 4; i += THREADS) {
    float4 v = b4[i];
    v.x = elu(v.x); v.y = elu(v.y); v.z = elu(v.z); v.w = elu(v.w);
    b4[i] = v;
  }
}

// Reflect the slots of an array past the sequence's edges: slot i holds
// logical position p = origin + i of a sequence of length L; for p < 0 or
// p >= L it takes the slot of reflect(p), where that slot exists.
__device__ __forceinline__ void fixup(float* buf, int ld, int channels, int n, int origin,
                                      int L) {
  const int left = min(n, max(0, -origin));          // slots [0, left)
  const int right = max(left, min(n, L - origin));   // slots [right, n)
  const int count = left + (n - right);
  for (int i = threadIdx.x; i < channels * count; i += THREADS) {
    const int c = i / count, r = i % count;
    const int slot = r < left ? r : right + (r - left);
    const int p = origin + slot;
    const int q = p < 0 ? -p : 2 * L - 2 - p;
    const int src = q - origin;
    if (q >= 0 && q < L && src >= 0 && src < n) buf[c * ld + slot] = buf[c * ld + src];
  }
}

// The last conv's K-slice i: rows 32 i .. 32 i + 31 of the (512, 128) weight
// (row = tap * 64 + c_in), each row at a stride of RS floats.
__device__ __forceinline__ void stage_slice(float* ring, const float* __restrict__ wd, int i) {
  if (i >= SLICES) return;
  float* dst = ring + (i % RING) * SLICE_FLOATS;
  for (int v = threadIdx.x; v < SLICE_ROWS * 32; v += THREADS) {
    const int row = v / 32, c4 = v % 32;
    cp_async16(dst + row * RS + 4 * c4, wd + (size_t)(SLICE_ROWS * i + row) * 128 + 4 * c4);
  }
}

// fp32 x as a TF32 head and tail.  The head is x rounded to 10 mantissa
// bits (half an ulp added, the 13 low bits cleared: integer ops, full rate,
// where cvt.rna.tf32 runs at an eighth of it); the tail x - head is exact in
// fp32, and the tensor cores read its top 19 bits, so x ~= hi + lo to
// ~2^-21 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 TF32 tile (f32 sums).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS, 1)
front_kernel(const float* __restrict__ audio, const float* __restrict__ wa,
             const float* __restrict__ wb, const float* __restrict__ wd,
             const float* __restrict__ bd, float* __restrict__ out, int T,
             int tiles_per_row) {
  extern __shared__ __align__(16) float smem[];
  float* R0 = smem;
  float* R1 = R0 + R0_FLOATS;
  float* R2 = R1 + R1_FLOATS;
  float* WB = R2 + R2_FLOATS;
  float* sa = WB + WB_FLOATS;

  const int T2 = T / 2, T8 = T / 8;
  const int b = blockIdx.x / tiles_per_row;
  const int n0 = (blockIdx.x % tiles_per_row) * NT;
  const int nv = min(NT, T8 - n0);
  const int oa = 8 * n0 - 11, o0 = 8 * n0 - 8, o1 = 8 * n0 - 7;
  const int o2 = 4 * n0 - 3, o3 = 4 * n0 - 2;

  stage(WB, wa, A_SIZE);
  cp_commit();
  const float* ab = audio + (size_t)b * T;
  for (int i = threadIdx.x; i < NA; i += THREADS) {
    const int p = oa + i;
    const int q = p < 0 ? -p : (p >= T ? 2 * T - 2 - p : p);
    sa[i] = ab[min(max(q, 0), T - 1)];
  }
  cp_wait<0>();
  __syncthreads();

  // ---- layers 0-3 at rate T --------------------------------------------
  // x0 = conv0(audio), reflect pad 3/3 (in the audio slots).
  conv<1, 32, 7, 1, 32, 4, 8, 0>(sa, 0, 0, WB + A_W0, WB + A_B0, R0, LD1, N0);
  __syncthreads();
  fixup(R0, LD1, 32, N0, o0, T);
  __syncthreads();
  // Shortcut k1 on the un-ELU'd x0 into x1e.
  conv<32, 32, 1, 1, 32, 8, 8, 0>(R0, LD1, 1, WB + A_WS, WB + A_BS, R2, LD1, N1);
  __syncthreads();
  elu_inplace<LD1, 32>(R0);
  __syncthreads();
  // z = ELU(k3(h) + b), reflect pad 1/1 (in the x0 slots).
  conv<32, 16, 3, 1, 32, 4, 8, 1>(R0, LD1, 0, WB + A_W3, WB + A_B3, R1, LD1, N1);
  __syncthreads();
  // x1e = ELU(shortcut + k1(z) + b): the resblock and the ELU layer after it.
  conv<16, 32, 1, 1, 32, 8, 8, 2>(R1, LD1, 0, WB + A_W1, WB + A_B1, R2, LD1, N1);
  __syncthreads();
  fixup(R2, LD1, 32, N1, o1, T);
  __syncthreads();
  // x2 = down k4 s2 (reflect pad 1/1, in the x1e slots).
  conv<32, 64, 4, 2, 16, 8, 8, 0>(R2, LD1, 0, WB + A_WD, WB + A_BD, R0, LD2, N2);
  __syncthreads();

  // ---- layers 4-5 at rate T/2 ------------------------------------------
  stage(WB, wb, B_SIZE);
  cp_commit();
  fixup(R0, LD2, 64, N2, o2, T2);
  cp_wait<0>();
  __syncthreads();
  conv<64, 64, 1, 1, 32, 8, 8, 0>(R0, LD2, 1, WB + B_WS, WB + B_BS, R2, LD2, N3);
  __syncthreads();
  elu_inplace<LD2, 64>(R0);
  __syncthreads();
  conv<64, 32, 3, 1, 32, 4, 8, 1>(R0, LD2, 0, WB + B_W3, WB + B_B3, R1, LD2, N3);
  __syncthreads();
  // R0 is free: the last conv's first K-slices load during the next conv.
  float* ring = R0;
  for (int i = 0; i < RING - 1; ++i) {
    stage_slice(ring, wd, i);
    cp_commit();
  }
  conv<32, 64, 1, 1, 32, 8, 8, 2>(R1, LD2, 0, WB + B_W1, WB + B_B1, R2, LD2, N3);
  __syncthreads();
  fixup(R2, LD2, 64, N3, o3, T2);

  // ---- layer 6: down k8 s4 64->128, 3xTF32 on the tensor cores --------
  // An im2col GEMM: out (64 positions, 128) = A (64, 512) @ Wd (512, 128)
  // with A[s][tap * 64 + ci] = x3e[ci][4 s + tap] (rows 62, 63 are past the
  // tile and not stored).  Each operand is split into a TF32 head and tail
  // and the three products head*head, head*tail, tail*head are summed in
  // f32 (tail*tail, ~2^-21 relative, is dropped): fp32-class accuracy at
  // tensor-core rates.  Warp (wm, wn) = (warp / 4, warp % 4) owns rows
  // 32 wm .. + 31 and columns 32 wn .. + 31 as 2 x 4 m16n8k8 tiles.  Each
  // slice's 32-deep sums collect in the tensor cores and are added to the
  // running f32 sums on the CUDA cores, so no tensor-core sum runs longer
  // than 96 products.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp / 4, wn = warp % 4;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
  for (int i = 0; i < SLICES; ++i) {
    cp_wait<RING - 2>();
    __syncthreads();
    stage_slice(ring, wd, i + RING - 1);
    cp_commit();
    // Slice i is rows 32 i .. + 31: one tap, 32 input channels.
    const int tap = i / 2, ci0 = 32 * (i % 2);
    const float* xs = R2 + (ci0 + t) * LD2 + 4 * (32 * wm + g) + tap;
    const float* ws = ring + (i % RING) * SLICE_FLOATS + t * RS + 32 * wn + g;
    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[mi][ni][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < SLICE_ROWS / 8; ++kk) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        const float* xa = xs + 8 * kk * LD2 + 64 * mi;
        split_tf32(xa[0], ah[mi][0], al[mi][0]);
        split_tf32(xa[32], ah[mi][1], al[mi][1]);
        split_tf32(xa[4 * LD2], ah[mi][2], al[mi][2]);
        split_tf32(xa[4 * LD2 + 32], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // b0 (k t, column g), b1 (t + 4, g)
        const float* wb = ws + 8 * kk * RS + 8 * ni;
        split_tf32(wb[0], bh[ni][0], bl[ni][0]);
        split_tf32(wb[4 * RS], bh[ni][1], bl[ni][1]);
      }
      // Small products first; consecutive mmas go to different tiles, so
      // none waits on the one before it.
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(part[mi][ni], al[mi], bh[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(part[mi][ni], ah[mi], bl[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(part[mi][ni], ah[mi], bh[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
  }
  // c0, c1 at (row g, columns 2t, 2t + 1); c2, c3 at row g + 8.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = 32 * wn + 8 * ni + 2 * t;
    const float b0 = __ldg(bd + col), b1 = __ldg(bd + col + 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int srow = 32 * wm + 16 * mi + g + 8 * h;
        if (srow < nv)
          *reinterpret_cast<float2*>(out + ((size_t)b * T8 + n0 + srow) * 128 + col) =
              make_float2(acc[mi][ni][2 * h] + b0, acc[mi][ni][2 * h + 1] + b1);
      }
  }
}

}  // namespace

// audio (B, T) f32 -> out (B, T/8, 128) f32.  wa / wb are the packs of
// layers 0-3 and 4-5, wd (512, 128) and bd (128,) the last conv.  Returns the
// CUDA error of the launch, or 0.
extern "C" int wt_encoder_front(const float* audio, const float* wa, const float* wb,
                                const float* wd, const float* bd, float* out, int B,
                                int T, void* stream) {
  static std::atomic<unsigned long long> configured{0};
  if (const int e = hopper::allow_smem(front_kernel, SMEM_BYTES, &configured)) return e;
  const int tiles = (T / 8 + NT - 1) / NT;
  front_kernel<<<B * tiles, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      audio, wa, wb, wd, bd, out, T, tiles);
  return (int)cudaGetLastError();
}
