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
// from the plain path.  None of that carries over: here every product is a
// plain fp32 FMA on the CUDA cores (no TF32, no tensor cores: the tokens are
// the contract), ELU is expm1f as F.elu computes it, and the sequence edges
// are reflected in-kernel (route 2 of the port's plan, no splice):
//
// * Every conv of this stack reflect-pads its own input.  A tile holds each
//   activation in shared memory, channel-major, as "slots" over a range of
//   logical positions that may run past either end of the sequence; the slot
//   of logical position p holds the activation at reflect(p).  A conv
//   computes slot p from its true position q = reflect(p), reading the input
//   slots around q, which already hold the reflected input values.  In the
//   interior q = p and this costs one compare per output position.
//
// Three launches, fp32 intermediates in device memory:
//   (a) front_a: conv0 + resblock(32) + ELU + down k4 s2 -> x2 (B, T/2, 64)
//   (b) front_b: resblock(64) + ELU                      -> x3 (B, T/2, 64)
//   (c) front_c: down k8 s4 as an im2col GEMM: row n of the output reads the
//       512 contiguous floats x3[4n-2 .. 4n+6) (reflected at the two edge
//       rows) against the weight repacked to (8*64, 128).
// Weights are repacked once when the model is built
// (ops/encoder_front.py::prepare_front_weights): every conv as
// (C_in, K, C_out), so a warp reads one float4 of output channels that all
// its lanes share.  (a) and (b) read them through the read-only cache (46 KB
// and 50 KB, resident in L1); their tiles take ~42 KB of shared memory, so
// four or five blocks share an SM.
//
// What bounds it on an H100: 21 728 multiply-adds per audio sample, i.e.
// ~0.40 TFLOP at B=128 x 3 s, ~6.0 ms at the 67 TFLOP/s fp32 CUDA-core peak,
// against ~37 MB in and ~590 MB out (~0.19 ms at 3.35 TB/s): arithmetic.
// The two 1.2 GB intermediates of this three-launch design add ~1.4 ms of
// traffic on top.  What the simple design leaves on the table, for a later
// PR: register tiles larger than 4x8, cp.async staging of the weights and
// the activations, one fused launch without the intermediates, and a
// 3xTF32 tensor-core route (split each operand into a TF32 head and tail,
// as CUTLASS does) that keeps fp32 accuracy at tensor-core rates.
//
// Plain C interface, bound from Python with ctypes
// (wavtokenizer_tpu_torch/ops/kernels.py::encoder_front).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expm1f(x); }

// Reflect a logical position into [0, L) (pads here are a few samples).
__device__ __forceinline__ int reflect(int p, int L) {
  return p < 0 ? -p : (p >= L ? 2 * L - 2 - p : p);
}

// One conv over a tile in shared memory.  in[ci * ldi + slot] and
// out[co * ldo + slot] are channel-major; w is (CIN, K, COUT) in global
// memory.  Output slot s (< n) is logical position p = out0 + s; its source
// position is q = REFL ? reflect(p, L) : p, and tap k reads input slot
// S * q + in_off + k.  Epilogue: EPI 0 stores acc + b, EPI 1 ELU(acc + b),
// EPI 2 ELU(out + acc + b).  Each warp owns units of 32*PT positions x PC
// channels; lane l holds positions l + 32 j.
template <int CIN, int COUT, int K, int S, bool REFL, int PT, int PC, int EPI>
__device__ __forceinline__ void conv_tile(const float* __restrict__ in, int ldi,
                                          int in_off, const float* __restrict__ w,
                                          const float* __restrict__ bias, float* out,
                                          int ldo, int n, int out0, int L) {
  static_assert(COUT % PC == 0 && PC % 4 == 0, "channel groups");
  constexpr int G = COUT / PC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (n + 32 * PT - 1) / (32 * PT);
  for (int u = warp; u < chunks * G; u += WARPS) {
    const int c0 = (u / G) * 32 * PT, g = u % G;
    int s[PT], base[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      s[j] = c0 + lane + 32 * j;
      const int p = out0 + min(s[j], n - 1);
      base[j] = S * (REFL ? reflect(p, L) : p) + in_off;
    }
    float acc[PT][PC];
#pragma unroll
    for (int j = 0; j < PT; ++j)
#pragma unroll
      for (int c = 0; c < PC; ++c) acc[j][c] = 0.f;
    const float* wg = w + g * PC;
#pragma unroll 2
    for (int ci = 0; ci < CIN; ++ci) {
      const float* inr = in + ci * ldi;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float a[PT], wv[PC];
#pragma unroll
        for (int j = 0; j < PT; ++j) a[j] = inr[base[j] + k];
        const float4* w4 = reinterpret_cast<const float4*>(wg + (ci * K + k) * COUT);
#pragma unroll
        for (int c = 0; c < PC / 4; ++c) {
          const float4 v = __ldg(w4 + c);
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
      const int co = g * PC + c;
      const float b = __ldg(bias + co);
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        if (s[j] < n) {
          float* o = out + co * ldo + s[j];
          float v = acc[j][c] + b;
          if (EPI == 2) v = *o + v;
          if (EPI >= 1) v = elu(v);
          *o = v;
        }
      }
    }
  }
}

__device__ __forceinline__ void elu_inplace(float* buf, int ld, int channels, int n) {
  for (int i = threadIdx.x; i < channels * n; i += THREADS) {
    float* p = buf + (i / n) * ld + (i % n);
    *p = elu(*p);
  }
}

// ---- (a) conv0 + resblock(32) + ELU + down k4 s2 --------------------------
// A tile owns MA positions [m0, m0 + mv) of x2.  Slot ranges, logical:
//   x1e and z: [2 m0 - 1, 2 m0 + 2 mv + 1)   (n1 = 2 mv + 2 slots)
//   x0 / h:    [2 m0 - 2, 2 m0 + 2 mv + 2)   (n0 = 2 mv + 4)
//   audio:     [2 m0 - 5, 2 m0 + 2 mv + 5)   (na = 2 mv + 10)
constexpr int MA = 63;
constexpr int LDA = 2 * MA + 10;     // 136
constexpr int LD0 = 2 * MA + 5;      // 131 (odd: conflict-free strided reads)
constexpr int LD1 = 2 * MA + 3;      // 129
constexpr int LDO_A = MA + 2;        // 65, output staging in the x0 buffer
static_assert(64 * LDO_A <= 32 * LD0, "staging fits");

__global__ void __launch_bounds__(THREADS)
front_a(const float* __restrict__ audio, const float* __restrict__ wa,
        float* __restrict__ x2, int T, int tiles_per_row) {
  __shared__ float sa[LDA];
  __shared__ float s0[32 * LD0];   // x0, then h = ELU(x0), then x2 staging
  __shared__ float sz[16 * LD1];   // z = ELU(k3(h))
  __shared__ float s1[32 * LD1];   // x1e
  const int L2 = T / 2;
  const int b = blockIdx.x / tiles_per_row;
  const int m0 = (blockIdx.x % tiles_per_row) * MA;
  const int mv = min(MA, L2 - m0);
  const int n1 = 2 * mv + 2, n0 = 2 * mv + 4, na = 2 * mv + 10;
  const int lo1 = 2 * m0 - 1, lo0 = 2 * m0 - 2, loa = 2 * m0 - 5;

  const float* ab = audio + (size_t)b * T;
  for (int i = threadIdx.x; i < na; i += THREADS) sa[i] = ab[reflect(loa + i, T)];
  __syncthreads();
  // x0 = conv0(audio), reflect pad 3/3.
  conv_tile<1, 32, 7, 1, true, 4, 8, 0>(sa, 0, -3 - loa, wa + A_W0, wa + A_B0,
                                        s0, LD0, n0, lo0, T);
  __syncthreads();
  // Shortcut k1 on the un-ELU'd x0 (with its bias) into x1e.
  conv_tile<32, 32, 1, 1, true, 2, 8, 0>(s0, LD0, -lo0, wa + A_WS, wa + A_BS,
                                         s1, LD1, n1, lo1, T);
  __syncthreads();
  elu_inplace(s0, LD0, 32, n0);
  __syncthreads();
  // z = ELU(k3(h) + b), reflect pad 1/1.
  conv_tile<32, 16, 3, 1, true, 2, 4, 1>(s0, LD0, -1 - lo0, wa + A_W3, wa + A_B3,
                                         sz, LD1, n1, lo1, T);
  __syncthreads();
  // x1e = ELU(shortcut + k1(z) + b): the resblock and the ELU layer after it.
  conv_tile<16, 32, 1, 1, true, 2, 8, 2>(sz, LD1, -lo1, wa + A_W1, wa + A_B1,
                                         s1, LD1, n1, lo1, T);
  __syncthreads();
  // x2 = down k4 s2 (reflect pad 1/1, already in the x1e slots).
  conv_tile<32, 64, 4, 2, false, 2, 8, 0>(s1, LD1, -1 - lo1, wa + A_WD, wa + A_BD,
                                          s0, LDO_A, mv, m0, L2);
  __syncthreads();
  float* xb = x2 + ((size_t)b * L2 + m0) * 64;
  for (int i = threadIdx.x; i < mv * 64; i += THREADS)
    xb[i] = s0[(i & 63) * LDO_A + (i >> 6)];
}

// ---- (b) resblock(64) + ELU -----------------------------------------------
// A tile owns NB positions [n0, n0 + nv) of x3; the x2 / h2 slots cover
// [n0 - 1, n0 + nv + 1), loaded with the k3 conv's reflect pad.
constexpr int NB = 64;
constexpr int LD2 = NB + 3;   // 67
constexpr int LD3 = NB + 1;   // 65

__global__ void __launch_bounds__(THREADS)
front_b(const float* __restrict__ x2, const float* __restrict__ wb,
        float* __restrict__ x3, int L2, int tiles_per_row) {
  __shared__ float s2[64 * LD2];   // x2, then h2 = ELU(x2)
  __shared__ float sz[32 * LD3];
  __shared__ float s3[64 * LD3];
  const int b = blockIdx.x / tiles_per_row;
  const int p0 = (blockIdx.x % tiles_per_row) * NB;
  const int nv = min(NB, L2 - p0);
  const int n2 = nv + 2, lo2 = p0 - 1;

  const float* xb = x2 + (size_t)b * L2 * 64;
  for (int i = threadIdx.x; i < n2 * 64; i += THREADS)
    s2[(i & 63) * LD2 + (i >> 6)] = xb[(size_t)reflect(lo2 + (i >> 6), L2) * 64 + (i & 63)];
  __syncthreads();
  conv_tile<64, 64, 1, 1, false, 2, 8, 0>(s2, LD2, -lo2, wb + B_WS, wb + B_BS,
                                          s3, LD3, nv, p0, L2);
  __syncthreads();
  elu_inplace(s2, LD2, 64, n2);
  __syncthreads();
  conv_tile<64, 32, 3, 1, false, 2, 4, 1>(s2, LD2, -1 - lo2, wb + B_W3, wb + B_B3,
                                          sz, LD3, nv, p0, L2);
  __syncthreads();
  conv_tile<32, 64, 1, 1, false, 2, 8, 2>(sz, LD3, -p0, wb + B_W1, wb + B_B1,
                                          s3, LD3, nv, p0, L2);
  __syncthreads();
  float* ob = x3 + ((size_t)b * L2 + p0) * 64;
  for (int i = threadIdx.x; i < nv * 64; i += THREADS)
    ob[i] = s3[(i & 63) * LD3 + (i >> 6)];
}

// ---- (c) down k8 s4 64->128 as an im2col GEMM ----------------------------
// out (M = B*T8, 128) = A (M, 512) @ Wd (512, 128) + b, where row (b, n) of
// A is x3[b, reflect(4n - 2 + tap), ci] at column tap * 64 + ci.  A block
// computes 64 rows x 128 columns, 4 x 8 per thread, over 16-deep slices.
constexpr int CM = 64, CN = 128, CK = 16;

__global__ void __launch_bounds__(THREADS)
front_c(const float* __restrict__ x3, const float* __restrict__ wd,
        const float* __restrict__ bd, float* __restrict__ out, int M, int T8,
        int L2) {
  __shared__ __align__(16) float As[CK][CM + 4];
  __shared__ __align__(16) float Bs[CK][CN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lr = tid / 4, kq = (tid % 4) * 4;
  const int R = blockIdx.x * CM + lr;
  const bool valid = R < M;
  size_t rowbase = 0;
  int p0 = 0;
  if (valid) {
    const int b = R / T8, n = R - b * T8;
    rowbase = (size_t)b * L2;
    p0 = 4 * n - 2;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < 8 * 64; k0 += CK) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      const int pos = reflect(p0 + (k0 >> 6), L2);
      v = __ldg(reinterpret_cast<const float4*>(x3 + (rowbase + pos) * 64 + (k0 & 63) + kq));
    }
    As[kq][lr] = v.x; As[kq + 1][lr] = v.y; As[kq + 2][lr] = v.z; As[kq + 3][lr] = v.w;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + THREADS * i, k = idx / 32, c4 = (idx % 32) * 4;
      *reinterpret_cast<float4*>(&Bs[k][c4]) =
          __ldg(reinterpret_cast<const float4*>(wd + (size_t)(k0 + k) * CN + c4));
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tx * 8 + 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
    __syncthreads();
  }
  float bias[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) bias[c] = __ldg(bd + tx * 8 + c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = blockIdx.x * CM + ty * 4 + i;
    if (r < M) {
      float4* o = reinterpret_cast<float4*>(out + (size_t)r * CN + tx * 8);
      o[0] = make_float4(acc[i][0] + bias[0], acc[i][1] + bias[1],
                         acc[i][2] + bias[2], acc[i][3] + bias[3]);
      o[1] = make_float4(acc[i][4] + bias[4], acc[i][5] + bias[5],
                         acc[i][6] + bias[6], acc[i][7] + bias[7]);
    }
  }
}

}  // namespace

// audio (B, T) f32 -> out (B, T/8, 128) f32; x2 and x3 are (B, T/2, 64) f32
// scratch.  wa / wb are the packs of (a) and (b), wd (512, 128) and bd (128,)
// the last conv.  Returns the first CUDA error of the three launches, or 0.
extern "C" int wt_encoder_front(const float* audio, const float* wa, const float* wb,
                                const float* wd, const float* bd, float* x2, float* x3,
                                float* out, int B, int T, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int L2 = T / 2, T8 = T / 8;
  const int ta = (L2 + MA - 1) / MA;
  front_a<<<B * ta, THREADS, 0, s>>>(audio, wa, x2, T, ta);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int tb = (L2 + NB - 1) / NB;
  front_b<<<B * tb, THREADS, 0, s>>>(x2, wb, x3, L2, tb);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int M = B * T8;
  front_c<<<(M + CM - 1) / CM, THREADS, 0, s>>>(x3, wd, bd, out, M, T8, L2);
  return (int)cudaGetLastError();
}
