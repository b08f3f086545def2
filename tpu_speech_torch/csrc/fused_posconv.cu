// Grouped 1-D convolution over channels-last (B, T, C) activations, fp32-
// accurate on Hopper's tensor cores (3xTF32): the positional convolution of
// the SPIRAL transformer blocks.
//
// Replaces the Pallas TPU kernel of
// tpu_speech/ops/fused_posconv.py::grouped_conv1d (pallas_call at line 132,
// _pallas_fwd:121, reached through _run:159); its VJP (_bwd:198) runs the
// same kernel again for dx on k-flipped, in/out-swapped weights with the
// complementary left pad. With xp = pad(x, (left_pad, K - 1 - left_pad)) in
// time and g = o / Cg the group of output channel o:
//     out[b, t, o] = sum_k sum_ci xp[b, t + k, g*Cg + ci] * w[g, k, ci, o - g*Cg]
// The weights arrive in the kernel layout (G, K, Cg_in, Cg_out), which the
// wrapper rearranges once per call from PyTorch's (C, Cg, K).
//
// What bounds it on an H100: the products, 2*B*T*C*Cg*K FLOP (36 GFLOP for
// a SPIRAL-base block-1 conv at B = 14, T = 604, C = 512, Cg = 32, K = 128)
// against a few MB of activations and 0.5-1.2 MB of weights per group: far
// above the memory roofline. The port's contract is fp32 with TF32 off; the
// first kernel ran on the fp32 CUDA cores at 20-27 TFLOP/s. Here every
// product runs on the tensor cores as three TF32 products of a hi/lo split
// (x = hi + lo, hi = x rounded to TF32, lo = x - hi read as TF32;
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi in fp32), which keeps 22 bits of
// each operand: fp32 accuracy at a third of the 495 TFLOP/s TF32 rate, so the
// bound is 3 * FLOP / 495 TFLOP/s. The TPU kernel packs taps into 128-lane
// blocks and runs one deep matmul per chunk of taps; that packing, the
// group-major transposes and the batch-tile VMEM budget are TPU-only and not
// carried over.
//
// Design: an implicit GEMM, M = frames, N = Cg output channels, and the sum
// over (tap, input channel), with mma.sync.m16n8k8 TF32. One block owns
// (batch b, group g, a tile of TT = 128 output frames); 4 warps own 32 frames
// (two m16 tiles) each. The block stages the input window
// x[t0 - left_pad : t0 + TT + K - 1 - left_pad, g*Cg : (g+1)*Cg] in shared
// memory once (zero outside [0, T) and past Cg); the A fragment of tap k is
// the window read k rows down, so no im2col copy exists. The group's weights
// stream through shared memory KC taps at a time, split once into (hi, lo)
// pairs as they are stored, so all four warps read ready B fragments; the
// next chunk's raw weights arrive by cp.async while the current one
// computes, and two blocks share an SM. Each chunk
// sums into fresh accumulators that are added to the running sum in fp32
// (the tensor cores' accumulation truncates: one chain over all K * Cg / 8
// steps drifts by up to 1e-4 relative). Row strides (Cg + 4 floats for the
// window, 2 Cg + 8 for the pairs) keep every fragment load conflict-free.
// Takes any Cg <= 64 (padded to a multiple of 8 with zeros), any K <= 128
// and any 0 <= left_pad < K.
//
// The bf16 kernel (entry tsx_grouped_conv1d_bf16) is in fused_posconv_sm90.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 128;  // output frames per block
constexpr int NW = 4;    // warps per block, 32 frames each
constexpr int NT = NW * 32;
constexpr int MAX_CG = 64;
constexpr int MAX_K = 128;

__host__ __device__ constexpr int ceil_to(int a, int b) { return (a + b - 1) / b * b; }

// ---- 3xTF32 products on the tensor cores (as in fused_attention.cu) ------
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi = x rounded to TF32 (to nearest, ties away from zero); lo = x - hi,
// which the tensor core reads as TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// A (16 x 8): rows r0.., columns c0.. of the window (lane = 4g + t holds
// (g, t), (g+8, t), (g, t+4), (g+8, t+4))
__device__ __forceinline__ FragA load_a(const float* s, int ss, int r0, int c0,
                                        int g, int t) {
  const float* p = s + (r0 + g) * ss + c0 + t;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * ss], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * ss + 4], f.hi[3], f.lo[3]);
  return f;
}

// B (8 x 8, k = input channel, n = output channel) from (hi, lo) pairs:
// b0 (t, g), b1 (t+4, g)
__device__ __forceinline__ FragB load_b(const uint32_t* s, int ss, int c0, int n0,
                                        int g, int t) {
  const uint32_t* p = s + (c0 + t) * ss + 2 * (n0 + g);
  const uint2 v0 = *reinterpret_cast<const uint2*>(p);
  const uint2 v1 = *reinterpret_cast<const uint2*>(p + 4 * ss);
  FragB f;
  f.hi[0] = v0.x;
  f.lo[0] = v0.y;
  f.hi[1] = v1.x;
  f.lo[1] = v1.y;
  return f;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               ::"r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// --------------------------------------------------------------------------

// window row stride and the weight pairs' row stride, in 4-byte words
__host__ __device__ constexpr int window_stride(int nn) { return nn * 8 + 4; }
__host__ __device__ constexpr int pair_stride(int nn) { return 2 * nn * 8 + 8; }

template <int NN, int KC>
size_t smem_bytes(int cg, int k) {  // the window; a chunk as pairs and raw
  const int rows = TT + ceil_to(k, KC) - 1;
  return sizeof(float) * ((size_t)rows * window_stride(NN) +
                          (size_t)KC * NN * 8 * pair_stride(NN) + (size_t)KC * cg * cg);
}

// NN: output-channel tiles of 8 (Cg padded to 8 NN); KC: taps per chunk
template <int NN, int KC>
__global__ void __launch_bounds__(NT, 2)
grouped_conv1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, int T, int C, int Cg, int K,
                      int left_pad) {
  constexpr int CGP = NN * 8;
  constexpr int XS = window_stride(NN);
  constexpr int WS = pair_stride(NN);
  extern __shared__ __align__(16) float smem[];
  const int Kp = ceil_to(K, KC);
  const int rows = TT + Kp - 1;
  float* xs = smem;                                              // rows x XS
  uint32_t* ws = reinterpret_cast<uint32_t*>(xs + rows * XS);    // KC x CGP x WS
  float* raw = reinterpret_cast<float*>(ws + KC * CGP * WS);     // KC x Cg x Cg

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 32;  // the warp's frames of the tile
  const int t0 = blockIdx.x * TT;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const float* xb = x + (long long)b * T * C + grp * Cg;
  const float* wg = w + (long long)grp * K * Cg * Cg;

  // window row r holds input frame t0 - left_pad + r; rows past the true
  // window (r >= TT + K - 1, the tap padding) and channels past Cg are zero
  const int live = TT + K - 1;
  // (4-byte asynchronous copies, all in flight at once; any Cg)
  for (int i = tid; i < rows * CGP; i += NT) {
    const int r = i / CGP, c = i - r * CGP;
    const int tf = t0 - left_pad + r;
    const bool ok = c < Cg && r < live && tf >= 0 && tf < T;
    cp_async4(xs + r * XS + c, ok ? xb + (long long)tf * C + c : xb, ok);
  }
  // the raw weights of taps k0 .. k0 + KC - 1 (zeros past K), as they lie in
  // memory: one contiguous run of KC * Cg * Cg floats
  auto stage_chunk = [&](int k0) {
    const int n = KC * Cg * Cg, live_n = (K - k0 < KC ? K - k0 : KC) * Cg * Cg;
    const float* src = wg + (long long)k0 * Cg * Cg;
    for (int i = tid; i < n; i += NT) cp_async4(raw + i, i < live_n ? src + i : src, i < live_n);
    cp_async_commit();
  };
  stage_chunk(0);

  float acc[2][NN][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int k0 = 0; k0 < Kp; k0 += KC) {
    cp_async_wait_all();  // this chunk's raw weights (and, first, the window)
    __syncthreads();      // ... visible to all; the previous chunk is consumed
    for (int i = tid; i < KC * CGP * CGP; i += NT) {
      const int kk = i / (CGP * CGP), ci = (i / CGP) % CGP, o = i % CGP;
      uint2 pair;
      split(ci < Cg && o < Cg ? raw[(kk * Cg + ci) * Cg + o] : 0.f, pair.x, pair.y);
      *reinterpret_cast<uint2*>(ws + (kk * CGP + ci) * WS + 2 * o) = pair;
    }
    __syncthreads();
    if (k0 + KC < Kp) stage_chunk(k0 + KC);  // in flight during the products

    // the chunk's sum in its own accumulators, added to acc in fp32: the
    // tensor cores' accumulation truncates, so a chain over all K * Cg / 8
    // steps would drift
    float part[2][NN][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const uint32_t* wk = ws + kk * CGP * WS;
      const int r = r0 + k0 + kk;  // frame f at tap k reads window row f + k
#pragma unroll
      for (int c = 0; c < NN; ++c) {
        const FragA a0 = load_a(xs, XS, r, 8 * c, g, t);
        const FragA a1 = load_a(xs, XS, r + 16, 8 * c, g, t);
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const FragB bf = load_b(wk, WS, 8 * c, 8 * n, g, t);
          mma3(part[0][n], a0, bf);
          mma3(part[1][n], a1, bf);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
  }

  // element e of tile (m, n): frame r0 + 16m + g + 8 (e >> 1), channel
  // 8n + 2t + (e & 1)
  float* ob = out + (long long)b * T * C + grp * Cg;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tf = t0 + r0 + 16 * m + g + 8 * (e >> 1);
      if (tf < T) {
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const int co = 8 * n + 2 * t + (e & 1);
          if (co < Cg) ob[(long long)tf * C + co] = acc[m][n][e];
        }
      }
    }
}

template <int NN, int KC>
int launch(const float* x, const float* w, float* out, int B, int T, int C,
           int G, int K, int left_pad, cudaStream_t stream) {
  const int cg = C / G;
  const size_t smem = smem_bytes<NN, KC>(cg, K);
  cudaError_t err = cudaFuncSetAttribute(grouped_conv1d_kernel<NN, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TT - 1) / TT, G, B);
  grouped_conv1d_kernel<NN, KC><<<grid, NT, smem, stream>>>(x, w, out, T, C, cg, K,
                                                            left_pad);
  return cudaGetLastError();
}

}  // namespace

// out (B, T, C) from x (B, T, C) and w (G, K, C/G, C/G), all contiguous fp32.
extern "C" int tsx_grouped_conv1d(const void* x, const void* w, void* out, int B,
                                  int T, int C, int G, int K, int left_pad,
                                  void* stream) {
  if (G <= 0 || C % G != 0 || C / G > MAX_CG || K < 1 || K > MAX_K ||
      left_pad < 0 || left_pad >= K || B > 65535 || G > 65535)
    return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // taps per chunk: fewer as Cg grows, so that two blocks fit an SM's shared
  // memory up to Cg = 56 (88 KB a block at Cg = 32, 109 KB at Cg = 48)
  switch ((C / G + 7) / 8) {
    case 1: return launch<1, 4>(xf, wf, of, B, T, C, G, K, left_pad, s);
    case 2: return launch<2, 4>(xf, wf, of, B, T, C, G, K, left_pad, s);
    case 3: return launch<3, 4>(xf, wf, of, B, T, C, G, K, left_pad, s);
    case 4: return launch<4, 4>(xf, wf, of, B, T, C, G, K, left_pad, s);
    case 5: return launch<5, 2>(xf, wf, of, B, T, C, G, K, left_pad, s);
    case 6: return launch<6, 2>(xf, wf, of, B, T, C, G, K, left_pad, s);
    case 7: return launch<7, 1>(xf, wf, of, B, T, C, G, K, left_pad, s);
    case 8: return launch<8, 1>(xf, wf, of, B, T, C, G, K, left_pad, s);
    default: return cudaErrorInvalidValue;
  }
}
