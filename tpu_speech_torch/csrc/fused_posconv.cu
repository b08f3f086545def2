// Grouped 1-D convolution over channels-last (B, T, C) activations, fp32,
// for Hopper: the positional convolution of the SPIRAL transformer blocks.
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
// What bounds it on an H100: the products, 2*B*T*C*Cg*K FLOP (80 GFLOP for
// one SPIRAL-base block-2 conv at B = 14, T = 604, C = 768, Cg = 48,
// K = 128) on the fp32 CUDA cores (no TF32: fp32 parity). The bytes are
// small: x once per block, the group's weights (K*Cg*Cg floats, 1.2 MB at
// Cg = 48) once per block from L2. The TPU kernel packs taps into 128-lane
// blocks and runs one deep matmul per chunk of taps; that packing, the
// group-major transposes and the batch-tile VMEM budget are TPU-only and not
// carried over.
//
// Design: an implicit GEMM over the taps. One block owns (batch b, group g,
// a tile of TT = 128 output frames). It stages the input window
// x[t0 - left_pad : t0 + TT + K - 1 - left_pad, g*Cg : (g+1)*Cg] in shared
// memory once (zero outside [0, T)), then streams the group's weights
// through shared memory KC taps at a time. 256 threads: thread (rg, cg)
// owns the 8 frames rg*8 .. rg*8+7 and the output channels cg + 16j,
// j < CPT = ceil(Cg / 16), in registers. For one input channel and one chunk
// of taps a thread loads the RPT + KC - 1 window values once and reuses each
// across the taps (frame t at tap k reads window row t + k), so the inner
// loop does KC*RPT*CPT FMAs per RPT + KC - 1 + KC*CPT shared loads. The
// window's row stride is odd, so the two row groups of a warp hit different
// banks; the 16 threads of a half-warp read 16 consecutive weights.
// Takes any Cg <= 64, any K <= 128 and any 0 <= left_pad < K.

#include <cuda_runtime.h>

namespace {

constexpr int TT = 128;   // output frames per block
constexpr int RPT = 8;    // frames per thread
constexpr int TC = 16;    // column threads
constexpr int NT = (TT / RPT) * TC;  // 256
constexpr int MAX_CG = 64;
constexpr int MAX_K = 128;
constexpr int WPAD = TC * 4;  // slack after the weight tile: idle columns read it

__host__ __device__ constexpr int ceil_to(int a, int b) { return (a + b - 1) / b * b; }

__host__ __device__ constexpr int window_stride(int cg) { return cg | 1; }

template <int KC>
size_t smem_bytes(int cg, int k) {
  const int rows = TT + ceil_to(k, KC) - 1;
  return sizeof(float) *
         ((size_t)rows * window_stride(cg) + (size_t)KC * cg * cg + WPAD);
}

template <int CPT, int KC>
__global__ void __launch_bounds__(NT)
grouped_conv1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, int T, int C, int Cg, int K,
                      int left_pad) {
  extern __shared__ __align__(16) float smem[];
  const int XS = window_stride(Cg);
  const int Kp = ceil_to(K, KC);
  const int rows = TT + Kp - 1;
  float* xs = smem;              // rows x XS: the input window
  float* ws = xs + rows * XS;    // KC x Cg x Cg (+ WPAD): a chunk of taps

  const int tid = threadIdx.x;
  const int rg = tid / TC;
  const int cg = tid % TC;
  const int t0 = blockIdx.x * TT;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const float* xb = x + (long long)b * T * C + g * Cg;

  // window row r holds input frame t0 - left_pad + r; rows past the true
  // window (r >= TT + K - 1, the tap padding) stay zero
  const int live = TT + K - 1;
  for (int i = tid; i < rows * Cg; i += NT) {
    const int r = i / Cg, c = i - r * Cg;
    const int t = t0 - left_pad + r;
    xs[r * XS + c] = (r < live && t >= 0 && t < T) ? xb[(long long)t * C + c] : 0.f;
  }
  if (tid < WPAD) ws[KC * Cg * Cg + tid] = 0.f;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  const int r0 = rg * RPT;
  const int tap = Cg * Cg;
  const float* wg = w + (long long)g * K * tap;
  for (int k0 = 0; k0 < Kp; k0 += KC) {
    __syncthreads();  // the window is staged / the previous chunk is consumed
    for (int i = tid; i < KC * tap; i += NT) {
      const int kk = i / tap;
      ws[i] = k0 + kk < K ? wg[(long long)k0 * tap + i] : 0.f;
    }
    __syncthreads();

    for (int ci = 0; ci < Cg; ++ci) {
      float xv[RPT + KC - 1];
      const float* xc = xs + (r0 + k0) * XS + ci;
#pragma unroll
      for (int i = 0; i < RPT + KC - 1; ++i) xv[i] = xc[i * XS];
      const float* wc = ws + ci * Cg + cg;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float wv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) wv[j] = wc[kk * tap + TC * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xv[i + kk], wv[j], acc[i][j]);
      }
    }
  }

  float* ob = out + (long long)b * T * C + g * Cg;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = t0 + r0 + i;
    if (t < T) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int co = cg + TC * j;
        if (co < Cg) ob[(long long)t * C + co] = acc[i][j];
      }
    }
  }
}

template <int CPT, int KC>
int launch(const float* x, const float* w, float* out, int B, int T, int C,
           int G, int K, int left_pad, cudaStream_t stream) {
  const int cg = C / G;
  const size_t smem = smem_bytes<KC>(cg, K);
  cudaError_t err = cudaFuncSetAttribute(grouped_conv1d_kernel<CPT, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TT - 1) / TT, G, B);
  grouped_conv1d_kernel<CPT, KC><<<grid, NT, smem, stream>>>(x, w, out, T, C, cg, K,
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
  // taps per chunk: 8 while the chunk is small, 4 at Cg > 32 so that two
  // blocks fit an SM's shared memory at Cg = 48
  switch ((C / G + TC - 1) / TC) {
    case 1: return launch<1, 8>(xf, wf, of, B, T, C, G, K, left_pad, s);
    case 2: return launch<2, 8>(xf, wf, of, B, T, C, G, K, left_pad, s);
    case 3: return launch<3, 4>(xf, wf, of, B, T, C, G, K, left_pad, s);
    case 4: return launch<4, 4>(xf, wf, of, B, T, C, G, K, left_pad, s);
    default: return cudaErrorInvalidValue;
  }
}
