// Fused framing -> windowed DFT -> power -> mel -> log, fp32, for Hopper.
//
// Replaces the Pallas TPU kernel tpu_speech/ops/fused_logmel.py::fused_logmel
// (kernel body _kernel, pallas_call at line 203). It computes the same
// function, not the TPU layout: no lcm-row DMA, no phase-blocked output and no
// de-interleave. Frame t of row b reads x[b, t*hop : t*hop + n_fft].
//
// What bounds it on an H100: arithmetic. The DFT as a product is
// 4 * n_fft * n_freq FLOP per frame (0.53 MFLOP at n_fft=512), so the SPIRAL
// batch (14 x 2401 frames) is ~18 GFLOP in fp32 against ~22 MB of wav in
// and ~17 MB of log-mel out: far above the memory roofline, on the fp32
// CUDA cores (the tensor cores have no full-fp32 mode; fp32 stands in for
// the TPU kernel's Precision.HIGHEST).
//
// Design. A block owns (b, a tile of TF consecutive frames):
//  - it stages the contiguous wav span of the tile, (TF-1)*hop + n_fft
//    samples, in shared memory once; overlapping frames are strided reads of
//    that span, so the wav is read from device memory about once;
//  - the window-folded DFT matrix [cos*win | -sin*win] (n_fft x 2*n_freq,
//    1 MB at n_fft=512) does not fit in shared memory; it stays in L2 and is
//    streamed through shared memory KC rows at a time;
//  - thread k owns frequency bin k and keeps the real and imaginary sums of
//    all TF frames in registers; the wav reads are float4 broadcasts, so each
//    shared-memory load feeds eight FMAs;
//  - each sum grows by 4-term partials: a bin far from the signal's strong
//    tones has large oscillating partial sums and a small result, so fewer
//    roundings at the running sum's magnitude cut the error that the log
//    amplifies in near-zero bins (measured on an H100 at the SPIRAL shape:
//    max |log-mel error| vs a float64 evaluation 2.3e-4 instead of 2.9e-4,
//    at no cost in time; fp32 cuFFT is 4.6e-4 off on the same input);
//  - power (or sqrt(power + eps)), the n_freq -> n_mels mel product and the
//    log run in the same block; only the n_freq real bins are computed.
// Inputs and arithmetic are fp32 throughout.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TF = 16;           // frames per block
constexpr int KC = 16;           // DFT rows staged per step
constexpr int FPG = 8;           // frames per mel task
constexpr int MAX_THREADS = 544; // covers n_freq = 513 (n_fft = 1024) in one pass

__global__ void __launch_bounds__(MAX_THREADS)
logmel_kernel(const float* __restrict__ x, const float* __restrict__ dft,
              const float* __restrict__ mel, float* __restrict__ out,
              int N, int n_fft, int hop, int n_freq, int n_mels,
              int num_frames, int mag_mode, float mag_eps, int log_mode,
              float log_guard) {
  extern __shared__ __align__(16) float smem[];
  const int span = (TF - 1) * hop + n_fft;
  const int span_pad = (span + 3) & ~3;
  const int two_f = 2 * n_freq;
  float* wav = smem;                   // span_pad
  float* stage = wav + span_pad;       // KC * two_f
  float* power = stage + KC * two_f;   // TF * n_freq

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const long long start = (long long)t0 * hop;
  const float* xb = x + (long long)b * N + start;
  const long long avail = (long long)N - start;
  for (int i = tid; i < span_pad; i += blockDim.x)
    wav[i] = (i < span && i < avail) ? xb[i] : 0.f;

  for (int k0 = 0; k0 < n_freq; k0 += blockDim.x) {
    const int k = k0 + tid;
    float re[TF], im[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) { re[f] = 0.f; im[f] = 0.f; }

    for (int n0 = 0; n0 < n_fft; n0 += KC) {
      __syncthreads();  // the wav is staged / the previous chunk is consumed
      const float* src = dft + (long long)n0 * two_f;
      for (int i = tid; i < KC * two_f; i += blockDim.x) stage[i] = src[i];
      __syncthreads();
      if (k < n_freq) {
#pragma unroll
        for (int j = 0; j < KC; j += 4) {
          float c[4], s[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            c[q] = stage[(j + q) * two_f + k];
            s[q] = stage[(j + q) * two_f + n_freq + k];
          }
#pragma unroll
          for (int f = 0; f < TF; ++f) {
            const float4 v =
                *reinterpret_cast<const float4*>(wav + f * hop + n0 + j);
            float pr = v.x * c[0], pi = v.x * s[0];
            pr = fmaf(v.y, c[1], pr);
            pi = fmaf(v.y, s[1], pi);
            pr = fmaf(v.z, c[2], pr);
            pi = fmaf(v.z, s[2], pi);
            pr = fmaf(v.w, c[3], pr);
            pi = fmaf(v.w, s[3], pi);
            re[f] += pr;
            im[f] += pi;
          }
        }
      }
    }
    if (k < n_freq) {
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        float p = re[f] * re[f] + im[f] * im[f];
        if (mag_mode == 1) p = sqrtf(p + mag_eps);
        power[f * n_freq + k] = p;
      }
    }
  }
  __syncthreads();

  // mel product + log: task = (mel m, group g of FPG frames)
  const int groups = TF / FPG;
  for (int task = tid; task < n_mels * groups; task += blockDim.x) {
    const int m = task % n_mels;
    const int g = task / n_mels;
    const float* prow = power + g * FPG * n_freq;
    float acc[FPG];
#pragma unroll
    for (int j = 0; j < FPG; ++j) acc[j] = 0.f;
    for (int k = 0; k < n_freq; ++k) {
      const float w = __ldg(mel + (long long)k * n_mels + m);
#pragma unroll
      for (int j = 0; j < FPG; ++j) acc[j] = fmaf(prow[j * n_freq + k], w, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < FPG; ++j) {
      const int t = t0 + g * FPG + j;
      if (t < num_frames) {
        const float v = log_mode == 1 ? logf(fmaxf(acc[j], log_guard))
                                      : logf(acc[j] + log_guard);
        out[((long long)b * num_frames + t) * n_mels + m] = v;
      }
    }
  }
}

}  // namespace

extern "C" int tsx_fused_logmel(const void* x, const void* dft,
                                const void* mel, void* out, int B, int N,
                                int n_fft, int hop, int n_freq, int n_mels,
                                int num_frames, int mag_mode, float mag_eps,
                                int log_mode, float log_guard, void* stream) {
  if (B <= 0 || num_frames <= 0) return cudaSuccess;
  if (hop % 4 != 0 || n_fft % KC != 0 || n_freq != n_fft / 2 + 1)
    return cudaErrorInvalidValue;
  const int span_pad = (((TF - 1) * hop + n_fft) + 3) & ~3;
  const size_t smem =
      sizeof(float) * ((size_t)span_pad + (size_t)KC * 2 * n_freq +
                       (size_t)TF * n_freq);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int threads = ((n_freq + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const dim3 grid((num_frames + TF - 1) / TF, B);
  logmel_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dft),
      static_cast<const float*>(mel), static_cast<float*>(out), N, n_fft, hop,
      n_freq, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard);
  return cudaGetLastError();
}

// Shared by every entry point of the library: message for a returned code.
extern "C" const char* tsx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
