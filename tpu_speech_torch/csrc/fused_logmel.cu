// Fused framing -> window -> real FFT -> power -> banded mel -> log, for Hopper.
//
// Replaces the Pallas TPU kernel tpu_speech/ops/fused_logmel.py::fused_logmel
// (kernel body _kernel, pallas_call at line 203). It computes the same
// function, not the TPU layout: no lcm-row DMA, no phase-blocked output.
// Frame t of row b reads x[b, t*hop : t*hop + n_fft] (zeros past the end of
// the row), for any hop >= 1 and any n_fft from 1 to DFT_MAX_N_FFT = 8192,
// by one of two transforms chosen by n_fft:
//  - a power of two from 128 to 2048: the float64 FFT below
//    (logmel_fft_kernel<LOGV>), the SPIRAL and HiFi-GAN path;
//  - any other n_fft (odd, not a power of two, or a power of two outside
//    128-2048): a float64 direct DFT from a shared-memory table
//    (logmel_dft_kernel<TF>, see "The other n_fft" at the end of the design).
//
// What bounds it on an H100. The function moves ~22 MB of wav in and ~17 MB
// of log-mel out at the SPIRAL shape (14 x 2401 frames), ~12 us at 3.35 TB/s;
// a real FFT is ~2.5 N log2 N operations a frame and the banded mel ~2 per
// filterbank nonzero, ~0.45 GFLOP, so device memory bounds the function.
// This kernel keeps everything between the two on chip; what bounds it is
// the SMs' instruction throughput on the float64 transform (see Precision):
// its butterflies, and the selects and shuffles of the cross-lane exchanges.
//
// Design.
//  - A block owns a tile (batch row, 16 consecutive frames): it stages the
//    tile's contiguous wav span ((TF - 1) hop + n_fft samples), the twiddle
//    tables, the window and the band limits in shared memory once. Where hop
//    is odd (a frame's float2 reads would be misaligned) or hop >= n_fft (the
//    span would hold samples no frame reads), it stages each frame on its
//    own instead, n_fft samples apart: the tile then always fits.
//  - One warp transforms one frame. The frame's real samples are packed as
//    M = n_fft/2 complex points z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1] (the
//    window product in fp32, as the plain version's frames * window), and
//    Z = DFT_M(z) is taken as M = V x 32: lane l holds z[l + 32 p], p < V,
//    runs a V-point DFT in registers (radix 2, decimation in frequency) and
//    multiplies by W_M^(l k1); the 32-point DFTs across the lanes are five
//    radix-2 stages in which each pair of lanes trades half its registers by
//    shuffles, so every lane does whole butterflies and a stage moves half
//    the data. Nothing goes through shared memory between the frame's load
//    and its power, so there is nothing to conflict and no barrier.
//  - The real split pairs bins k and M - k in one lane: X[k] = E + W_N^k O,
//    X[M - k] = conj(E - W_N^k O), E and O from Z[k] and conj Z[M - k].
//  - Power (or sqrt(power + eps), or power^(p/2)) goes to a (16, n_freq)
//    tile padded by one float every 32 bins, which keeps the lanes'
//    bit-reversed stores apart in the banks.
//  - The mel product runs over each filter's nonzero band [lo_m, hi_m) only
//    (a skipped term is an exact zero, so the function is the same for any
//    filterbank), 8 frames per weight read, then the log, stored coalesced.
// Precision. The log amplifies rounding in near-zero-power mel bins (the low
// bins after preemphasis). On chip_smoke.py's speech-like input the plain
// fp32 version (cuFFT) is itself ~1.3e-4 off a float64 evaluation, and an
// fp32 DFT that rounds independently landed ~1.9e-4 off it: an fp32
// transform sits at the 2e-4 limit. So the transform runs in float64, with
// float64 twiddle tables built once on the host with exact angle reduction
// (no sincos, no recurrences); the fp32 window product is then the only
// rounding before the power (~4e-5 off float64). The power tile, mel
// product and log are fp32.
// The other n_fft. Bluestein's chirp-z would take any N to a power-of-two FFT
// of length >= 2N - 1 (8192 for N = 4096: past one warp's registers, so a
// multi-warp FFT, two of them a frame, and odd N without the even/odd
// packing). The direct DFT is one loop and the same float64 arithmetic:
// X[k] = sum_n xw[n] W_N^(kn), the twiddle W_N^a read from a float64 table
// of N entries (built once on the host, a < N: no angle reduction) at
// a = kn mod N, kept by an add and a compare. A block owns TF frames (16,
// halved to 8, 4, 2, 1 until the table, the frames and the power tile fit
// in shared memory); a thread owns bin k for all TF frames, so each table
// read serves 2 TF float64 FMAs. It costs N (N/2 + 1) TF FMA pairs a tile,
// O(N^2) against the FFT's O(N log N): about 0.3 ms at the SPIRAL shape with
// n_fft 400, tens of ms at 4096; no main path calls it. Its power, mel
// product and log are the FFT kernel's (mel_log_tile).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FPG = 8;  // frames per mel task
constexpr unsigned FULL = 0xffffffffu;
constexpr int DFT_MAX_N_FFT = 8192;  // the direct DFT's largest n_fft
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on Hopper

// frames per tile: 16 (8 at n_fft 2048, whose frames need 255 registers and
// so one block per SM); a tile's span reads n_fft - hop samples twice
__host__ __device__ constexpr int frames_per_tile(int logv) { return logv <= 4 ? 16 : 8; }

__host__ __device__ constexpr int bitrev(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r = (r << 1) | ((x >> i) & 1);
  return r;
}

// table entries (double2): tw1[V*32], tw2[V/2*32], W_V^e (e < V/2), W_32^j (j < 16)
__host__ __device__ constexpr int table_len(int logv) {
  return (32 << logv) + (16 << logv) + (1 << logv) / 2 + 16;
}

// the power tile's row stride: bins 0..M with one pad float every 32 bins
__host__ __device__ constexpr int power_stride(int m) { return m + (m >> 5) + 2; }

__device__ __forceinline__ int padk(int k) { return k + (k >> 5); }

// the magnitude that the mel product reads, from q = 4 |X|^2 (the split
// computes 2X): mode 0 the power, scaled in fp32, exactly; mode 1
// sqrt(power + mag_arg); mode 2 |X|^p = power^mag_arg with mag_arg = p / 2,
// in float64 (the JAX package's rfft path for a mag_power other than 1 or 2)
__device__ __forceinline__ float magnitude(double q, int mag_mode, double mag_arg) {
  if (mag_mode == 1) return (float)sqrt(fma(0.25, q, mag_arg));
  if (mag_mode == 2) return (float)pow(0.25 * q, mag_arg);
  return 0.25f * (float)q;
}

// f(integral_constant<int, I>) for I = B .. E-1: loop indices that are
// compile-time constants, so the register arrays are never indexed at run time
template <int B, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

__device__ __forceinline__ void cmul(double& re, double& im, double2 w) {
  const double r = re * w.x - im * w.y;
  im = re * w.y + im * w.x;
  re = r;
}

// The banded mel product and the log of a tile's TF power rows (row stride
// pstride, bin k at padk(k)): task = (mel m, group g of G frames), so each
// weight is read once for G frames; the log-mel stored coalesced.
template <int TF>
__device__ __forceinline__ void mel_log_tile(const float* pw, int pstride, const int* band,
                                             const float* __restrict__ mel, int n_freq,
                                             int n_mels, float* __restrict__ out, int b, int t0,
                                             int num_frames, int log_mode, float log_guard) {
  constexpr int G = TF < FPG ? TF : FPG;  // frames a task
  constexpr int GROUPS = TF / G;
  for (int task = threadIdx.x; task < n_mels * GROUPS; task += THREADS) {
    const int m = task % n_mels;
    const int g = task / n_mels;
    const float* wrow = mel + (long long)m * n_freq;
    const float* prow = pw + g * G * pstride;
    float acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = 0.f;
    for (int k = band[m], hi = band[n_mels + m]; k < hi; ++k) {
      const float w = __ldg(wrow + k);
      const int kk = padk(k);
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] = fmaf(prow[j * pstride + kk], w, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int t = t0 + g * G + j;
      if (t < num_frames) {
        const float v = log_mode == 1 ? logf(fmaxf(acc[j], log_guard))
                                      : logf(acc[j] + log_guard);
        out[((long long)b * num_frames + t) * n_mels + m] = v;
      }
    }
  }
}

// A block owns one tile: batch row blockIdx.y, frames TF * blockIdx.x on.
template <int LOGV>
__global__ void __launch_bounds__(THREADS)
logmel_fft_kernel(const float* __restrict__ x, const float* __restrict__ window,
                  const float* __restrict__ mel, const int* __restrict__ bands,
                  const double2* __restrict__ tables, float* __restrict__ out,
                  int N, int hop, int fs, int n_mels, int num_frames, int mag_mode,
                  double mag_eps, int log_mode, float log_guard) {
  constexpr int V = 1 << LOGV;
  constexpr int M = 32 * V;
  constexpr int NFFT = 2 * M;
  constexpr int TF = frames_per_tile(LOGV);
  constexpr int NTAB = table_len(LOGV);
  constexpr int PSTRIDE = power_stride(M);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double2* tab = reinterpret_cast<double2*>(smem_raw);
  float* win = reinterpret_cast<float*>(tab + NTAB);
  // frame f at wav + f * fs: fs = hop (the tile's span), or n_fft (each
  // frame on its own, where hop is odd or >= n_fft)
  const int span_pad = (((TF - 1) * fs + NFFT) + 3) & ~3;
  float* wav = win + NFFT;     // the tile's span
  float* pw = wav + span_pad;  // the (TF, PSTRIDE) power tile
  int* band = reinterpret_cast<int*>(pw + TF * PSTRIDE);  // lo (n_mels), hi (n_mels)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, t0 = blockIdx.x * TF;
  const long long start = (long long)t0 * hop;
  const float* xb = x + (long long)b * N + start;
  const long long avail = (long long)N - start;  // samples of the row from `start` on
  if (fs == hop) {
    for (int i = tid; i < span_pad; i += THREADS) wav[i] = i < avail ? __ldg(xb + i) : 0.f;
  } else {
    for (int i = tid; i < span_pad; i += THREADS) {
      const int f = i / fs;
      const long long s = (long long)f * hop + (i - f * fs);
      wav[i] = f < TF && s < avail ? __ldg(xb + s) : 0.f;
    }
  }
  for (int i = tid; i < NTAB; i += THREADS) tab[i] = tables[i];
  for (int i = tid; i < NFFT; i += THREADS) win[i] = __ldg(window + i);
  for (int i = tid; i < 2 * n_mels; i += THREADS) band[i] = __ldg(bands + i);
  __syncthreads();

  constexpr int H = V / 2, LH = LOGV - 1;
  const double2* tw1 = tab;          // [p*32 + l] = W_M^(l * bitrev_V(p)), p < V
  const double2* tw2 = tab + M;      // [a*32 + l] = W_N^(k(l, a)), a < V/2 (the split)
  const double2* wv = tw2 + M / 2;   // W_V^e, e < V/2
  // the cross-lane stage of half-size d = 16 >> q multiplies a difference by
  // W_2d^(l mod d), and by -1 on the upper lane of a pair (whose difference
  // comes out negated); q = 4 (d = 1) by the sign alone
  const double2* w32 = wv + H;       // W_32^j, j < 16
  double2 ws[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int d = 16 >> q;
    const double2 w = w32[(lane & (d - 1)) * (16 / d)];
    ws[q] = (lane & d) ? make_double2(-w.x, -w.y) : w;
  }
  const double sg1 = (lane & 1) ? -1.0 : 1.0;
  // the split's partners (see below): bin k of register a < V/2 pairs with
  // bin M - k on lane l ^ 15, or, for k1 = 0 (l < 16, a = 0), on lane src0
  const int l4 = lane >> 4, b4 = __brev(lane & 15) >> 28;
  const int src0 = l4 ? lane ^ 15 : (b4 == 0 ? lane : __brev((16 - b4) & 15) >> 28);

  // the loop's trip count is the same for every warp (frames past num_frames
  // are transformed and not stored), so the compiler sees the shuffles in
  // converged code
#pragma unroll 1
  for (int f0 = 0; f0 < TF; f0 += WARPS) {
    const int f = f0 + warp;
    double re[V], im[V];
    const float* fr = wav + f * fs;
    static_for<0, V>([&](auto P) {
      constexpr int p = decltype(P)::value;
      const int n = lane + 32 * p;
      const float2 s = *reinterpret_cast<const float2*>(fr + 2 * n);
      const float2 w = *reinterpret_cast<const float2*>(win + 2 * n);
      re[p] = (double)(s.x * w.x);
      im[p] = (double)(s.y * w.y);
    });
    // V-point DFT over p (stride-32 samples), radix 2, decimation in
    // frequency: register p ends up holding bin bitrev_V(p)
    static_for<0, LOGV>([&](auto ST) {
      constexpr int s = V >> (decltype(ST)::value + 1);
      static_for<0, V / 2>([&](auto J) {  // butterfly J of this stage
        constexpr int j = decltype(J)::value;
        constexpr int i = j % s, a = (j / s) * 2 * s + i, c = a + s;
        constexpr int e = i * (V / (2 * s));  // W_2s^i = W_V^e
        const double dr = re[a] - re[c], di = im[a] - im[c];
        re[a] += re[c];
        im[a] += im[c];
        if constexpr (e == 0) {
          re[c] = dr;
          im[c] = di;
        } else if constexpr (4 * e == V) {  // -i
          re[c] = di;
          im[c] = -dr;
        } else {
          re[c] = dr;
          im[c] = di;
          cmul(re[c], im[c], wv[e]);
        }
      });
    });
    static_for<1, V>([&](auto P) {
      constexpr int p = decltype(P)::value;
      cmul(re[p], im[p], tw1[p * 32 + lane]);
    });
    // 32-point DFTs across the lanes, radix 2, decimation in frequency.
    // Stage d pairs lanes l and l ^ d in every register. The lower lane
    // keeps registers [0, V/2) and the upper lane [V/2, V); each sends the
    // other half, so a shuffle moves half the data and every lane does
    // whole butterflies: lower lane and register j < V/2 hold the pair's
    // sum and difference in j and j + V/2 (the upper lane likewise for
    // register j + V/2). Lane bit d trades places with the register's top
    // bit: afterwards lane l, register (t, a) (t the top bit) holds
    //   bin k = k1 + V k2, k1 = l4 + 2 bitrev_(V/2)(a), k2 = 16 t + bitrev_16(l mod 16)
    // where l4 = l / 16.
    static_for<0, 5>([&](auto Q) {
      constexpr int q = decltype(Q)::value, d = 16 >> q;
      const bool up = lane & d;
      static_for<0, H>([&](auto J) {
        constexpr int j = decltype(J)::value;
        const double sr = up ? re[j] : re[j + H], si = up ? im[j] : im[j + H];
        const double kr = up ? re[j + H] : re[j], ki = up ? im[j + H] : im[j];
        const double rr = __shfl_xor_sync(FULL, sr, d);
        const double ri = __shfl_xor_sync(FULL, si, d);
        re[j] = kr + rr;
        im[j] = ki + ri;
        re[j + H] = kr - rr;
        im[j + H] = ki - ri;
        if constexpr (q < 4) {
          cmul(re[j + H], im[j + H], ws[q]);
        } else {
          re[j + H] *= sg1;
          im[j + H] *= sg1;
        }
      });
    });
    // real split, one pair (k, M - k) per register a < V/2 (top bit 0:
    // k < M/2): X[k] = E + W_N^k O and X[M - k] = conj(E - W_N^k O) with
    // E = (Z[k] + conj Z[M-k]) / 2, O = (Z[k] - conj Z[M-k]) / 2i. Z[M - k]
    // has top bit 1: on lane l ^ 15 in register (1, a'), a' by l4 as below;
    // for k1 = 0 on lane src0, the same register (k = 0 pairs with itself)
    // or (1, 0). Each lane sends what its own partner needs.
    float* prow = pw + f * PSTRIDE;
    static_for<0, H>([&](auto A) {
      constexpr int a = decltype(A)::value;
      constexpr int a1 = bitrev(H - 1 - bitrev(a, LH), LH);   // l4 = 1
      constexpr int a0 = bitrev((H - bitrev(a, LH)) % H, LH);  // l4 = 0, a > 0
      double sr, si;
      if constexpr (a == 0) {
        sr = l4 ? re[H + a1] : (b4 == 0 ? re[0] : re[H]);
        si = l4 ? im[H + a1] : (b4 == 0 ? im[0] : im[H]);
      } else {
        sr = l4 ? re[H + a1] : re[H + a0];
        si = l4 ? im[H + a1] : im[H + a0];
      }
      const int src = a == 0 ? src0 : lane ^ 15;
      const double br = __shfl_sync(FULL, sr, src);
      const double bi = -__shfl_sync(FULL, si, src);  // conj
      // 2E and 2O, so 2X = 2E +- W 2O
      const double er = re[a] + br, ei = im[a] + bi;
      const double o_r = im[a] - bi, o_i = br - re[a];
      const double2 w = tw2[a * 32 + lane];
      const double wr = w.x * o_r - w.y * o_i, wi = w.x * o_i + w.y * o_r;
      const int k = l4 + 2 * bitrev(a, LH) + V * b4;
      prow[padk(k)] =
          magnitude((er + wr) * (er + wr) + (ei + wi) * (ei + wi), mag_mode, mag_eps);
      prow[padk(M - k)] =
          magnitude((er - wr) * (er - wr) + (ei - wi) * (ei - wi), mag_mode, mag_eps);
    });
    if (lane == 0)  // bin M/2: |Z[M/2]|^2, lane 0, register (1, 0)
      prow[padk(M / 2)] = magnitude(4.0 * (re[H] * re[H] + im[H] * im[H]), mag_mode, mag_eps);
  }
  __syncthreads();

  mel_log_tile<TF>(pw, PSTRIDE, band, mel, M + 1, n_mels, out, b, t0, num_frames, log_mode,
                   log_guard);
}

// the frame stride in the FFT kernel's staged wav: hop (one span), or n_fft
int frame_stride(int n_fft, int hop) { return hop % 2 == 0 && hop < n_fft ? hop : n_fft; }

template <int LOGV>
cudaError_t launch_fft(const float* x, const float* window, const float* mel,
                       const int* bands, const double2* tables, float* out, int B,
                       int N, int hop, int n_mels, int num_frames, int mag_mode,
                       float mag_eps, int log_mode, float log_guard,
                       cudaStream_t stream) {
  constexpr int M = 32 << LOGV;
  constexpr int TF = frames_per_tile(LOGV);
  const int fs = frame_stride(2 * M, hop);
  const size_t span_pad = (size_t)(((TF - 1) * fs + 2 * M) + 3) & ~(size_t)3;
  const size_t smem = 16 * (size_t)table_len(LOGV) +
                      sizeof(float) * (2 * M + span_pad + (size_t)TF * power_stride(M) +
                                       2 * (size_t)n_mels);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_fft_kernel<LOGV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_frames + TF - 1) / TF, B);
  logmel_fft_kernel<LOGV><<<grid, THREADS, smem, stream>>>(
      x, window, mel, bands, tables, out, N, hop, fs, n_mels, num_frames, mag_mode,
      (double)mag_eps, log_mode, log_guard);
  return cudaGetLastError();
}

// the direct DFT's power tile row stride: bins 0..n_freq-1 at padk(k)
__host__ __device__ constexpr int dft_power_stride(int n_freq) {
  return n_freq + (n_freq >> 5) + 1;
}

size_t dft_smem(int n_fft, int tf, int n_mels) {
  const int n_freq = n_fft / 2 + 1;
  return 16 * (size_t)n_fft + 8 * (size_t)n_fft * tf +
         4 * ((size_t)tf * dft_power_stride(n_freq) + 2 * (size_t)n_mels);
}

// A block owns a tile of TF frames of batch row blockIdx.y; thread k owns
// bins k, k + THREADS, ... for all TF frames.
template <int TF>
__global__ void __launch_bounds__(THREADS)
logmel_dft_kernel(const float* __restrict__ x, const float* __restrict__ window,
                  const float* __restrict__ mel, const int* __restrict__ bands,
                  const double2* __restrict__ table, float* __restrict__ out, int N,
                  int n_fft, int hop, int n_mels, int num_frames, int mag_mode,
                  double mag_eps, int log_mode, float log_guard) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_freq = n_fft / 2 + 1;
  const int pstride = dft_power_stride(n_freq);
  double2* tab = reinterpret_cast<double2*>(smem_raw);          // W_N^a, a < N
  double* xw = reinterpret_cast<double*>(tab + n_fft);            // [n][TF]: windowed samples
  float* pw = reinterpret_cast<float*>(xw + (size_t)n_fft * TF);  // (TF, pstride)
  int* band = reinterpret_cast<int*>(pw + TF * pstride);
  const int tid = threadIdx.x;
  const int b = blockIdx.y, t0 = blockIdx.x * TF;
  const float* xb = x + (long long)b * N;
  for (int i = tid; i < n_fft; i += THREADS) tab[i] = table[i];
  for (int i = tid; i < TF * n_fft; i += THREADS) {
    const int f = i / n_fft, n = i - f * n_fft;
    const long long s = (long long)(t0 + f) * hop + n;
    const float v = s < N ? __ldg(xb + s) : 0.f;
    xw[n * TF + f] = (double)(v * __ldg(window + n));  // fp32 product, as the plain version
  }
  for (int i = tid; i < 2 * n_mels; i += THREADS) band[i] = __ldg(bands + i);
  __syncthreads();
  for (int k = tid; k < n_freq; k += THREADS) {
    double re[TF], im[TF];
#pragma unroll
    for (int f = 0; f < TF; ++f) re[f] = im[f] = 0.0;
    int a = 0;  // k n mod n_fft
#pragma unroll 2
    for (int n = 0; n < n_fft; ++n) {
      const double2 w = tab[a];
      a += k;
      a -= a >= n_fft ? n_fft : 0;
      const double* xs = xw + n * TF;
#pragma unroll
      for (int f = 0; f < TF; ++f) {
        re[f] = fma(xs[f], w.x, re[f]);
        im[f] = fma(xs[f], w.y, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < TF; ++f)
      pw[f * pstride + padk(k)] =
          magnitude(4.0 * (re[f] * re[f] + im[f] * im[f]), mag_mode, mag_eps);
  }
  __syncthreads();
  mel_log_tile<TF>(pw, pstride, band, mel, n_freq, n_mels, out, b, t0, num_frames, log_mode,
                   log_guard);
}

template <int TF>
cudaError_t launch_dft(const float* x, const float* window, const float* mel,
                       const int* bands, const double2* table, float* out, int B, int N,
                       int n_fft, int hop, int n_mels, int num_frames, int mag_mode,
                       float mag_eps, int log_mode, float log_guard, cudaStream_t stream) {
  const size_t smem = dft_smem(n_fft, TF, n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_dft_kernel<TF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((num_frames + TF - 1) / TF, B);
  logmel_dft_kernel<TF><<<grid, THREADS, smem, stream>>>(
      x, window, mel, bands, table, out, N, n_fft, hop, n_mels, num_frames, mag_mode,
      (double)mag_eps, log_mode, log_guard);
  return cudaGetLastError();
}

}  // namespace

// The direct DFT's frames a tile for (n_fft, n_mels): the largest of 16, 8,
// 4, 2, 1 whose tile fits in shared memory; 0 where none does or n_fft is out
// of range (a count, not an error code).
extern "C" int tsx_fused_logmel_dft_frames(int n_fft, int n_mels) {
  if (n_fft < 1 || n_fft > DFT_MAX_N_FFT) return 0;
  for (int tf = 16; tf >= 1; tf >>= 1)
    if (dft_smem(n_fft, tf, n_mels) <= MAX_SMEM) return tf;
  return 0;
}

// tables: the FFT's twiddle table (fft_tables) for a power-of-two n_fft in
// 128..2048, else the direct DFT's table of n_fft entries (dft_table).
// mag_mode 0: power; 1: sqrt(power + mag_eps); 2: power^mag_eps (mag_eps is
// then half the magnitude's exponent).
extern "C" int tsx_fused_logmel(const void* x, const void* window, const void* mel,
                                const void* bands, const void* tables, void* out,
                                int B, int N, int n_fft, int hop, int n_mels,
                                int num_frames, int mag_mode, float mag_eps,
                                int log_mode, float log_guard, void* stream) {
  if (B <= 0 || num_frames <= 0) return cudaSuccess;
  if (hop <= 0 || n_fft < 1 || n_mels <= 0 || n_mels > n_fft / 2 + 1)
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(window);
  const auto* mf = static_cast<const float*>(mel);
  const auto* bi = static_cast<const int*>(bands);
  const auto* tb = static_cast<const double2*>(tables);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 128: return launch_fft<1>(xf, wf, mf, bi, tb, of, B, N, hop, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard, s);
    case 256: return launch_fft<2>(xf, wf, mf, bi, tb, of, B, N, hop, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard, s);
    case 512: return launch_fft<3>(xf, wf, mf, bi, tb, of, B, N, hop, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard, s);
    case 1024: return launch_fft<4>(xf, wf, mf, bi, tb, of, B, N, hop, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard, s);
    case 2048: return launch_fft<5>(xf, wf, mf, bi, tb, of, B, N, hop, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard, s);
    default: break;
  }
  switch (tsx_fused_logmel_dft_frames(n_fft, n_mels)) {
    case 16: return launch_dft<16>(xf, wf, mf, bi, tb, of, B, N, n_fft, hop, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard, s);
    case 8: return launch_dft<8>(xf, wf, mf, bi, tb, of, B, N, n_fft, hop, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard, s);
    case 4: return launch_dft<4>(xf, wf, mf, bi, tb, of, B, N, n_fft, hop, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard, s);
    case 2: return launch_dft<2>(xf, wf, mf, bi, tb, of, B, N, n_fft, hop, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard, s);
    case 1: return launch_dft<1>(xf, wf, mf, bi, tb, of, B, N, n_fft, hop, n_mels, num_frames, mag_mode, mag_eps, log_mode, log_guard, s);
    default: return cudaErrorInvalidValue;
  }
}

// Shared by every entry point of the library: message for a returned code.
extern "C" const char* tsx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
