// Monotonic alignment search (MAS): the most likely monotone path of text
// tokens over mel frames, as Grad-TTS's training step needs it once a step.
//
// Replaces no Pallas kernel: the JAX package compiles MAS as one lax.scan over
// the Ty mel columns and a reversed scan for the backtrace
// (tpu_speech/ops/monotonic_align.py::maximum_path:27). In eager PyTorch the
// same scan is a Python loop of Ty columns with several launches each
// (maximum_path_plain in ops/monotonic_align.py); this kernel is one launch.
// Its arithmetic is the scan's, cell for cell, so the path is the same bit for
// bit. With v = value * mask in fp32, per batch row b, t_x = sum_x mask[x, 0],
// t_y = sum_y mask[0, y], MAX_NEG = -1e9:
//     D[x, y] = v[x, y] + max(stay, adv),
//     stay = MAX_NEG if x == y else D[x, y - 1]   (D[., -1] = MAX_NEG),
//     adv  = D[x - 1, y - 1]; at x == 0: 0 if y == 0 else MAX_NEG;
// then from index = t_x - 1 at y = t_y - 1 down to y = 0: path[index, y] = 1,
// and index steps down when y > 0, index != 0 and (index == y or
// D[index, y - 1] < D[index - 1, y - 1]) (ties stay). Only cells with
// x < t_x and y < t_y are computed: no other cell reaches the backtrace.
//
// What bounds it on an H100: not bytes (value, mask and path are 7 MB at the
// bench point B = 16, Tx = 72, Ty = 512: 2 us at 3.35 TB/s) and not
// operations (two per cell), but the dependency chain: t_y DP columns, each
// a barrier apart, then t_y dependent reads in the backtrace. The design is
// the simple one that is right: one block per batch row, threads striding
// over Tx, the previous and current DP column in shared memory (double
// buffered, one __syncthreads per column), every DP column also stored to a
// (B, Ty, Tx) fp32 scratch, and one thread walking the backtrace over that
// scratch and writing the ones into a path the block zeroed first. The
// lengths come from the mask on the device: the host reads nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float MAX_NEG = -1e9f;
constexpr int MAX_THREADS = 1024;
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on Hopper

// jnp.maximum: a NaN operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void maximum_path_kernel(const float* __restrict__ value,
                                    const float* __restrict__ mask,
                                    float* __restrict__ dp, float* __restrict__ path,
                                    int Tx, int Ty) {
  extern __shared__ float cols[];  // 2 x Tx: DP columns y - 1 and y
  __shared__ float lens[2];
  const size_t plane = static_cast<size_t>(Tx) * Ty;
  const float* v = value + blockIdx.x * plane;  // (Tx, Ty)
  const float* m = mask + blockIdx.x * plane;   // (Tx, Ty)
  float* d = dp + blockIdx.x * plane;           // (Ty, Tx)
  float* p = path + blockIdx.x * plane;         // (Tx, Ty)

  if (threadIdx.x < 2) lens[threadIdx.x] = 0.f;
  __syncthreads();
  float sx = 0.f, sy = 0.f;  // sums of 0/1 values: exact in any order
  for (int x = threadIdx.x; x < Tx; x += blockDim.x) sx += m[static_cast<size_t>(x) * Ty];
  for (int y = threadIdx.x; y < Ty; y += blockDim.x) sy += m[y];
  for (size_t i = threadIdx.x; i < plane; i += blockDim.x) p[i] = 0.f;
  atomicAdd(&lens[0], sx);
  atomicAdd(&lens[1], sy);
  float* prev = cols;
  float* cur = cols + Tx;
  for (int x = threadIdx.x; x < Tx; x += blockDim.x) prev[x] = MAX_NEG;
  __syncthreads();
  const int t_x = static_cast<int>(lens[0]);
  const int t_y = static_cast<int>(lens[1]);

  for (int y = 0; y < t_y; ++y) {
    for (int x = threadIdx.x; x < t_x; x += blockDim.x) {
      const size_t i = static_cast<size_t>(x) * Ty + y;
      const float stay = x == y ? MAX_NEG : prev[x];
      const float adv = x == 0 ? (y == 0 ? 0.f : MAX_NEG) : prev[x - 1];
      // two roundings, as the scan's multiply and add (no contraction)
      const float s = __fadd_rn(__fmul_rn(v[i], m[i]), nan_max(stay, adv));
      cur[x] = s;
      d[static_cast<size_t>(y) * Tx + x] = s;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }

  if (threadIdx.x != 0 || t_x <= 0) return;
  int index = t_x - 1;
  for (int y = t_y - 1; y >= 0; --y) {
    p[static_cast<size_t>(index) * Ty + y] = 1.f;
    if (y > 0 && index != 0) {
      const float* col = d + static_cast<size_t>(y - 1) * Tx;
      index -= (index == y || col[index] < col[index - 1]) ? 1 : 0;
    }
  }
}

}  // namespace

// path (B, Tx, Ty) of 0/1 from value and mask (B, Tx, Ty), all contiguous
// fp32; dp is a (B, Ty, Tx) fp32 scratch. Tx up to MAX_SMEM / 8.
extern "C" int tsx_maximum_path(const void* value, const void* mask, void* dp, void* path,
                                int B, int Tx, int Ty, void* stream) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(Tx);
  if (B < 0 || Tx < 0 || Ty < 0 || smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (B == 0 || Tx == 0 || Ty == 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        maximum_path_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int threads = ((Tx + 31) / 32) * 32;
  threads = threads < 128 ? 128 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  maximum_path_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(mask),
      static_cast<float*>(dp), static_cast<float*>(path), Tx, Ty);
  return cudaGetLastError();
}
