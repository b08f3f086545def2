// Merged-qkv self-attention forward, fp32, flash-style, for Hopper.
//
// Replaces the forward Pallas TPU kernel of
// tpu_speech/ops/fused_attention.py::fused_qkv_self_attention (kernel body
// _qkv_fwd_kernel, pallas_call at line 384 in _fused_qkv_attn_fwd), with
// dropout off. Per (batch b, head h):
//     out[b, :, h*D:(h+1)*D] = softmax(q k^T, padded keys filled with -1e9) v
// where q, k, v are head h's column slices of the merged (B, T, 3E) plane
// (q already carries the d_head**-0.5 scale). The fill is the finite -1e9,
// never -inf, so a query row whose keys are all padded stays finite (it
// averages v), exactly like the reference. The softmax is fp32.
//
// What bounds it on an H100: the two products, 4*B*H*T^2*D FLOP (10.5
// GFLOP for SPIRAL block 1 at B=14, T=604, E=512), on the fp32 CUDA cores;
// the bytes are small (qkv read once per query tile, out written once). The
// TPU kernel holds a whole (T, T) f32 score tile in VMEM; at T=604 that tile
// is 1.46 MB, far over the 227 KB of shared memory a block may use, so:
//
// Design. One block owns (b, h, a tile of BQ queries) and loops over key
// tiles of BK with an online softmax (running max m, running sum l, rescaled
// accumulator), so no (T, T) tile ever exists. q/k/v are read straight from
// the (B, T, 3E) plane by strides (no split copies) and the block writes
// head h's columns of (B, T, E). 256 threads: thread (rg, cg) owns rows
// rg*4..rg*4+3 and score columns cg+16j, and output columns cg+16i; the 16
// threads that share rows sit in one half-warp and reduce with shuffles.
// Shared tiles use an odd row stride so column reads are conflict-free.
// Keys past T (the ragged last tile) get -inf and drop out exactly.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D>
constexpr size_t attn_smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
          (size_t)BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(NT)
qkv_attn_fwd_kernel(const float* __restrict__ qkv,
                    const unsigned char* __restrict__ key_pad,
                    float* __restrict__ out, int T, int H) {
  constexpr int DP = D + 1;
  constexpr int PS = BK + 1;
  constexpr int DPT = (D + 15) / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // BQ x DP
  float* ks = qs + BQ * DP;    // BK x DP
  float* vs = ks + BK * DP;    // BK x D
  float* ps = vs + BK * D;     // BQ x PS

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int E = H * D;
  const long long row = 3LL * E;
  const float* base = qkv + (long long)b * T * row;
  const float* qg = base + h * D;
  const float* kg = base + E + h * D;
  const float* vg = base + 2 * E + h * D;
  const unsigned char* pad = key_pad ? key_pad + (long long)b * T : nullptr;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, t = q0 + r;
    qs[r * DP + c] = t < T ? qg[t * row + c] : 0.f;
  }

  float m[4], l[4], o[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // q is staged / the previous key tile is consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, t = k0 + r;
      const bool ok = t < T;
      ks[r * DP + c] = ok ? kg[t * row + c] : 0.f;
      vs[r * D + c] = ok ? vg[t * row + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cg + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + cg + 16 * j;
      const bool valid = key < T;
      const bool padded = valid && pad != nullptr && pad[key] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = !valid ? -INFINITY : (padded ? -1e9f : s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      // key k0 < T is valid, so mt (and m_new) is finite
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(rg * 4 + i) * PS + cg + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) o[i][c] *= alpha;
    }
    __syncthreads();  // the probability tile is complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = cg + 16 * c;
        if (col < D) {
          const float v = vs[kk * D + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], v, o[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + rg * 4 + i;
    if (t < T) {
      const float inv = 1.f / l[i];
      float* dst = out + ((long long)b * T + t) * E + h * D;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = cg + 16 * c;
        if (col < D) dst[col] = o[i][c] * inv;
      }
    }
  }
}

template <int D>
int launch(const float* qkv, const unsigned char* key_pad, float* out, int B,
           int T, int H, cudaStream_t stream) {
  constexpr size_t smem = attn_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      qkv_attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  qkv_attn_fwd_kernel<D><<<grid, NT, smem, stream>>>(qkv, key_pad, out, T, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tsx_qkv_attention_fwd(const void* qkv, const void* key_pad,
                                     void* out, int B, int T, int H, int D,
                                     void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  const float* q = static_cast<const float*>(qkv);
  const unsigned char* kp = static_cast<const unsigned char*>(key_pad);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch<8>(q, kp, o, B, T, H, s);
    case 16: return launch<16>(q, kp, o, B, T, H, s);
    case 32: return launch<32>(q, kp, o, B, T, H, s);
    case 64: return launch<64>(q, kp, o, B, T, H, s);
    default: return cudaErrorInvalidValue;
  }
}
