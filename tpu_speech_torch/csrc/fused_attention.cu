// Self-attention, forward and backward, fp32, flash-style, with in-kernel
// attention dropout, for Hopper.
//
// Replaces the Pallas TPU kernels of tpu_speech/ops/fused_attention.py:
//   K2, fused_qkv_self_attention (q, k, v the thirds of a merged (B, T, 3E)
//   plane):
//     forward  _qkv_fwd_kernel (pallas_call at line 384, _fused_qkv_attn_fwd)
//     backward _qkv_bwd_kernel (pallas_call at line 401, _fused_qkv_attn_bwd)
//   K3, fused_self_attention (q, k, v separate (B, T, H, D) arrays):
//     forward  _fwd_kernel (pallas_call at line 222, _fused_attn_fwd)
//     backward _bwd_kernel (pallas_call at line 239, _fused_attn_bwd)
// Both are one set of kernels here. They read row t of head h of q, k and v
// at base + (b*T + t)*ld + h*D: ld = 3E for the merged plane (k and v start E
// and 2E floats after q), ld = H*D for separate (B, T, H, D) arrays. The
// gradients go out the same way with their own row stride. Per (batch b,
// head h), with q already carrying the d_head**-0.5 scale:
//     S = q k^T, padded keys filled with the finite -1e9
//     P = softmax(S) in fp32,   P~ = P * keep / (1 - p_drop)
//     out[b, :, h*D:(h+1)*D] = P~ v      (out is (B, T, H*D))
// A query row whose keys are all padded stays finite (P is uniform, 1/T), as
// in the reference.
//
// Dropout. The TPU kernel draws its keep bits from the core's PRNG, which
// nothing else can reproduce. Here the bits are a counter-based function
// of (seed, b*H + h, i*T + j), defined ONCE below (dropout_stream /
// dropout_bits) and mirrored bit for bit by the plain PyTorch version
// (ops/fused_attention.py::dropout_keep_mask). Every kernel and every tiling
// therefore regenerates the same mask; nothing (B, H, T, T) is stored.
// keep = bits >= threshold, threshold = min(floor(p * 2^32), 2^32 - 1), as
// the TPU kernel's _keep_mask.
//
// Backward. The forward saves the row logsumexp L (B, H, T) when a gradient
// is needed. The backward recomputes P = exp(S - L) and regenerates keep:
//     dV  = P~^T dO
//     dP  = (dO v^T) * keep / (1 - p_drop)
//     dS  = P * (dP - Delta),  Delta_i = rowsum(dO_i * out_i)
//     dQ  = dS k,   dK = dS^T q
// and writes dQ, dK, dV by their row stride. dS is zero at padded keys: the gradient of the -1e9 fill, which
// is what the XLA path (jnp.where) and the plain PyTorch version
// (masked_fill) give. The Pallas backward differs there for fully padded
// rows (ROADMAP Queue 3). A fully padded row's L rounds to the fill itself
// in fp32 (-1e9 + log T == -1e9), so the backward reads L == -1e9 as "uniform
// row" and uses P = 1/T, which is exact.
//
// What bounds it on an H100: the products, 4*B*H*T^2*D FLOP forward and
// about 2.5x that backward, on the fp32 CUDA cores (no TF32, no tensor
// cores: fp32 parity). The TPU kernels hold a whole (T, T) f32 tile in VMEM;
// at T = 456 that tile is 0.83 MB, far over the 227 KB of shared memory a
// block may use, so:
//
// Design. Forward: one block owns (b, h, a tile of BQ queries) and loops over
// key tiles of BK with an online softmax (running max m, running sum l of the
// UN-dropped probabilities, rescaled accumulator of the dropped ones), so no
// (T, T) tile ever exists. Backward, deterministic, no atomics, three
// launches: Delta per (b, h, row); one block per (b, h, key tile) loops over
// query tiles and accumulates dK, dV in registers; one block per (b, h,
// query tile) loops over key tiles and accumulates dQ. 256 threads: thread
// (rg, cg) owns rows rg*4..rg*4+3 and score columns cg+16j, and output
// columns cg+16i; the 16 threads that share rows sit in one half-warp and
// reduce with shuffles. Shared tiles use an odd row stride so column reads
// are conflict-free. Keys and queries past T (ragged last tiles) drop out.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int PS = BK + 1;
constexpr float FILL = -1e9f;

// ---- the dropout bits: the one definition (plain twin in Python) --------
__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// per (seed, b*H + h) stream key
__device__ __forceinline__ unsigned dropout_stream(unsigned seed, unsigned bh) {
  return fmix32(seed ^ fmix32(bh + 0x9E3779B9u));
}

// bits of element idx = i*T + j of that stream
__device__ __forceinline__ unsigned dropout_bits(unsigned stream, unsigned idx) {
  return fmix32(stream ^ (idx * 0x9E3779B1u));
}
// --------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
          (size_t)BQ * PS);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {  // q, dO, k, v tiles; P~ and dS tiles; L, Delta
  return sizeof(float) * (4 * (size_t)BQ * (D + 1) + 2 * (size_t)BQ * PS + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {  // q, dO, k, v tiles; dS tile
  return sizeof(float) * (4 * (size_t)BQ * (D + 1) + (size_t)BQ * PS);
}

template <int D>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, int ld,
                const unsigned char* __restrict__ key_pad,
                float* __restrict__ out, float* __restrict__ lse, int T, int H,
                unsigned seed, unsigned thresh, float drop_scale) {
  constexpr int DP = D + 1;
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
  const long long row = ld;
  const long long head = (long long)b * T * row + h * D;
  const float* qg = q + head;
  const float* kg = k + head;
  const float* vg = v + head;
  const unsigned char* pad = key_pad ? key_pad + (long long)b * T : nullptr;
  const unsigned stream = thresh ? dropout_stream(seed, (unsigned)blockIdx.y) : 0u;

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
        s[i][j] = !valid ? -INFINITY : (padded ? FILL : s[i][j]);
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
      const unsigned qrow = (unsigned)(q0 + rg * 4 + i) * (unsigned)T;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + cg + 16 * j;
        const float p = expf(s[i][j] - m_new);
        rs += p;  // the softmax sum runs over the un-dropped probabilities
        const bool drop =
            thresh != 0u && dropout_bits(stream, qrow + (unsigned)key) < thresh;
        ps[(rg * 4 + i) * PS + cg + 16 * j] = drop ? 0.f : p * drop_scale;
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
          const float vv = vs[kk * D + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
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
      if (lse != nullptr && cg == 0)
        lse[(long long)blockIdx.y * T + t] = m[i] + logf(l[i]);
    }
  }
}

// Delta[b, h, t] = sum_c dO[b, t, h*D + c] * out[b, t, h*D + c]; one block
// per (b, t), one warp per head.
__global__ void attn_bwd_delta_kernel(const float* __restrict__ out,
                                      const float* __restrict__ dout,
                                      float* __restrict__ delta, int T, int H,
                                      int D) {
  const int bt = blockIdx.x;
  const int b = bt / T, t = bt % T;
  const long long E = (long long)H * D;
  const float* o = out + bt * E;
  const float* g = dout + bt * E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int h = warp; h < H; h += nw) {
    float acc = 0.f;
    for (int c = lane; c < D; c += 32) acc = fmaf(o[h * D + c], g[h * D + c], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[((long long)b * H + h) * T + t] = acc;
  }
}

// The 4x4 score and dO v^T fragments of thread (rg, cg) for the staged
// query tile (qs, dos) against the staged key tile (ks, vs).
template <int D>
__device__ __forceinline__ void score_fragments(const float* qs, const float* dos,
                                                const float* ks, const float* vs,
                                                int rg, int cg, float s[4][4],
                                                float dp[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(rg * 4 + i) * DP + d];
      gv[i] = dos[(rg * 4 + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(cg + 16 * j) * DP + d];
      vv[j] = vs[(cg + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

// P~ (dropped, scaled) and dS of one score element; zeros outside the
// valid (query, key) range.
struct ElemGrad {
  float pd, ds;
};

__device__ __forceinline__ ElemGrad elem_grad(float s, float dp, float L,
                                              float Di, bool in_range,
                                              bool padded, bool drop,
                                              float drop_scale, float inv_t) {
  ElemGrad r{0.f, 0.f};
  if (!in_range) return r;
  // L == FILL only when every key of the row is padded: P is uniform there
  const float p = L <= FILL ? inv_t : expf((padded ? FILL : s) - L);
  const float keep = drop ? 0.f : drop_scale;
  r.pd = p * keep;
  r.ds = padded ? 0.f : p * (dp * keep - Di);
  return r;
}

template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int t0, int T,
                                           int tid) {
  constexpr int DP = D + 1;
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * DP + c] = t < T ? src[t * stride + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, int ld,
                     const unsigned char* __restrict__ key_pad,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int ld_grad, int T, int H,
                     unsigned seed, unsigned thresh, float drop_scale,
                     float inv_t) {
  constexpr int DP = D + 1;
  constexpr int DPT = (D + 15) / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // BQ x DP
  float* dos = qs + BQ * DP;    // BQ x DP
  float* ks = dos + BQ * DP;    // BK x DP
  float* vs = ks + BK * DP;     // BK x DP
  float* pt = vs + BK * DP;     // BQ x PS: P~
  float* dst = pt + BQ * PS;    // BQ x PS: dS
  float* rowl = dst + BQ * PS;  // BQ: L
  float* rowd = rowl + BQ;      // BQ: Delta

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int E = H * D;
  const long long row = ld;
  const long long head = (long long)b * T * row + h * D;
  const float* dog = dout + (long long)b * T * E + h * D;
  const unsigned char* pad = key_pad ? key_pad + (long long)b * T : nullptr;
  const unsigned stream = thresh ? dropout_stream(seed, (unsigned)bh) : 0u;

  stage_rows<D>(ks, k + head, row, k0, T, tid);
  stage_rows<D>(vs, v + head, row, k0, T, tid);
  int kidx[4];
  bool kvalid[4], kpad[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    kidx[j] = k0 + cg + 16 * j;
    kvalid[j] = kidx[j] < T;
    kpad[j] = kvalid[j] && pad != nullptr && pad[kidx[j]] != 0;
  }

  float dkr[4][DPT], dvr[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dkr[i][c] = 0.f;
      dvr[i][c] = 0.f;
    }

  for (int q0 = 0; q0 < T; q0 += BQ) {
    __syncthreads();  // the previous query tile is consumed
    stage_rows<D>(qs, q + head, row, q0, T, tid);
    stage_rows<D>(dos, dog, E, q0, T, tid);
    if (tid < BQ) {
      const int t = q0 + tid;
      rowl[tid] = t < T ? lse[(long long)bh * T + t] : 0.f;
      rowd[tid] = t < T ? delta[(long long)bh * T + t] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    score_fragments<D>(qs, dos, ks, vs, rg, cg, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int qi = q0 + r;
      const float L = rowl[r], Di = rowd[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool drop =
            thresh != 0u &&
            dropout_bits(stream, (unsigned)qi * (unsigned)T + (unsigned)kidx[j]) < thresh;
        const ElemGrad g = elem_grad(s[i][j], dp[i][j], L, Di,
                                     qi < T && kvalid[j], kpad[j], drop,
                                     drop_scale, inv_t);
        pt[r * PS + cg + 16 * j] = g.pd;
        dst[r * PS + cg + 16 * j] = g.ds;
      }
    }
    __syncthreads();  // the P~ and dS tiles are complete

    // dV[key] += sum_q P~[q, key] dO[q];  dK[key] += sum_q dS[q, key] q[q]
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pv[kk] = pt[qq * PS + rg * 4 + kk];
        dsv[kk] = dst[qq * PS + rg * 4 + kk];
      }
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = cg + 16 * c;
        if (col < D) {
          const float g = dos[qq * DP + col];
          const float qv = qs[qq * DP + col];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            dvr[kk][c] = fmaf(pv[kk], g, dvr[kk][c]);
            dkr[kk][c] = fmaf(dsv[kk], qv, dkr[kk][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int t = k0 + rg * 4 + kk;
    if (t < T) {
      const long long off = ((long long)b * T + t) * ld_grad + h * D;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = cg + 16 * c;
        if (col < D) {
          dk[off + col] = dkr[kk][c];
          dv[off + col] = dvr[kk][c];
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, int ld,
                   const unsigned char* __restrict__ key_pad,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int ld_grad, int T, int H, unsigned seed, unsigned thresh,
                   float drop_scale, float inv_t) {
  constexpr int DP = D + 1;
  constexpr int DPT = (D + 15) / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // BQ x DP
  float* dos = qs + BQ * DP;   // BQ x DP
  float* ks = dos + BQ * DP;   // BK x DP
  float* vs = ks + BK * DP;    // BK x DP
  float* dst = vs + BK * DP;   // BQ x PS: dS

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int E = H * D;
  const long long row = ld;
  const long long head = (long long)b * T * row + h * D;
  const unsigned char* pad = key_pad ? key_pad + (long long)b * T : nullptr;
  const unsigned stream = thresh ? dropout_stream(seed, (unsigned)bh) : 0u;

  stage_rows<D>(qs, q + head, row, q0, T, tid);
  stage_rows<D>(dos, dout + (long long)b * T * E + h * D, E, q0, T, tid);
  float L[4], Di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + rg * 4 + i;
    L[i] = t < T ? lse[(long long)bh * T + t] : 0.f;
    Di[i] = t < T ? delta[(long long)bh * T + t] : 0.f;
  }

  float dqr[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dqr[i][c] = 0.f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // q/dO staged / the previous key tile is consumed
    stage_rows<D>(ks, k + head, row, k0, T, tid);
    stage_rows<D>(vs, v + head, row, k0, T, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_fragments<D>(qs, dos, ks, vs, rg, cg, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + cg + 16 * j;
      const bool kvalid = key < T;
      const bool kpad = kvalid && pad != nullptr && pad[key] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + rg * 4 + i;
        const bool drop =
            thresh != 0u &&
            dropout_bits(stream, (unsigned)qi * (unsigned)T + (unsigned)key) < thresh;
        const ElemGrad g = elem_grad(s[i][j], dp[i][j], L[i], Di[i],
                                     qi < T && kvalid, kpad, drop, drop_scale,
                                     inv_t);
        dst[(rg * 4 + i) * PS + cg + 16 * j] = g.ds;
      }
    }
    __syncthreads();  // the dS tile is complete

    // dQ[q] += sum_key dS[q, key] k[key]
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dst[(rg * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = cg + 16 * c;
        if (col < D) {
          const float kv = ks[kk * DP + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) dqr[i][c] = fmaf(dsv[i], kv, dqr[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + rg * 4 + i;
    if (t < T) {
      float* drow = dq + ((long long)b * T + t) * ld_grad + h * D;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = cg + 16 * c;
        if (col < D) drow[col] = dqr[i][c];
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Row strides and pointers of one attention call: q, k, v rows at stride ld;
// dq, dk, dv rows at stride ld_grad (backward only).
struct Operands {
  const float *q, *k, *v;
  int ld;
  float *dq, *dk, *dv;
  int ld_grad;
};

template <int D>
int launch_fwd(const Operands& a, const unsigned char* key_pad, float* out,
               float* lse, int B, int T, int H, unsigned seed, unsigned thresh,
               float drop_scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(attn_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  attn_fwd_kernel<D><<<grid, NT, smem, stream>>>(a.q, a.k, a.v, a.ld, key_pad, out,
                                                 lse, T, H, seed, thresh, drop_scale);
  return cudaGetLastError();
}

template <int D>
int launch_bwd(const Operands& a, const unsigned char* key_pad, const float* out,
               const float* dout, const float* lse, float* delta, int B, int T,
               int H, unsigned seed, unsigned thresh, float drop_scale,
               cudaStream_t stream) {
  const float inv_t = 1.f / (float)T;
  attn_bwd_delta_kernel<<<B * T, 128, 0, stream>>>(out, dout, delta, T, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkdv_smem_bytes<D>();
  err = allow_smem(attn_bwd_dkdv_kernel<D>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((T + BK - 1) / BK, B * H);
  attn_bwd_dkdv_kernel<D><<<grid_kv, NT, smem_kv, stream>>>(
      a.q, a.k, a.v, a.ld, key_pad, dout, lse, delta, a.dk, a.dv, a.ld_grad, T, H,
      seed, thresh, drop_scale, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = dq_smem_bytes<D>();
  err = allow_smem(attn_bwd_dq_kernel<D>, smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((T + BQ - 1) / BQ, B * H);
  attn_bwd_dq_kernel<D><<<grid_q, NT, smem_q, stream>>>(
      a.q, a.k, a.v, a.ld, key_pad, dout, lse, delta, a.dq, a.ld_grad, T, H, seed,
      thresh, drop_scale, inv_t);
  return cudaGetLastError();
}

}  // namespace

// out (B, T, H*D); lse (B, H, T) or null (no gradient needed). q, k, v rows
// of width >= H*D at stride ld.
extern "C" int tsx_attention_fwd(const void* q, const void* k, const void* v,
                                 int ld, const void* key_pad, void* out,
                                 void* lse, int B, int T, int H, int D,
                                 unsigned seed, unsigned thresh, float drop_scale,
                                 void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  const Operands a{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), ld, nullptr, nullptr, nullptr, 0};
  const unsigned char* kp = static_cast<const unsigned char*>(key_pad);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch_fwd<8>(a, kp, o, l, B, T, H, seed, thresh, drop_scale, s);
    case 16: return launch_fwd<16>(a, kp, o, l, B, T, H, seed, thresh, drop_scale, s);
    case 32: return launch_fwd<32>(a, kp, o, l, B, T, H, seed, thresh, drop_scale, s);
    case 64: return launch_fwd<64>(a, kp, o, l, B, T, H, seed, thresh, drop_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// dq, dk, dv (rows at stride ld_grad) from q, k, v, out, dout (B, T, H*D) and
// the forward's lse; delta (B, H, T) is scratch.
extern "C" int tsx_attention_bwd(const void* q, const void* k, const void* v,
                                 int ld, const void* key_pad, const void* out,
                                 const void* dout, const void* lse, void* delta,
                                 void* dq, void* dk, void* dv, int ld_grad, int B,
                                 int T, int H, int D, unsigned seed,
                                 unsigned thresh, float drop_scale, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  const Operands a{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), ld, static_cast<float*>(dq),
                   static_cast<float*>(dk), static_cast<float*>(dv), ld_grad};
  const unsigned char* kp = static_cast<const unsigned char*>(key_pad);
  const float* o = static_cast<const float*>(out);
  const float* g = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch_bwd<8>(a, kp, o, g, l, dl, B, T, H, seed, thresh, drop_scale, s);
    case 16: return launch_bwd<16>(a, kp, o, g, l, dl, B, T, H, seed, thresh, drop_scale, s);
    case 32: return launch_bwd<32>(a, kp, o, g, l, dl, B, T, H, seed, thresh, drop_scale, s);
    case 64: return launch_bwd<64>(a, kp, o, g, l, dl, B, T, H, seed, thresh, drop_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
