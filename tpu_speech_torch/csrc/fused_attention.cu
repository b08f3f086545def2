// Self-attention, forward and backward, fp32-accurate on Hopper's tensor
// cores (3xTF32), flash-style, with in-kernel attention dropout.
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
// of (seed, bh0 + b*H + h, i*T + j), defined once in dropout_bits.cuh
// (dropout_stream / dropout_bits) and mirrored bit for bit by the plain
// PyTorch version (ops/fused_attention.py::dropout_keep_mask). Every kernel
// and every tiling therefore regenerates the same mask; nothing (B, H, T, T)
// is stored.
// keep = bits >= threshold, threshold = min(floor(p * 2^32), 2^32 - 1), as
// the TPU kernel's _keep_mask.
//
// Backward. The forward saves the row logsumexp L (B, H, T) when a gradient
// is needed. The backward recomputes P = exp(S - L) and regenerates keep:
//     dV  = P~^T dO
//     dP  = (dO v^T) * keep / (1 - p_drop)
//     dS  = P * (dP - Delta),  Delta_i = rowsum(dO_i * out_i)
//     dQ  = dS k,   dK = dS^T q
// and writes dQ, dK, dV by their row stride. dS is zero at padded keys: the
// gradient of the -1e9 fill, which is what the XLA path (jnp.where) and the
// plain PyTorch version (masked_fill) give. The Pallas backward differs there
// for fully padded rows (ROADMAP Queue 3). A fully padded row's L rounds to
// the fill itself in fp32 (-1e9 + log T == -1e9), so the backward reads
// L == -1e9 as "uniform row" and uses P = 1/T, which is exact.
//
// What bounds it on an H100: the products, 4*B*H*T^2*D FLOP forward and
// 10*B*H*T^2*D backward (S and dO v^T recomputed), against a few MB of
// operands: far above the memory roofline. The port's contract is fp32 with
// TF32 off, so the fp32 CUDA cores (67 TFLOP/s peak) were the obvious home,
// and the first kernels ran there at 12-19 TFLOP/s. The tensor cores take
// TF32 only, which keeps 11 bits of each operand (about 3 digits; the limits
// are 1e-4). So every product runs as three TF32 products of a hi/lo split:
//     x = hi + lo,  hi = rna_tf32(x),  lo = tf32(x - hi)
//     a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi    (fp32 accumulate)
// which keeps 22 bits of each operand and drops only lo*lo (2^-22 relative):
// fp32 accuracy at a third of the 495 TFLOP/s TF32 rate. The bound is
// 3 * FLOP / 495 TFLOP/s. (tests/test_torch_attention.py emulates the split
// in numpy: within 1e-6 of fp32, where one TF32 pass misses the 1e-4 limit.)
//
// Design. All products are mma.sync.m16n8k8 TF32 (Hopper's wgmma takes TF32
// from shared memory only in K-major layout, and the hi/lo split happens in
// registers, so each 16 x 8 fragment is split where it is loaded). A block
// has 4 warps; each warp owns 16 rows of its tile, so nothing is reduced
// across warps. Tiles of 64 rows stream through shared memory double-
// buffered by cp.async (16-byte copies, zero-filled past T) while the
// previous tile computes; rows are padded to D + 4 floats, which makes every
// fragment load conflict-free.
//   Forward: one block per (b*H + h, 64 queries). S (16 x 64 per warp) stays
//   in the accumulator registers; the online softmax, the -1e9 fill and the
//   dropout bits (from each element's (query, key) index) run on the
//   fragments. P~ is split in registers and used as the A operand of P~ V:
//   the accumulator holds columns (2t, 2t+1) where the A operand wants
//   (t, t+4), so V's rows are read from shared memory in that permuted order
//   instead of shuffling P.
//   Backward, deterministic, no atomics, three launches: Delta per (b, h,
//   row); one block per (b*H + h, 64 keys) computes S^T and dP^T with the
//   keys as rows, so P~^T and dS^T are already the A operands of
//   dV += P~^T dO and dK += dS^T q (32 queries at a time, to keep it under
//   255 registers), and writes dS^T to a scratch (B*H x T x T rounded up to
//   64, fp32: 154 MB at the pretrain shape, 4 % of the FLOP in bytes); one
//   block per (b*H + h, 64 queries) then forms dQ = dS k as a plain product.
//   The first design recomputed S and dP for dQ: 14 instead of 10
//   B H T^2 D FLOP.
//
// Head widths: 8, 16, 32 and 64, 12 (the toy config's 48 / 4) and 96
// (wav2vec 2.0 BASE, 768 / 8). The
// products step d by the mma's k of 8, so a width that is not a multiple of
// 8 runs padded to the next one (padded()): stage_rows zero-fills the tiles'
// extra columns, which adds exact zeros to S and dP, and the stores skip
// them. q carries the 12**-0.5 scale already.
//
// bf16 operands (entry points tsx_attention_*_bf16) run on the Hopper
// kernels of fused_attention_sm90.cu (wgmma, TMA), with the same semantics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_bits.cuh"

namespace {

constexpr int BQ = 64;        // queries per tile
constexpr int BK = 64;        // keys per tile
constexpr int NW = 4;         // warps per block, 16 tile rows each
constexpr int NT = NW * 32;
constexpr float FILL = -1e9f;
constexpr unsigned char KEY_VALID = 0, KEY_PADDED = 1, KEY_OUT = 2;

// ---- 3xTF32 products on the tensor cores ---------------------------------
// A 16 x 8 operand (a0..a3 of mma.m16n8k8) and an 8 x 8 one (b0, b1), each
// value split in hi + lo.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi = x rounded to TF32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives for finite x; on sm_90 that instruction compiles to
// a longer sequence with NaN and overflow checks, which cost more than the
// products); lo = x - hi exactly, which the tensor core reads as TF32 by
// dropping its low 13 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float x0, float x1, float x2, float x3) {
  FragA f;
  split(x0, f.hi[0], f.lo[0]);
  split(x1, f.hi[1], f.lo[1]);
  split(x2, f.hi[2], f.lo[2]);
  split(x3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float x0, float x1) {
  FragB f;
  split(x0, f.hi[0], f.lo[0]);
  split(x1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in fp32 accuracy: the small terms first, then hi * hi
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// Fragment layouts (lane = 4g + t): A (16 x 8) a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); B (8 x 8, k x n) b0 (t, g), b1 (t+4, g);
// C (16 x 8) c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).

// A = rows r0.. and columns c0.. of a row-major shared tile (row stride ss)
__device__ __forceinline__ FragA load_a(const float* s, int ss, int r0, int c0,
                                        int g, int t) {
  const float* p = s + (r0 + g) * ss + c0 + t;
  return frag_a(p[0], p[8 * ss], p[4], p[8 * ss + 4]);
}

// B[k][n] = s[n0 + n][k0 + k]: a shared tile whose rows are B's columns
__device__ __forceinline__ FragB load_bt(const float* s, int ss, int n0, int k0,
                                         int g, int t) {
  const float* p = s + (n0 + g) * ss + k0 + t;
  return frag_b(p[0], p[4]);
}

// B[k][n] = s[k0 + k][n0 + n] in the k order of acc_as_a: logical k = t and
// t + 4 are the tile's rows 2t and 2t + 1
__device__ __forceinline__ FragB load_b_perm(const float* s, int ss, int k0, int n0,
                                             int g, int t) {
  const float* p = s + (k0 + 2 * t) * ss + n0 + g;
  return frag_b(p[0], p[ss]);
}

// an accumulator tile (16 x 8) as an A operand whose k runs over its
// columns in the order 2t, 2t + 1 (see load_b_perm)
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}
// --------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
// --------------------------------------------------------------------------

// ---- staging: cp.async, 16 bytes a copy, zero-filled past T --------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               ::"r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the head width the products run at: D rounded up to the mma's k of 8
__host__ __device__ constexpr int padded(int d) { return (d + 7) / 8 * 8; }

// rows t0 .. t0 + 63 of a slab with row stride `stride` floats, D of them
// a row, into a shared [64][DP + 4] tile; rows past T and columns D .. DP - 1
// are zeros (a head of 12 runs as 16 whose last 4 are zero: its products are
// exact)
template <int D, int DP = D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int t0, int T, int tid) {
  constexpr int C4 = DP / 4;
  for (int i = tid; i < 64 * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4, t = t0 + r;
    const bool ok = t < T && c < D;
    cp_async16(dst + r * (DP + 4) + c, ok ? src + t * stride + c : src, ok);
  }
}

// whether column 8n + 2t of a fragment row is one of the head's D
template <int D>
__device__ __forceinline__ bool in_head(int n, int t) {
  return D % 8 == 0 || 8 * n + 2 * t < D;
}

// per key of a tile: valid, padded (the -1e9 fill) or past T
__device__ __forceinline__ void stage_key_flags(unsigned char* dst,
                                                const unsigned char* pad, int k0,
                                                int T, int tid) {
  if (tid < BK) {
    const int key = k0 + tid;
    dst[tid] = key >= T ? KEY_OUT
                        : (pad != nullptr && pad[key] != 0 ? KEY_PADDED : KEY_VALID);
  }
}

// wait for the tile of this iteration, keeping the next one in flight
__device__ __forceinline__ void wait_tile(bool next_in_flight) {
  if (next_in_flight)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();
}
// --------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_bytes() {  // q tile; 2 x (k, v) tiles; 2 x key flags
  return sizeof(float) * (size_t)(BQ + 4 * BK) * (padded(D) + 4) + 2 * BK;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {  // k, v tiles; 2 x (q, dO) tiles; 2 x (L, Delta)
  return sizeof(float) * ((size_t)(2 * BK + 4 * BQ) * (padded(D) + 4) + 4 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {  // 2 x (dS^T, k) tiles
  return sizeof(float) * (size_t)2 * BK * ((BQ + 4) + (padded(D) + 4));
}

// The -1e9 fill, then the online softmax and the dropout on one 16 x 64 tile
// of S in the accumulators (element e of tile j is row g + 8 (e >> 1), key
// 8j + 2t + (e & 1)): leaves P~ = p * keep / (1 - p_drop), unnormalised, in
// s, updates the rows' running max m and sum l, and returns in alpha the
// factor that rescales their earlier output.
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], const unsigned char* fl,
                                             int t, unsigned k0, const unsigned (&qrow)[2],
                                             unsigned stream, unsigned thresh,
                                             float drop_scale, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned char f = fl[8 * j + 2 * t + (e & 1)];
      s[j][e] = f == KEY_OUT ? -INFINITY : (f == KEY_PADDED ? FILL : s[j][e]);
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // key k0 < T is valid, so the new max is finite
    const float m_new = fmaxf(m[i], mx[i]);
    alpha[i] = expf(m[i] - m_new);  // 0 on the first tile
    m[i] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = expf(s[j][e] - m[i]);
      rs[i] += p;  // the softmax sum runs over the un-dropped probabilities
      const unsigned key = k0 + 8 * j + 2 * t + (e & 1);
      const bool drop = thresh != 0u && dropout_bits(stream, qrow[i] + key) < thresh;
      s[j][e] = drop ? 0.f : p * drop_scale;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l[i] = l[i] * alpha[i] + rs[i];
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, int ld,
                const unsigned char* __restrict__ key_pad,
                float* __restrict__ out, float* __restrict__ lse, int T, int H,
                unsigned seed, unsigned bh0, unsigned thresh, float drop_scale) {
  constexpr int DP = padded(D);
  constexpr int SS = DP + 4;
  constexpr int KD = DP / 8;  // 8-wide slabs of d: the k-steps of S, the n-tiles of out
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // BQ x SS
  float* kbuf = qs + BQ * SS;        // 2 x BK x SS
  float* vbuf = kbuf + 2 * BK * SS;  // 2 x BK x SS
  unsigned char* flags = reinterpret_cast<unsigned char*>(vbuf + 2 * BK * SS);

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16;  // the warp's rows of the tile
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int E = H * D;
  const long long row = ld;
  const long long head = (long long)b * T * row + (long long)h * D;
  const float* kg = k + head;
  const float* vg = v + head;
  const unsigned char* pad = key_pad ? key_pad + (long long)b * T : nullptr;
  const unsigned stream = thresh ? dropout_stream(seed, bh0 + (unsigned)bh) : 0u;
  const int n_tiles = (T + BK - 1) / BK;

  stage_rows<D, DP>(qs, q + head, row, q0, T, tid);
  cp_async_commit();
  stage_rows<D, DP>(kbuf, kg, row, 0, T, tid);
  stage_rows<D, DP>(vbuf, vg, row, 0, T, tid);
  stage_key_flags(flags, pad, 0, T, tid);
  cp_async_commit();
  wait_tile(true);  // the q tile; the first key tile stays in flight

  // the warp's 16 query rows, split once and kept in registers up to d 64;
  // at d 96 they would take 96 of the 255 registers beside the 48 of the
  // output, so they are split again from shared memory for each key tile
  constexpr bool QREG = KD <= 8;
  FragA qf[QREG ? KD : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) qf[kd] = load_a(qs, SS, r0, 8 * kd, g, t);
  }
  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // dropout index of (row, key 0) for the thread's rows g and g + 8
  const unsigned qrow[2] = {(unsigned)(q0 + r0 + g) * (unsigned)T,
                            (unsigned)(q0 + r0 + g + 8) * (unsigned)T};

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    const bool more = it + 1 < n_tiles;
    if (more) {
      const int k1 = (it + 1) * BK;
      stage_rows<D, DP>(kbuf + (cur ^ 1) * BK * SS, kg, row, k1, T, tid);
      stage_rows<D, DP>(vbuf + (cur ^ 1) * BK * SS, vg, row, k1, T, tid);
      stage_key_flags(flags + (cur ^ 1) * BK, pad, k1, T, tid);
      cp_async_commit();
    }
    wait_tile(more);
    const float* ks = kbuf + cur * BK * SS;
    const float* vs = vbuf + cur * BK * SS;
    const unsigned char* fl = flags + cur * BK;
    const unsigned k0 = (unsigned)it * BK;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      FragA qa;
      if constexpr (QREG)
        qa = qf[kd];
      else
        qa = load_a(qs, SS, r0, 8 * kd, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma3(s[j], qa, load_bt(ks, SS, 8 * j, 8 * kd, g, t));
    }

    float alpha[2];
    softmax_tile(s, fl, t, k0, qrow, stream, thresh, drop_scale, m, l, alpha);
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // out += P~ v: key slab j of P~ is accumulator tile j
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const FragA pa = acc_as_a(s[j]);
#pragma unroll
      for (int n = 0; n < KD; ++n) mma3(o[n], pa, load_b_perm(vs, SS, 8 * j, 8 * n, g, t));
    }
    __syncthreads();  // the next iteration refills this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = q0 + r0 + g + 8 * i;
    if (tq < T) {
      const float inv = 1.f / l[i];
      float* dst = out + ((long long)b * T + tq) * E + h * D + 2 * t;
#pragma unroll
      for (int n = 0; n < KD; ++n)
        if (in_head<D>(n, t))
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      if (lse != nullptr && t == 0) lse[(long long)bh * T + tq] = m[i] + logf(l[i]);
    }
  }
}

// Delta[b, h, t] = sum_c dO[b, t, h*D + c] * out[b, t, h*D + c] in fp32; one
// block per (b, t), one warp per head.
template <typename X>
__global__ void attn_bwd_delta_kernel(const X* __restrict__ out,
                                      const X* __restrict__ dout,
                                      float* __restrict__ delta, int T, int H,
                                      int D) {
  const int bt = blockIdx.x;
  const int b = bt / T, t = bt % T;
  const long long E = (long long)H * D;
  const X* o = out + bt * E;
  const X* g = dout + bt * E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int h = warp; h < H; h += nw) {
    float acc = 0.f;
    for (int c = lane; c < D; c += 32)
      acc = fmaf(to_f32(o[h * D + c]), to_f32(g[h * D + c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[((long long)b * H + h) * T + t] = acc;
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

// L and Delta of query rows t0 .. t0 + 63 (zeros past T)
__device__ __forceinline__ void stage_row_stats(float* rl, float* rd, const float* lse,
                                                const float* delta, int t0, int T,
                                                int tid) {
  if (tid < BQ) {
    const int tq = t0 + tid;
    rl[tid] = tq < T ? lse[tq] : 0.f;
    rd[tid] = tq < T ? delta[tq] : 0.f;
  }
}

// dK, dV of one tile of 64 keys; CH queries per pass
template <int D, int CH>
__global__ void __launch_bounds__(NT, 2)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, int ld,
                     const unsigned char* __restrict__ key_pad,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dst, int ld_grad,
                     int T, int H, unsigned seed, unsigned bh0, unsigned thresh, float drop_scale,
                     float inv_t) {
  constexpr int DP = padded(D);
  constexpr int SS = DP + 4;
  constexpr int KD = DP / 8;
  constexpr int NJ = CH / 8;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // BK x SS
  float* vs = ks + BK * SS;            // BK x SS
  float* qbuf = vs + BK * SS;          // 2 x BQ x SS
  float* dobuf = qbuf + 2 * BQ * SS;   // 2 x BQ x SS
  float* rowl = dobuf + 2 * BQ * SS;   // 2 x BQ: L
  float* rowd = rowl + 2 * BQ;         // 2 x BQ: Delta

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16;  // the warp's keys of the tile
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int E = H * D;
  const long long row = ld;
  const long long head = (long long)b * T * row + (long long)h * D;
  const float* qg = q + head;
  const float* dog = dout + (long long)b * T * E + h * D;
  const float* lg = lse + (long long)bh * T;
  const float* dg = delta + (long long)bh * T;
  const int TQ = (T + BQ - 1) / BQ * BQ;  // the scratch's row length
  float* dsT = dst + (long long)bh * TQ * TQ;
  const unsigned char* pad = key_pad ? key_pad + (long long)b * T : nullptr;
  const unsigned stream = thresh ? dropout_stream(seed, bh0 + (unsigned)bh) : 0u;
  const int n_tiles = (T + BQ - 1) / BQ;

  stage_rows<D, DP>(ks, k + head, row, k0, T, tid);
  stage_rows<D, DP>(vs, v + head, row, k0, T, tid);
  stage_rows<D, DP>(qbuf, qg, row, 0, T, tid);
  stage_rows<D, DP>(dobuf, dog, E, 0, T, tid);
  stage_row_stats(rowl, rowd, lg, dg, 0, T, tid);
  cp_async_commit();

  // the thread's keys: rows g and g + 8 of the warp's 16
  int key[2];
  bool kin[2], kpad[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + r0 + g + 8 * i;
    kin[i] = key[i] < T;
    kpad[i] = kin[i] && pad != nullptr && pad[key[i]] != 0;
  }
  float dkr[KD][4], dvr[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dkr[n][e] = 0.f;
      dvr[n][e] = 0.f;
    }

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    const bool more = it + 1 < n_tiles;
    if (more) {
      const int q1 = (it + 1) * BQ, nxt = cur ^ 1;
      stage_rows<D, DP>(qbuf + nxt * BQ * SS, qg, row, q1, T, tid);
      stage_rows<D, DP>(dobuf + nxt * BQ * SS, dog, E, q1, T, tid);
      stage_row_stats(rowl + nxt * BQ, rowd + nxt * BQ, lg, dg, q1, T, tid);
      cp_async_commit();
    }
    wait_tile(more);
    const float* qs = qbuf + cur * BQ * SS;
    const float* dos = dobuf + cur * BQ * SS;
    const float* L = rowl + cur * BQ;
    const float* Dl = rowd + cur * BQ;
    const int q0 = it * BQ;

#pragma unroll 1
    for (int c = 0; c < BQ; c += CH) {
      // S^T and (dO v^T)^T for the warp's 16 keys and CH queries
      float st[NJ][4], dpt[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0.f;
          dpt[j][e] = 0.f;
        }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const FragA kf = load_a(ks, SS, r0, 8 * kd, g, t);
        const FragA vf = load_a(vs, SS, r0, 8 * kd, g, t);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma3(st[j], kf, load_bt(qs, SS, c + 8 * j, 8 * kd, g, t));
          mma3(dpt[j], vf, load_bt(dos, SS, c + 8 * j, 8 * kd, g, t));
        }
      }
      // element e of tile j: key row g + 8 (e >> 1), query c + 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int ql = c + 8 * j + 2 * t + (e & 1);
          const int qi = q0 + ql;
          const bool drop = thresh != 0u &&
                            dropout_bits(stream, (unsigned)qi * (unsigned)T +
                                                     (unsigned)key[i]) < thresh;
          const ElemGrad gr = elem_grad(st[j][e], dpt[j][e], L[ql], Dl[ql],
                                        kin[i] && qi < T, kpad[i], drop, drop_scale,
                                        inv_t);
          st[j][e] = gr.pd;
          dpt[j][e] = gr.ds;
        }
      // dS^T to the scratch, rows = keys, for dQ = dS k (attn_bwd_dq_kernel)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(dsT + (long long)(key[i]) * TQ + q0 + c + 8 * j + 2 * t) =
              make_float2(dpt[j][2 * i], dpt[j][2 * i + 1]);
      // dV += P~^T dO, dK += dS^T q over these queries
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const FragA pa = acc_as_a(st[j]);
        const FragA da = acc_as_a(dpt[j]);
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          mma3(dvr[n], pa, load_b_perm(dos, SS, c + 8 * j, 8 * n, g, t));
          mma3(dkr[n], da, load_b_perm(qs, SS, c + 8 * j, 8 * n, g, t));
        }
      }
    }
    __syncthreads();  // the next iteration refills this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kin[i]) {
      const long long off = ((long long)b * T + key[i]) * ld_grad + h * D + 2 * t;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        if (!in_head<D>(n, t)) continue;
        *reinterpret_cast<float2*>(dk + off + 8 * n) =
            make_float2(dkr[n][2 * i], dkr[n][2 * i + 1]);
        *reinterpret_cast<float2*>(dv + off + 8 * n) =
            make_float2(dvr[n][2 * i], dvr[n][2 * i + 1]);
      }
    }
  }
}

// dQ = dS k for one tile of 64 queries, from the dS^T that the dK/dV kernel
// left in the scratch (rows = keys, TQ = T rounded up to 64 columns, zeros
// past T): a plain product, so the scores are not computed a third time.
template <int D>
__global__ void __launch_bounds__(NT, 2)
attn_bwd_dq_kernel(const float* __restrict__ k, int ld, const float* __restrict__ dst,
                   float* __restrict__ dq, int ld_grad, int T, int H) {
  constexpr int DP = padded(D);
  constexpr int SS = DP + 4;
  constexpr int PS = BQ + 4;  // dS^T tile row stride
  constexpr int KD = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* sbuf = smem;                 // 2 x BK x PS: dS^T rows of the key tile
  float* kbuf = sbuf + 2 * BK * PS;   // 2 x BK x SS

  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16;  // the warp's queries of the tile
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int TQ = (T + BQ - 1) / BQ * BQ;
  const float* kg = k + (long long)b * T * ld + (long long)h * D;
  const float* sg = dst + (long long)bh * TQ * TQ + q0;
  const int n_tiles = (T + BK - 1) / BK;

  stage_rows<BQ>(sbuf, sg, TQ, 0, T, tid);
  stage_rows<D, DP>(kbuf, kg, ld, 0, T, tid);
  cp_async_commit();

  float dqr[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqr[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    const bool more = it + 1 < n_tiles;
    if (more) {
      const int k1 = (it + 1) * BK, nxt = cur ^ 1;
      stage_rows<BQ>(sbuf + nxt * BK * PS, sg, TQ, k1, T, tid);
      stage_rows<D, DP>(kbuf + nxt * BK * SS, kg, ld, k1, T, tid);
      cp_async_commit();
    }
    wait_tile(more);
    const float* ss = sbuf + cur * BK * PS;
    const float* ks = kbuf + cur * BK * SS;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // A[query][key] = dS^T[key][query], keys in the order of load_b_perm
      const float* p = ss + (8 * j + 2 * t) * PS + r0 + g;
      const FragA da = frag_a(p[0], p[8], p[PS], p[PS + 8]);
#pragma unroll
      for (int n = 0; n < KD; ++n) mma3(dqr[n], da, load_b_perm(ks, SS, 8 * j, 8 * n, g, t));
    }
    __syncthreads();  // the next iteration refills this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = q0 + r0 + g + 8 * i;
    if (tq < T) {
      float* drow = dq + ((long long)b * T + tq) * ld_grad + h * D + 2 * t;
#pragma unroll
      for (int n = 0; n < KD; ++n)
        if (in_head<D>(n, t))
          *reinterpret_cast<float2*>(drow + 8 * n) =
              make_float2(dqr[n][2 * i], dqr[n][2 * i + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Row strides and pointers of one attention call: q, k, v rows at stride ld;
// dq, dk, dv rows at stride ld_grad (backward only). X is float.
template <typename X>
struct Operands {
  const X *q, *k, *v;
  int ld;
  X *dq, *dk, *dv;
  int ld_grad;
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// What the kernels take: q, k, v rows start on 16 bytes (cp.async), the
// gradient rows on two elements (float2 stores).
template <typename X>
bool operands_ok(const Operands<X>& a, bool backward) {
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
      (a.ld * sizeof(X)) % 16 != 0)
    return false;
  if (!backward) return true;
  const uintptr_t grads = reinterpret_cast<uintptr_t>(a.dq) |
                          reinterpret_cast<uintptr_t>(a.dk) |
                          reinterpret_cast<uintptr_t>(a.dv);
  return (grads & (2 * sizeof(X) - 1)) == 0 && a.ld_grad % 2 == 0;
}

template <int D>
int launch_fwd(const Operands<float>& a, const unsigned char* key_pad, float* out,
               float* lse, int B, int T, int H, unsigned seed, unsigned bh0, unsigned thresh,
               float drop_scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(attn_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  attn_fwd_kernel<D><<<grid, NT, smem, stream>>>(a.q, a.k, a.v, a.ld, key_pad, out,
                                                 lse, T, H, seed, bh0, thresh, drop_scale);
  return cudaGetLastError();
}
template <int D>
int launch_bwd(const Operands<float>& a, const unsigned char* key_pad, const float* out,
               const float* dout, const float* lse, float* delta, int B, int T,
               int H, unsigned seed, unsigned bh0, unsigned thresh, float drop_scale,
               cudaStream_t stream) {
  // queries per pass of the dK/dV kernel: 16 at d 96, whose dK and dV
  // accumulators take 96 registers
  constexpr int CH = D > 64 ? 16 : 32;
  const float inv_t = 1.f / (float)T;
  // the scratch: Delta (B, H, T), then dS^T (B*H, TQ, TQ) on a 16-byte boundary
  float* dst = delta + ((long long)B * H * T + 3) / 4 * 4;
  attn_bwd_delta_kernel<float><<<B * T, 128, 0, stream>>>(out, dout, delta, T, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkdv_smem_bytes<D>();
  err = allow_smem(attn_bwd_dkdv_kernel<D, CH>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((T + BK - 1) / BK, B * H);
  attn_bwd_dkdv_kernel<D, CH><<<grid_kv, NT, smem_kv, stream>>>(
      a.q, a.k, a.v, a.ld, key_pad, dout, lse, delta, a.dk, a.dv, dst, a.ld_grad, T,
      H, seed, bh0, thresh, drop_scale, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = dq_smem_bytes<D>();
  err = allow_smem(attn_bwd_dq_kernel<D>, smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((T + BQ - 1) / BQ, B * H);
  attn_bwd_dq_kernel<D><<<grid_q, NT, smem_q, stream>>>(a.k, a.ld, dst, a.dq,
                                                         a.ld_grad, T, H);
  return cudaGetLastError();
}
// One forward call in element type X over the head widths X is built for.
template <typename X>
int attention_fwd(const void* q, const void* k, const void* v, int ld, const void* key_pad,
                  void* out, void* lse, int B, int T, int H, int D, unsigned seed, unsigned bh0,
                  unsigned thresh, float drop_scale, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  const Operands<X> a{static_cast<const X*>(q), static_cast<const X*>(k),
                      static_cast<const X*>(v), ld, nullptr, nullptr, nullptr, 0};
  if (!operands_ok(a, false) || !aligned16(out)) return cudaErrorMisalignedAddress;
  const unsigned char* kp = static_cast<const unsigned char*>(key_pad);
  X* o = static_cast<X*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch_fwd<8>(a, kp, o, l, B, T, H, seed, bh0, thresh, drop_scale, s);
    case 12: return launch_fwd<12>(a, kp, o, l, B, T, H, seed, bh0, thresh, drop_scale, s);
    case 16: return launch_fwd<16>(a, kp, o, l, B, T, H, seed, bh0, thresh, drop_scale, s);
    case 32: return launch_fwd<32>(a, kp, o, l, B, T, H, seed, bh0, thresh, drop_scale, s);
    case 64: return launch_fwd<64>(a, kp, o, l, B, T, H, seed, bh0, thresh, drop_scale, s);
    case 96: return launch_fwd<96>(a, kp, o, l, B, T, H, seed, bh0, thresh, drop_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename X>
int attention_bwd(const void* q, const void* k, const void* v, int ld, const void* key_pad,
                  const void* out, const void* dout, const void* lse, void* delta,
                  void* dq, void* dk, void* dv, int ld_grad, int B, int T, int H, int D,
                  unsigned seed, unsigned bh0, unsigned thresh, float drop_scale, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  const Operands<X> a{static_cast<const X*>(q), static_cast<const X*>(k),
                      static_cast<const X*>(v), ld, static_cast<X*>(dq),
                      static_cast<X*>(dk), static_cast<X*>(dv), ld_grad};
  if (!operands_ok(a, true) || !aligned16(dout) || !aligned16(delta))
    return cudaErrorMisalignedAddress;
  const unsigned char* kp = static_cast<const unsigned char*>(key_pad);
  const X* o = static_cast<const X*>(out);
  const X* g = static_cast<const X*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch_bwd<8>(a, kp, o, g, l, dl, B, T, H, seed, bh0, thresh, drop_scale, s);
    case 12: return launch_bwd<12>(a, kp, o, g, l, dl, B, T, H, seed, bh0, thresh, drop_scale, s);
    case 16: return launch_bwd<16>(a, kp, o, g, l, dl, B, T, H, seed, bh0, thresh, drop_scale, s);
    case 32: return launch_bwd<32>(a, kp, o, g, l, dl, B, T, H, seed, bh0, thresh, drop_scale, s);
    case 64: return launch_bwd<64>(a, kp, o, g, l, dl, B, T, H, seed, bh0, thresh, drop_scale, s);
    case 96: return launch_bwd<96>(a, kp, o, g, l, dl, B, T, H, seed, bh0, thresh, drop_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out (B, T, H*D); lse (B, H, T) or null (no gradient needed). q, k, v rows
// of width >= H*D at stride ld, 16-byte aligned. fp32; D in 8, 12, 16, 32, 64, 96.
// The dropout key of head h of row b is bh0 + b*H + h (dropout_bits.cuh).
extern "C" int tsx_attention_fwd(const void* q, const void* k, const void* v,
                                 int ld, const void* key_pad, void* out,
                                 void* lse, int B, int T, int H, int D,
                                 unsigned seed, unsigned bh0, unsigned thresh, float drop_scale,
                                 void* stream) {
  return attention_fwd<float>(q, k, v, ld, key_pad, out, lse, B, T, H, D, seed, bh0, thresh,
                              drop_scale, stream);
}

// dq, dk, dv (rows at stride ld_grad) from q, k, v, out, dout (B, T, H*D) and
// the forward's lse. delta is scratch of ceil4(B*H*T) + B*H*TQ*TQ floats,
// TQ = T rounded up to 64, 16-byte aligned: Delta, then dS^T.
extern "C" int tsx_attention_bwd(const void* q, const void* k, const void* v,
                                 int ld, const void* key_pad, const void* out,
                                 const void* dout, const void* lse, void* delta,
                                 void* dq, void* dk, void* dv, int ld_grad, int B,
                                 int T, int H, int D, unsigned seed, unsigned bh0,
                                 unsigned thresh, float drop_scale, void* stream) {
  return attention_bwd<float>(q, k, v, ld, key_pad, out, dout, lse, delta, dq, dk, dv,
                              ld_grad, B, T, H, D, seed, bh0, thresh, drop_scale, stream);
}
