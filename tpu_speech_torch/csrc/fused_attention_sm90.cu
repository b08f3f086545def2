// Self-attention on bf16 operands, forward and backward, for Hopper: wgmma
// products, TMA tile loads, in-kernel attention dropout, no T x T scratch.
//
// Replaces the Pallas TPU kernels of tpu_speech/ops/fused_attention.py on
// bf16 activations:
//   K2, fused_qkv_self_attention (q, k, v the thirds of a merged (B, T, 3E)
//   plane):
//     forward  _qkv_fwd_kernel:258 (pallas_call at line 384, _fused_qkv_attn_fwd:380)
//     backward _qkv_bwd_kernel:288 (pallas_call at line 401, _fused_qkv_attn_bwd:396)
//   K3, fused_self_attention (q, k, v separate (B, T, H, D) arrays):
//     forward  _fwd_kernel:95 (pallas_call at line 222, _fused_attn_fwd:218)
//     backward _bwd_kernel:131 (pallas_call at line 239, _fused_attn_bwd:234)
// One set of kernels serves both: q, k and v are three (B, T, H*D) arrays
// whose rows lie ld elements apart (ld = 3E on the merged plane, whose k and
// v start E and 2E elements after q; ld = H*D for (B, T, H, D) arrays), and
// head h is columns h*D .. h*D + D - 1 of each. The entry points are
// tsx_attention_fwd_bf16 and tsx_attention_bwd_bf16; the fp32 kernels stay
// in fused_attention.cu.
//
// Semantics, those of fused_attention.cu on bf16 (and of the Pallas
// kernels' casts): per (b, h), q already scaled,
//     S = q k^T in fp32, padded keys filled with the finite -1e9,
//     P = softmax(S) in fp32, P~ = P * keep / (1 - p_drop) rounded to bf16,
//     out = P~ v (bf16), L = rowwise logsumexp (fp32).
// keep is the counter-hash of dropout_bits.cuh, bit for bit. A fully padded
// row's L rounds to the fill (-1e9 + log T == -1e9 in fp32), and the
// backward reads L == -1e9 as a uniform row, P = 1/T. The backward:
//     Delta = rowsum(dO * out) from the bf16 out (fp32),
//     P recomputed from L, keep regenerated,
//     dP = dO v^T,  dS = P (dP keep / (1 - p_drop) - Delta), 0 at padded keys,
//     dS rounded to bf16; dQ = dS k, dK = dS^T q, dV = P~^T dO (bf16 out).
//
// What bounds it (chip_smoke.py::attention_bound): the forward does 4 B H T^2
// D FLOP and the backward 10 B H T^2 D; the operands are bf16 (q, k, v, out
// in and out, plus dO, L and three gradients). At the pretrain path's K2
// shape (24, 392, 3 x 512), H 8, D 64: forward 7.6e9 FLOP (7.6 us at 989
// TFLOP/s) against 38.5 MB (11.5 us at 3.35 TB/s), backward 1.9e10 FLOP
// (19 us) against 77 MB (23 us): both bound by bytes. At K3's (14, 604, 8,
// 64): 10.6 us of FLOP against 10.3 us of bytes forward, 26 us against 21
// us backward.
//
// What the hash costs: every score element needs its dropout bits, two
// fmix32 (about 13 integer operations), besides an exp and the mask: 29.5 M
// elements at the K2 shape, 0.4 G integer operations, 13-26 us at the SMs'
// integer rate, more than the forward's products at the tensor cores' peak.
// So the CUDA cores, not the tensor cores, set the floor. The backward
// regenerates the bits twice (see the dQ kernel below).
//
// Design, and what each choice does about those limits:
// - wgmma.mma_async m64nNk16, bf16 operands, fp32 accumulators, one
//   warpgroup (128 threads) per 64-row tile. S = q k^T (and dP = dO v^T)
//   read both operands from shared memory, K-major. P~ v takes P~ as the A
//   operand from registers: the m64 accumulator's per-warp fragment of two
//   adjacent 8-column slabs, packed in bf16 pairs, is the A fragment of the
//   16-wide k step over those columns. V is the B operand in its natural
//   (keys x D) layout, with wgmma's transpose bit (MN-major). The backward's
//   dV += P~^T dO and dK += dS^T q take P~^T and dS^T the same way, from
//   S^T and dP^T computed with the keys as rows; dQ += dS k likewise.
// - TMA (cp.async.bulk.tensor + mbarrier) loads every tile: a 3-D tensor
//   map (columns, T, B) per operand with the row stride ld, boxes of D
//   columns x 64 rows of one batch item, so rows past T arrive as zeros and
//   a tile never reads item b + 1's rows (which a 2-D (B*T, cols) view of
//   the merged plane would). The q, k, v maps start at the three pointers,
//   so head h is column h*D of each. Rows of 2D bytes use the matching
//   swizzle (D 64: 128-byte, 32: 64-byte, 16: 32-byte), which the wgmma
//   descriptors name; tiles sit on 1024 bytes. D 96 (wav2vec 2.0 BASE) has
//   192-byte rows, past the widest swizzle: its tiles are three 32-column
//   parts, three boxes a tile, and each product over d (S = q k^T: 3 x 2
//   k16 steps) or into d (P~ v: three n32 wgmma a k step) runs part by
//   part (Tile, issue_scores, issue_rows). The dK/dV kernel takes L
//   and Delta as 64-float boxes of a 1-D map over row statistics that the dQ
//   kernel lays out in rows of T rounded up to 64 (boxes of the (B, H, T)
//   arrays themselves start on any 4 bytes, and such loads fault). The maps
//   are encoded inside the C entry points (cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, so the link needs no -lcuda) and passed as
//   __grid_constant__ parameters: no Python work and no launch is added to
//   a call.
// - A ring of two K/V (or q/dO) stages; thread 0 refills a stage once the
//   warpgroup is done with it, so the next tile's load runs during this
//   tile's work. No producer warp: a block is one warpgroup, small enough
//   (40-50 KB of shared memory, 128 threads) for 2-4 blocks on an SM.
// - The CUDA-core work overlaps the tensor cores two ways. Inside a
//   warpgroup a software pipeline issues the next tile's S (and dP) wgmma
//   before this tile's P~ v (or dQ, dK, dV) wgmma and runs the next tile's
//   mask, softmax and hash while the latter is in flight (the last tile is
//   peeled, so every wgmma is issued unconditionally: with a conditional
//   issue ptxas serialized the wgmma, C7514). Across warpgroups the 2-4
//   resident blocks of an SM interleave on its tensor cores.
// - 64-row tiles: T = 392 pads to 448 (12 % waste) where 128-row tiles pad
//   to 512 (23 %); the path's lengths are 196-604. The kernels are
//   templated on dropout: with p = 0 no hash is computed. Key tiles run to
//   ceil(T / 64), never wholly past T.
// - Backward, deterministic, no atomics, two launches, no T x T scratch:
//   one block per (b*H + h, 64 queries) computes Delta for its rows (writing
//   it for the next launch) and dQ, recomputing S and dP per key tile; then
//   one block per (b*H + h, 64 keys) computes dK and dV over the query
//   tiles. This does 14 instead of 10 B H T^2 D FLOP and hashes twice, where
//   the bf16 dS^T scratch of the mma.sync kernels it replaces was written
//   and read back, 2 B H T^2 bytes each way (154 MB in all at the K2 shape,
//   46 us at 3.35 TB/s, twice the backward's bound). The only scratch left
//   is L and Delta, 8 B H T bytes with T rounded up to 64 (688 KB at the K2
//   shape). Every sum runs in a fixed order: equal bits run to run.

#include <cuda.h>  // CUtensorMap and its enums only: nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "dropout_bits.cuh"
#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;     // rows of a tile (queries or keys); the width of S
constexpr int NT = 128;      // one warpgroup
constexpr int STAGES = 2;    // ring of K/V (forward, dQ) or q/dO/L/Delta (dK/dV) tiles
constexpr float FILL = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

// A bf16 tile of 64 rows x D, stored as NP parts of PW columns each: rows
// of 2 PW bytes, swizzled over 2 PW bytes, one part after the other. D 16,
// 32 and 64 are one part. A 96-wide row is 192 bytes, more than the widest
// swizzle span (128 bytes), so D 96 is three 32-column parts: each a tile
// as D 32's, loaded by its own TMA box, and every product over d or into d
// runs part by part (see issue_scores and issue_rows).
template <int D>
struct Tile {
  static constexpr int PW = D == 96 ? 32 : D;  // columns a part
  static constexpr int NP = D / PW;            // parts
  static constexpr int SW = 2 * PW;            // bytes a part's row = the swizzle span
  static constexpr int PART = TILE * SW;       // bytes a part, a multiple of 1024
  static constexpr int BYTES = NP * PART;
  static constexpr int KSTEPS = PW / 16;       // k steps of a product over a part's d
  static constexpr int ACC = D / 2;            // accumulators of a 64 x D product
};

// ---- TMA (the mbarrier and load helpers are in sm90.cuh) --------------------
// one 64-row tile of a map at (col, row, b) into dst, a box a part
template <int D>
__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int col, int row, int b) {
  using TL = Tile<D>;
#pragma unroll
  for (int p = 0; p < TL::NP; ++p)
    tma_load_3d(static_cast<unsigned char*>(dst) + p * TL::PART, map, bar, col + p * TL::PW,
                row, b);
}

// two 64-row tiles of two maps at (col, row, b) into dst_a, dst_b
template <int D>
__device__ __forceinline__ void load_tile_pair(void* dst_a, const CUtensorMap* map_a,
                                               void* dst_b, const CUtensorMap* map_b,
                                               uint64_t* bar, int col, int row, int b,
                                               unsigned extra_bytes = 0) {
  mbar_expect_tx(bar, 2 * Tile<D>::BYTES + extra_bytes);
  load_tile<D>(dst_a, map_a, bar, col, row, b);
  load_tile<D>(dst_b, map_b, bar, col, row, b);
}
// --------------------------------------------------------------------------

// ---- wgmma ----------------------------------------------------------------
// Shared-memory matrix descriptor of a swizzled tile of 64 rows x D (rows of
// SW = 2D bytes, 1024-byte aligned): the stride byte offset is 8 rows; the
// leading byte offset is unused (a k step of 16 elements lies inside one
// swizzled row, and N <= 64 elements inside one swizzle atom).
template <int SW>
__device__ __forceinline__ uint64_t make_desc(const void* tile) {
  constexpr uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(tile) & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(8 * SW / 16) << 32) | (layout << 62);
}

// d = a b (+ d if accumulate): a (64 x 16) and b (16 x 64) from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += a b: a (64 x 16) from registers (4 bf16 pairs a thread), b (16 x N)
// from shared memory, MN-major (N contiguous: wgmma's transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// s = a b^T over d: the 64 x 64 product of two 64 x D tiles (descriptors of
// their first parts; a part starts PART bytes, PART / 16 descriptor units,
// after the one before)
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint64_t a, uint64_t b) {
  using TL = Tile<D>;
#pragma unroll
  for (int p = 0; p < TL::NP; ++p)
#pragma unroll
    for (int kk = 0; kk < TL::KSTEPS; ++kk) {
      const uint64_t off = p * (TL::PART / 16) + 2 * kk;
      wgmma_ss64(s, a + off, b + off, p > 0 || kk > 0);
    }
}

// acc += p x: p the 64 x 64 register operand (4 k steps of 16 columns), x a
// 64 x D tile read row by row (16 of its rows a k step); part p of x gives
// the accumulators of its PW columns, acc[p * PW / 2 ..], whose layout is
// that of a 64 x PW product
template <int D>
__device__ __forceinline__ void issue_rows(float (&acc)[D / 2], const uint32_t (&p)[4][4],
                                           uint64_t x) {
  using TL = Tile<D>;
#pragma unroll
  for (int part = 0; part < TL::NP; ++part) {
    float(&a)[TL::PW / 2] = *reinterpret_cast<float(*)[TL::PW / 2]>(acc + part * (TL::PW / 2));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      wgmma_rs<TL::PW>(a, p[jj], x + part * (TL::PART / 16) + jj * (16 * TL::SW / 16));
  }
}

// Accumulator layout of a 64 x N product (warp w, lane = 4g + t): element i
// is row 16w + g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2t + (i & 1), the
// m16n8 layout of each 8-column slab. Two adjacent slabs, rounded to bf16
// pairs, are the A fragment of the k step over their 16 columns.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[jj][q] = pack_bf16(s[8 * jj + 2 * q], s[8 * jj + 2 * q + 1]);
}
// earlier output rows times the softmax's rescale factors (rows g, g + 8)
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}
// --------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bit j: key k0 + j of the batch item's mask row is padded (0 past T); the
// same in every warp
__device__ __forceinline__ uint64_t padded_keys(const unsigned char* pad, int k0, int T,
                                                int lane) {
  if (pad == nullptr) return 0;
  const int a = k0 + lane, c = a + 32;
  const unsigned lo = __ballot_sync(0xffffffffu, a < T && pad[a] != 0);
  const unsigned hi = __ballot_sync(0xffffffffu, c < T && pad[c] != 0);
  return (uint64_t)hi << 32 | lo;
}

// The -1e9 fill (bit 8j + c of pb = pad bits >> 2t), keys past T (column >=
// lim) out, then the online softmax and the dropout on a 64 x 64 tile of S:
// leaves P~ = p * keep * drop_scale, unnormalised, in s; updates the rows'
// running max m and the thread's share l of their sum (reduced over the
// row's four threads at the end), and gives in alpha the factor that
// rescales their earlier output. hb[r]: (query * T + k0 + 2t) * the index
// multiplier of the thread's row r.
template <bool DROP>
__device__ __forceinline__ void softmax_tile(float (&s)[32], uint64_t pad_bits, int lim, int t,
                                             const unsigned (&hb)[2], unsigned stream,
                                             unsigned thresh, float drop_scale, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
  if (pad_bits != 0 || lim < TILE) {
    const uint64_t pb = pad_bits >> (2 * t);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = i >> 2, c = i & 1;
      const bool padded = (pb >> (8 * j + c)) & 1;
      s[i] = 8 * j + 2 * t + c >= lim ? -INFINITY : (padded ? FILL : s[i]);
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);  // finite: key k0 < T is in every tile
    alpha[r] = ex2((m[r] - m_new) * LOG2E);  // 0 on the first tile
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    // s - m first: the row's largest score gives exactly 1, as it does in
    // a fully padded row, where every score is the -1e9 fill
    const float p = ex2((s[i] - m[r]) * LOG2E);
    rs[r] += p;  // the softmax sum runs over the un-dropped probabilities
    if (DROP) {
      const unsigned bits =
          fmix32(stream ^ (hb[r] + (unsigned)(8 * (i >> 2) + (i & 1)) * DROPOUT_IDX_MUL));
      s[i] = bits >= thresh ? p * drop_scale : 0.f;
    } else {
      s[i] = p * drop_scale;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

template <int D>
constexpr size_t fwd_smem_bytes() {  // alignment slack; q; STAGES x (k, v); barriers
  return 1024 + (size_t)(1 + 2 * STAGES) * Tile<D>::BYTES + 8 * (1 + STAGES);
}

// One block per (64 queries, b*H + h): out and (if lse) the row logsumexp.
template <int D, bool DROP>
__global__ void __launch_bounds__(NT, 3)
attn_fwd_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                     __grid_constant__ const CUtensorMap map_k,
                     __grid_constant__ const CUtensorMap map_v,
                     const unsigned char* __restrict__ key_pad, bf16* __restrict__ out,
                     float* __restrict__ lse, int T, int H, unsigned seed, unsigned bh0,
                     unsigned thresh, float drop_scale) {
  using TL = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* ks = qs + TL::BYTES;               // STAGES tiles
  unsigned char* vs = ks + STAGES * TL::BYTES;      // STAGES tiles
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + STAGES * TL::BYTES);  // q, stages

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 5) * 16;  // the warp's rows of the tile
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE, col = h * D;
  const int n_tiles = (T + TILE - 1) / TILE;
  const unsigned char* pad = key_pad ? key_pad + (long long)b * T : nullptr;
  const unsigned stream = DROP ? dropout_stream(seed, bh0 + (unsigned)bh) : 0u;

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(bar + i, 1);
    fence_mbar_init();
    mbar_expect_tx(bar, TL::BYTES);
    load_tile<D>(qs, &map_q, bar, col, q0, b);
    for (int st = 0; st < STAGES && st < n_tiles; ++st)
      load_tile_pair<D>(ks + st * TL::BYTES, &map_k, vs + st * TL::BYTES, &map_v, bar + 1 + st,
                        col, st * TILE, b);
  }
  __syncthreads();

  const uint64_t q_desc = make_desc<TL::SW>(qs);
  float s[32], o[TL::ACC];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TL::ACC; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  unsigned qrow[2];  // (query * T + 2t) * the index multiplier, rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qrow[r] = ((unsigned)(q0 + row0 + g + 8 * r) * (unsigned)T + 2u * t) * DROPOUT_IDX_MUL;

  // tile 0's scores and softmax
  uint64_t pad_bits = padded_keys(pad, 0, T, lane);
  mbar_wait(bar, 0);
  mbar_wait(bar + 1, 0);
  wg_fence();
  issue_scores<D>(s, q_desc, make_desc<TL::SW>(ks));
  wg_commit();
  wg_wait<0>();
  reg_fence(s);
  {
    const unsigned hb[2] = {qrow[0], qrow[1]};
    softmax_tile<DROP>(s, pad_bits, T, t, hb, stream, thresh, drop_scale, m, l, alpha);
  }

  // Steady state, peeled so that every wgmma is issued unconditionally: the
  // next tile's scores go first, then out += P~ v, whose wgmma runs while
  // the next tile's softmax and hash run on the CUDA cores.
  for (int it = 0; it + 1 < n_tiles; ++it) {
    const int st = it % STAGES, nx = (it + 1) % STAGES, k1 = (it + 1) * TILE;
    pad_bits = padded_keys(pad, k1, T, lane);
    uint32_t pa[4][4];  // P~ of tile it, bf16
    pack_a(pa, s);
    rescale(o, alpha);
    mbar_wait(bar + 1 + nx, ((it + 1) / STAGES) & 1);
    wg_fence();
    issue_scores<D>(s, q_desc, make_desc<TL::SW>(ks + nx * TL::BYTES));
    wg_commit();
    issue_rows<D>(o, pa, make_desc<TL::SW>(vs + st * TL::BYTES));
    wg_commit();
    wg_wait<1>();
    reg_fence(s);
    const unsigned hb[2] = {qrow[0] + (unsigned)k1 * DROPOUT_IDX_MUL,
                            qrow[1] + (unsigned)k1 * DROPOUT_IDX_MUL};
    softmax_tile<DROP>(s, pad_bits, T - k1, t, hb, stream, thresh, drop_scale, m, l, alpha);
    wg_wait<0>();
    reg_fence(o);
    __syncthreads();  // the warpgroup is done with stage st: refill it
    if (tid == 0 && it + STAGES < n_tiles)
      load_tile_pair<D>(ks + st * TL::BYTES, &map_k, vs + st * TL::BYTES, &map_v, bar + 1 + st,
                        col, (it + STAGES) * TILE, b);
  }
  {  // the last tile's P~ v
    uint32_t pa[4][4];
    pack_a(pa, s);
    rescale(o, alpha);
    wg_fence();
    issue_rows<D>(o, pa, make_desc<TL::SW>(vs + (n_tiles - 1) % STAGES * TL::BYTES));
    wg_commit();
    wg_wait<0>();
    reg_fence(o);
  }

  const int E = H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int tq = q0 + row0 + g + 8 * r;
    if (tq < T) {
      const float inv = 1.f / l[r];
      bf16* dst = out + ((long long)b * T + tq) * E + col + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      if (lse != nullptr && t == 0) lse[(long long)bh * T + tq] = m[r] + logf(l[r]);
    }
  }
}

// ---- backward -------------------------------------------------------------

// dS of a 64 x 64 tile with queries as rows (the dQ kernel): s holds S, dp
// holds dP = dO v^T; leaves dS in s. lsc[r] = L * log2(e) of row r, uni[r]:
// L == -1e9 (P uniform, 1/T); dl[r] Delta.
template <bool DROP>
__device__ __forceinline__ void ds_rows_tile(float (&s)[32], const float (&dp)[32],
                                             uint64_t pad_bits, int lim, int t,
                                             const unsigned (&hb)[2], const float (&lsc)[2],
                                             const bool (&uni)[2], const float (&dl)[2],
                                             unsigned stream, unsigned thresh,
                                             float drop_scale, float inv_t) {
  const uint64_t pb = pad_bits >> (2 * t);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int j = i >> 2, c = i & 1, r = (i >> 1) & 1;
    const bool zero = ((pb >> (8 * j + c)) & 1) || 8 * j + 2 * t + c >= lim;
    const float p = uni[r] ? inv_t : ex2(fmaf(s[i], LOG2E, -lsc[r]));
    float keep = drop_scale;
    if (DROP) {
      const unsigned bits =
          fmix32(stream ^ (hb[r] + (unsigned)(8 * j + c) * DROPOUT_IDX_MUL));
      keep = bits >= thresh ? drop_scale : 0.f;
    }
    s[i] = zero ? 0.f : p * (dp[i] * keep - dl[r]);
  }
}

// P~^T and dS^T of a 64 x 64 tile with keys as rows (the dK/dV kernel): s
// holds S^T, dp holds dP^T; leaves P~^T in s and dS^T in dp. Ls, Ds: L and
// Delta of the tile's 64 queries; kin, kpad: the thread's keys in range and
// padded; hb[r]: (q0 + 2t) * T * mul + key * mul; tmul = T * mul.
template <bool DROP>
__device__ __forceinline__ void ds_cols_tile(float (&s)[32], float (&dp)[32], const float* Ls,
                                             const float* Ds, int lim, int t,
                                             const bool (&kin)[2], const bool (&kpad)[2],
                                             const unsigned (&hb)[2], unsigned tmul,
                                             unsigned stream, unsigned thresh,
                                             float drop_scale, float inv_t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lq = *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
    const float2 dd = *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, c = e & 1, r = e >> 1;
      const float L = c ? lq.y : lq.x, Dl = c ? dd.y : dd.x;
      const bool in = kin[r] && 8 * j + 2 * t + c < lim;
      const float p = L <= FILL ? inv_t : ex2(fmaf(kpad[r] ? FILL : s[i], LOG2E, -L * LOG2E));
      float keep = drop_scale;
      if (DROP) {
        const unsigned bits = fmix32(stream ^ (hb[r] + (unsigned)(8 * j + c) * tmul));
        keep = bits >= thresh ? drop_scale : 0.f;
      }
      const float ds = kpad[r] ? 0.f : p * (dp[i] * keep - Dl);
      s[i] = in ? p * keep : 0.f;
      dp[i] = in ? ds : 0.f;
    }
  }
}

__device__ __forceinline__ float dot8(const uint4& a, const uint4& b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

template <int D>
constexpr size_t dq_smem_bytes() {  // slack; q, dO; STAGES x (k, v); Delta; barriers
  return 1024 + (size_t)(2 + 2 * STAGES) * Tile<D>::BYTES + 4 * TILE + 8 * (1 + STAGES);
}

// One block per (64 queries, b*H + h): Delta of its rows (fp32, from the
// bf16 out and dO) and dQ = dS k over the key tiles, recomputing S = q k^T
// and dP = dO v^T. It writes its rows' L and Delta to the row statistics
// (see launch_bwd) for the dK/dV kernel.
template <int D, bool DROP>
__global__ void __launch_bounds__(NT, 2)
attn_bwd_dq_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                        __grid_constant__ const CUtensorMap map_k,
                        __grid_constant__ const CUtensorMap map_v,
                        __grid_constant__ const CUtensorMap map_do,
                        const unsigned char* __restrict__ key_pad,
                        const bf16* __restrict__ out, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ stats,
                        bf16* __restrict__ dq, int ld_grad, int T, int H, unsigned seed,
                        unsigned bh0, unsigned thresh, float drop_scale, float inv_t) {
  using TL = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* dos = qs + TL::BYTES;
  unsigned char* ks = dos + TL::BYTES;           // STAGES tiles
  unsigned char* vs = ks + STAGES * TL::BYTES;   // STAGES tiles
  float* rowd = reinterpret_cast<float*>(vs + STAGES * TL::BYTES);  // Delta of the rows
  uint64_t* bar = reinterpret_cast<uint64_t*>(rowd + TILE);          // q + dO, stages

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 5) * 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE, col = h * D, E = H * D;
  const int n_tiles = (T + TILE - 1) / TILE;
  const unsigned char* pad = key_pad ? key_pad + (long long)b * T : nullptr;
  const unsigned stream = DROP ? dropout_stream(seed, bh0 + (unsigned)bh) : 0u;

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(bar + i, 1);
    fence_mbar_init();
    load_tile_pair<D>(qs, &map_q, dos, &map_do, bar, col, q0, b);
    for (int st = 0; st < STAGES && st < n_tiles; ++st)
      load_tile_pair<D>(ks + st * TL::BYTES, &map_k, vs + st * TL::BYTES, &map_v, bar + 1 + st,
                        col, st * TILE, b);
  }
  {  // Delta: two threads a row, D / 2 columns each, in a fixed order
    const int r = tid >> 1, half = tid & 1, tq = q0 + r;
    float acc = 0.f, L = 0.f;
    if (tq < T) {
      L = lse[(long long)bh * T + tq];
      const long long off = ((long long)b * T + tq) * E + col + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8)
        acc = dot8(*reinterpret_cast<const uint4*>(out + off + c),
                   *reinterpret_cast<const uint4*>(dout + off + c), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {  // rows past T: 0 (the dK/dV kernel masks them)
      const int tp = (T + TILE - 1) / TILE * TILE;
      rowd[r] = acc;
      stats[(long long)bh * 2 * tp + tq] = L;
      stats[(long long)bh * 2 * tp + tp + tq] = acc;
    }
  }
  __syncthreads();

  float lsc[2], dl[2];
  bool uni[2];
  unsigned qrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tq = q0 + row0 + g + 8 * r;
    const float L = tq < T ? lse[(long long)bh * T + tq] : 0.f;
    lsc[r] = L * LOG2E;
    uni[r] = L <= FILL;
    dl[r] = rowd[row0 + g + 8 * r];
    qrow[r] = ((unsigned)tq * (unsigned)T + 2u * t) * DROPOUT_IDX_MUL;
  }

  const uint64_t q_desc = make_desc<TL::SW>(qs), do_desc = make_desc<TL::SW>(dos);
  float s[32], dp[32], acc[TL::ACC];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TL::ACC; ++i) acc[i] = 0.f;

  uint64_t pad_bits = padded_keys(pad, 0, T, lane);
  mbar_wait(bar, 0);
  mbar_wait(bar + 1, 0);
  wg_fence();
  issue_scores<D>(s, q_desc, make_desc<TL::SW>(ks));
  issue_scores<D>(dp, do_desc, make_desc<TL::SW>(vs));
  wg_commit();
  wg_wait<0>();
  reg_fence(s);
  reg_fence(dp);
  ds_rows_tile<DROP>(s, dp, pad_bits, T, t, qrow, lsc, uni, dl, stream, thresh, drop_scale,
                     inv_t);

  // steady state as the forward's: the next tile's S and dP, then dQ += dS k
  for (int it = 0; it + 1 < n_tiles; ++it) {
    const int st = it % STAGES, nx = (it + 1) % STAGES, k1 = (it + 1) * TILE;
    pad_bits = padded_keys(pad, k1, T, lane);
    uint32_t da[4][4];  // dS of tile it, bf16
    pack_a(da, s);
    mbar_wait(bar + 1 + nx, ((it + 1) / STAGES) & 1);
    wg_fence();
    issue_scores<D>(s, q_desc, make_desc<TL::SW>(ks + nx * TL::BYTES));
    issue_scores<D>(dp, do_desc, make_desc<TL::SW>(vs + nx * TL::BYTES));
    wg_commit();
    issue_rows<D>(acc, da, make_desc<TL::SW>(ks + st * TL::BYTES));
    wg_commit();
    wg_wait<1>();
    reg_fence(s);
    reg_fence(dp);
    const unsigned hb[2] = {qrow[0] + (unsigned)k1 * DROPOUT_IDX_MUL,
                            qrow[1] + (unsigned)k1 * DROPOUT_IDX_MUL};
    ds_rows_tile<DROP>(s, dp, pad_bits, T - k1, t, hb, lsc, uni, dl, stream, thresh,
                       drop_scale, inv_t);
    wg_wait<0>();
    reg_fence(acc);
    __syncthreads();
    if (tid == 0 && it + STAGES < n_tiles)
      load_tile_pair<D>(ks + st * TL::BYTES, &map_k, vs + st * TL::BYTES, &map_v, bar + 1 + st,
                        col, (it + STAGES) * TILE, b);
  }
  {  // the last tile's dS k
    uint32_t da[4][4];
    pack_a(da, s);
    wg_fence();
    issue_rows<D>(acc, da, make_desc<TL::SW>(ks + (n_tiles - 1) % STAGES * TL::BYTES));
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tq = q0 + row0 + g + 8 * r;
    if (tq < T) {
      bf16* dst = dq + ((long long)b * T + tq) * ld_grad + col + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem_bytes() {  // slack; k, v; STAGES x (q, dO, L, Delta); barriers
  return 1024 + (size_t)(2 + 2 * STAGES) * Tile<D>::BYTES + STAGES * 2 * 4 * TILE +
         8 * (1 + STAGES);
}

// One block per (64 keys, b*H + h): dK = dS^T q and dV = P~^T dO over the
// query tiles, with the keys as rows (S^T = k q^T, dP^T = v dO^T).
template <int D, bool DROP>
__global__ void __launch_bounds__(NT, 2)
attn_bwd_dkdv_sm90_kernel(__grid_constant__ const CUtensorMap map_q,
                          __grid_constant__ const CUtensorMap map_k,
                          __grid_constant__ const CUtensorMap map_v,
                          __grid_constant__ const CUtensorMap map_do,
                          __grid_constant__ const CUtensorMap map_stats,
                          const unsigned char* __restrict__ key_pad, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int ld_grad, int T, int H, unsigned seed,
                          unsigned bh0, unsigned thresh, float drop_scale, float inv_t) {
  using TL = Tile<D>;
  constexpr unsigned ROW_STATS = 2 * 4 * TILE;  // L and Delta of a query tile, bytes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);
  unsigned char* vs = ks + TL::BYTES;
  unsigned char* qb = vs + TL::BYTES;             // STAGES tiles
  unsigned char* dob = qb + STAGES * TL::BYTES;   // STAGES tiles
  float* stats = reinterpret_cast<float*>(dob + STAGES * TL::BYTES);  // STAGES x (L, Delta)
  uint64_t* bar = reinterpret_cast<uint64_t*>(stats + STAGES * 2 * TILE);  // k + v, stages

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 5) * 16;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * TILE, col = h * D;
  const int n_tiles = (T + TILE - 1) / TILE;
  const int tp = n_tiles * TILE;
  const int stat0 = bh * 2 * tp;  // L (tp floats) and Delta (tp) of (b, h) start here
  const unsigned stream = DROP ? dropout_stream(seed, bh0 + (unsigned)bh) : 0u;

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(bar + i, 1);
    fence_mbar_init();
    load_tile_pair<D>(ks, &map_k, vs, &map_v, bar, col, k0, b);
    for (int st = 0; st < STAGES && st < n_tiles; ++st) {
      load_tile_pair<D>(qb + st * TL::BYTES, &map_q, dob + st * TL::BYTES, &map_do,
                        bar + 1 + st, col, st * TILE, b, ROW_STATS);
      tma_load_1d(stats + st * 2 * TILE, &map_stats, bar + 1 + st, stat0 + st * TILE);
      tma_load_1d(stats + st * 2 * TILE + TILE, &map_stats, bar + 1 + st,
                  stat0 + tp + st * TILE);
    }
  }
  __syncthreads();

  // the thread's keys: rows g and g + 8 of the warp's 16
  bool kin[2], kpad[2];
  unsigned kmul[2];
  const unsigned tmul = (unsigned)T * DROPOUT_IDX_MUL;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + g + 8 * r;
    kin[r] = key < T;
    kpad[r] = kin[r] && key_pad != nullptr && key_pad[(long long)b * T + key] != 0;
    kmul[r] = (unsigned)key * DROPOUT_IDX_MUL + 2u * t * tmul;
  }

  const uint64_t k_desc = make_desc<TL::SW>(ks), v_desc = make_desc<TL::SW>(vs);
  float s[32], dp[32], dka[TL::ACC], dva[TL::ACC];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TL::ACC; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(bar, 0);
  mbar_wait(bar + 1, 0);
  wg_fence();
  issue_scores<D>(s, k_desc, make_desc<TL::SW>(qb));
  issue_scores<D>(dp, v_desc, make_desc<TL::SW>(dob));
  wg_commit();
  wg_wait<0>();
  reg_fence(s);
  reg_fence(dp);
  ds_cols_tile<DROP>(s, dp, stats, stats + TILE, T, t, kin, kpad, kmul, tmul, stream, thresh,
                     drop_scale, inv_t);

  // steady state as the forward's: the next tile's S^T and dP^T, then
  // dV += P~^T dO and dK += dS^T q
  for (int it = 0; it + 1 < n_tiles; ++it) {
    const int st = it % STAGES, nx = (it + 1) % STAGES, q1 = (it + 1) * TILE;
    uint32_t pa[4][4], da[4][4];  // P~^T and dS^T of tile it, bf16
    pack_a(pa, s);
    pack_a(da, dp);
    mbar_wait(bar + 1 + nx, ((it + 1) / STAGES) & 1);
    wg_fence();
    issue_scores<D>(s, k_desc, make_desc<TL::SW>(qb + nx * TL::BYTES));
    issue_scores<D>(dp, v_desc, make_desc<TL::SW>(dob + nx * TL::BYTES));
    wg_commit();
    issue_rows<D>(dva, pa, make_desc<TL::SW>(dob + st * TL::BYTES));
    issue_rows<D>(dka, da, make_desc<TL::SW>(qb + st * TL::BYTES));
    wg_commit();
    wg_wait<1>();
    reg_fence(s);
    reg_fence(dp);
    const float* sn = stats + nx * 2 * TILE;
    const unsigned hb[2] = {kmul[0] + (unsigned)q1 * tmul, kmul[1] + (unsigned)q1 * tmul};
    ds_cols_tile<DROP>(s, dp, sn, sn + TILE, T - q1, t, kin, kpad, hb, tmul, stream, thresh,
                       drop_scale, inv_t);
    wg_wait<0>();
    reg_fence(dka);
    reg_fence(dva);
    __syncthreads();
    if (tid == 0 && it + STAGES < n_tiles) {
      const int q2 = (it + STAGES) * TILE;
      load_tile_pair<D>(qb + st * TL::BYTES, &map_q, dob + st * TL::BYTES, &map_do,
                        bar + 1 + st, col, q2, b, ROW_STATS);
      tma_load_1d(stats + st * 2 * TILE, &map_stats, bar + 1 + st, stat0 + q2);
      tma_load_1d(stats + st * 2 * TILE + TILE, &map_stats, bar + 1 + st, stat0 + tp + q2);
    }
  }
  {  // the last tile's products
    const int st = (n_tiles - 1) % STAGES;
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, s);
    pack_a(da, dp);
    wg_fence();
    issue_rows<D>(dva, pa, make_desc<TL::SW>(dob + st * TL::BYTES));
    issue_rows<D>(dka, da, make_desc<TL::SW>(qb + st * TL::BYTES));
    wg_commit();
    wg_wait<0>();
    reg_fence(dka);
    reg_fence(dva);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + g + 8 * r;
    if (kin[r]) {
      const long long off = ((long long)b * T + key) * ld_grad + col + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
            pack_bf16(dka[4 * n + 2 * r], dka[4 * n + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
            pack_bf16(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
      }
    }
  }
}

// ---- host side ------------------------------------------------------------

// A (B, T, cols) bf16 array whose rows lie ld elements apart, read in boxes
// of one tile part's columns (D, or 32 at D 96) x TILE rows of one batch item
// (rows past T read as zeros), swizzled over the part's row bytes.
bool encode_rows(CUtensorMap* map, const void* base, int cols, int ld, int T, int B, int D) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const int pw = D == 96 ? 32 : D;  // Tile<D>::PW
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)ld * 2 * T};
  const cuuint32_t box[3] = {(cuuint32_t)pw, (cuuint32_t)TILE, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = pw == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : pw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// n fp32 values read in boxes of TILE (past n: zeros)
bool encode_vector(CUtensorMap* map, const float* base, long long n) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // unused at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)TILE};
  const cuuint32_t elem[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q, k, v maps of one call: (B, T, H*D) at row stride ld
bool encode_qkv(CUtensorMap (&maps)[3], const void* q, const void* k, const void* v, int ld,
                int B, int T, int H, int D) {
  return encode_rows(&maps[0], q, H * D, ld, T, B, D) &&
         encode_rows(&maps[1], k, H * D, ld, T, B, D) &&
         encode_rows(&maps[2], v, H * D, ld, T, B, D);
}

template <int D>
int launch_fwd(const CUtensorMap (&maps)[3], const unsigned char* key_pad, bf16* out, float* lse,
               int B, int T, int H, unsigned seed, unsigned bh0, unsigned thresh, float drop_scale,
               cudaStream_t stream, int dev) {
  static std::atomic<unsigned long long> smem_set[2];  // without, with dropout
  constexpr size_t smem = fwd_smem_bytes<D>();
  const auto kernel = thresh ? attn_fwd_sm90_kernel<D, true> : attn_fwd_sm90_kernel<D, false>;
  const cudaError_t err = allow_smem(kernel, smem, smem_set[thresh != 0], dev);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  kernel<<<grid, NT, smem, stream>>>(maps[0], maps[1], maps[2], key_pad, out, lse, T, H, seed, bh0,
                                     thresh, drop_scale);
  return cudaGetLastError();
}

template <int D>
int launch_bwd(const CUtensorMap (&maps)[3], const CUtensorMap& map_do,
               const CUtensorMap& map_stats, const unsigned char* key_pad, const bf16* out,
               const bf16* dout, const float* lse, float* stats, bf16* dq, bf16* dk, bf16* dv,
               int ld_grad, int B, int T, int H, unsigned seed, unsigned bh0, unsigned thresh,
               float drop_scale, cudaStream_t stream, int dev) {
  static std::atomic<unsigned long long> smem_set[2][2];  // [dQ, dK/dV][without, with dropout]
  const float inv_t = 1.f / (float)T;
  const dim3 grid((T + TILE - 1) / TILE, B * H);
  constexpr size_t smem_q = dq_smem_bytes<D>();
  const auto dq_kernel =
      thresh ? attn_bwd_dq_sm90_kernel<D, true> : attn_bwd_dq_sm90_kernel<D, false>;
  cudaError_t err = allow_smem(dq_kernel, smem_q, smem_set[0][thresh != 0], dev);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, NT, smem_q, stream>>>(maps[0], maps[1], maps[2], map_do, key_pad, out, dout,
                                          lse, stats, dq, ld_grad, T, H, seed, bh0, thresh,
                                          drop_scale, inv_t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkdv_smem_bytes<D>();
  const auto kv_kernel =
      thresh ? attn_bwd_dkdv_sm90_kernel<D, true> : attn_bwd_dkdv_sm90_kernel<D, false>;
  err = allow_smem(kv_kernel, smem_kv, smem_set[1][thresh != 0], dev);
  if (err != cudaSuccess) return err;
  kv_kernel<<<grid, NT, smem_kv, stream>>>(maps[0], maps[1], maps[2], map_do, map_stats, key_pad,
                                           dk, dv, ld_grad, T, H, seed, bh0, thresh, drop_scale,
                                           inv_t);
  return cudaGetLastError();
}

}  // namespace

// out (B, T, H*D) bf16; lse (B, H, T) fp32 or null (no gradient needed). q,
// k, v rows of width >= H*D at stride ld (a multiple of 8), 16-byte aligned,
// as out and lse. D in 16, 32, 64, 96.
extern "C" int tsx_attention_fwd_bf16(const void* q, const void* k, const void* v, int ld,
                                      const void* key_pad, void* out, void* lse, int B, int T,
                                      int H, int D, unsigned seed, unsigned bh0, unsigned thresh,
                                      float drop_scale, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (D != 16 && D != 32 && D != 64 && D != 96) return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !aligned16(lse) ||
      ld % 8 != 0)
    return cudaErrorMisalignedAddress;
  int dev = 0;
  const cudaError_t err = bind_context(&dev);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[3];
  if (!encode_qkv(maps, q, k, v, ld, B, T, H, D)) return cudaErrorInvalidValue;
  const unsigned char* kp = static_cast<const unsigned char*>(key_pad);
  bf16* o = static_cast<bf16*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fwd<16>(maps, kp, o, l, B, T, H, seed, bh0, thresh, drop_scale, s, dev);
    case 32: return launch_fwd<32>(maps, kp, o, l, B, T, H, seed, bh0, thresh, drop_scale, s, dev);
    case 64: return launch_fwd<64>(maps, kp, o, l, B, T, H, seed, bh0, thresh, drop_scale, s, dev);
    default: return launch_fwd<96>(maps, kp, o, l, B, T, H, seed, bh0, thresh, drop_scale, s, dev);
  }
}

// dq, dk, dv (rows at stride ld_grad, even, 4-byte aligned) from q, k, v,
// out, dout (B, T, H*D), all 16-byte aligned, and the forward's lse. delta
// is a 16-byte aligned scratch of B*H*2*TP floats, TP = T rounded up to 64:
// the row statistics, L then Delta of each (b, h) in rows of TP, which the dQ
// kernel writes and the dK/dV kernel reads in 256-byte boxes.
extern "C" int tsx_attention_bwd_bf16(const void* q, const void* k, const void* v, int ld,
                                      const void* key_pad, const void* out, const void* dout,
                                      const void* lse, void* delta, void* dq, void* dk, void* dv,
                                      int ld_grad, int B, int T, int H, int D, unsigned seed,
                                      unsigned bh0, unsigned thresh, float drop_scale,
                                      void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (D != 16 && D != 32 && D != 64 && D != 96) return cudaErrorInvalidValue;
  const uintptr_t grads = reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                          reinterpret_cast<uintptr_t>(dv);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !aligned16(dout) ||
      !aligned16(delta) || ld % 8 != 0 || (grads & 3u) != 0 ||
      ld_grad % 2 != 0)
    return cudaErrorMisalignedAddress;
  int dev = 0;
  const cudaError_t err = bind_context(&dev);
  if (err != cudaSuccess) return err;
  const long long n_stats = (long long)B * H * 2 * ((T + TILE - 1) / TILE * TILE);
  CUtensorMap maps[3], map_do, map_stats;
  if (!encode_qkv(maps, q, k, v, ld, B, T, H, D) ||
      !encode_rows(&map_do, dout, H * D, H * D, T, B, D) ||
      !encode_vector(&map_stats, static_cast<const float*>(delta), n_stats))
    return cudaErrorInvalidValue;
  const unsigned char* kp = static_cast<const unsigned char*>(key_pad);
  const bf16* o = static_cast<const bf16*>(out);
  const bf16* g = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk), *gv = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_bwd<16>(maps, map_do, map_stats, kp, o, g, l, dl, gq, gk, gv, ld_grad,
                            B, T, H, seed, bh0, thresh, drop_scale, s, dev);
    case 32:
      return launch_bwd<32>(maps, map_do, map_stats, kp, o, g, l, dl, gq, gk, gv, ld_grad,
                            B, T, H, seed, bh0, thresh, drop_scale, s, dev);
    case 64:
      return launch_bwd<64>(maps, map_do, map_stats, kp, o, g, l, dl, gq, gk, gv, ld_grad,
                            B, T, H, seed, bh0, thresh, drop_scale, s, dev);
    default:
      return launch_bwd<96>(maps, map_do, map_stats, kp, o, g, l, dl, gq, gk, gv, ld_grad,
                            B, T, H, seed, bh0, thresh, drop_scale, s, dev);
  }
}
