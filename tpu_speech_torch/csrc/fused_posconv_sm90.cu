// Grouped 1-D convolution on bf16 activations for Hopper: wgmma products
// from shared memory, TMA loads, each weight chunk shared by 256 frames. The
// positional convolution of the SPIRAL transformer blocks in bf16 (K4) and
// its input gradient (K4-dx).
//
// Replaces the Pallas TPU kernel of tpu_speech/ops/fused_posconv.py on bf16
// activations: grouped_conv1d (pallas_call at line 132, _pallas_fwd:121,
// _fwd_kernel:72); its VJP (_bwd:198) runs the same kernel again for dx on
// k-flipped, in/out-swapped weights with the complementary left pad, and so
// does the port (ops/fused_posconv.py), so this one kernel serves both. With
// xp = pad(x, (left_pad, K - 1 - left_pad)) in time and g = o / Cg:
//     out[b, t, o] = sum_k sum_ci xp[b, t + k, g*Cg + ci] * w[o, ci, k],
// products of the bf16 values summed in fp32, the output rounded to bf16
// once. The entry is tsx_grouped_conv1d_bf16 (Cg 16, 32, 48, 64; K <= 128;
// any 0 <= left_pad < K; any T); the fp32 kernel stays in fused_posconv.cu.
//
// What bounds it (chip_smoke.py::roofline): 2 B T C Cg K FLOP at 989 TFLOP/s
// against x and out once each and the weights once (2 (2 B T C + C Cg K)
// bytes at 3.35 TB/s). At the paths' shapes (16 groups, K 128):
//   (14, 604, 512) Cg 32: 35.5 GFLOP, 35.9 us; 21.5 MB, 6.4 us
//   (14, 302, 768) Cg 48: 39.9 GFLOP, 40.3 us; 22.4 MB, 6.7 us
//   (24, 392, 512), (24, 456, 512) Cg 32: 39.9 and 46.4 us of FLOP
//   (24, 196, 768), (24, 228, 768) Cg 48: 44.9 and 52.2 us of FLOP
// The tensor cores bound every shape, by 6x or more over the bytes. Under
// that, shared memory: a wgmma m64nNk16 with both operands in shared memory
// reads 2 KB of A and N/16 KB of B for 16 N/2048 cycles of the SM's peak, so
// at 128 bytes a cycle it runs at most at 2/3 of the peak at Cg 32 and 7/8 at
// Cg 48 (by that count).
//
// Weight traffic of the tiling: a block reads its group's weights, K Cg^2
// bf16 (256 KB at Cg 32, 576 KB at Cg 48), once from L2, and there are B G
// ceil(T / 256) blocks: 176 MB a call at (14, 604, 512), 264 MB at (14, 302,
// 768), 201 MB at either pretrain Cg 32 shape and 226 MB at either Cg 48
// one, half of what 128-frame blocks read (294, 396, 403 and 453 MB). From
// device memory the weights come once a call if L2 keeps them (0.5 and
// 1.2 MB): not measured.
//
// Design, and what each choice does about those limits:
// - wgmma.mma_async m64nCgk16 (N = Cg: 16, 32, 48 and 64 are legal widths),
//   bf16 operands, fp32 accumulators: M is 64 output frames, the sum runs
//   over (tap, input channel) in k16 steps, Cg/16 of them a tap. Both
//   operands come from shared memory in wgmma's no-swizzle K-major layout:
//   core matrices of 8 rows x 16 bytes (8 channels), 128 bytes apart along M
//   or N (SBO), LBO bytes apart along k (the next 8 channels).
// - A is the input window with no im2col copy: Cg/8 slabs of 8 channels,
//   each slab's rows 16 bytes apart, so tap k's A is the slab base + 16 k
//   bytes, a legal descriptor start for every k (a swizzled tile's pattern
//   would break under a one-row shift, and a 96-byte Cg 48 row is no swizzle
//   width). LBO is the slab stride. A from registers instead (ldmatrix with
//   per-lane row addresses, as the attention kernel's P~) reads the same
//   bytes of shared memory through ldmatrix and needs a wait per tap before
//   its registers are reused; on an H100 that variant ran slower than this
//   one at every path shape, so both operands stay in shared memory.
// - B is tap k's Cg_in x Cg_out weight slab in the same layout: the wrapper
//   lays the weights out as (G, K, Cg_in/8, Cg_out, 8), so LBO = 16 Cg, and
//   a chunk of KC taps of one group is one contiguous run of KC Cg^2 bf16.
// - The weights reach that layout by this file's second kernel
//   (posconv_weight_layout_kernel, entry tsx_grouped_conv1d_bf16_weights),
//   which the wrapper launches in place of PyTorch's permute-copy: one pass
//   through shared memory, reading runs of contiguous words and writing
//   whole 32-byte sectors, and for dx the flip and the swap in the same
//   pass. The permute-copy reads each 2-byte word from a sector of its own,
//   and dx's flip is a second copy before it; chip_smoke.py's phase 17
//   times both ways beside each other.
// - TMA brings both (cp.async.bulk.tensor + mbarrier). The window: a 3-D map
//   (C, T, B), boxes of 8 channels x up to 256 frames of one batch item from
//   frame t0 - left_pad, so rows outside [0, T) arrive as zeros (the pad for
//   free, negative coordinates included); 256 + K - 1 rows take two boxes a
//   slab. A weight chunk: one box of a 4-D map (256, Cg^2/256, K, G), rows of
//   512 bytes; taps past K arrive as zeros. The maps are encoded in the C
//   entry and passed as __grid_constant__ parameters: no Python work and no
//   launch is added to a call.
// - Taps past K (the last chunk, when KC does not divide K) take their A
//   from a 2 KB zero region, chosen by selecting the descriptor, not by a
//   branch: every wgmma issues unconditionally (with a conditional issue
//   ptxas serializes them, C7514), and no frame outside a sum's window
//   enters it, not even as 0 x inf.
// - Fewer weight re-reads: two consumer warpgroups of MW 64-frame tiles each
//   (MW = 2 up to Cg 48: 256 frames a block; 1 at Cg 64, whose accumulators
//   would not fit 128 registers twice) share every weight chunk.
// - A ring of STAGES chunks. Thread 0 issues every load (no producer warp:
//   two warpgroups, 256 threads and at most 128 registers a thread keep two
//   blocks on an SM, 91 KB of shared memory a block at Cg 32, 111 KB at Cg
//   48, so one block's set-up and stores overlap the other's products). After
//   chunk c it refills the stage of chunk c - 1 once every live warp has
//   released it (one mbarrier arrival a warp), so loads run STAGES - 1
//   chunks ahead and the warpgroups stay within a chunk of each other.
// - The sum in fp32, in a fixed order: chunk c (taps c KC .. c KC + KC - 1;
//   KC = 8 at Cg 16 and 32, 4 at 48, 2 at 64) sums into fresh accumulators,
//   tap by tap and within a tap k16 step by k16 step over the input
//   channels, and is then added to the running fp32 sum, chunk by chunk: the
//   promotion of the kernels this one replaces, which kept the tensor cores'
//   own accumulation to a short chain. No atomics: equal bits run to run.
//   tests/test_torch_posconv_tiles.py emulates this order on the CPU.
// - The grid is (G, B, time blocks): the last time block of each row, partly
//   past T at most lengths and so lighter, is scheduled last and fills the
//   final wave of two blocks an SM.
// - Edges: a 64-frame tile that starts at or past T issues no wgmma: a
//   warpgroup runs the loop instantiated for its live tiles (MW or 1), and
//   one with none leaves after set-up. Frames past T inside a live tile are
//   computed on zeros and not stored.

#include <cuda.h>  // CUtensorMap and its enums only: nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NWG = 2;             // consumer warpgroups a block
constexpr int NT = 128 * NWG;
constexpr int MAX_CG = 64;
constexpr int MAX_K = 128;
constexpr int STAGES = 4;          // the ring of weight chunks
constexpr int ZERO_BYTES = 2048;   // the A operand of taps past K: two 1 KB slabs of zeros
constexpr int BOX_ROWS = 256;      // the most rows a TMA box holds

// 64-frame tiles a warpgroup at CG channels a group: 2 up to Cg 48 (256
// frames a block), 1 at Cg 64, whose accumulators would not fit 128
// registers twice
constexpr int tiles_of(int cg) { return cg <= 48 ? 2 : 1; }

// CG channels a group, MW 64-frame tiles a warpgroup
template <int CG, int MW>
struct Plan {
  static constexpr int SLABS = CG / 8;                        // of 8 channels
  static constexpr int KSTEPS = CG / 16;                      // k16 steps a tap
  static constexpr int ACC = CG / 2;                          // accumulators of 64 x CG
  static constexpr int KC = CG <= 32 ? 8 : CG == 48 ? 4 : 2;  // taps a chunk
  static constexpr int FRAMES = 64 * NWG * MW;                // output frames a block
  static constexpr int TAP_BYTES = CG * CG * 2;               // one tap's weights
  static constexpr int STAGE_BYTES = KC * TAP_BYTES;          // a chunk
  static constexpr int WSLAB = CG * 16;                       // 8 input channels of a tap
};

// The window of a block: frames + K - 1 rows, in `boxes` TMA boxes of `rows`
// rows each (a multiple of 8, so that every box lands on 128 bytes)
struct Window {
  int rows, boxes;
};

Window window_of(int frames, int K) {
  const int live = frames + K - 1;
  const int boxes = (live + BOX_ROWS - 1) / BOX_ROWS;
  return {((live + boxes - 1) / boxes + 7) / 8 * 8, boxes};
}

// alignment slack; the ring; the window's slabs; the zeros; the barriers
template <int CG, int MW>
size_t smem_bytes(const Window& win) {
  return 1024 + (size_t)STAGES * Plan<CG, MW>::STAGE_BYTES +
         (size_t)Plan<CG, MW>::SLABS * win.rows * win.boxes * 16 + ZERO_BYTES +
         8 * (2 * STAGES + 1);
}

// ---- wgmma ----------------------------------------------------------------
// Descriptor of a no-swizzle K-major operand at shared address `addr`: core
// matrices of 8 rows x 16 bytes, 128 bytes apart along M or N (the stride
// byte offset), `lbo` bytes apart along k (the leading byte offset). Adding
// n to it moves the start n x 16 bytes.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d = a b (+ d if accumulate): a (64 x 16) and b (16 x N) from shared memory,
// both K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<48>(float (&d)[24], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---- the kernel -----------------------------------------------------------

// chunk c (taps c KC ..) of group grp into its stage of the ring
template <int CG, int MW>
__device__ __forceinline__ void load_chunk(const CUtensorMap* map_w, unsigned char* ring,
                                           uint64_t* full, int c, int grp) {
  using P = Plan<CG, MW>;
  const int st = c % STAGES;
  mbar_expect_tx(full + st, P::STAGE_BYTES);
  tma_load_4d(ring + st * P::STAGE_BYTES, map_w, full + st, 0, 0, c * P::KC, grp);
}

// The sums of a warpgroup's NL live tiles, window rows m0 + 64 NWG i (i < NL):
// every chunk of taps into fresh accumulators `part`, added to acc. Thread 0
// also refills the ring.
template <int CG, int MW, int NL>
__device__ __forceinline__ void conv_tiles(float (&acc)[NL][CG / 2],
                                           const CUtensorMap* map_w, unsigned char* ring,
                                           uint64_t* full, uint64_t* empty, uint32_t window,
                                           int win_slab, uint32_t zeros, int m0, int K,
                                           int grp, int tid) {
  using P = Plan<CG, MW>;
  const int n_chunks = (K + P::KC - 1) / P::KC;
  const uint32_t ring_addr = smem_u32(ring);
  uint64_t a_desc[P::KSTEPS];  // k16 step j: window slabs 2j and 2j + 1 from row m0
#pragma unroll
  for (int j = 0; j < P::KSTEPS; ++j)
    a_desc[j] = desc_k_major(window + 2 * j * win_slab + 16 * m0, win_slab);
  const uint64_t z_desc = desc_k_major(zeros, ZERO_BYTES / 2);
  float part[NL][P::ACC];
#pragma unroll
  for (int i = 0; i < NL; ++i)
#pragma unroll
    for (int e = 0; e < P::ACC; ++e) acc[i][e] = part[i][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % STAGES;
    const uint32_t stage = ring_addr + st * P::STAGE_BYTES;
    mbar_wait(full + st, (c / STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < P::KC; ++kk) {
      const int tap = c * P::KC + kk;
      const bool live = tap < K;
#pragma unroll
      for (int j = 0; j < P::KSTEPS; ++j) {
        const uint64_t b = desc_k_major(stage + kk * P::TAP_BYTES + 2 * j * P::WSLAB, P::WSLAB);
#pragma unroll
        for (int i = 0; i < NL; ++i)  // frame f of tile i at this tap: window row f + tap
          wgmma_ss<CG>(part[i], live ? a_desc[j] + (uint64_t)(64 * NWG * i + tap) : z_desc, b,
                       kk + j > 0);
      }
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < NL; ++i) reg_fence(part[i]);
    if ((tid & 31) == 0) mbar_arrive(empty + st);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < NL; ++i)
#pragma unroll
      for (int e = 0; e < P::ACC; ++e) acc[i][e] += part[i][e];
    const int r = c - 1;  // the chunk whose stage thread 0 refills now
    if (tid == 0 && r >= 0 && r + STAGES < n_chunks) {
      mbar_wait(empty + r % STAGES, (r / STAGES) & 1);
      load_chunk<CG, MW>(map_w, ring, full, r + STAGES, grp);
    }
  }
}

// Accumulator element e of a 64 x CG tile (warp w of the warpgroup, lane =
// 4g + t): row 16w + g + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2t + (e & 1).
// Tile i starts at output frame f0 + 64 NWG i; frames past T are not stored.
template <int CG, int NL>
__device__ __forceinline__ void store_tiles(const float (&acc)[NL][CG / 2], bf16* out, int b,
                                            int T, int C, int grp, int f0, int tid) {
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NL; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int f = f0 + 64 * NWG * i + 16 * warp + g + 8 * r;
      if (f < T) {
        bf16* dst = out + ((long long)b * T + f) * C + grp * CG + 2 * t;
#pragma unroll
        for (int n = 0; n < CG / 8; ++n)
          *reinterpret_cast<uint32_t*>(dst + 8 * n) =
              pack_bf16(acc[i][4 * n + 2 * r], acc[i][4 * n + 2 * r + 1]);
      }
    }
}

// One block per (group, batch item, FRAMES output frames): out[b, t0 .. t0 +
// FRAMES - 1, the group's channels]. The time blocks vary slowest, so the
// last time block of every row, which may be partly past T and lighter, is
// scheduled last and fills the final wave. Warpgroup w owns the 64-frame
// tiles w, w + NWG, ... of the block (window rows 64 (w + NWG i)).
template <int CG, int MW>
__global__ void __launch_bounds__(NT, 2)
grouped_conv1d_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w, bf16* __restrict__ out,
                           int T, int C, int K, int left_pad, int win_rows, int win_boxes) {
  using P = Plan<CG, MW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);                 // STAGES chunks
  unsigned char* window = ring + STAGES * P::STAGE_BYTES;     // SLABS slabs
  const int win_slab = win_rows * win_boxes * 16;             // bytes a slab
  unsigned char* zeros = window + P::SLABS * win_slab;
  uint64_t* full = reinterpret_cast<uint64_t*>(zeros + ZERO_BYTES);  // STAGES
  uint64_t* empty = full + STAGES;                                   // STAGES
  uint64_t* win_bar = empty + STAGES;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int grp = blockIdx.x, b = blockIdx.y, t0 = blockIdx.z * P::FRAMES;
  int live[NWG];  // the live tiles of each warpgroup: those that start before T
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    live[w] = 0;
#pragma unroll
    for (int i = 0; i < MW; ++i) live[w] += t0 + 64 * (w + NWG * i) < T;
  }

  if (tid == 0) {  // warpgroup 0 always has a live tile: t0 < T
    int live_warps = 0;
#pragma unroll
    for (int w = 0; w < NWG; ++w) live_warps += live[w] > 0 ? 4 : 0;
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, live_warps);
    }
    mbar_init(win_bar, 1);
    fence_mbar_init();
    mbar_expect_tx(win_bar, P::SLABS * win_slab);
    for (int s = 0; s < P::SLABS; ++s)
      for (int i = 0; i < win_boxes; ++i)
        tma_load_3d(window + s * win_slab + i * win_rows * 16, &map_x, win_bar,
                    grp * CG + 8 * s, t0 - left_pad + i * win_rows, b);
    const int n_chunks = (K + P::KC - 1) / P::KC;
    for (int c = 0; c < STAGES && c < n_chunks; ++c)
      load_chunk<CG, MW>(&map_w, ring, full, c, grp);
  }
  for (int i = tid; i < ZERO_BYTES / 16; i += NT)
    reinterpret_cast<uint4*>(zeros)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();  // the zeros, for wgmma's reads
  __syncthreads();
  if (live[wg] == 0) return;
  mbar_wait(win_bar, 0);
  const uint32_t win_addr = smem_u32(window), zero_addr = smem_u32(zeros);
  if (live[wg] == MW) {
    float acc[MW][P::ACC];
    conv_tiles<CG, MW, MW>(acc, &map_w, ring, full, empty, win_addr, win_slab, zero_addr,
                           64 * wg, K, grp, tid);
    store_tiles<CG, MW>(acc, out, b, T, C, grp, t0 + 64 * wg, tid);
  } else {
    float acc[1][P::ACC];
    conv_tiles<CG, MW, 1>(acc, &map_w, ring, full, empty, win_addr, win_slab, zero_addr,
                          64 * wg, K, grp, tid);
    store_tiles<CG, 1>(acc, out, b, T, C, grp, t0 + 64 * wg, tid);
  }
}

// ---- the weights' layout ----------------------------------------------------
// out (G, K, Cg/8, Cg, 8) from w (C, Cg, K), PyTorch's grouped-conv layout, in
// one pass over 16-bit words: block (p, g) stages two channels n0 = 2p, 2p + 1
// with all their taps in shared memory, rows[nl][m][k], read in runs of
// contiguous words (16 bytes a thread when `vec`: K a multiple of 8, w 16-byte
// aligned), and writes out[g, k, m / 8, n0 + nl, 0..7] as 16-byte units, the
// two channels' units of one (k, m / 8) side by side (a 32-byte sector). The
// forward's n is the output channel and m the input one: rows[nl][m][k] =
// w[g Cg + n0 + nl, m, k]. dx's n is w's input channel and m its output one,
// taps flipped: rows[nl][m][k] = w[g Cg + m, n0 + nl, K - 1 - k]. Both read
// runs of the same shape: the forward one run of 2 Cg K words, dx Cg runs of
// 2 K words, Cg K words apart.
constexpr int LAYOUT_NT = 256;

__global__ void __launch_bounds__(LAYOUT_NT)
    posconv_weight_layout_kernel(const uint16_t* __restrict__ w, uint4* __restrict__ out, int cg,
                                 int K, int dx, int vec) {
  extern __shared__ uint16_t rows[];  // [2][cg][K + 2]: a row pad of 4 bytes spreads the banks
  const int g = blockIdx.y, n0 = 2 * blockIdx.x, ld = K + 2;
  const uint16_t* src = w + (size_t)g * cg * cg * K + (size_t)n0 * (dx ? K : cg * K);
  // word i of the block's runs: run i / run_len, word r = i % run_len of it
  const int run_len = dx ? 2 * K : 2 * cg * K, run_stride = dx ? cg * K : 0, n = 2 * cg * K;
  // -> rows[nl][m][kk]; the forward's run holds (nl, m, k), dx's run m holds (nl, k)
  auto place = [&](int i, int* row, int* k) {
    const int run = i / run_len, r = i - run * run_len;
    const int nl = dx ? r / K : r / (cg * K), rest = dx ? r - nl * K : r - nl * cg * K;
    const int m = dx ? run : rest / K;
    *k = dx ? rest : rest - m * K;
    *row = nl * cg + m;
  };
  if (vec) {  // 8 words a thread, of one row (K % 8 == 0)
    for (int i = 8 * threadIdx.x; i < n; i += 8 * LAYOUT_NT) {
      int row, k;
      place(i, &row, &k);
      const int run = i / run_len;
      const uint4 v = *reinterpret_cast<const uint4*>(src + (size_t)run * run_stride +
                                                      (i - run * run_len));
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      uint32_t* dst = reinterpret_cast<uint32_t*>(rows + row * ld);  // ld even: 4-byte rows
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (dx)  // words k + 2j, k + 2j + 1 land at K - 2 - k - 2j, K - 1 - k - 2j, swapped
          dst[(K - 2 - k) / 2 - j] = __byte_perm(words[j], 0, 0x1032);
        else
          dst[k / 2 + j] = words[j];
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += LAYOUT_NT) {
      int row, k;
      place(i, &row, &k);
      const int run = i / run_len;
      rows[row * ld + (dx ? K - 1 - k : k)] = src[(size_t)run * run_stride + (i - run * run_len)];
    }
  }
  __syncthreads();
  const int m8s = cg / 8, units = 2 * m8s * K;
  for (int u = threadIdx.x; u < units; u += LAYOUT_NT) {
    const int nl = u & 1, m8 = (u >> 1) % m8s, k = (u >> 1) / m8s;
    const uint16_t* e = rows + (nl * cg + 8 * m8) * ld + k;
    uint4 v;
    v.x = e[0] | (uint32_t)e[ld] << 16;
    v.y = e[2 * ld] | (uint32_t)e[3 * ld] << 16;
    v.z = e[4 * ld] | (uint32_t)e[5 * ld] << 16;
    v.w = e[6 * ld] | (uint32_t)e[7 * ld] << 16;
    out[(((size_t)g * K + k) * m8s + m8) * cg + n0 + nl] = v;
  }
}

// ---- host side ------------------------------------------------------------

// x (B, T, C) bf16, read in boxes of 8 channels x `rows` frames of one batch
// item (frames outside [0, T) read as zeros)
bool encode_window(CUtensorMap* map, const void* x, int B, int T, int C, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * 2 * T};
  const cuuint32_t box[3] = {8, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w (G, K, Cg/8, Cg, 8) bf16 as (256, Cg^2/256, K, G), read a chunk of kc
// taps of one group a box (taps past K read as zeros)
bool encode_weights(CUtensorMap* map, const void* w, int G, int K, int cg, int kc) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t tap = (cuuint64_t)cg * cg;
  const cuuint64_t dims[4] = {256, tap / 256, (cuuint64_t)K, (cuuint64_t)G};
  const cuuint64_t strides[3] = {512, tap * 2, tap * 2 * K};
  const cuuint32_t box[4] = {256, (cuuint32_t)(tap / 256), (cuuint32_t)kc, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(w), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CG, int MW>
int launch(const void* x, const void* w, bf16* out, int B, int T, int C, int G, int K,
           int left_pad, cudaStream_t stream, int dev) {
  using P = Plan<CG, MW>;
  static std::atomic<unsigned long long> smem_set;
  const Window win = window_of(P::FRAMES, K);
  CUtensorMap map_x, map_w;
  if (!encode_window(&map_x, x, B, T, C, win.rows) ||
      !encode_weights(&map_w, w, G, K, CG, P::KC))
    return cudaErrorInvalidValue;
  const auto kernel = grouped_conv1d_sm90_kernel<CG, MW>;
  // the limit is the largest window's (K = MAX_K), set once a device
  const cudaError_t err =
      allow_smem(kernel, smem_bytes<CG, MW>(window_of(P::FRAMES, MAX_K)), smem_set, dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(G, B, (T + P::FRAMES - 1) / P::FRAMES);
  kernel<<<grid, NT, smem_bytes<CG, MW>(win), stream>>>(map_x, map_w, out, T, C, K, left_pad,
                                                        win.rows, win.boxes);
  return cudaGetLastError();
}

}  // namespace

// out (B, T, C) from x (B, T, C) and w (G, K, Cg/8, Cg, 8), w[g, k, ci / 8,
// o, ci % 8] the weight of input channel ci to output channel o of group g
// at tap k; all contiguous bf16, x and w 16-byte aligned, out 4-byte
// aligned; Cg = C/G in 16, 32, 48, 64.
extern "C" int tsx_grouped_conv1d_bf16(const void* x, const void* w, void* out, int B, int T,
                                       int C, int G, int K, int left_pad, void* stream) {
  if (G <= 0 || C % G != 0 || (C / G) % 16 != 0 || C / G > MAX_CG || K < 1 || K > MAX_K ||
      left_pad < 0 || left_pad >= K || B > 65535 || T / 128 >= 65535)
    return cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (!aligned16(x) || !aligned16(w) || (reinterpret_cast<uintptr_t>(out) & 3u) != 0)
    return cudaErrorMisalignedAddress;
  int dev = 0;
  const cudaError_t err = bind_context(&dev);
  if (err != cudaSuccess) return err;
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / G) {
    case 16: return launch<16, tiles_of(16)>(x, w, o, B, T, C, G, K, left_pad, s, dev);
    case 32: return launch<32, tiles_of(32)>(x, w, o, B, T, C, G, K, left_pad, s, dev);
    case 48: return launch<48, tiles_of(48)>(x, w, o, B, T, C, G, K, left_pad, s, dev);
    default: return launch<64, tiles_of(64)>(x, w, o, B, T, C, G, K, left_pad, s, dev);
  }
}

// The weights tsx_grouped_conv1d_bf16 reads, from w (C, Cg, K) bf16 (PyTorch's
// grouped-conv layout, contiguous): out (G, K, Cg/8, Cg, 8), contiguous and
// 16-byte aligned, out[g, k, ci / 8, o, ci % 8] = w[g Cg + o, ci, k]; with dx
// the weights of the input gradient, out[g, k, o / 8, ci, o % 8] = w[g Cg + o,
// ci, K - 1 - k]. Cg in 16, 32, 48, 64; K <= 128. One launch on `stream`.
extern "C" int tsx_grouped_conv1d_bf16_weights(const void* w, void* out, int G, int Cg, int K,
                                               int dx, void* stream) {
  if (G <= 0 || G > 65535 || Cg <= 0 || Cg % 16 != 0 || Cg > MAX_CG || K < 1 || K > MAX_K)
    return cudaErrorInvalidValue;
  if (!aligned16(out) || (reinterpret_cast<uintptr_t>(w) & 1u) != 0)
    return cudaErrorMisalignedAddress;
  const size_t smem = (size_t)2 * Cg * (K + 2) * sizeof(uint16_t);
  posconv_weight_layout_kernel<<<dim3(Cg / 2, G), LAYOUT_NT, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(w), static_cast<uint4*>(out), Cg, K, dx,
      K % 8 == 0 && aligned16(w));
  return cudaGetLastError();
}

// The output frames a block of tsx_grouped_conv1d_bf16 at Cg channels a
// group (0 for a Cg it does not take): a block reads its group's weights
// once, so a call reads B G ceil(T / frames) K Cg^2 bf16 of weights from L2.
extern "C" int tsx_grouped_conv1d_bf16_frames(int cg) {
  switch (cg) {
    case 16: return Plan<16, tiles_of(16)>::FRAMES;
    case 32: return Plan<32, tiles_of(32)>::FRAMES;
    case 48: return Plan<48, tiles_of(48)>::FRAMES;
    case 64: return Plan<64, tiles_of(64)>::FRAMES;
    default: return 0;
  }
}
