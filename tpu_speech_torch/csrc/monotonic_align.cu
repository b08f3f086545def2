// Monotonic alignment search (MAS): the most likely monotone path of text
// tokens over mel frames, as Grad-TTS's training step needs it once a step.
//
// Replaces no Pallas kernel: the JAX package compiles MAS as one lax.scan over
// the Ty mel columns and a reversed scan for the backtrace
// (tpu_speech/ops/monotonic_align.py::maximum_path:27). In eager PyTorch the
// same scan is a Python loop of Ty columns with several launches each
// (maximum_path_plain in ops/monotonic_align.py); this is one launch. Its
// arithmetic is the scan's, cell for cell, so the path is the same bit for
// bit. With v = value * mask in fp32, per batch row b, t_x = sum_x mask[x, 0],
// t_y = sum_y mask[0, y], MAX_NEG = -1e9:
//     D[x, y] = v[x, y] + max(stay, adv)          (two roundings, NaN wins)
//     stay = MAX_NEG if x == y else D[x, y - 1]   (D[., -1] = MAX_NEG),
//     adv  = D[x - 1, y - 1]; at x == 0: 0 if y == 0 else MAX_NEG;
// then from index = t_x - 1 at y = t_y - 1 down to y = 0: path[index, y] = 1,
// and index steps down when y > 0, index != 0 and (index == y or
// D[index, y - 1] < D[index - 1, y - 1]) (ties stay). Only cells with
// x < t_x and y < t_y are computed: no other cell reaches the backtrace.
//
// What bounds it on an H100: not bytes (value, mask and path are 7 MB at the
// bench point B = 16, Tx = 72, Ty = 512: 2 us at 3.35 TB/s) and not
// operations (two per cell), but two dependency chains per batch row: t_y DP
// columns, each needing the one before, then t_y backtrace steps, each
// needing the index the one before chose. The design keeps both chains in
// one warp's registers and everything else off their path.
//
// The warp path (Tx <= 1024, mas_warp_kernel<V>): a block of five warps per
// batch row, the DP warp (0), three producers (1-3) and a signaller (4).
//  - The DP chain in registers. Lane l holds the V consecutive cells x = l V
//    .. l V + V - 1 (V = 1 .. 32, a power of two >= Tx / 32) of the current
//    column, updated in place from the top slot down, so the previous column
//    never leaves them; the one cross-lane neighbour, D[l V - 1, y - 1],
//    comes by one __shfl_up_sync, issued right after the top cell so that
//    the other cells hide its latency. Columns y >= 32 V hold no diagonal
//    cell and skip its test. A box of box_cols(V) columns (32, 16, 8) is
//    straight-line code: no branch inside, and the role and the lengths are
//    warp-uniform (broadcast by a shuffle), so the shuffles need no
//    divergence checks.
//  - v * m staged ahead of the chain. The producers copy boxes of value and
//    mask (rows x C columns) into a shared-memory ring of up to 8 stages with
//    16-byte cp.async (4 bytes where rows are unaligned); row x sits at
//    (x / V) S + x % V with S = V | 1 and a row is C + 4 floats. A lane
//    reads G consecutive columns of a row with one vector load (G = 4, 2, 1
//    at V <= 8, 16, 32; the 16-byte loads fall in distinct banks), the next
//    G columns while these compute, and multiplies value by mask itself.
//  - No mbarrier on the DP's path. The copies arrive on their stage's
//    mbarrier as they land (cp.async.mbarrier.arrive.noinc); the signaller
//    waits on those and publishes a count of landed boxes, which the DP
//    polls with a plain acquire load (an mbarrier test costs hundreds of
//    cycles a box); the DP publishes the boxes it is done with, which the
//    producers poll before reusing a stage. The first stages are issued
//    before the lengths are known (all Tx rows), while warp 0 sums them.
//  - Decision bits, not a DP scratch. At column y a lane holds D[x, y - 1]
//    and D[x - 1, y - 1] for its cells, so it forms the backtrace's decision
//    (x == y) || D[x, y - 1] < D[x - 1, y - 1] there and stores it: V words a
//    column, each lane its own V-bit field at bit l V (x at bit x) from V = 8
//    on, a ballot a slot at V = 2, 4 (word j, bit l: x = l V + j), one ballot
//    at V = 1. In shared memory (Tx Ty / 8 bytes: 8 KB at (72, 512)) or,
//    where they do not fit, in a (B, Ty rounded up to C, V) uint32 scratch
//    the wrapper allocates. No fp32 DP scratch exists.
//  - The backtrace in registers. Warp 0 walks 32 aligned columns a round:
//    lane k gathers column top - k's 32 decisions from the index I down
//    (a funnel shift of two words; spread bits at V = 2, 4), the 32 windows
//    go to every lane through shared memory, and the walk is a one-hot bit d
//    that moves up a place where its window's bit is set, d += d & u: two
//    integer operations a column. idx[y] lives in shared memory, in chunks
//    of up to 2048 columns.
//  - The path written once, coalesced, behind the walk: warp 0 publishes
//    each round's 32 columns and the other warps write path[x, y] = (idx[y]
//    == x) for them at once, 16 bytes a thread (4 where Ty % 4 != 0),
//    columns at or past t_y holding idx -1: no zero fill, no scattered ones.
// The block path (1024 < Tx <= 29055, mas_block_kernel<K>), chosen by shape:
// past V = 32 a warp's registers and a ring row no longer pay, so 1024
// threads own x = t + 1024 k (k < K), the previous and current DP columns
// are shared-memory arrays (one barrier a column), each thread loads its
// rows' values and masks C columns at a time (one vector load a row where
// rows are aligned), and the decisions are ballots over 32 consecutive x,
// the same x-ordered words (in shared memory where they fit, else the same
// global scratch); the walk is the warp path's, and every warp writes the
// path after it (31 writer warps beside it would slow the walk's reads).
// Both paths count as one launch of `maximum_path`. The lengths come from
// the mask on the device: the host reads nothing. A non-null `stamps` gets,
// per block, the SM clock at the start, after the lengths, after the DP, the
// backtrace's own cycles, the clock at the end, the global timer (ns) at the
// start and the end, and (warp path) the DP's cycles waiting for boxes, the
// DP's end and a producer's cycles waiting for free stages.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr float MAX_NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on Hopper
constexpr int PRODUCERS = 3;          // producer warps of the warp path
constexpr int WARP_THREADS = 32 * (2 + PRODUCERS);  // and the DP warp and the signaller
constexpr int BLOCK_THREADS = 1024;   // the block path
constexpr int WARP_MAX_TX = 1024;     // the warp path: V = 32 at most
constexpr int BLOCK_MAX_TX = 29055;   // two fp32 columns in a block's shared memory
constexpr int IDX_CHUNK = 2048;       // backtrace columns a chunk
constexpr int N_STAMPS = 10;
constexpr int MAX_STAGES = 8;         // ring stages of the warp path

// the warp path's columns a ring stage (a box) at V cells a lane; a ring row
// holds them and 4 floats more, so that 16-byte copies land aligned
__host__ __device__ constexpr int box_cols(int V) { return V <= 4 ? 32 : (V == 8 ? 16 : 8); }
__host__ __device__ constexpr int ring_ld(int V) { return box_cols(V) + 4; }

// what a launch needs, computed on the host by plan_of
struct Plan {
  int block_path;   // 0: mas_warp_kernel<width>, 1: mas_block_kernel<width>
  int width;        // V (cells a lane) or K (cells a thread)
  int cols;         // C: columns a ring stage (warp path)
  int stages;       // NS (warp path)
  int bits_smem;    // the decision words in shared memory
  int smem;         // dynamic shared memory bytes
  int words;        // decision words a column
  int chunk;        // backtrace columns a chunk
  long long scratch_words;  // global decision words a batch row (0 in shared memory)
  // byte offsets in dynamic shared memory
  int bar_off, scratch_off, idx_off, bits_off, ring_off, rows;
};

struct Args {
  const float* value;
  const float* mask;
  float* path;
  uint32_t* bits_global;  // (B, Ty, words), or null
  long long* stamps;      // (B, N_STAMPS), or null
  int Tx, Ty;
  Plan plan;
};

// f(integral_constant<int, I>) for I = B .. E-1: loop indices that are
// compile-time constants, so the register arrays are never indexed at run time
template <int B, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// jnp.maximum: a NaN operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// [start, after the lengths, after the DP, backtrace cycles, end] clocks and
// [start, end] global-timer nanoseconds
__device__ __forceinline__ void write_stamps(long long* out, long long c_start, long long c_lens,
                                             long long c_dp, long long c_walk, long long ns) {
  const long long c_end = clock64(), ns_end = global_ns();
  out[0] = c_start;
  out[1] = c_lens;
  out[2] = c_dp;
  out[3] = c_walk;
  out[4] = c_end;
  out[5] = ns;
  out[6] = ns_end;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// a shared-memory int with acquire / release semantics at CTA scope: the
// counters by which warps of a block hand boxes and groups of columns on
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];" : "=r"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.b32 [%0], %1;" ::"r"(smem_u32(p)), "r"(v) : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// t_x and t_y from the mask's first column and first row, in every thread
// (sums of 0/1 values: exact in any order); `scratch` holds 64 floats and may
// be reused once this returns
__device__ __forceinline__ void lengths(const float* m, int Tx, int Ty, float* scratch,
                                        int& t_x, int& t_y) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float sx = 0.f, sy = 0.f;
  for (int x = tid; x < Tx; x += blockDim.x) sx += __ldg(m + static_cast<size_t>(x) * Ty);
  for (int y = tid; y < Ty; y += blockDim.x) sy += __ldg(m + y);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    sx += __shfl_xor_sync(FULL, sx, o);
    sy += __shfl_xor_sync(FULL, sy, o);
  }
  if (lane == 0) {
    scratch[warp] = sx;
    scratch[32 + warp] = sy;
  }
  __syncthreads();
  float tx = 0.f, ty = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    tx += scratch[w];
    ty += scratch[32 + w];
  }
  __syncthreads();
  t_x = min(max(static_cast<int>(tx), 0), Tx);
  t_y = min(max(static_cast<int>(ty), 0), Ty);
}

// t_x and t_y summed by one warp (the warp path's warp 0), in every lane
__device__ __forceinline__ void warp_lengths(const float* m, int Tx, int Ty, int& t_x, int& t_y) {
  const int lane = threadIdx.x & 31;
  float sx = 0.f, sy = 0.f;
  for (int x = lane; x < Tx; x += 32) sx += __ldg(m + static_cast<size_t>(x) * Ty);
  for (int y = lane; y < Ty; y += 32) sy += __ldg(m + y);
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    sx += __shfl_xor_sync(FULL, sx, o);
    sy += __shfl_xor_sync(FULL, sy, o);
  }
  t_x = min(max(static_cast<int>(sx), 0), Tx);
  t_y = min(max(static_cast<int>(sy), 0), Ty);
}

// bit t of an 8-bit x to bit 4t, and of a 16-bit x to bit 2t
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

__device__ __forceinline__ uint32_t spread2(uint32_t x) {
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// A column's decision bits for x0 .. x0 + 31 (bit e: x0 + e, x0 >= -31; bits
// below x = 0 are 0). LAYOUT 0: x at bit x of the column (word x / 32);
// LAYOUT 2 or 4 (the warp path at V = 2, 4): word j, bit l holds x = l V + j,
// gathered as lanes l0 .. l0 + 32/V - 1 (a word, bit t V + j) and the lane
// above (bit j), joined by a funnel shift.
template <int LAYOUT>
__device__ __forceinline__ uint32_t window(const uint32_t* col, int x0, int I) {
  if constexpr (LAYOUT == 0) {
    const int wl = (x0 + 32) / 32 - 1;  // floor(x0 / 32)
    const uint32_t lo = wl >= 0 ? col[wl] : 0u;
    const uint32_t hi = 32 * (wl + 1) <= I ? col[wl + 1] : 0u;
    return __funnelshift_r(lo, hi, x0 - 32 * wl);
  } else {
    constexpr int V = LAYOUT, T = 32 / V;
    const int l0 = x0 >= 0 ? x0 / V : -((V - 1 - x0) / V);  // floor(x0 / V) >= -T
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t w = col[j];
      const uint32_t f = l0 >= 0 ? w >> l0 : w << -l0;  // lane l0 at bit 0
      lo |= (V == 4 ? spread4(f & 0xFFu) : spread2(f & 0xFFFFu)) << j;
      hi |= (l0 + T < 32 ? (w >> (l0 + T)) & 1u : 0u) << j;
    }
    return __funnelshift_r(lo, hi, x0 - l0 * V);
  }
}

// Warp 0 walks columns [c0, end) from the top (end <= t_y) in groups of 32
// aligned columns, from index I, writes idx[y - c0] and publishes each group
// through `ready` (the lowest column whose idx is written); I leaves as the
// index at column c0 - 1. Lane k builds column top - k's window of the 32
// indices from I down (bit k: index I - k) and the 32 windows go to every
// lane through `wbuf`; the walk is then a one-hot bit d (bit k: index I - k)
// that moves up one place where the window's bit is set, d += d & u: two
// integer operations a column, all in registers.
template <int LAYOUT>
__device__ __forceinline__ void walk(const uint32_t* bits, int words, int* idx, uint32_t* wbuf,
                                     int* ready, int c0, int end, int& I) {
  const int lane = threadIdx.x & 31;
  for (int g0 = (end - 1) & ~31; end > c0 && g0 >= c0; g0 -= 32) {
    const int top = min(g0 + 31, end - 1);
    const int x0 = I - 31;
    const int y = top - lane;
    uint32_t u = 0;
    if (y >= g0 && y > 0) {
      u = window<LAYOUT>(bits + static_cast<size_t>(y) * words, x0, I);
      if (x0 <= 0) u &= ~(1u << (-x0));  // index 0 never steps down
    }
    wbuf[lane] = __brev(u);
    __syncwarp();
    uint32_t uk[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 t = reinterpret_cast<const uint4*>(wbuf)[q];
      uk[4 * q] = t.x;
      uk[4 * q + 1] = t.y;
      uk[4 * q + 2] = t.z;
      uk[4 * q + 3] = t.w;
    }
    // 31 steps stay inside the window; the 32nd as an integer
    uint32_t d = 1u, mine = 0;
#pragma unroll
    for (int k = 0; k < 31; ++k) {
      mine = lane == k ? d : mine;
      d += d & uk[k];
    }
    mine = lane == 31 ? d : mine;
    if (y >= g0) idx[y - c0] = I - 31 + __clz(mine);
    I = I - 31 + __clz(d) - ((d & uk[31]) ? 1 : 0);
    __syncwarp();
    if (lane == 0) st_release(ready, g0);
  }
}

// path[x, y] = (idx[y - c0] == x) for columns [g0, g1) and every row x < Tx,
// by the writer warps (w of nw): 16 bytes a thread along y, 8 threads a row
// (4 bytes, 32 threads a row, where Ty % 4 != 0)
__device__ __forceinline__ void write_group(float* p, const int* idx, int c0, int g0, int g1,
                                            int Tx, int Ty, int w, int nw) {
  const int lane = threadIdx.x & 31;
  if ((Ty & 3) == 0) {  // rows 16-byte aligned; g0 and g1 multiples of 4
    const int q = lane & 7;
    if (g0 + 4 * q >= g1) return;
    const int4 i = reinterpret_cast<const int4*>(idx + (g0 - c0))[q];
    for (int x = 4 * w + (lane >> 3); x < Tx; x += 4 * nw)
      *reinterpret_cast<float4*>(p + static_cast<size_t>(x) * Ty + g0 + 4 * q) =
          make_float4(i.x == x, i.y == x, i.z == x, i.w == x);
  } else {
    const int y = g0 + lane;
    if (y >= g1) return;
    const int i = idx[y - c0];
    for (int x = w; x < Tx; x += nw) p[static_cast<size_t>(x) * Ty + y] = i == x ? 1.f : 0.f;
  }
}

// the backtrace and the path, chunk by chunk from the top; every thread.
// Warp 0 walks. OVERLAP (the warp path): the other warps write each group of
// 32 columns as soon as warp 0 publishes it, so the path's writes hide
// behind the walk. Else (the block path, whose 31 writer warps would slow
// the walk's reads of the decision words in device memory) every warp
// writes the chunk once it is walked.
template <int LAYOUT, bool OVERLAP>
__device__ __forceinline__ void backtrace_and_write(const Args& a, const uint32_t* bits, int* idx,
                                                    uint32_t* wbuf, int* ready_word, float* p,
                                                    int warp, int t_x, int t_y,
                                                    long long& walk_cycles) {
  const int lane = threadIdx.x & 31, nw = (blockDim.x >> 5) - 1;
  int* ready = ready_word;
  const int CH = a.plan.chunk;
  int I = t_x - 1;
  if (threadIdx.x == 0) st_release(ready, 0x7fffffff);  // no group published yet
  __syncthreads();
  for (int c0 = ((a.Ty - 1) / CH) * CH; c0 >= 0; c0 -= CH) {
    const int c1 = min(c0 + CH, a.Ty);
    const int end = t_x > 0 ? max(c0, min(c1, t_y)) : c0;
    if (warp == 0) {
      for (int y = end + lane; y < c1; y += 32) idx[y - c0] = -1;
      __syncwarp();
      if (lane == 0) st_release(ready, min(c1, (end + 31) & ~31));
      const long long t0 = clock64();
      walk<LAYOUT>(bits, a.plan.words, idx, wbuf, ready, c0, end, I);
      walk_cycles += clock64() - t0;
    } else if (OVERLAP) {
      for (int g0 = (c1 - 1) & ~31; g0 >= c0; g0 -= 32) {
        while (ld_acquire(ready) > g0) __nanosleep(64);
        write_group(p, idx, c0, g0, min(g0 + 32, c1), a.Tx, a.Ty, warp - 1, nw);
      }
    }
    if (!OVERLAP) {
      __syncthreads();
      for (int g0 = (c1 - 1) & ~31; g0 >= c0; g0 -= 32)
        write_group(p, idx, c0, g0, min(g0 + 32, c1), a.Tx, a.Ty, warp, nw + 1);
    }
    __syncthreads();
  }
}

// One column's decision bits (bit[j]: lane l's cell l V + j), stored as the
// column's V words: V = 1 one ballot; V = 2, 4 a ballot a slot (word j, bit
// l: x = l V + j); V >= 8 each lane its own V-bit field at bit l V, so x sits
// at bit x with no exchange between lanes.
template <int V>
__device__ __forceinline__ void store_bits(const bool (&bit)[V], uint32_t* col) {
  const int lane = threadIdx.x & 31;
  if constexpr (V <= 4) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = __ballot_sync(FULL, bit[j]);
    if (lane == 0) {
      if constexpr (V == 1) col[0] = w[0];
      if constexpr (V == 2) *reinterpret_cast<uint2*>(col) = make_uint2(w[0], w[1]);
      if constexpr (V == 4) *reinterpret_cast<uint4*>(col) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    uint32_t w[V];  // the lane's field, ORed as a tree
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = bit[j] ? 1u << j : 0u;
#pragma unroll
    for (int span = 1; span < V; span *= 2)
#pragma unroll
      for (int j = 0; j + span < V; j += 2 * span) w[j] |= w[j + span];
    if constexpr (V == 8) reinterpret_cast<uint8_t*>(col)[lane] = static_cast<uint8_t>(w[0]);
    if constexpr (V == 16) reinterpret_cast<uint16_t*>(col)[lane] = static_cast<uint16_t>(w[0]);
    if constexpr (V == 32) col[lane] = w[0];
  }
}

// One DP column y over lane l's cells from the ring's values v and masks m
// (multiplied here, far from their loads) and the shuffled top cell of the
// lane below, `below` (D[l V - 1, y - 1]; lane 0 takes the start cell
// instead); returns this column's shuffled top cell for the next. DIAG: some
// cell of this warp may be the diagonal x == y (y < 32 V); past it no cell
// is, and the test and its select drop out. The top cell comes first and its
// shuffle is issued before the others, which hide its latency.
template <int V, bool DIAG>
__device__ __forceinline__ float dp_column(float (&d)[V], const float (&v)[V], const float (&m)[V],
                                           float below, int y, uint32_t* col) {
  const int lane = threadIdx.x & 31;
  const int r = y - lane * V;  // slot r holds the diagonal
  bool bit[V];
  auto cell = [&](auto J) {
    constexpr int j = decltype(J)::value;
    float lft;
    if constexpr (j > 0)
      lft = d[j - 1];
    else
      lft = lane == 0 ? (y == 0 ? 0.f : MAX_NEG) : below;
    const float old = d[j];
    const float p = __fmul_rn(v[j], m[j]);  // the scan's value * mask
    if constexpr (DIAG) {
      const bool diag = r == j;
      bit[j] = diag || old < lft;
      d[j] = __fadd_rn(p, max_nan(diag ? MAX_NEG : old, lft));
    } else {
      bit[j] = old < lft;
      d[j] = __fadd_rn(p, max_nan(old, lft));
    }
  };
  cell(std::integral_constant<int, V - 1>{});
  const float next = __shfl_up_sync(FULL, d[V - 1], 1);
  static_for<0, V - 1>(
      [&](auto I) { cell(std::integral_constant<int, V - 2 - decltype(I)::value>{}); });
  store_bits<V>(bit, col);
  return next;
}

// G consecutive columns of the V rows l V + j of the ring at q: values from
// q, masks from q + half, one vector load each
template <int V, int G, int LD>
__device__ __forceinline__ void load_group(float (&v)[G][V], float (&m)[G][V], const float* q,
                                           int half) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float* r = q + j * LD;
    if constexpr (G == 4) {
      const float4 x = *reinterpret_cast<const float4*>(r);
      const float4 y = *reinterpret_cast<const float4*>(r + half);
      v[0][j] = x.x, v[1][j] = x.y, v[2][j] = x.z, v[3][j] = x.w;
      m[0][j] = y.x, m[1][j] = y.y, m[2][j] = y.z, m[3][j] = y.w;
    } else if constexpr (G == 2) {
      const float2 x = *reinterpret_cast<const float2*>(r);
      const float2 y = *reinterpret_cast<const float2*>(r + half);
      v[0][j] = x.x, v[1][j] = x.y;
      m[0][j] = y.x, m[1][j] = y.y;
    } else {
      v[0][j] = r[0];
      m[0][j] = r[half];
    }
  }
}

// G DP columns y .. y + G - 1 from a loaded group
template <int V, int G, bool DIAG>
__device__ __forceinline__ float dp_group(float (&d)[V], const float (&v)[G][V],
                                          const float (&m)[G][V], float below, int y,
                                          uint32_t* col) {
#pragma unroll
  for (int i = 0; i < G; ++i)
    below = dp_column<V, DIAG>(d, v[i], m[i], below, y + i, col + i * V);
  return below;
}

// One box's C columns from the ring at `base`, two register sets in turn.
template <int V, int G, int C, int LD, bool DIAG>
__device__ __forceinline__ float dp_box(float (&d)[V], const float* base, int half, float below,
                                        int y0, uint32_t* col) {
  float va[G][V], ma[G][V], vb[G][V], mb[G][V];
  load_group<V, G, LD>(va, ma, base, half);
#pragma unroll
  for (int c = 0; c < C; c += 2 * G) {
    load_group<V, G, LD>(vb, mb, base + c + G, half);
    below = dp_group<V, G, DIAG>(d, va, ma, below, y0 + c, col + c * V);
    if (c + 2 * G < C) load_group<V, G, LD>(va, ma, base + c + 2 * G, half);
    below = dp_group<V, G, DIAG>(d, vb, mb, below, y0 + c + G, col + (c + G) * V);
  }
  return below;
}

// Warp 0's DP over the ring: lane l's cells x = l V + j, j < V, box by box.
// A box is box_cols(V) columns, a compile-time count, so its columns run as
// straight-line code (columns past t_y in the last box compute junk into
// padding that nothing reads). A lane reads G consecutive columns of a row
// with one vector load (G = 4, 2, 1 at V <= 8, 16, 32: 16 bytes free of bank
// conflicts, within the registers), and two register sets take turns: the
// next G columns' values and masks are read while these G compute.
template <int V>
__device__ __forceinline__ void dp_warp(const Args& a, const float* ring, const int* landed,
                                        int* consumed, uint32_t* bits, int ncol,
                                        long long& wait_cycles) {
  constexpr int S = V | 1, C = box_cols(V), LD = ring_ld(V);
  constexpr int G = V <= 8 ? 4 : (V == 16 ? 2 : 1);
  const int lane = threadIdx.x & 31;
  const int NS = a.plan.stages, half = a.plan.rows * LD;
  // lanes past the row's last cell read that lane's rows (a broadcast): their
  // cells are never read back
  const int row0 = min(lane, (a.Tx - 1) / V) * S;
  float d[V];
#pragma unroll
  for (int j = 0; j < V; ++j) d[j] = MAX_NEG;
  float below = MAX_NEG;
  const int nbox = (ncol + C - 1) / C;
  int s = 0;
  for (int k = 0; k < nbox; ++k) {
    // box k has landed once the signaller's count passes it: a load of
    // shared memory, where an mbarrier test costs hundreds of cycles a box
    const long long t0 = clock64();
    while (ld_acquire(landed) <= k) {
    }
    wait_cycles += clock64() - t0;
    const float* base = ring + s * 2 * half + row0 * LD;
    const int y0 = k * C;
    uint32_t* col = bits + static_cast<size_t>(y0) * V;
    if (y0 < 32 * V)
      below = dp_box<V, G, C, LD, true>(d, base, half, below, y0, col);
    else
      below = dp_box<V, G, C, LD, false>(d, base, half, below, y0, col);
    // the stage is free: its values are in registers or spent
    if (lane == 0) st_release(consumed, k + 1);
    if (++s == NS) s = 0;
  }
}

// Warps 1-3: boxes k0 .. k1 - 1 of value and mask (rows < nrows, columns <
// ncols) into the ring, cp.async copies of 16 bytes (4 columns of a row; 4
// bytes where Ty % 4 != 0 or an unaligned tensor leaves rows unaligned) that
// arrive on the stage's `full` barrier as they land; no thread waits for data.
template <int V>
__device__ __forceinline__ void produce(const Args& a, const float* v, const float* m, float* ring,
                                        uint64_t* full, const int* consumed, int nrows,
                                        int ncols, int k0, int k1, long long& wait_cycles) {
  constexpr int S = V | 1, C = box_cols(V), LD = ring_ld(V);
  const int pt = threadIdx.x - 32, npt = 32 * PRODUCERS;
  const int NS = a.plan.stages, half = a.plan.rows * LD;
  const bool wide = (a.Ty & 3) == 0 && ((reinterpret_cast<uintptr_t>(v) |
                                          reinterpret_cast<uintptr_t>(m)) & 15) == 0;
  for (int k = k0; k < k1; ++k) {
    const int s = k % NS;
    if (k >= NS) {  // box k - NS has been read
      const long long t0 = clock64();
      while (ld_acquire(consumed) <= k - NS) __nanosleep(32);
      wait_cycles += clock64() - t0;
    }
    const int y0 = k * C, n = min(C, ncols - y0);
    float* sv = ring + s * 2 * half;
    if (wide) {  // e: row x = e / (C / 4), 4 columns from 4 (e % (C / 4))
      for (int e = pt; e < nrows * (C / 4); e += npt) {
        const int x = e / (C / 4), c = 4 * (e % (C / 4));
        if (c < n) {
          float* dst = sv + ((x / V) * S + x % V) * LD + c;
          const size_t g = static_cast<size_t>(x) * a.Ty + y0 + c;
          cp_async16(dst, v + g);
          cp_async16(dst + half, m + g);
        }
      }
    } else {
      for (int e = pt; e < nrows * C; e += npt) {
        const int x = e / C, c = e % C;
        if (c < n) {
          float* dst = sv + ((x / V) * S + x % V) * LD + c;
          const size_t g = static_cast<size_t>(x) * a.Ty + y0 + c;
          cp_async4(dst, v + g);
          cp_async4(dst + half, m + g);
        }
      }
    }
    cp_async_arrive(&full[s]);
  }
}

template <int V>
__global__ void __launch_bounds__(WARP_THREADS, 1) mas_warp_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& pl = a.plan;
  const int b = blockIdx.x, tid = threadIdx.x;
  const bool stamp = tid == 0 && a.stamps;
  const long long c_start = stamp ? clock64() : 0, ns_start = stamp ? global_ns() : 0;
  long long c_lens = 0, c_dp = 0, c_walk = 0;
  const size_t plane = static_cast<size_t>(a.Tx) * a.Ty;
  const float* v = a.value + b * plane;
  const float* m = a.mask + b * plane;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + pl.bar_off);  // the copies landed
  uint64_t* lens_bar = full + pl.stages;  // t_x and t_y published
  constexpr int C = box_cols(V);
  float* scratch = reinterpret_cast<float*>(smem + pl.scratch_off);
  int* lens = reinterpret_cast<int*>(scratch + 48);
  int* landed = reinterpret_cast<int*>(scratch + 52);    // boxes landed
  int* consumed = reinterpret_cast<int*>(scratch + 53);  // boxes the DP is done with
  // warp-uniform as far as the compiler can see, so that the DP's shuffles
  // and ballots need no divergence checks
  const int warp = __shfl_sync(FULL, tid >> 5, 0);
  if (tid == 0) {
    for (int s = 0; s < pl.stages; ++s) mbar_init(&full[s], 32 * PRODUCERS);
    mbar_init(lens_bar, 1);
    *landed = 0;
    *consumed = 0;
  }
  __syncthreads();
  float* ring = reinterpret_cast<float*>(smem + pl.ring_off);
  long long waited = 0;
  // the first stages' copies, all Tx rows and Ty columns, fly while the
  // lengths are summed
  const int head = min(pl.stages, (a.Ty + C - 1) / C);
  uint32_t* bits = pl.bits_smem ? reinterpret_cast<uint32_t*>(smem + pl.bits_off)
                                : a.bits_global + b * static_cast<size_t>(pl.scratch_words);
  if (warp == 0) {
    // the DP starts on its own lengths; the others take them from `lens`
    int t_x, t_y;
    warp_lengths(m, a.Tx, a.Ty, t_x, t_y);
    if (tid == 0) {
      lens[0] = t_x, lens[1] = t_y;
      mbar_arrive(lens_bar);
    }
    if (stamp) c_lens = clock64();
    // decision words in shared memory through a pointer the compiler sees
    // as shared (STS, not a generic store)
    if (pl.bits_smem)
      dp_warp<V>(a, ring, landed, consumed, reinterpret_cast<uint32_t*>(smem + pl.bits_off),
                 t_x > 0 ? t_y : 0, waited);
    else
      dp_warp<V>(a, ring, landed, consumed, bits, t_x > 0 ? t_y : 0, waited);
    if (stamp) a.stamps[b * N_STAMPS + 7] = waited, a.stamps[b * N_STAMPS + 8] = clock64();
  } else if (warp <= PRODUCERS) {
    produce<V>(a, v, m, ring, full, consumed, a.Tx, a.Ty, 0, head, waited);
    mbar_wait(lens_bar, 0);
    const int t_x = lens[0], ncol = t_x > 0 ? lens[1] : 0;
    produce<V>(a, v, m, ring, full, consumed, t_x, ncol, head, (ncol + C - 1) / C, waited);
    asm volatile("cp.async.wait_all;" ::: "memory");  // no copy lands after the block exits
    if (tid == 32 && a.stamps) a.stamps[b * N_STAMPS + 9] = waited;
  } else if ((tid & 31) == 0) {
    // the signaller: box k's copies have all landed -> landed = k + 1; the
    // head, then (once the lengths are known) the boxes the DP needs
    auto signal = [&](int k) {
      mbar_wait(&full[k % pl.stages], (k / pl.stages) & 1);
      st_release(landed, k + 1);
    };
    for (int k = 0; k < head; ++k) signal(k);
    mbar_wait(lens_bar, 0);
    const int nbox = ((lens[0] > 0 ? lens[1] : 0) + C - 1) / C;
    for (int k = head; k < nbox; ++k) signal(k);
  }
  __syncthreads();
  const int t_x = __shfl_sync(FULL, lens[0], 0), t_y = __shfl_sync(FULL, lens[1], 0);
  if (stamp) c_dp = clock64();
  constexpr int LAYOUT = V == 2 || V == 4 ? V : 0;
  backtrace_and_write<LAYOUT, true>(a, bits, reinterpret_cast<int*>(smem + pl.idx_off),
                              reinterpret_cast<uint32_t*>(scratch),
                              reinterpret_cast<int*>(scratch + 32), a.path + b * plane, warp, t_x,
                              t_y, c_walk);
  if (stamp) write_stamps(a.stamps + b * N_STAMPS, c_start, c_lens, c_dp, c_walk, ns_start);
}

template <int K>
__global__ void __launch_bounds__(BLOCK_THREADS, 1) mas_block_kernel(const Args a) {
  // columns a box: each thread loads its K cells' values and masks of C
  // columns at once (one vector load a row where rows are aligned; K C <= 16
  // products kept), within the 64 registers of a 1024-thread block
  constexpr int C = K <= 4 ? 4 : (K == 8 ? 2 : 1);
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& pl = a.plan;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(FULL, tid >> 5, 0);
  const bool stamp = tid == 0 && a.stamps;
  const long long c_start = stamp ? clock64() : 0, ns_start = stamp ? global_ns() : 0;
  long long c_lens = 0, c_dp = 0, c_walk = 0;
  const size_t plane = static_cast<size_t>(a.Tx) * a.Ty;
  const float* v = a.value + b * plane;
  const float* m = a.mask + b * plane;
  // the two columns; before the DP the lengths' scratch, after it idx
  float* prev = reinterpret_cast<float*>(smem + pl.ring_off);
  float* cur = prev + a.Tx;
  int t_x, t_y;
  lengths(m, a.Tx, a.Ty, prev, t_x, t_y);
  if (stamp) c_lens = clock64();
  const int ncol = t_x > 0 ? t_y : 0;
  uint32_t* bits = pl.bits_smem ? reinterpret_cast<uint32_t*>(smem + pl.bits_off)
                                : a.bits_global + b * static_cast<size_t>(pl.scratch_words);
  for (int x = tid; x < t_x; x += BLOCK_THREADS) prev[x] = MAX_NEG;
  __syncthreads();
  // rows aligned to C floats: a row's C columns in one vector load
  const bool wide = C > 1 && a.Ty % C == 0 &&
                    ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(m)) &
                     (4 * C - 1)) == 0;
  for (int y0 = 0; y0 < ncol; y0 += C) {
    float pv[K][C];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int x = tid + BLOCK_THREADS * k;
      const size_t g = static_cast<size_t>(x) * a.Ty + y0;
      float rv[C], rm[C];
      if (x < t_x && wide) {
        if constexpr (C == 4) {
          const float4 p = __ldg(reinterpret_cast<const float4*>(v + g));
          const float4 q = __ldg(reinterpret_cast<const float4*>(m + g));
          rv[0] = p.x, rv[1] = p.y, rv[2] = p.z, rv[3] = p.w;
          rm[0] = q.x, rm[1] = q.y, rm[2] = q.z, rm[3] = q.w;
        } else if constexpr (C == 2) {
          const float2 p = __ldg(reinterpret_cast<const float2*>(v + g));
          const float2 q = __ldg(reinterpret_cast<const float2*>(m + g));
          rv[0] = p.x, rv[1] = p.y;
          rm[0] = q.x, rm[1] = q.y;
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const bool in = x < t_x && y0 + c < ncol;
          rv[c] = in ? __ldg(v + g + c) : 0.f;
          rm[c] = in ? __ldg(m + g + c) : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) pv[k][c] = __fmul_rn(rv[c], rm[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int y = y0 + c;
      if (y >= ncol) break;
      const float start = y == 0 ? 0.f : MAX_NEG;
      uint32_t mine = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int x = tid + BLOCK_THREADS * k;
        bool bit = false;
        if (x < t_x) {
          const float old = prev[x];
          const float lft = x ? prev[x - 1] : start;
          const bool diag = x == y;
          bit = diag || old < lft;
          cur[x] = __fadd_rn(pv[k][c], max_nan(diag ? MAX_NEG : old, lft));
        }
        const uint32_t word = __ballot_sync(FULL, bit);  // x = 32 (32 k + warp) + lane
        if (lane == k) mine = word;
      }
      const int word = 32 * lane + warp;
      if (lane < K && word < pl.words) bits[static_cast<size_t>(y) * pl.words + word] = mine;
      __syncthreads();
      float* t = prev;
      prev = cur;
      cur = t;
    }
  }
  __syncthreads();
  if (stamp) c_dp = clock64();
  backtrace_and_write<0, false>(a, bits, reinterpret_cast<int*>(smem + pl.ring_off),
                         reinterpret_cast<uint32_t*>(smem + pl.ring_off + 4 * pl.chunk),
                         reinterpret_cast<int*>(smem + pl.ring_off + 4 * pl.chunk + 128),
                         a.path + b * plane, warp, t_x, t_y, c_walk);
  if (stamp) write_stamps(a.stamps + b * N_STAMPS, c_start, c_lens, c_dp, c_walk, ns_start);
}

size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// the launch for (Tx, Ty); false where the kernel does not take the shape
bool plan_of(int Tx, int Ty, Plan& p) {
  if (Tx <= 0 || Ty <= 0 || Tx > BLOCK_MAX_TX) return false;
  p = Plan{};
  const int ty32 = (Ty + 31) / 32 * 32;
  p.chunk = ty32 < IDX_CHUNK ? ty32 : IDX_CHUNK;
  const size_t idx_bytes = 4 * static_cast<size_t>(p.chunk);
  if (Tx <= WARP_MAX_TX) {
    const int V = pow2_at_least((Tx + 31) / 32);
    const int S = V | 1;
    p.width = V;
    p.words = V;
    p.rows = ((Tx - 1) / V + 1) * S;
    const int c = box_cols(V);
    // the last box's columns past Ty compute into padding: Ty rounded up to c
    const long long words = static_cast<long long>((Ty + c - 1) / c * c) * V;
    const size_t bits_bytes = 4 * static_cast<size_t>(words);
    p.cols = c;
    p.bar_off = 0;
    p.scratch_off = 144;                   // 8 + 1 mbarriers at most
    p.idx_off = 144 + 256;                 // after 64 floats of scratch
    const size_t fixed = align16(p.idx_off + idx_bytes);
    for (int in_smem = 1; in_smem >= 0; --in_smem) {
      const size_t head = fixed + (in_smem ? align16(bits_bytes) : 0);
      for (int ns = MAX_STAGES; ns >= 2; --ns) {
        const size_t ring = static_cast<size_t>(ns) * 2 * p.rows * ring_ld(V) * 4;
        if (head + ring <= MAX_SMEM) {
          p.bits_smem = in_smem;
          p.bits_off = static_cast<int>(fixed);
          p.ring_off = static_cast<int>(head);
          p.smem = static_cast<int>(head + ring);
          p.stages = ns;
          p.scratch_words = in_smem ? 0 : words;
          return true;
        }
      }
    }
    return false;
  }
  p.block_path = 1;
  p.width = pow2_at_least((Tx + BLOCK_THREADS - 1) / BLOCK_THREADS);
  p.words = (Tx + 31) / 32;
  size_t region = 8 * static_cast<size_t>(Tx);  // the columns; then idx and the walk's windows
  if (region < idx_bytes + 144) region = idx_bytes + 144;
  const size_t bits_bytes = align16(4 * static_cast<size_t>(Ty) * p.words);
  p.bits_smem = bits_bytes + region <= MAX_SMEM;
  p.bits_off = 0;
  p.ring_off = p.bits_smem ? static_cast<int>(bits_bytes) : 0;
  p.smem = static_cast<int>(p.ring_off + region);
  p.scratch_words = p.bits_smem ? 0 : static_cast<long long>(Ty) * p.words;
  return p.smem <= static_cast<int>(MAX_SMEM);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, std::atomic<unsigned long long>& done, const Args& a, int B,
                   int threads, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = allow_smem(kernel, MAX_SMEM, done, dev);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, a.plan.smem, stream>>>(a);
  return cudaGetLastError();
}

#define MAS_WARP(V_)                                                          \
  case V_: {                                                                  \
    static std::atomic<unsigned long long> done{0};                           \
    return launch(mas_warp_kernel<V_>, done, a, B, WARP_THREADS, s);     \
  }
#define MAS_BLOCK(K_)                                                         \
  case K_: {                                                                  \
    static std::atomic<unsigned long long> done{0};                           \
    return launch(mas_block_kernel<K_>, done, a, B, BLOCK_THREADS, s);   \
  }

}  // namespace

// The launch plan of (Tx, Ty) as 9 ints: block path (0/1), V or K, columns a
// ring stage, stages, decision words in shared memory (0/1), shared-memory
// bytes, decision words a column, backtrace columns a chunk, global decision
// words a batch row (the scratch the wrapper allocates, 0 if none).
extern "C" int tsx_maximum_path_plan(int Tx, int Ty, int* out) {
  Plan p;
  if (!plan_of(Tx, Ty, p)) return cudaErrorInvalidValue;
  const long long v[9] = {p.block_path, p.width, p.cols, p.stages, p.bits_smem, p.smem,
                          p.words, p.chunk, p.scratch_words};
  for (int i = 0; i < 9; ++i) out[i] = static_cast<int>(v[i]);
  return cudaSuccess;
}

// path (B, Tx, Ty) of 0/1 from value and mask (B, Tx, Ty), all contiguous
// fp32; bits: the (B, Ty, words) uint32 scratch where the plan asks for one
// (else null); stamps: null, or (B, 10) int64 of clock stamps.
extern "C" int tsx_maximum_path(const void* value, const void* mask, void* bits, void* path,
                                int B, int Tx, int Ty, void* stamps, void* stream) {
  if (B < 0 || Tx < 0 || Ty < 0) return cudaErrorInvalidValue;
  if (B == 0 || Tx == 0 || Ty == 0) return cudaSuccess;
  Args a{static_cast<const float*>(value), static_cast<const float*>(mask),
         static_cast<float*>(path), static_cast<uint32_t*>(bits),
         static_cast<long long*>(stamps), Tx, Ty, Plan{}};
  if (!plan_of(Tx, Ty, a.plan) || (a.plan.scratch_words > 0 && bits == nullptr))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (!a.plan.block_path) {
    switch (a.plan.width) {
      MAS_WARP(1) MAS_WARP(2) MAS_WARP(4) MAS_WARP(8) MAS_WARP(16) MAS_WARP(32)
    }
  } else {
    switch (a.plan.width) { MAS_BLOCK(2) MAS_BLOCK(4) MAS_BLOCK(8) MAS_BLOCK(16) MAS_BLOCK(32) }
  }
  return cudaErrorInvalidValue;
}
