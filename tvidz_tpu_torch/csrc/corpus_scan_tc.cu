// K4 — corpus scan on the tensor cores: M packed query fingerprints of W
// 32-bit words against N corpus fingerprints, through a ±1 int8 matrix
// product, in one persistent launch. Any W below 2^18 (kMaxKeyWords, the
// running key's row field); the production W = 2 (64-bit pHash) has an
// instance of its own, phash256 runs W = 8, and rows wider than one pass
// holds (kMaxWords, 37) walk their words in chunks (FW = -1, below).
//
// Replaces the four MXU variants of the corpus scan in
// tvidz_tpu/ops/hamming.py, one template mode each:
//   kFull         ::_corpus_scan_kernel_mxu             (hamming.py:211)
//   kFullCols     ::_corpus_scan_kernel_mxu_hoisted     (hamming.py:340)
//   kTwoPhase     ::_corpus_scan_kernel_mxu_twophase    (hamming.py:442)
//   kFrameMin     ::_corpus_frame_min_kernel_mxu        (hamming.py:553)
//   kQueryNearest ::_corpus_query_nearest_kernel_mxu    (hamming.py:610)
// Their contract is K2's (csrc/corpus_scan.cu):
//   frame_min[n] = min_m hamming(q[m], c[n])             (N,) int32
//   q_min[m]     = min_n hamming(q[m], c[n])             (M,) int32
//   q_arg[m]     = the FIRST n attaining q_min[m]         (M,) int32
// kFrameMin writes frame_min only, kQueryNearest (q_min, q_arg) only.
// Sentinel rows (all ones) are ordinary rows. 1 <= M <= 16384 (the
// wrapper, ops/hamming.py, splits more queries into chunks of 16384).
//
// Formulation. Bits unpack to ±1 (set -> +1), MSB-first per 32-bit word
// (golden.pack_bits order); dot = sum of 32 W products and
// hamming = (32 W - dot) / 2, exact in int32. A k32 step of wgmma is one
// word: W steps per 64 rows.
//
// What bounds it on the H100 (M=128, N=2^20): the tensor-core work,
// 2 x 128 x 64 x 2^20 = 17 G int8 ops (8.7 us at 1,979 TOPS); HBM traffic
// is 8 MB of corpus plus 4 MB of frame_min (3.6 us at 3.35 TB/s). Two
// things held the tiled form this kernel replaced (mma.sync, one CTA per
// 256-row tile) far above that: mma.sync's int8 rate on Hopper, which
// measured ~0.5 POPS on this card (its frame_min mode, whose
// epilogue is one max per pair, sits at that floor), and a call of four
// launches and a memset. This form:
// - Products: wgmma.m64n128k32 s8·s8 -> s32, the only route to the card's
//   full int8 rate. The corpus rows are A, from registers: each warp of a
//   warpgroup builds the fragments of its 16 rows straight from the packed
//   words (4 bits -> 4 ±1 bytes through a 16-entry table in shared
//   memory). The query chunk (<= 128 rows) is B, unpacked once per CTA into
//   shared memory in wgmma's no-swizzle core-matrix layout (8 rows x 16
//   bytes per core matrix).
// - Persistent grid: CTAs of one warpgroup, as many as fit on the card at
//   once (the occupancy API: on the H100, 3 per SM for the argmin modes
//   and 4 for frame_min, so that one's epilogue runs while another's wgmma
//   does; tvz_corpus_scan_tc_grid reports the grid), each owning a
//   contiguous range of 256-row tiles that it walks in ASCENDING order,
//   one wgmma pair per 64 rows. Within a thread a later row never wins a
//   tie, so a running best with strict improvement keeps the first index. For M > 128 a CTA walks
//   its range again per chunk (the range is in L2).
// - Corpus in flight: packed rows of 4 W bytes come through a cp.async
//   ring in shared memory: 6 tiles at W = 2, else as many 1 KB-W tiles as
//   fit in 32 KB (2 to 6). The query chunk takes 32 W bytes a query (32 KB
//   at W = 8), so the grid (occupancy) is asked per W.
// - Epilogues on the CUDA cores, per thread 2 corpus rows x 32 queries:
//   frame_min: a row max with the DPX __vimax3_s32 (two pairs an
//   instruction), two shuffles, one store per row;
//   argmin (kFull, kFullCols, kTwoPhase, kQueryNearest): per thread and
//   query column a running best KEY, (dot + 32 W) / 2 << shift | (low -
//   row offset in the CTA's range) (KeyForm: shift = 25, low = 2^25 - 1 at
//   W = 2; 23 at W = 8): the largest dot, then the first row. A
//   pair's key is one multiply-add from its dot and one DPX __vimax3_u32
//   folds two pairs into the running key, so a strict improvement is
//   found with no compare, branch or vote at all: kTwoPhase's gate became
//   the key's order, and it runs kFull's code. kFullCols takes the winning
//   row from the (N,) table (which holds 0..N-1) where the other modes
//   compute it: the TPU kernel's hoisted iota. A range holds fewer than
//   low rows (2^23 - 1 at W = 8: N < 2^31 on 132 SMs needs ~1.6 x 10^7 at
//   one CTA an SM; a W-word corpus that fits the card's memory never comes
//   near it).
// - Masking: in the last tile only, rows past N get dot -32 W and key 0,
//   so they can neither win nor be stored.
// - W != 2: the A fragments of kGroupW = 4 k-steps at a time (a wait
//   between groups keeps their registers few).
// - W > kMaxWords (TVIDZ_HASH_SIZE >= 40 at TVIDZ_DCT_SIZE=64: 50 to
//   128 words): the query chunk of every word and a ring of such rows do
//   not fit a block's shared memory, so the rows walk their words in
//   chunks of kChunkW = 16. Per 64-row wgmma, each chunk's words of the
//   128 queries are unpacked into shared memory (64 KB) and the corpus
//   words come straight from global memory (L1/L2) into the A fragments;
//   the dot accumulates across the chunks in the wgmma accumulators, and
//   the epilogue (min, key) sees only the whole dot. The key then leaves
//   fewer bits to the row offset (19 at W = 128: 524,287 rows a range),
//   so the grid grows past the resident CTAs where a range would hold
//   more rows than that (they run in waves; the combine does not care).
// - One combine: per (CTA, query) one 64-bit atomicMin of
//   (dist << 32 | row) into a workspace of keys, exact with ties across
//   CTAs; the last CTA to finish (an atomic ticket) turns the keys into
//   q_min / q_arg, resets them to all ones and resets the ticket, so the
//   workspace is ready for the next call on the stream. One launch a call.
// What bounds it now: the epilogue's integer work. Hopper issues 64 INT32
// operations per clock per SM; the argmin epilogue is 1.5 of them per pair
// (two multiply-adds and a three-way max per two pairs), frame_min's 0.5,
// which at M=128, N=2^24 is as long as the products or longer. A key in 16
// bits, two to a register (DPX's 16x2 forms), is the next lever.
// Resources: chip_smoke.py's build phase prints ptxas's registers and
// spills for every instance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFull = 0;
constexpr int kFullCols = 1;
constexpr int kTwoPhase = 2;
constexpr int kFrameMin = 3;
constexpr int kQueryNearest = 4;

constexpr int kThreads = 128;                // one warpgroup
constexpr int kTileN = 256;                  // rows per tile (ring stage)
constexpr int kSubs = kTileN / 64;           // wgmma m64 per tile
constexpr int kQChunk = 128;                 // queries held at a time (wgmma N)
constexpr int kCols = kQChunk / 4;           // query columns per thread
constexpr unsigned long long kNoKey = ~0ull;
constexpr int kMaxSmem = 232448;             // a block's shared memory on Hopper
constexpr int kStaticSmem = 2048;            // s_key, s_pm1, s_last (rounded up)
// The widest rows: the query chunk and a 2-tile ring in shared memory.
constexpr int kMaxWords = (kMaxSmem - kStaticSmem) / (kQChunk * 32 + 2 * kTileN * 4);
// Wider rows (FW = -1) hold kChunkW words of the query chunk at a time.
constexpr int kChunkW = 16;
// The widest rows at all: the key keeps a row field of at least 9 bits
// (a 256-row tile in a range), so bits(32 W) <= 23.
constexpr int kMaxKeyWords = (1 << 18) - 1;

// Bits 4i .. 4i+3 (MSB-first) of a packed word as 4 ±1 bytes (set -> +1):
// one entry of a 16-entry table in shared memory, indexed by the nibble.
__device__ __forceinline__ int nibble_index(uint32_t w, int i) {
  return (w >> (28 - 4 * i)) & 0xf;
}

__device__ __forceinline__ int pm1_entry(int n) {    // the table's entry n
  int v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) v |= ((n >> (3 - j)) & 1 ? 0x01 : 0xff) << (8 * j);
  return v;
}

// Byte offset of (query r, bit k) in the no-swizzle core-matrix layout:
// core matrices of 8 queries x 16 bytes, 128 bytes apart along k (LBO) and
// sbo = 256 W bytes apart along the queries (SBO).
__device__ __forceinline__ int q_offset(int r, int k, unsigned sbo) {
  return (r >> 3) * sbo + (k >> 4) * 128 + (r & 7) * 16 + (k & 15);
}

// wgmma shared-memory descriptor: start >> 4, LBO and SBO in 16-byte
// units, no swizzle.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned sbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 corpus rows x 128 queries, s32) = A (registers) x B (descriptor),
// plus d when scale_d.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], const int (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Pins the accumulators at this point of the program: wgmma writes them
// asynchronously, so no read may move above the wait before it.
__device__ __forceinline__ void fence_operands(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The running key of a (query, row) pair, (dot + 32 W) / 2 << kShift |
// (kLow - row offset): dot + 32 W = 2 (32 W - hamming) is even, so its
// half, 32 W - hamming, takes bits(32 W) bits and the row offset the rest.
// One multiply-add from the dot: dot * 2^(kShift - 1) + kBase + low.
struct KeyForm {
  int shift;          // 32 - bits(32 W): 25 at W = 2, 23 at W = 8
  unsigned low;       // 2^shift - 1: a range holds at most low - 1 rows
  unsigned mul;       // 2^(shift - 1)
  unsigned base;      // 32 W << (shift - 1)
};

__host__ __device__ __forceinline__ KeyForm key_form(int W) {
  int bits = 0;
  while ((32 * W) >> bits) ++bits;
  KeyForm k;
  k.shift = 32 - bits;
  k.low = (1u << k.shift) - 1u;
  k.mul = 1u << (k.shift - 1);
  k.base = (unsigned)(32 * W) << (k.shift - 1);
  return k;
}

// Corpus tiles in the ring: 6 at W = 2; otherwise as many of 1,024 W bytes
// as fit in 32 KB, 2 to 6.
__host__ __device__ __forceinline__ int ring_stages(int W) {
  if (W == 2) return 6;
  const int n = 32 * 1024 / (kTileN * 4 * W);
  return n < 2 ? 2 : (n > 6 ? 6 : n);
}

// Dynamic shared memory: the unpacked query chunk (32 W bytes a query),
// then the corpus ring; past kMaxWords, kChunkW words of the query chunk.
__host__ __device__ __forceinline__ size_t scan_smem(int W) {
  if (W > kMaxWords) return (size_t)kQChunk * 32 * kChunkW;
  return (size_t)kQChunk * 32 * W + (size_t)ring_stages(W) * kTileN * 4 * W;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// cp.async.wait_group with a pending count known only at run time (0..4).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// FW = 2: the production instance, 64-bit rows, every size fixed at
// compile time. FW = 0: any W <= kMaxWords at run time, rows of W words,
// the query A fragments kGroupW k-steps at a time. FW = -1: W >
// kMaxWords, the words walked in chunks of kChunkW (header note).
template <int MODE, int FW>
__global__ void __launch_bounds__(kThreads, FW == 2 ? 3 : 2)
corpus_scan_kernel(const uint32_t* __restrict__ q, int M,
                   const uint32_t* __restrict__ corpus, int N, int Wrt,
                   int tiles, const int32_t* __restrict__ rows,
                   int32_t* __restrict__ frame_min,
                   unsigned long long* __restrict__ keys,
                   unsigned* __restrict__ ticket,
                   int32_t* __restrict__ q_min, int32_t* __restrict__ q_arg) {
  constexpr bool kFmin = MODE != kQueryNearest;
  constexpr bool kArg = MODE != kFrameMin;
  constexpr int kGroupW = FW == 2 ? 2 : 4;     // k-steps per wgmma group
  constexpr bool kChunked = FW < 0;
  const int W = FW > 0 ? FW : Wrt;
  const int Wq = kChunked ? kChunkW : W;       // query words in shared memory
  const int stages = kChunked ? 2 : ring_stages(W);
  const KeyForm kf = key_form(W);
  const int dot_min = -32 * W;                 // every bit differs

  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* s_q = reinterpret_cast<int8_t*>(smem);                 // kQChunk x 32 Wq
  uint32_t* s_ring = reinterpret_cast<uint32_t*>(smem + kQChunk * 32 * Wq);
  __shared__ unsigned long long s_key[kQChunk];
  __shared__ int s_pm1[16];
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // This thread's two corpus rows of each wgmma: r_lo and r_lo + 8 of the
  // tile, r_lo = sub * 64 + (warp's 16) + g.
  const int r_warp = warp * 16 + g;
  const int tile_begin = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int ntiles =
      (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x) - tile_begin;
  const int range_base = tile_begin * kTileN;    // < 2^31 (launch)
  const unsigned q_addr = (unsigned)__cvta_generic_to_shared(s_q);
  const unsigned sbo = 256u * Wq;                // bytes between 8-query groups

  // Words c0 .. c0 + wc - 1 of the chunk's queries as ±1 rows, one row a
  // thread; rows past M repeat the chunk's first (a duplicate never
  // changes a minimum, and its key is never stored).
  auto stage_q = [&](int q0, int qn, int c0, int wc) {
    const int r = tid;                   // kThreads == kQChunk
    const uint32_t* qr = q + (size_t)(q0 + (r < qn ? r : 0)) * W + c0;
    for (int w = 0; w < wc; ++w) {
      const uint32_t word = qr[w];
#pragma unroll
      for (int part = 0; part < 8; ++part)
        *reinterpret_cast<int*>(s_q + q_offset(r, 32 * w + 4 * part, sbo)) =
            s_pm1[nibble_index(word, part)];
    }
  };

  if (tid < 16) s_pm1[tid] = pm1_entry(tid);
  for (int q0 = 0; q0 < M; q0 += kQChunk) {
    const int qn = min(kQChunk, M - q0);
    __syncthreads();                     // the table is set; the last chunk's
                                         // smem reads are done
    if (!kChunked) stage_q(q0, qn, 0, W);
    if (kArg)
      for (int m = tid; m < kQChunk; m += kThreads) s_key[m] = kNoKey;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // Running best per query column 8c + 2t + j (index 2c + j), as a key
    // (KeyForm): the largest dot, then the first row; 0 before any row.
    unsigned best[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) best[i] = 0;

    // The epilogue of one wgmma: rows r_lo and r_lo + 8 of a tile.
    auto epilogue = [&](int (&acc)[64], long long tile_base, int r_lo) {
      const int row_lo = (int)tile_base + r_lo, row_hi = row_lo + 8;
      const bool ok_lo = row_lo < N, ok_hi = row_hi < N;
      if (tile_base + kTileN > N) {      // the last tile: rows past N
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          acc[4 * c] = ok_lo ? acc[4 * c] : dot_min;
          acc[4 * c + 1] = ok_lo ? acc[4 * c + 1] : dot_min;
          acc[4 * c + 2] = ok_hi ? acc[4 * c + 2] : dot_min;
          acc[4 * c + 3] = ok_hi ? acc[4 * c + 3] : dot_min;
        }
      }
      if (kFmin) {
        // Four independent chains per row, then their max: a short
        // dependency path.
        int lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) lo[c] = acc[4 * c], hi[c] = acc[4 * c + 2];
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          lo[c & 3] = __vimax3_s32(lo[c & 3], acc[4 * c], acc[4 * c + 1]);
          hi[c & 3] = __vimax3_s32(hi[c & 3], acc[4 * c + 2], acc[4 * c + 3]);
        }
        int m_lo = max(__vimax3_s32(lo[0], lo[1], lo[2]), lo[3]);
        int m_hi = max(__vimax3_s32(hi[0], hi[1], hi[2]), hi[3]);
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          m_lo = max(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, x));
          m_hi = max(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, x));
        }
        const int row = t == 0 ? row_lo : row_hi;
        if (t < 2 && row < N) {
          int fm = (32 * W - (t == 0 ? m_lo : m_hi)) >> 1;
          // Later chunks: the same thread stored this row before.
          if (q0 > 0) fm = min(fm, frame_min[row]);
          frame_min[row] = fm;
        }
      }
      if (kArg) {
        // A pair's key is one multiply-add from its dot; a masked row's
        // (dot -32 W, no row bits) is 0 and never wins.
        const unsigned k_lo = ok_lo ? kf.base | (kf.low - (row_lo - range_base)) : kf.base;
        const unsigned k_hi = ok_hi ? kf.base | (kf.low - (row_hi - range_base)) : kf.base;
#pragma unroll
        for (int c = 0; c < 16; ++c)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            best[2 * c + j] = __vimax3_u32(best[2 * c + j],
                                           (unsigned)acc[4 * c + j] * kf.mul + k_lo,
                                           (unsigned)acc[4 * c + 2 + j] * kf.mul + k_hi);
      }
    };

    auto issue = [&](int i) {            // tile i of the range into the ring
      if (i < ntiles) {
        const long long r0 = (long long)(tile_begin + i) * kTileN;
        uint32_t* slot = s_ring + (size_t)(i % stages) * kTileN * W;
        if (FW == 2) {
#pragma unroll
          for (int k = 0; k < kTileN / kThreads; ++k) {
            const int c = k * kThreads + tid;
            const long long r = r0 + c;
            cp_async8(slot + 2 * c, corpus + 2 * (r < N ? r : N - 1));
          }
        } else {
          // The tile's words are contiguous; words of rows past N come
          // from row 0 of the tile (masked in the epilogue).
          const long long valid = ((long long)N - r0) * W;
          for (int c = tid; c < kTileN * W; c += kThreads)
            cp_async4(slot + c, corpus + r0 * W + (c < valid ? c : 0));
        }
      }
      cp_async_commit();
    };
    int acc[64];
    if (kChunked) {
      // The word-chunked walk: per 64-row wgmma, each chunk's query words
      // into shared memory, the rows' words from global memory, the dot
      // accumulated across chunks; the epilogue on the whole dot.
      for (int i = 0; i < ntiles; ++i) {
        const long long tile_base = (long long)(tile_begin + i) * kTileN;
#pragma unroll 1
        for (int sub = 0; sub < kSubs; ++sub) {
          const int r_lo = r_warp + sub * 64;
          // Rows past N read row N - 1 (masked in the epilogue).
          const uint32_t* c_lo = corpus + min(tile_base + r_lo, (long long)N - 1) * W;
          const uint32_t* c_hi = corpus + min(tile_base + r_lo + 8, (long long)N - 1) * W;
#pragma unroll 1
          for (int c0 = 0; c0 < W; c0 += kChunkW) {
            const int wc = min(kChunkW, W - c0);
            __syncthreads();             // the last chunk's products read s_q
            stage_q(q0, qn, c0, wc);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncthreads();
#pragma unroll 1
            for (int w0 = 0; w0 < wc; w0 += kGroupW) {
              int a[kGroupW][4];
#pragma unroll
              for (int s = 0; s < kGroupW; ++s) {
                const int w = c0 + (w0 + s < wc ? w0 + s : w0);
                const uint32_t w_lo = __ldg(c_lo + w), w_hi = __ldg(c_hi + w);
                a[s][0] = s_pm1[nibble_index(w_lo, t)];
                a[s][1] = s_pm1[nibble_index(w_hi, t)];
                a[s][2] = s_pm1[nibble_index(w_lo, 4 + t)];
                a[s][3] = s_pm1[nibble_index(w_hi, 4 + t)];
              }
              fence_operands(acc);
              wgmma_fence();
#pragma unroll
              for (int s = 0; s < kGroupW; ++s)
                if (w0 + s < wc)         // the same in every thread
                  wgmma_m64n128k32(acc, a[s], smem_desc(q_addr + 256 * (w0 + s), sbo),
                                   c0 + w0 + s > 0);
              wgmma_commit();
              wgmma_wait<0>();
              fence_operands(acc);
            }
          }
          epilogue(acc, tile_base, r_lo);
        }
      }
    }
    if (!kChunked)
      for (int s = 0; s < stages - 1; ++s) issue(s);
    for (int i = 0; i < (kChunked ? 0 : ntiles); ++i) {
      if (FW == 2) cp_async_wait<4>();   // stages - 2
      else cp_async_wait_n(stages - 2);
      __syncthreads();                   // tile i landed; tile i-1 was read
      issue(i + stages - 1);
      const long long tile_base = (long long)(tile_begin + i) * kTileN;
      const uint32_t* slot = s_ring + (size_t)(i % stages) * kTileN * W;
#pragma unroll
      for (int sub = 0; sub < kSubs; ++sub) {
        const int r_lo = r_warp + sub * 64;
        // k-steps w0 .. w0 + kGroupW - 1: word w of both rows per step.
        for (int w0 = 0; w0 < W; w0 += kGroupW) {
          int a[kGroupW][4];
          unsigned long long v_lo = 0, v_hi = 0;
          if (FW == 2) {                 // one 8-byte load a row
            v_lo = reinterpret_cast<const unsigned long long*>(slot)[r_lo];
            v_hi = reinterpret_cast<const unsigned long long*>(slot)[r_lo + 8];
          }
#pragma unroll
          for (int s = 0; s < kGroupW; ++s) {
            const int w = w0 + s < W ? w0 + s : w0;
            const uint32_t w_lo = FW == 2 ? (uint32_t)(v_lo >> (32 * s)) : slot[r_lo * W + w];
            const uint32_t w_hi = FW == 2 ? (uint32_t)(v_hi >> (32 * s)) : slot[(r_lo + 8) * W + w];
            a[s][0] = s_pm1[nibble_index(w_lo, t)];
            a[s][1] = s_pm1[nibble_index(w_hi, t)];
            a[s][2] = s_pm1[nibble_index(w_lo, 4 + t)];
            a[s][3] = s_pm1[nibble_index(w_hi, 4 + t)];
          }
          fence_operands(acc);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < kGroupW; ++s)
            if (w0 + s < W)              // the same in every thread
              wgmma_m64n128k32(acc, a[s], smem_desc(q_addr + 256 * (w0 + s), sbo),
                               w0 + s > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(acc);
        }
        epilogue(acc, tile_base, r_lo);
      }
    }
    cp_async_wait<0>();

    if (kArg) {
      // The thread's best per query -> the CTA's per query -> the keys.
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        unsigned long long k = kNoKey;
        if (best[i] != 0) {
          const int dist = 32 * W - (int)(best[i] >> kf.shift);
          int r = range_base + (int)(kf.low - (best[i] & kf.low));
          if (MODE == kFullCols) r = rows[r];
          k = ((unsigned long long)dist << 32) | (unsigned)r;
        }
#pragma unroll
        for (int x = 4; x <= 16; x <<= 1) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, k, x);
          k = o < k ? o : k;
        }
        if (g == 0 && k != kNoKey) atomicMin(&s_key[8 * (i >> 1) + 2 * t + (i & 1)], k);
      }
      __syncthreads();
      for (int m = tid; m < qn; m += kThreads)
        if (s_key[m] != kNoKey) atomicMin(&keys[q0 + m], s_key[m]);
    }
  }

  if (kArg) {
    // The last CTA to finish turns the keys into (q_min, q_arg) and leaves
    // the workspace as it found it.
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      for (int m = tid; m < M; m += kThreads) {
        const unsigned long long k = atomicExch(&keys[m], kNoKey);
        q_min[m] = (int32_t)(k >> 32);
        q_arg[m] = (int32_t)(k & 0xffffffffull);
      }
      if (tid == 0) atomicExch(ticket, 0u);
    }
  }
}

template <int MODE, int FW>
const void* kernel_of() {
  return (const void*)corpus_scan_kernel<MODE, FW>;
}

// The instance a call of W-word rows launches.
template <int MODE>
const void* instance_for(int W) {
  return W == 2 ? kernel_of<MODE, 2>()
                : (W <= kMaxWords ? kernel_of<MODE, 0>() : kernel_of<MODE, -1>());
}

// Devices whose grids are cached (a device past them asks every call).
constexpr int kCachedDevices = 16;

// The grid for an N-row corpus of W-word rows on the current device: as
// many CTAs as fit on the card at once (the occupancy API, asked once per
// device, mode and W; one slot for every chunked W), at most one per tile,
// and more where a range would hold more rows than the key's row field
// (wide W on a large corpus: the extra CTAs run in waves). Where W needs
// more than 48 KB of shared memory the instance opts in to the most a
// block may have, so that a narrower W asked later never lowers the limit
// under a wider one's launches. The opt-in holds for one device only, so
// each device makes its own.
template <int MODE>
cudaError_t grid_for(int N, int W, int* grid) {
  static int ctas_by_w[kCachedDevices][kMaxWords + 1];   // a benign race
  const size_t smem = scan_smem(W);
  if (W < 1 || W > kMaxKeyWords || smem + kStaticSmem > (size_t)kMaxSmem)
    return cudaErrorInvalidValue;
  int dev = 0, uncached = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int& ctas_slot = dev < kCachedDevices ? ctas_by_w[dev][W <= kMaxWords ? W : 0]
                                        : uncached;
  if (ctas_slot == 0) {
    const void* fn = instance_for<MODE>(W);
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem - kStaticSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    if (e != cudaSuccess) return e;
    ctas_slot = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int ctas = ctas_slot;
  const int tiles = (int)(((long long)N + kTileN - 1) / kTileN);
  // A running key holds a row of its CTA's range below key_form(W).low.
  const long long range_tiles = ((long long)key_form(W).low - 1) / kTileN;
  const long long need = (tiles + range_tiles - 1) / range_tiles;
  long long g = tiles < ctas ? tiles : ctas;
  *grid = (int)(g < need ? need : g);
  return cudaSuccess;
}

template <int MODE>
cudaError_t launch(const uint32_t* q, int M, const uint32_t* corpus, int N,
                   int W, const int32_t* rows, int32_t* frame_min,
                   unsigned long long* keys, unsigned* ticket, int32_t* q_min,
                   int32_t* q_arg, cudaStream_t s) {
  int grid = 0;
  const cudaError_t e = grid_for<MODE>(N, W, &grid);
  if (e != cudaSuccess) return e;
  const int tiles = (int)(((long long)N + kTileN - 1) / kTileN);
  const size_t smem = scan_smem(W);
  if (W == 2)
    corpus_scan_kernel<MODE, 2><<<grid, kThreads, smem, s>>>(
        q, M, corpus, N, W, tiles, rows, frame_min, keys, ticket, q_min, q_arg);
  else if (W <= kMaxWords)
    corpus_scan_kernel<MODE, 0><<<grid, kThreads, smem, s>>>(
        q, M, corpus, N, W, tiles, rows, frame_min, keys, ticket, q_min, q_arg);
  else
    corpus_scan_kernel<MODE, -1><<<grid, kThreads, smem, s>>>(
        q, M, corpus, N, W, tiles, rows, frame_min, keys, ticket, q_min, q_arg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tvz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (M, W) and corpus (N, W) packed int32 rows, W in [1, kMaxKeyWords]; rows
// (N,) int32 table (mode 1 only, else null); frame_min (N,) int32 (modes
// 0-3, else null); keys (>= M,) uint64 workspace holding all ones and
// ticket one uint32 holding 0 (modes 0-2 and 4; both are left so again);
// q_min and q_arg (M,) int32 (modes 0-2 and 4, else null). mode: 0 full,
// 1 full_cols, 2 twophase, 3 frame_min, 4 query_nearest.
int tvz_corpus_scan_tc(const void* q, int M, const void* corpus, int N, int W,
                       const void* rows, int mode, void* frame_min,
                       void* keys, void* ticket, void* q_min, void* q_arg,
                       void* stream) {
  if (M <= 0 || M > 16384 || N <= 0 || W < 1 || W > kMaxKeyWords || mode < 0 ||
      mode > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* qq = (const uint32_t*)q;
  const uint32_t* c = (const uint32_t*)corpus;
  const int32_t* r = (const int32_t*)rows;
  int32_t* f = (int32_t*)frame_min;
  unsigned long long* k = (unsigned long long*)keys;
  unsigned* tk = (unsigned*)ticket;
  int32_t* mn = (int32_t*)q_min;
  int32_t* ag = (int32_t*)q_arg;
  switch (mode) {
    case kFull: return (int)launch<kFull>(qq, M, c, N, W, r, f, k, tk, mn, ag, s);
    case kFullCols: return (int)launch<kFullCols>(qq, M, c, N, W, r, f, k, tk, mn, ag, s);
    case kTwoPhase: return (int)launch<kTwoPhase>(qq, M, c, N, W, r, f, k, tk, mn, ag, s);
    case kFrameMin: return (int)launch<kFrameMin>(qq, M, c, N, W, r, f, k, tk, mn, ag, s);
    default: return (int)launch<kQueryNearest>(qq, M, c, N, W, r, f, k, tk, mn, ag, s);
  }
}

// The grid (CTA count) a call of this mode launches for an N-row corpus of
// W-word rows on the current device, into *grid; launches nothing.
int tvz_corpus_scan_tc_grid(int mode, int N, int W, int* grid) {
  if (N <= 0 || mode < 0 || mode > 4 || grid == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kFull: return (int)grid_for<kFull>(N, W, grid);
    case kFullCols: return (int)grid_for<kFullCols>(N, W, grid);
    case kTwoPhase: return (int)grid_for<kTwoPhase>(N, W, grid);
    case kFrameMin: return (int)grid_for<kFrameMin>(N, W, grid);
    default: return (int)grid_for<kQueryNearest>(N, W, grid);
  }
}

}  // extern "C"
