// K3 — fragment alignment on the int8 tensor cores: Q packed query
// sequences against a bucket of V corpus sequences, best temporal offset of
// each query in each video. Rows of W 32-bit words, in one of three forms
// that the C entry point picks by W (ops/align.py k3_form mirrors it):
// - "bands", fragment_search_kernel, W = 2 (the default 64-bit pHash): a
//   CTA a (query, video, band of 128 offsets); the design below.
// - "tiles", fragment_search_tiles_kernel, W = 1 and 3 to kMaxWords (23;
//   phash256: W = 8): a CTA a (video, band of diagonals of up to the whole
//   row, group of queries), the Hamming matrix cut into 64 x 256 tiles
//   (64 x 128 past 8 words, 64 x 64 past 16), each pair multiplied about
//   once; its note, below.
// - "chunked", fragment_search_chunked_kernel, wider rows
//   (TVIDZ_HASH_SIZE=32 at the default dct_size, 50 to 128 words at
//   TVIDZ_DCT_SIZE=64): the band form's walk with the words in chunks (its
//   note, below).
//
// Replaces tvidz_tpu/ops/align_pallas.py::_fragment_kernel (wrappers
// fragment_search_pallas_batch / fragment_search_pallas); the contract is
// ops/align.fragment_core's, exactly:
//   score[q, v, o] = #{ t < q_len[q] : 0 <= t+o < len[v],
//                       popcount(qs[q, t] ^ corpus[v, t+o]) <= thr }
//   for o in [-(Tq_pad-1), Tc-1], d = o + Tq_pad - 1 the score row index;
//   scores[q, v] = max_o score,  offs[q, v] = the FIRST o attaining it
// (an all-zero row reports -(Tq_pad-1)). Counts are int32 throughout.
//
// What it computes is what the TPU kernel computed (align_pallas.py:91-196):
// ±1 products, a threshold, anti-diagonal counts and a first-index argmax.
// What bounds it on the H100: the work is q_len x len[v] 64-bit
// comparisons per (query, video), 805 M pairs at (Q, Tq_pad, V, Tc) =
// (1, 768, 1024, 1024), against 8 MB of corpus: operations, not bytes. As
// 64-term ±1 int8 dots that is 0.052 ms at 1,979 TOPS. The popcount form
// this kernel replaced (one offset per thread, XOR and two POPC per pair)
// cannot go below ~0.385 ms: POPC issues at 16 per clock per SM;
// an mma.sync form of this design measured no faster than it (mma.sync's
// int8 rate on Hopper is ~0.5 POPS). The band form:
// - A CTA (one warpgroup) owns one (query q, video v, band of kBand = 128
//   offsets). It walks the query rows in tiles of 64, taking only the rows
//   that can touch the band; a tile needs the corpus window
//   [t0 + o0, t0 + o0 + 64 + kBand - 1). The first tile starts early enough
//   that t0 + o0 is a multiple of 64 (rows before the band's are masked).
// - The window lives in shared memory as unpacked ±1 rows in a 256-row
//   ring laid out in wgmma's no-swizzle core matrices (8 rows x 16 bytes);
//   consecutive windows overlap by kBand rows, so a tile unpacks only 64
//   new rows. With the 64-row alignment each 64-row piece of the window is
//   8 whole groups of the ring and never wraps. While a tile's products
//   run, the next tile's 64 new window rows are unpacked into the ring
//   (rows the products do not read: ring = window + 64) and its A
//   fragments built, from packed rows (8 bytes each) that came in by
//   cp.async one tile earlier.
// - Products: three wgmma.m64n64k32 s8·s8 -> s32 pairs per tile, the
//   query rows as A from registers (built from the packed words: 4 bits ->
//   4 ±1 bytes through a 16-entry table in shared memory), the window
//   pieces as B from shared memory, one 64-row piece at a time: with 32
//   accumulators six CTAs fit on an SM and their phases overlap (with all
//   96 at once only three fit, and the kernel ran slower). Computing
//   the 64 x 192 block where the band needs 64 x 128 spends a third more
//   products; the tensor cores have that headroom.
// - The threshold: hamming <= thr  <=>  dot >= 32 W - 2 thr. wgmma starts its
//   accumulators at zero for free (a preset start would cost a move per
//   accumulator), so the gate is a DPX three-way max over a piece's 32
//   accumulators (half an instruction a pair) compared once with
//   64 - 2 thr, and one warp vote skips the piece when no pair matched: the
//   CUDA form of the TPU kernel's hit gate. On random hashes almost every
//   piece is skipped.
// - Counting: a matched pair inside the band and the valid rows
//   (0 <= t < q_len, 0 <= j < len[v], checked only for matched pairs) adds
//   one to a shared diagonal counter. Where a warp's whole 16 x 64 block
//   matched (a DPX min and a second vote, taken only past the first), as in
//   a static or black scene, the counts are known without looking at the
//   pairs: inside the valid rows the block adds the same trapezoid of
//   counts wherever it sits, so a shared counter per warp and piece counts
//   such blocks and the CTA adds the trapezoids once at its end; at an
//   edge each diagonal gains its overlap with the block's valid rows, 3
//   shared adds a lane. A shared atomic per pair would serialize a whole
//   scene on the counters.
// - Result: the band's max and first-index argmax as one 64-bit key
//   (score << 32 | 0x7fffffff - d) and one global atomicMax per (q, v,
//   band): exact across bands. Keys start at the all-zero row's answer
//   (score 0, d 0), so a band with no match issues none.
// Launches a call: set the keys, the scan, unpack the keys into (offs,
// scores). Resources (nvcc 12.8 -Xptxas -v): the scan 72 registers and
// 19,088 bytes of static shared memory, no spills; the two small kernels
// 10 and 14 registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;           // one warpgroup
constexpr int kBand = 128;              // offsets per CTA
constexpr int kTileT = 64;              // query rows per step (wgmma M)
constexpr int kPieces = 3;              // 64-row window pieces (wgmma N = 64)
constexpr int kWin = kPieces * 64;      // window rows (>= kTileT + kBand - 1)
constexpr int kRing = 256;              // ring rows (a power of two >= kWin)
constexpr int kCtasPerSm = 6;           // resident CTAs an SM should hold
constexpr unsigned long long kZeroKey = 0x7fffffffull;   // score 0 at d = 0

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

// Byte offset of (corpus row j, bit k) in the ring: core matrices of 8 rows
// x 16 bytes, 128 bytes apart along k (LBO), 512 bytes apart along the rows
// (SBO), row j in group (j / 8) mod 32.
__device__ __forceinline__ int ring_offset(int j, int k) {
  return ((j >> 3) & (kRing / 8 - 1)) * 512 + (k >> 4) * 128 + (j & 7) * 16 + (k & 15);
}

// wgmma shared-memory descriptor: start >> 4, LBO and SBO in 16-byte
// units, no swizzle.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32);
}

// d (64 query rows x 64 window rows, s32) = A (registers) x B (descriptor),
// plus d when scale_d.
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], const int (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__global__ void init_keys_kernel(unsigned long long* __restrict__ keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = kZeroKey;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
fragment_search_kernel(const uint32_t* __restrict__ qs,
                       const int32_t* __restrict__ q_lens, int Tq_pad,
                       const uint32_t* __restrict__ corpus,
                       const int32_t* __restrict__ lens, int V, int Tc,
                       int thr, int bands,
                       unsigned long long* __restrict__ keys) {
  __shared__ __align__(128) int8_t s_c[kRing * 64];
  // Per tile, packed: its 64 new window rows [0] and 64 query rows [1].
  __shared__ __align__(16) uint64_t s_stage[2][2][kTileT];
  __shared__ int s_cnt[kBand];
  // Per warp and piece, its 16 x 64 blocks that matched whole inside the
  // valid rows: they all add the same counts, once, at the end.
  __shared__ int s_whole[kThreads / 32][kPieces];
  __shared__ int s_pm1[16];
  __shared__ unsigned long long s_warp[kBand / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qi = blockIdx.y;
  const int v = blockIdx.x / bands;
  const int d0 = (blockIdx.x % bands) * kBand;
  const int o0 = d0 - (Tq_pad - 1);         // the band's first offset
  const int q_len = min(max(q_lens[qi], 0), Tq_pad);
  const int c_len = min(max(lens[v], 0), Tc);
  const uint32_t* qrow = qs + (size_t)qi * Tq_pad * 2;
  const uint32_t* crow = corpus + (size_t)v * Tc * 2;

  // Rows some offset of the band can use: t + o0 + kBand - 1 >= 0,
  // t + o0 < c_len, t < q_len.
  const int t_begin = max(0, -(o0 + kBand - 1));
  const int t_end = min(q_len, c_len - o0);
  if (t_begin >= t_end) return;             // the whole CTA: nothing to count

  s_cnt[tid] = 0;                           // kThreads == kBand
  if (tid < kThreads / 32 * kPieces) (&s_whole[0][0])[tid] = 0;
  if (tid < 16) s_pm1[tid] = pm1_entry(tid);
  const int thr_dot = 64 - 2 * thr;         // a match: dot >= thr_dot
  const unsigned c_addr = (unsigned)__cvta_generic_to_shared(s_c);
  const uint2* cpk = reinterpret_cast<const uint2*>(crow);
  const uint2* qpk = reinterpret_cast<const uint2*>(qrow);

  // Parts p0 .. p0+n-1 of window row j (packed w) into the ring, zero
  // outside the video.
  auto put = [&](int j, uint2 w, int p0, int n) {
    const bool ok = j >= 0 && j < c_len;
#pragma unroll
    for (int part = p0; part < p0 + n; ++part)
      *reinterpret_cast<int*>(s_c + ring_offset(j, 4 * part)) =
          ok ? s_pm1[nibble_index(part < 8 ? w.x : w.y, part & 7)] : 0;
  };
  // Tile at t0 into stage buffer b: its last 64 window rows (the ones the
  // previous tile did not have) and its 64 query rows, by cp.async.
  auto stage = [&](int t0, int b) {
    const int j = t0 + o0 + kWin - kTileT + tid, t = t0 + tid - kTileT;
    if (tid < kTileT) {
      if (j >= 0 && j < c_len) cp_async8(&s_stage[b][0][tid], cpk + j);
    } else if (t >= 0 && t < q_len) {
      cp_async8(&s_stage[b][1][tid - kTileT], qpk + t);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // Stage buffer b (tile t0) into the ring (its 64 new window rows) and
  // into A fragments: query rows t0 + 16 warp + g and + 8, zero outside
  // [0, q_len).
  auto take = [&](int b, int t0, int (&a)[2][4]) {
    {                                        // two threads a staged row
      const int r = tid >> 1;
      const uint64_t w = s_stage[b][0][r];
      put(t0 + o0 + kWin - kTileT + r, make_uint2((uint32_t)w, (uint32_t)(w >> 32)),
          8 * (tid & 1), 8);
    }
    const int r_a = 16 * warp + g, t_a = t0 + r_a, t_b = t_a + 8;
    const bool ok_a = t_a >= 0 && t_a < q_len, ok_b = t_b >= 0 && t_b < q_len;
    const uint64_t qa = s_stage[b][1][r_a], qb = s_stage[b][1][r_a + 8];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint32_t wa = (uint32_t)(qa >> (32 * s)), wb = (uint32_t)(qb >> (32 * s));
      a[s][0] = ok_a ? s_pm1[nibble_index(wa, t4)] : 0;
      a[s][1] = ok_b ? s_pm1[nibble_index(wb, t4)] : 0;
      a[s][2] = ok_a ? s_pm1[nibble_index(wa, 4 + t4)] : 0;
      a[s][3] = ok_b ? s_pm1[nibble_index(wb, 4 + t4)] : 0;
    }
  };

  const int t_first = t_begin - (((t_begin + o0) % 64) + 64) % 64;
  __syncthreads();                          // the table is set
  {
    // The first window's rows before the staged ones, one a thread.
    const int j = t_first + o0 + tid;       // kWin - kTileT == kThreads rows
    put(j, (j >= 0 && j < c_len) ? cpk[j] : make_uint2(0, 0), 0, 16);
  }
  stage(t_first, 0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  int a_cur[2][4], a_next[2][4];
  take(0, t_first, a_cur);
  if (t_first + kTileT < t_end) stage(t_first + kTileT, 1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // Per tile: the products run while the next tile's rows are unpacked
  // into the ring (rows the products do not read) and the one after is
  // staged.
  int b = 0;
  for (int t0 = t_first; t0 < t_end; t0 += kTileT, b ^= 1) {
    const int j0 = t0 + o0;                  // window row 0; a multiple of 64
    const bool next = t0 + kTileT < t_end;
    // One 64-row window piece at a time: 32 accumulators, so that more
    // CTAs fit on an SM. The first piece's products run while the next
    // tile's rows are unpacked.
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      int acc[32];
      const unsigned base = c_addr + (((j0 >> 3) + 8 * p) & (kRing / 8 - 1)) * 512;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      wgmma_m64n64k32(acc, a_cur[0], smem_desc(base), 0);
      wgmma_m64n64k32(acc, a_cur[1], smem_desc(base + 256), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (p == 0 && next) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();                     // stage b ^ 1 landed everywhere
        take(b ^ 1, t0 + kTileT, a_next);
        if (t0 + 2 * kTileT < t_end) stage(t0 + 2 * kTileT, b);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      // The products read acc and a_cur until here: pin both at the wait.
#pragma unroll
      for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(acc[i])::"memory");
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a_cur[s][i])::"memory");

      // The piece's largest dot, over four independent chains.
      int mx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i] = acc[i];
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        mx[(i / 2) & 3] = __vimax3_s32(mx[(i / 2) & 3], acc[i], acc[i + 1]);
      const int m = max(__vimax3_s32(mx[0], mx[1], mx[2]), mx[3]);
      if (__any_sync(0xffffffffu, m >= thr_dot)) {
        int mn[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mn[i] = acc[i];
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          mn[(i / 2) & 3] = __vimin3_s32(mn[(i / 2) & 3], acc[i], acc[i + 1]);
        if (__all_sync(0xffffffffu, min(__vimin3_s32(mn[0], mn[1], mn[2]), mn[3]) >= thr_dot)) {
          // Every pair of the warp's 16 x 64 block matched (a static or
          // black scene).
          if (t0 + 16 * warp >= 0 && t0 + 16 * warp + 16 <= q_len &&
              j0 + 64 * p >= 0 && j0 + 64 * p + 64 <= c_len) {
            if (lane == 0) ++s_whole[warp][p];
            continue;
          }
          // At an edge: diagonal dd gains the block's valid rows tl with
          // tl + dd among its valid window rows, a difference of interval
          // ends; at most 79 diagonals, 3 shared adds a lane.
          const int r_lo = max(16 * warp, -t0), r_hi = min(16 * warp + 16, q_len - t0);
          const int c_lo = max(64 * p, -j0), c_hi = min(64 * p + 64, c_len - j0);
          const int d_hi = min(kBand - 1, c_hi - 1 - r_lo);
          for (int dd = max(0, c_lo - r_hi + 1) + lane; dd <= d_hi; dd += 32) {
            const int n = min(r_hi, c_hi - dd) - max(r_lo, c_lo - dd);
            if (n > 0) atomicAdd(&s_cnt[dd], n);
          }
        } else {
          // acc[4c + e]: query row 16 warp + g (+ 8 for e >= 2), window
          // row 64p + 8c + 2 t4 + (e & 1).
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int tl = 16 * warp + g + 8 * (e >> 1);
              const int jj = 64 * p + 8 * c + 2 * t4 + (e & 1);
              const int dd = jj - tl, t = t0 + tl, j = j0 + jj;
              if (acc[4 * c + e] >= thr_dot && dd >= 0 && dd < kBand && t >= 0 &&
                  t < q_len && j >= 0 && j < c_len)
                atomicAdd(&s_cnt[dd], 1);
            }
        }
      }
    }
    if (next) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) a_cur[s][i] = a_next[s][i];
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();                       // the next window is in the ring
    }
  }
  // The whole blocks: each adds its trapezoid, min(16, 64 - x) - max(0, -x)
  // on diagonal 64 p - 16 warp + x, for x in [-15, 63].
  __syncwarp();
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const int n = s_whole[warp][p];
    if (n == 0) continue;
    const int base = 64 * p - 16 * warp;
    for (int dd = max(0, base - 15) + lane; dd <= min(kBand - 1, base + 63); dd += 32) {
      const int x = dd - base;
      atomicAdd(&s_cnt[dd], n * (min(16, 64 - x) - max(0, -x)));
    }
  }
  __syncthreads();

  // The band's maximum at its first offset: one 64-bit key.
  const int c = s_cnt[tid];
  unsigned long long key =
      c > 0 ? ((unsigned long long)c << 32) | (unsigned long long)(0x7fffffff - (d0 + tid))
            : 0ull;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, s);
    key = other > key ? other : key;
  }
  if (lane == 0) s_warp[warp] = key;
  __syncthreads();
  if (tid == 0) {
    unsigned long long best = s_warp[0];
#pragma unroll
    for (int w = 1; w < kBand / 32; ++w) best = s_warp[w] > best ? s_warp[w] : best;
    if (best > kZeroKey) atomicMax(&keys[(size_t)qi * V + v], best);
  }
}

// Shared by the two forms below: rows of 32 W bytes in wgmma's no-swizzle
// core matrices (LBO 128 bytes, SBO 256 W), a group of k-steps.
constexpr int kGroupW = 4;              // k-steps per wgmma group (chunked form)

// Byte offset of (corpus row j, bit k) in a ring of 32 W-byte rows.
__device__ __forceinline__ int ring_offset_w(int j, int k, int sbo) {
  return ((j >> 3) & (kRing / 8 - 1)) * sbo + (k >> 4) * 128 + (j & 7) * 16 + (k & 15);
}

__device__ __forceinline__ uint64_t smem_desc_w(unsigned addr, unsigned sbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// -- any other W up to kMaxWords: fragment_search_tiles_kernel ----------------
//
// Rows of W = 1 or 3 .. 23 words (phash256: W = 8). Where the band form
// above multiplies a 64 x 192 box for the 64 x 128 pairs of its band's
// diagonals and unpacks each corpus row once per band and per query, this
// form tiles each (query, video) Hamming matrix itself:
// - A CTA owns one video, a band of diagonals [d0, d0 + band) and a group
//   of q_group queries, with an int32 counter per (query, diagonal) of the
//   band in shared memory. The host's plan (ops/align.py k3_tiles_plan,
//   passed in as band and q_group) takes the whole diagonal row,
//   Tq_pad + Tc - 1, as the band where the counters of one query fit, and
//   as many queries a group as fit beside it, then shrinks the groups, and
//   at last the bands (to no fewer than 512 diagonals), until the grid has
//   a CTA for every SM. At the fragment-search cell (Q = 4, Tq_pad <= 1024,
//   Tc = 4,096) one CTA holds a video's four whole diagonal rows (20,476
//   counters, 80 KB): every (query row, corpus row) pair is multiplied
//   once, less the query's padding to 64 rows (about 6% there).
// - The CTA walks the video's corpus rows in tiles of NR = 256 rows (128
//   past 8 words, 64 past 16: the widest N whose two-stage ring fits
//   128 KB), and for each tile every 64-row query tile of every query of
//   the group whose pairs touch the band: one item, a 64 x NR box of
//   pairs, W wgmma.m64nNRk32 s8·s8 -> s32 steps, query rows as A from
//   registers (built from the packed words in ALU instructions, pm1_of),
//   the unpacked tile as B from shared memory.
// - Warp roles (384 threads, one CTA an SM): a producer warpgroup brings
//   a tile's packed rows (4 W bytes each) into one of two staging slots by
//   one cp.async.bulk on an mbarrier, two tiles ahead, and its 128 threads
//   unpack them into one of two ring stages (NR rows of 32 W ±1 bytes in
//   wgmma's no-swizzle core matrices, zero past the video's length); two
//   consumer warpgroups take the items of the CTA in turn (even and odd),
//   so that one's gate, counting and A fragments run under the other's
//   products (ordering their issues by named barriers, as FA3's ping-pong
//   does, measured 4% slower than letting them interleave); each loads its
//   next item's query words while its own products run. A stage is handed
//   over by mbarriers: full (the producer's 128 threads) and empty (the
//   consumers' 256). setmaxnreg moves registers from the producer (40 a
//   thread) to the consumers (232: 128 accumulators, 32 A registers, 16
//   prefetched words). Each corpus row is unpacked once a CTA: once a
//   launch at the cell, for all four queries.
// - Gate and counts as in the band form, on a warp's 16 x NR block: the
//   DPX max of its accumulators against 32 W - 2 thr and one warp vote,
//   then the same by 16 x 64 quarters (a still scene of 80 to 300 frames
//   seldom fills a 256-column block); a quarter that matched whole adds
//   its trapezoid clipped to the valid rows, one shared add a diagonal (79,
//   3 a lane); otherwise each matched pair inside the band and the valid
//   rows adds one.
// - Result: a CTA's maximum and first index per query as the 64-bit key
//   (score << 32 | 0x7fffffff - d), one global atomicMax a warp: exact
//   across bands and equal to the band form's.
// What bounds it: the products, and under them the card's power. Per item
// 64 x NR x 32 W int8 multiply-adds, 1,024 tensor clocks an SM at W = 8,
// against ~300 issue slots a warp for the A fragments (32 registers, five
// ALU instructions each: the nibble table's shared-memory reads queued
// behind the products' B reads and held the A fragments back, at 43% of
// the bound), the gate and the loop; the producer's unpack runs under the
// Q x Tq_pad / 64 items of the tile. At the cell the card holds its 700 W
// limit with the SM clock at 1.67-1.88 GHz (1.98 idle) and the scan at
// ~72% of its bound (the same loop with constant A operands, at 1.98 GHz:
// 97%). Shared memory at W = 8: 128 KB of ring, 16 KB of staging and up to
// 83,904 bytes of counters.

constexpr int kMaxWords = 23;           // the widest rows of this form
constexpr int kMaxSmem = 232448;        // a block's shared memory on Hopper
constexpr int kTilesStatic = 1024;      // kept for the kernel's static shared memory
constexpr int kTilesThreads = 384;      // two consumer warpgroups, one producer
constexpr int kConsumers = 256;         // the consumers' threads; the producer's first
constexpr int kProducerRegs = 40;       // registers a producer thread keeps
constexpr int kConsumerRegs = 232;      // and a consumer's (setmaxnreg)

// Corpus rows of a tile (the products' N) at W words.
__host__ __device__ constexpr int tile_rows(int W) {
  return W <= 8 ? 256 : (W <= 16 ? 128 : 64);
}
// A ring stage (unpacked rows) and a staging slot (packed rows, widened to
// the 16-byte chunks that hold them) in bytes.
__host__ __device__ constexpr int ring_bytes(int W) { return tile_rows(W) * 32 * W; }
__host__ __device__ constexpr int packed_bytes(int W) { return tile_rows(W) * 4 * W + 32; }
// The k-steps an instance for any W holds in registers, at N = NR.
template <int NR>
__host__ __device__ constexpr int max_steps() { return NR == 256 ? 7 : (NR == 128 ? 16 : kMaxWords); }

struct TilesPlan {
  int band, q_group, bands, groups;
  long long smem;
};

// A call's grid (V x bands, groups) and dynamic shared memory from the band
// and the query group of the host's plan (ops/align.py k3_tiles_plan, the
// module note above); false where they do not fit a block or the grid.
bool tiles_layout(int Q, int Tq_pad, int V, int Tc, int W, int band, int q_group,
                  TilesPlan* p) {
  if (band < 1 || q_group < 1 || q_group > Q) return false;
  const long long nd = (long long)Tq_pad + Tc - 1;
  const long long bands = (nd + band - 1) / band;
  p->band = band;
  p->q_group = q_group;
  p->bands = (int)std::min<long long>(bands, 0x7fffffffll);
  p->groups = (Q + q_group - 1) / q_group;
  p->smem = 2LL * ring_bytes(W) + 2LL * packed_bytes(W) + 4LL * q_group * band;
  return p->smem <= kMaxSmem - kTilesStatic && bands * V < 0x7fffffffll &&
         p->groups <= 65535;
}

// The low 4 bits of n, LSB first, as 4 ±1 bytes (set -> +1), in ALU
// instructions alone: spread bit j to byte j, then 255 - 254 b per byte. On
// a bit-reversed word r, (r >> 4 i) holds nibble i MSB-first, as
// pm1_entry's table does; the table's shared-memory reads would queue
// behind the products' own.
__device__ __forceinline__ int pm1_of(uint32_t n) {
  return (int)((((n & 0xfu) * 0x00204081u) & 0x01010101u) * 0xffffff02u + 0xffffffffu);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// Bytes [src, src + n) into ``slot`` by one bulk copy: the 16-byte chunks
// that hold them, so byte src lands at slot + (src & 15). (An allocation's
// start and size are multiples of 512 B, so those chunks are mapped.)
__device__ __forceinline__ void copy_rows(unsigned char* slot, uint64_t* bar,
                                          const void* src, int n) {
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)15;
  const uintptr_t e = ((uintptr_t)src + (uintptr_t)n + 15) & ~(uintptr_t)15;
  const uint32_t bytes = (uint32_t)(e - a);
  // The slot's last reads were generic; the copy writes through the async
  // proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(slot)), "l"((const void*)a), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A named barrier of the two consumer warpgroups (0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kConsumers) : "memory");
}

// d (64 query rows x N corpus rows, s32) = A (registers) x B (descriptor),
// plus d when scale_d, at N = 256 and 128 (N = 64: wgmma_m64n64k32 above).
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], const int (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

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

template <int NR>
__device__ __forceinline__ void wgmma_tile(int (&d)[NR / 2], const int (&a)[4],
                                           uint64_t desc, int scale_d) {
  if constexpr (NR == 256) wgmma_m64n256k32(d, a, desc, scale_d);
  else if constexpr (NR == 128) wgmma_m64n128k32(d, a, desc, scale_d);
  else wgmma_m64n64k32(d, a, desc, scale_d);
}

template <int FW, int NR>
__global__ void __launch_bounds__(kTilesThreads, 1)
fragment_search_tiles_kernel(const uint32_t* __restrict__ qs,
                             const int32_t* __restrict__ q_lens, int Q, int Tq_pad,
                             const uint32_t* __restrict__ corpus,
                             const int32_t* __restrict__ lens, int V, int Tc,
                             int Wrt, int thr, int band, int q_group, int bands,
                             unsigned long long* __restrict__ keys) {
  constexpr int kK = FW > 0 ? FW : max_steps<NR>();   // k-steps in registers
  const int W = FW > 0 ? FW : Wrt;
  extern __shared__ __align__(128) unsigned char smem[];
  // full[2] (a ring stage unpacked), empty[2] (a stage read), packed[2]
  // (a staging slot landed).
  __shared__ __align__(8) uint64_t s_bar[6];
  const int ring_b = ring_bytes(W), packed_b = packed_bytes(W);   // NR = tile_rows(W)
  auto ring = [&](int s) { return smem + s * ring_b; };
  auto packed = [&](int s) { return smem + 2 * ring_b + s * packed_b; };
  int* s_cnt = reinterpret_cast<int*>(smem + 2 * ring_b + 2 * packed_b);

  const int tid = threadIdx.x;
  const int v = blockIdx.x / bands;
  const int d0 = (blockIdx.x - v * bands) * band;
  const int d1 = min(Tq_pad + Tc - 1, d0 + band);        // diagonals [d0, d1)
  const int nb = d1 - d0;
  const int o0 = d0 - (Tq_pad - 1), o1 = d1 - Tq_pad;    // first, last offset
  const int q0 = blockIdx.y * q_group, nq = min(q_group, Q - q0);
  const int c_len = min(max(lens[v], 0), Tc);
  auto qlen = [&](int i) { return min(max(__ldg(q_lens + q0 + i), 0), Tq_pad); };
  int q_max = 0;
  for (int i = 0; i < nq; ++i) q_max = max(q_max, qlen(i));
  // Corpus rows some pair of the band touches, in tiles of NR rows from a
  // multiple of NR; per tile, query i's rows t in [t_lo, t_hi), walked in
  // 64-row tiles from a multiple of 64.
  const int j_lo = max(0, o0), j_hi = min(c_len, q_max + o1);
  if (q_max == 0 || j_lo >= j_hi) return;               // the whole CTA
  const int j_first = j_lo & ~(NR - 1);
  const int n_tiles = (j_hi - j_first + NR - 1) / NR;
  auto t_lo_of = [&](int j0) { return max(0, j0 - o1); };
  auto t_hi_of = [&](int j0, int i) {
    return (int)min((long long)qlen(i), (long long)j0 - o0 + NR);
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&s_bar[s], kTilesThreads - kConsumers);
      mbar_init(&s_bar[2 + s], kConsumers);
      mbar_init(&s_bar[4 + s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < nq * band; i += kTilesThreads) s_cnt[i] = 0;
  __syncthreads();

  const uint32_t* vrow = corpus + (size_t)v * Tc * W;
  if (tid >= kConsumers) {
    // The producer: tile k's packed rows land in slot k % 2 (copied two
    // tiles ahead) and are unpacked into ring stage k % 2 once the
    // consumers are done with tile k - 2.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    auto src_of = [&](int k) { return vrow + (size_t)(j_first + k * NR) * W; };
    auto bytes_of = [&](int k) { return min(NR, c_len - (j_first + k * NR)) * 4 * W; };
    if (pt == 0) {
      copy_rows(packed(0), &s_bar[4], src_of(0), bytes_of(0));
      if (n_tiles > 1) copy_rows(packed(1), &s_bar[5], src_of(1), bytes_of(1));
    }
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k & 1;
      const uint32_t ph = (k >> 1) & 1;
      const int nrows = min(NR, c_len - (j_first + k * NR));
      mbar_wait(&s_bar[4 + s], ph);
      mbar_wait(&s_bar[2 + s], ph ^ 1);
      const uint32_t* P = reinterpret_cast<const uint32_t*>(
          packed(s) + ((uintptr_t)src_of(k) & 15));
      unsigned char* R = ring(s);
      // Thread r: rows r, r + 128, ...; a word's 32 ±1 bytes as two 16-byte
      // stores, conflict-free (8 lanes write 8 rows of one core matrix).
      for (int r = pt; r < NR; r += kTilesThreads - kConsumers) {
        unsigned char* row = R + (r >> 3) * (256 * W) + (r & 7) * 16;
        const bool ok = r < nrows;
#pragma unroll 4
        for (int w = 0; w < W; ++w) {
          const uint32_t x = ok ? __brev(P[r * W + w]) : 0u;
          int4 lo = make_int4(0, 0, 0, 0), hi = lo;
          if (ok) {
            lo = make_int4(pm1_of(x), pm1_of(x >> 4), pm1_of(x >> 8), pm1_of(x >> 12));
            hi = make_int4(pm1_of(x >> 16), pm1_of(x >> 20), pm1_of(x >> 24), pm1_of(x >> 28));
          }
          *reinterpret_cast<int4*>(row + 256 * w) = lo;
          *reinterpret_cast<int4*>(row + 256 * w + 128) = hi;
        }
      }
      // The products read the stage through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&s_bar[s]);
      if (k + 2 < n_tiles) {
        // Slot s is read (every producer thread arrived on full[s] after
        // its reads) before it is written again.
        mbar_wait(&s_bar[s], ph);
        if (pt == 0) copy_rows(packed(s), &s_bar[4 + s], src_of(k + 2), bytes_of(k + 2));
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // The consumers. Items in the CTA's order: corpus tile k, query i, query
  // tile t0 (seek: the first item at or after a cursor, t0 < 0 for a
  // query's first). Warpgroup wg takes the items of wg's parity, and the two
  // interleave on the tensor pipe: one's gate and A fragments run under the
  // other's products. A warpgroup holds a ring stage from its full barrier
  // to its empty one, every tile in turn.
  const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int thr_dot = 32 * W - 2 * thr;     // a match: dot >= thr_dot
  const unsigned sbo = 256u * W;
  auto seek = [&](int& k, int& i, int& t0) {
    while (k < n_tiles) {
      if (i < nq) {
        const int j0 = j_first + k * NR, lo = t_lo_of(j0), hi = t_hi_of(j0, i);
        if (t0 < 0) t0 = lo & ~(kTileT - 1);
        if (lo < hi && t0 < hi) return;
        ++i;
      } else {
        ++k;
        i = 0;
      }
      t0 = -1;
    }
  };
  auto next = [&](int& k, int& i, int& t0) {
    t0 += kTileT;
    seek(k, i, t0);
  };
  int held = -1;                            // the stage held, by its tile
  auto hold = [&](int kt) {                 // release tiles < kt, hold kt
    for (; held < kt; ++held) {
      if (held >= 0) mbar_arrive(&s_bar[2 + (held & 1)]);
      if (held + 1 < n_tiles) mbar_wait(&s_bar[(held + 1) & 1], ((held + 1) >> 1) & 1);
    }
  };
  // The packed words of an item's two query rows (t0 + 16 wq + g and + 8),
  // zero at and past q_len: loaded one item ahead, under the products.
  uint32_t wa[kK], wb[kK];
  auto load = [&](int k, int i, int t0) {
    const int q_len = qlen(i), ta = t0 + 16 * wq + g, tb = ta + 8;
    const uint32_t* qrow = qs + (size_t)(q0 + i) * Tq_pad * W;
#pragma unroll
    for (int st = 0; st < kK; ++st) {
      if (st < W) {                          // the same in every thread
        wa[st] = ta < q_len ? __ldg(qrow + (size_t)ta * W + st) : 0u;
        wb[st] = tb < q_len ? __ldg(qrow + (size_t)tb * W + st) : 0u;
      }
    }
  };
  int k = 0, i = 0, t0 = -1;
  seek(k, i, t0);
  if (wg == 1 && k < n_tiles) next(k, i, t0);
  if (k < n_tiles) load(k, i, t0);
  while (k < n_tiles) {
    // A from the words: row 16 wq + g (a[.][0], [2]) and + 8 ([1], [3]),
    // nibbles t4 and 4 + t4 of each word (bits 4 t4 and 16 + 4 t4 of the
    // reversed word). (A zero word is not a zero row: rows past q_len are
    // zeroed by ok_a / ok_b.)
    const int q_len = qlen(i), ta = t0 + 16 * wq + g;
    const bool ok_a = ta < q_len, ok_b = ta + 8 < q_len;
    int a[kK][4];
#pragma unroll
    for (int st = 0; st < kK; ++st) {
      if (st < W) {
        const uint32_t ra = __brev(wa[st]) >> (4 * t4), rb = __brev(wb[st]) >> (4 * t4);
        a[st][0] = ok_a ? pm1_of(ra) : 0;
        a[st][1] = ok_b ? pm1_of(rb) : 0;
        a[st][2] = ok_a ? pm1_of(ra >> 16) : 0;
        a[st][3] = ok_b ? pm1_of(rb >> 16) : 0;
      }
    }
    hold(k);
    const int j0 = j_first + k * NR, ci = i, ct0 = t0;
    const unsigned b_addr = smem_u32(ring(k & 1));
    int acc[NR / 2];
#pragma unroll
    for (int x = 0; x < NR / 2; ++x) asm volatile("" : "+r"(acc[x])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < kK; ++st)
      if (st < W)
        wgmma_tile<NR>(acc, a[st], smem_desc_w(b_addr + 256 * st, sbo), st > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // This warpgroup's next item, and its words, while the products run.
    next(k, i, t0);
    if (k < n_tiles) next(k, i, t0);
    if (k < n_tiles) load(k, i, t0);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // The products read acc and a until here: pin both at the wait.
#pragma unroll
    for (int x = 0; x < NR / 2; ++x) asm volatile("" : "+r"(acc[x])::"memory");
#pragma unroll
    for (int st = 0; st < kK; ++st)
#pragma unroll
      for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[st][x])::"memory");

    // The warp's 16 x NR block, by 16 x 64 quarters (columns 64 p ..
    // 64 p + 63: acc[32 p .. 32 p + 31]): each quarter's largest dot
    // over two chains, and one vote on the largest.
    int mq[NR / 64];
#pragma unroll
    for (int p = 0; p < NR / 64; ++p) {
      int ch[2] = {acc[32 * p], acc[32 * p + 1]};
#pragma unroll
      for (int x = 2; x < 32; x += 2)
        ch[(x / 2) & 1] = __vimax3_s32(ch[(x / 2) & 1], acc[32 * p + x], acc[32 * p + x + 1]);
      mq[p] = max(ch[0], ch[1]);
    }
    int m = mq[0];
#pragma unroll
    for (int p = 1; p < NR / 64; ++p) m = max(m, mq[p]);
    if (!__any_sync(0xffffffffu, m >= thr_dot)) continue;
    // Diagonal index in the band of the item's pair (row 0, column 0),
    // and the warp's valid rows [r_lo, r_hi).
    const int base = j0 - ct0 + (Tq_pad - 1) - d0;
    const int r_lo = 16 * wq, r_hi = min(r_lo + 16, q_len - ct0);
    int* cnt = s_cnt + ci * band;
#pragma unroll
    for (int p = 0; p < NR / 64; ++p) {
      if (!__any_sync(0xffffffffu, mq[p] >= thr_dot)) continue;
      int ch[2] = {acc[32 * p], acc[32 * p + 1]};
#pragma unroll
      for (int x = 2; x < 32; x += 2)
        ch[(x / 2) & 1] = __vimin3_s32(ch[(x / 2) & 1], acc[32 * p + x], acc[32 * p + x + 1]);
      if (__all_sync(0xffffffffu, min(ch[0], ch[1]) >= thr_dot)) {
        // Every pair of the quarter matched (a static or black scene): its
        // valid pairs, rows [r_lo, r_hi) x columns [c_lo, c_hi), add
        // min(r_hi, c_hi - x) - max(r_lo, c_lo - x) on diagonal x =
        // column - row; at most 79 diagonals, 3 shared adds a lane.
        const int c_lo = 64 * p, c_hi = min(c_lo + 64, c_len - j0);
        if (r_lo < r_hi)
          for (int x = c_lo - r_hi + 1 + lane; x <= c_hi - 1 - r_lo; x += 32) {
            const int dd = base + x;
            const int n = min(r_hi, c_hi - x) - max(r_lo, c_lo - x);
            if ((unsigned)dd < (unsigned)nb && n > 0) atomicAdd(cnt + dd, n);
          }
      } else {
        // acc[4c + e]: row 16 wq + g (+ 8 for e >= 2), column 8c + 2 t4
        // + (e & 1).
#pragma unroll
        for (int c = 8 * p; c < 8 * p + 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * wq + g + 8 * (e >> 1);
            const int col = 8 * c + 2 * t4 + (e & 1);
            const int dd = base + col - r;
            if (acc[4 * c + e] >= thr_dot && (unsigned)dd < (unsigned)nb &&
                ct0 + r < q_len && j0 + col < c_len)
              atomicAdd(cnt + dd, 1);
          }
      }
    }
  }
  hold(n_tiles);                            // release the rest

  // Each query's maximum over the band at its first diagonal: one 64-bit
  // key a warp.
  consumers_sync();
  for (int i = 0; i < nq; ++i) {
    unsigned long long key = 0;
    for (int dd = tid; dd < nb; dd += kConsumers) {
      const int c = s_cnt[i * band + dd];
      const unsigned long long kk =
          ((unsigned long long)c << 32) | (unsigned long long)(0x7fffffff - (d0 + dd));
      if (c > 0 && kk > key) key = kk;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, s);
      key = other > key ? other : key;
    }
    if (lane == 0 && key > kZeroKey) atomicMax(&keys[(size_t)(q0 + i) * V + v], key);
  }
}


// -- W > kMaxWords: fragment_search_chunked_kernel ------------------------------
//
// A ring of 256 unpacked rows of 32 W bytes does not fit a block's shared
// memory past 23 words (256 KB at W = 32). This instance keeps the CTA's
// (query, video, band) work, the wgmma products, the gate on the whole dot
// and the counting of the kernels above, and changes only the walk over
// words: per query tile (64 rows from t_begin, no ring, so no alignment)
// and 64-row window piece, the words go in chunks of kChunkW = 16 — the
// piece's chunk of window rows unpacked into shared memory (32 KB, zero
// outside the video), the query rows' words straight from global memory
// (L1/L2) into the A fragments — and the dot accumulates across the
// chunks in the wgmma accumulators. Only after the last chunk is the gate
// dot >= 32 W - 2 thr applied. Each piece's window rows are unpacked anew
// for every tile (three times as often as the ring would): simple first.

constexpr int kChunkW = 16;             // words of a piece held at a time
// The widest rows at all: 32 W - 2 thr stays an int32.
constexpr int kMaxKeyWords = 1 << 24;

__global__ void __launch_bounds__(kThreads, 4)
fragment_search_chunked_kernel(const uint32_t* __restrict__ qs,
                               const int32_t* __restrict__ q_lens, int Tq_pad,
                               const uint32_t* __restrict__ corpus,
                               const int32_t* __restrict__ lens, int V, int Tc,
                               int W, int thr, int bands,
                               unsigned long long* __restrict__ keys) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* s_b = reinterpret_cast<int8_t*>(smem);            // 64 x 32 kChunkW
  __shared__ int s_cnt[kBand];
  __shared__ int s_whole[kThreads / 32][kPieces];
  __shared__ int s_pm1[16];
  __shared__ unsigned long long s_warp[kBand / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qi = blockIdx.y;
  const int v = blockIdx.x / bands;
  const int d0 = (blockIdx.x % bands) * kBand;
  const int o0 = d0 - (Tq_pad - 1);         // the band's first offset
  const int q_len = min(max(q_lens[qi], 0), Tq_pad);
  const int c_len = min(max(lens[v], 0), Tc);
  const uint32_t* qrow = qs + (size_t)qi * Tq_pad * W;
  const uint32_t* crow = corpus + (size_t)v * Tc * W;

  const int t_begin = max(0, -(o0 + kBand - 1));
  const int t_end = min(q_len, c_len - o0);
  if (t_begin >= t_end) return;             // the whole CTA: nothing to count

  s_cnt[tid] = 0;                           // kThreads == kBand
  if (tid < kThreads / 32 * kPieces) (&s_whole[0][0])[tid] = 0;
  if (tid < 16) s_pm1[tid] = pm1_entry(tid);
  const int thr_dot = 32 * W - 2 * thr;     // a match: dot >= thr_dot
  const unsigned sbo = 256u * kChunkW;
  const unsigned b_addr = (unsigned)__cvta_generic_to_shared(s_b);

  for (int t0 = t_begin; t0 < t_end; t0 += kTileT) {
    const int j0 = t0 + o0;                  // window row 0
    const int r_a = 16 * warp + g, t_a = t0 + r_a, t_b = t_a + 8;
    const bool ok_a = t_a >= 0 && t_a < q_len, ok_b = t_b >= 0 && t_b < q_len;
    const uint32_t* qa = qrow + (size_t)(ok_a ? t_a : 0) * W;
    const uint32_t* qb = qrow + (size_t)(ok_b ? t_b : 0) * W;
#pragma unroll 1
    for (int p = 0; p < kPieces; ++p) {
      int acc[32];
#pragma unroll 1
      for (int c0 = 0; c0 < W; c0 += kChunkW) {
        const int wc = min(kChunkW, W - c0);
        __syncthreads();                     // the table is set; the last
                                             // chunk's products read s_b
        {                                    // two threads a window row
          const int r = tid >> 1, j = j0 + 64 * p + r;
          const bool ok = j >= 0 && j < c_len;
          const uint32_t* wp = crow + (size_t)(ok ? j : 0) * W + c0;
          const int half = (wc + 1) / 2;
          const int w1 = (tid & 1) ? wc : half;
          for (int w = (tid & 1) ? half : 0; w < w1; ++w) {
            const uint32_t word = ok ? __ldg(wp + w) : 0u;
#pragma unroll
            for (int k = 0; k < 8; ++k)
              *reinterpret_cast<int*>(s_b + ring_offset_w(r, 32 * w + 4 * k, sbo)) =
                  ok ? s_pm1[nibble_index(word, k)] : 0;
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
#pragma unroll 1
        for (int w0 = 0; w0 < wc; w0 += kGroupW) {
          int a[kGroupW][4];
#pragma unroll
          for (int s = 0; s < kGroupW; ++s) {
            const int w = c0 + (w0 + s < wc ? w0 + s : w0);
            const uint32_t wa = ok_a ? __ldg(qa + w) : 0u, wb = ok_b ? __ldg(qb + w) : 0u;
            a[s][0] = ok_a ? s_pm1[nibble_index(wa, t4)] : 0;
            a[s][1] = ok_b ? s_pm1[nibble_index(wb, t4)] : 0;
            a[s][2] = ok_a ? s_pm1[nibble_index(wa, 4 + t4)] : 0;
            a[s][3] = ok_b ? s_pm1[nibble_index(wb, 4 + t4)] : 0;
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(acc[i])::"memory");
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int s = 0; s < kGroupW; ++s)
            if (w0 + s < wc)                 // the same in every thread
              wgmma_m64n64k32(acc, a[s], smem_desc_w(b_addr + 256 * (w0 + s), sbo),
                              c0 + w0 + s > 0);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
          for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(acc[i])::"memory");
#pragma unroll
          for (int s = 0; s < kGroupW; ++s)
#pragma unroll
            for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
        }
      }

      // The gate and the counts on the whole dot (as the kernels above).
      int mx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i] = acc[i];
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        mx[(i / 2) & 3] = __vimax3_s32(mx[(i / 2) & 3], acc[i], acc[i + 1]);
      const int m = max(__vimax3_s32(mx[0], mx[1], mx[2]), mx[3]);
      if (__any_sync(0xffffffffu, m >= thr_dot)) {
        int mn[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mn[i] = acc[i];
#pragma unroll
        for (int i = 0; i < 32; i += 2)
          mn[(i / 2) & 3] = __vimin3_s32(mn[(i / 2) & 3], acc[i], acc[i + 1]);
        if (__all_sync(0xffffffffu, min(__vimin3_s32(mn[0], mn[1], mn[2]), mn[3]) >= thr_dot)) {
          if (t0 + 16 * warp >= 0 && t0 + 16 * warp + 16 <= q_len &&
              j0 + 64 * p >= 0 && j0 + 64 * p + 64 <= c_len) {
            if (lane == 0) ++s_whole[warp][p];
            continue;
          }
          const int r_lo = max(16 * warp, -t0), r_hi = min(16 * warp + 16, q_len - t0);
          const int c_lo = max(64 * p, -j0), c_hi = min(64 * p + 64, c_len - j0);
          const int d_hi = min(kBand - 1, c_hi - 1 - r_lo);
          for (int dd = max(0, c_lo - r_hi + 1) + lane; dd <= d_hi; dd += 32) {
            const int n = min(r_hi, c_hi - dd) - max(r_lo, c_lo - dd);
            if (n > 0) atomicAdd(&s_cnt[dd], n);
          }
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int tl = 16 * warp + g + 8 * (e >> 1);
              const int jj = 64 * p + 8 * c + 2 * t4 + (e & 1);
              const int dd = jj - tl, t = t0 + tl, j = j0 + jj;
              if (acc[4 * c + e] >= thr_dot && dd >= 0 && dd < kBand && t >= 0 &&
                  t < q_len && j >= 0 && j < c_len)
                atomicAdd(&s_cnt[dd], 1);
            }
        }
      }
    }
  }
  // The whole blocks: each adds its trapezoid (as fragment_search_kernel).
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const int n = s_whole[warp][p];
    if (n == 0) continue;
    const int base = 64 * p - 16 * warp;
    for (int dd = max(0, base - 15) + lane; dd <= min(kBand - 1, base + 63); dd += 32) {
      const int x = dd - base;
      atomicAdd(&s_cnt[dd], n * (min(16, 64 - x) - max(0, -x)));
    }
  }
  __syncthreads();

  const int c = s_cnt[tid];
  unsigned long long key =
      c > 0 ? ((unsigned long long)c << 32) | (unsigned long long)(0x7fffffff - (d0 + tid))
            : 0ull;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, s);
    key = other > key ? other : key;
  }
  if (lane == 0) s_warp[warp] = key;
  __syncthreads();
  if (tid == 0) {
    unsigned long long best = s_warp[0];
#pragma unroll
    for (int w = 1; w < kBand / 32; ++w) best = s_warp[w] > best ? s_warp[w] : best;
    if (best > kZeroKey) atomicMax(&keys[(size_t)qi * V + v], best);
  }
}

__global__ void unpack_keys_kernel(const unsigned long long* __restrict__ keys,
                                   int n, int Tq_pad,
                                   int32_t* __restrict__ offs,
                                   int32_t* __restrict__ scores) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long k = keys[i];
    const int d = 0x7fffffff - (int)(k & 0xffffffffull);
    scores[i] = (int32_t)(k >> 32);
    offs[i] = d - (Tq_pad - 1);
  }
}

struct TilesArgs {
  const uint32_t* qs;
  const int32_t* q_lens;
  int Q, Tq_pad;
  const uint32_t* corpus;
  const int32_t* lens;
  int V, Tc, W, thr;
  unsigned long long* keys;
};

// One launch of an instance of the tiles form, its shared-memory limit set
// to the most a block may have (so no launch lowers it under another's).
template <int FW, int NR>
cudaError_t launch_tiles(const TilesPlan& p, dim3 grid, const TilesArgs& a,
                         cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(fragment_search_tiles_kernel<FW, NR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kMaxSmem - kTilesStatic);
  if (e != cudaSuccess) return e;
  fragment_search_tiles_kernel<FW, NR><<<grid, kTilesThreads, (size_t)p.smem, s>>>(
      a.qs, a.q_lens, a.Q, a.Tq_pad, a.corpus, a.lens, a.V, a.Tc, a.W, a.thr,
      p.band, p.q_group, p.bands, a.keys);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tvz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// qs (Q, Tq_pad, W) and corpus (V, Tc, W) int32 rows, W in [1,
// kMaxKeyWords]; q_lens (Q,), lens (V,) int32; keys (Q, V) uint64 scratch; offs,
// scores (Q, V) int32. band and q_group: the tiles form's plan (ops/align.py
// k3_tiles_plan), read at W = 1 and 3 .. kMaxWords only.
int tvz_fragment_search(const void* qs, const void* q_lens, int Q, int Tq_pad,
                        const void* corpus, const void* lens, int V, int Tc,
                        int W, int thr, int band, int q_group, void* keys,
                        void* offs, void* scores, void* stream) {
  if (Q <= 0 || Q > 65535 || Tq_pad <= 0 || V <= 0 || Tc <= 0 || W < 1 ||
      W > kMaxKeyWords)
    return (int)cudaErrorInvalidValue;
  const long long nd = (long long)Tq_pad + Tc - 1;
  const long long bands = (nd + kBand - 1) / kBand;
  if (nd >= 0x7fffffffll - 2 * kTileT || bands * V >= 0x7fffffffll ||
      (long long)Q * V >= 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  // hamming is in [0, 32 W]: any thr below 0 matches nothing, any above
  // 32 W everything, and the clamp keeps 32 W - 2 thr in range.
  thr = thr < -1 ? -1 : (thr > 32 * W ? 32 * W : thr);
  const bool tiles = W != 2 && W <= kMaxWords;
  TilesPlan p;
  if (tiles && !tiles_layout(Q, Tq_pad, V, Tc, W, band, q_group, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = Q * V;
  init_keys_kernel<<<(n + 255) / 256, 256, 0, s>>>((unsigned long long*)keys, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(bands * V), (unsigned)Q);
  if (W == 2) {
    fragment_search_kernel<<<grid, kThreads, 0, s>>>(
        (const uint32_t*)qs, (const int32_t*)q_lens, Tq_pad,
        (const uint32_t*)corpus, (const int32_t*)lens, V, Tc, thr, (int)bands,
        (unsigned long long*)keys);
  } else if (!tiles) {
    fragment_search_chunked_kernel<<<grid, kThreads, (size_t)64 * 32 * kChunkW, s>>>(
        (const uint32_t*)qs, (const int32_t*)q_lens, Tq_pad,
        (const uint32_t*)corpus, (const int32_t*)lens, V, Tc, W, thr,
        (int)bands, (unsigned long long*)keys);
  } else {
    const dim3 tgrid((unsigned)((long long)p.bands * V), (unsigned)p.groups);
    const TilesArgs a{(const uint32_t*)qs, (const int32_t*)q_lens, Q, Tq_pad,
                      (const uint32_t*)corpus, (const int32_t*)lens, V, Tc, W, thr,
                      (unsigned long long*)keys};
    if (W == 8) e = launch_tiles<8, 256>(p, tgrid, a, s);
    else if (W <= 8) e = launch_tiles<0, 256>(p, tgrid, a, s);
    else if (W <= 16) e = launch_tiles<0, 128>(p, tgrid, a, s);
    else e = launch_tiles<0, 64>(p, tgrid, a, s);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  unpack_keys_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      (const unsigned long long*)keys, n, Tq_pad, (int32_t*)offs,
      (int32_t*)scores);
  return (int)cudaGetLastError();
}

}  // extern "C"
