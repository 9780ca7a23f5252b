// K3 — fragment alignment on the int8 tensor cores: Q packed 64-bit query
// sequences against a bucket of V corpus sequences, best temporal offset of
// each query in each video.
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
// int8 rate on Hopper is ~0.5 POPS). This form:
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
// - The threshold: hamming <= thr  <=>  dot >= 64 - 2 thr. wgmma starts its
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

}  // namespace

extern "C" {

const char* tvz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// qs (Q, Tq_pad) and corpus (V, Tc) 64-bit rows; q_lens (Q,), lens (V,)
// int32; keys (Q, V) uint64 scratch; offs, scores (Q, V) int32.
int tvz_fragment_search(const void* qs, const void* q_lens, int Q, int Tq_pad,
                        const void* corpus, const void* lens, int V, int Tc,
                        int thr, void* keys, void* offs, void* scores,
                        void* stream) {
  if (Q <= 0 || Q > 65535 || Tq_pad <= 0 || V <= 0 || Tc <= 0)
    return (int)cudaErrorInvalidValue;
  const long long nd = (long long)Tq_pad + Tc - 1;
  const long long bands = (nd + kBand - 1) / kBand;
  if (nd >= 0x7fffffffll - 2 * kTileT || bands * V >= 0x7fffffffll ||
      (long long)Q * V >= 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  // hamming is in [0, 64]: any thr below 0 matches nothing, any above 64
  // everything, and the clamp keeps 64 - 2 thr in range.
  thr = thr < -1 ? -1 : (thr > 64 ? 64 : thr);
  cudaStream_t s = (cudaStream_t)stream;
  const int n = Q * V;
  init_keys_kernel<<<(n + 255) / 256, 256, 0, s>>>((unsigned long long*)keys, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(bands * V), (unsigned)Q);
  fragment_search_kernel<<<grid, kThreads, 0, s>>>(
      (const uint32_t*)qs, (const int32_t*)q_lens, Tq_pad,
      (const uint32_t*)corpus, (const int32_t*)lens, V, Tc, thr, (int)bands,
      (unsigned long long*)keys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  unpack_keys_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      (const unsigned long long*)keys, n, Tq_pad, (int32_t*)offs,
      (int32_t*)scores);
  return (int)cudaGetLastError();
}

}  // extern "C"
