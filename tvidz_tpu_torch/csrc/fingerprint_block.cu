// K1 — fingerprint block: scene scores + 64-bit DCT pHash, one launch over
// S segments of T luma frames each.
//
// Replaces tvidz_tpu/ops/fused_pallas.py::_fused_kernel (wrapper
// fingerprint_stream_pallas) and, on the port's path, the XLA composition
// tvidz_tpu/ops/fused.py::fingerprint_block / fingerprint_blocks_batched.
// Same function as ops/fused.py's plain version, per segment:
//   mafd[t]  = mean |x[t] - x[t-1]|  (x[-1] = the segment's carry frame)
//   score[t] = clip(min(mafd, |mafd - prev_mafd|) / 100, 0, 1), with a
//              fresh stream's frame 0 masked to 0
//   hash[t]  = MSB-first pack of (low > median(low)), low = L · X · Rᵀ,
//              L = (D·P_h)[:8] (8, H), R = (D·P_w)[:8] (8, W), float32;
//   the new carry is taken at frame valid_t - 1.
// A segment is one stream's block (a lone call: S = 1, T = 128), one of the
// dispatcher's K streams (S = K), or a whole stream (S = 1, T = NTOT).
//
// What bounds it on the H100: a 90x160 frame is 14,400 B of u8 luma and
// ~0.29 MFLOP of fp32 (the factored operators and mafd), so both roofs meet
// near 230 M frames/s. At T = 128 the call is far below both, and what
// counts is the launch and one CTA's critical path; on a long stream, the
// instructions issued per frame (the X·Rᵀ projection is most of them).
// Design:
// - one launch: a grid of at most (SMs x resident CTAs) CTAs, each walking
//   a contiguous ascending range of the S*T frames, so frame t-1 and its
//   mafd are already on chip. A range whose first frame has t > 0 also
//   computes its predecessor's mafd (no hash), in the same pass as its
//   own; t = 0 takes the segment's carry. Segment pointers, carries and
//   valid_t ride in the launch parameters (no host-to-device copy);
// - the operators are fetched first, then the frames by 16-byte cp.async
//   into a ring of three u8 buffers (frame k-1, k and k+1 in flight while
//   k is computed); mafd is __vsadu4 on packed bytes, an exact
//   int32 sum (< 2^24 at 90x160), and mafd = (float)sum / (float)(H*W);
//   the carry frame is written from shared memory;
// - every thread on the arithmetic: for X·Rᵀ a warp takes rows and its 32
//   lanes split W as one 4-byte word (columns 4l..4l+3) and one byte
//   (column 128+l), each lane holding its five columns of R in registers;
//   the 8 partial sums per row are combined by a fixed reduce-scatter
//   shuffle tree (16, 8, 4, then 2, 1), each lane's R rows permuted so the
//   tree needs no selects. L is folded in row by row: after a row's tree,
//   lane 4m + j adds L[2j][h]·tmp[h][m] and L[2j+1][h]·tmp[h][m] to two
//   running sums, and the eight warps' sums are added in warp order. The
//   median's rank count takes 4 threads per coefficient. fp32 FFMA only
//   (TF32 flips median-adjacent bits), in a fixed order, so a frame's hash
//   does not depend on S, T or its place in a range, and runs repeat bit
//   for bit.
// That form (form 0) takes W <= 160 and a multiple of 4, H*W a multiple of
// 16, and three frames in shared memory (3 H W + 32 H + 2.4 KB <= 227 KB).
//
// Every other geometry (form 1, fingerprint_bands_kernel), any H, W and
// alignment (H W <= 8,421,504 for the exact int32 mafd, W <= 7,188): a
// 720x1280 frame is 921,600 B, so three whole frames do not fit on an SM,
// and one frame a CTA hangs the call on one SM's latency. What bounds it
// on the H100: 8 fp32 FMA a byte for L · X · Rᵀ and 1 byte from HBM, so at
// 180x320 and above the FMA issue and the bytes meet (k1_bound). Design:
// - a frame is cut into row bands of ops/fused.py k1_band_rows(H, W) rows
//   (a function of the geometry alone, sized so that a CTA's ring of three
//   bands fits two CTAs to an SM); the grid is bands x frame ranges, CTA
//   (band b, range r) walking band b of the frames of range r in order;
// - a band's bytes reach shared memory by one cp.async.bulk (TMA, 1-D)
//   completed on an mbarrier: the band's flat byte range widened to the
//   16-byte chunks that hold its first and last bytes (an allocation's
//   start and size are multiples of 512 B, so those chunks are mapped),
//   at the slot offset that keeps the chunk alignment, so any base and W
//   work; frame k+2's band is in flight while frame k's is computed, and
//   frame k-1's band stays on chip as the mafd's predecessor. Each byte
//   leaves HBM once; a range re-reads only its first frame's predecessor
//   band (from L2), and reads a segment's carry frame once a band;
// - in a band, thread item (g, cw) takes columns 4cw..4cw+3 of rows g, g +
//   G, ... (G = 256 / ceil(W / 4) row groups, at least 1; items past 256
//   go round again). Per row it reads the word at any byte offset (two
//   aligned LDS and a funnel shift), adds __vsadu4 against the
//   predecessor's word (exact int32), turns the bytes into floats by
//   __byte_perm (no I2F) and folds them left-first, u[j][c] += L[j][h] x,
//   with Lᵀ's band rows staged in shared memory once per CTA; after its
//   rows, v[j][q] = sum_c u[j][c] R[q][c] in two halves of 32 (R's four
//   columns are read per item from L1: Rᵀ would take 32 W bytes of shared
//   memory, the ring's room at 720x1280 and more than a CTA has at W =
//   7,188), each half reduce-scattered over the warp (offsets 16, 8, 4, 2,
//   1) and added to the round's running sum; the warps' sums are added in
//   warp order;
// - the bands of a frame meet in a scratch area the wrapper allocates: each
//   band writes its 64 sums and its exact SAD, then thread 0 announces it
//   (one fence, then atomics) on the frame's arrival counter and, inside a
//   segment, on the next frame's (whose score needs this frame's SADs); a
//   counter is complete at B arrivals (a segment's frame 0) or 2 B. Frame
//   k is combined by the CTA of band k % B, which polls k's counter and,
//   once complete, adds the 64 sums in band order, runs the median and
//   pack, and takes k's and k-1's masked mafd from their SADs for the
//   score, so a range's first score needs no frame read twice. A CTA that
//   leaves its range (or holds four such frames) hands a frame over, and
//   the arrival that completes it combines it: no CTA ever waits on
//   another, and the combines spread over the bands (left to the last
//   arrival, a range's slowest band took them all and fell further
//   behind). A band is announced while the next frame is computed and the
//   atomics' results read a frame later. The counters live in a workspace
//   the wrapper keeps per stream, zeroed once; each launch leaves them at 0;
// - fp32 FMA only, in an order fixed by (H, W), so a frame's hash does not
//   depend on S, T, the grid or its place in a range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHash = 8;
constexpr int kBits = kHash * kHash;   // 64 coefficients, 2 words
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSegments = 64;       // ops/fused.py MAX_SEGMENTS
constexpr int kMaxWidth = 160;         // form 0: 32 lanes x (4-byte word + 1 byte)
constexpr int kMaxSmem = 232448;       // a block's shared memory on Hopper
constexpr long long kMaxPixels = 8421504;   // 255 H W < 2^31 (exact mafd)
constexpr int kMaxWidthGeneral = 7188;      // form 1's reach (ops/fused.py)
constexpr int kBandHeader = 2560;      // form 1: barriers, sums, stats, flags
constexpr int kSlots = 3;              // form 1: bands k-1, k, k+1 on chip
constexpr unsigned kFull = 0xffffffffu;

struct Segment {
  const uint8_t* luma;        // (T, H, W) u8, 16-byte aligned for form 0
  const float* carry_frame;   // (H, W) whole numbers in [0, 255]
  const float* carry_mafd;    // ()
  const uint8_t* has_prev;    // () bool
  int valid_t;                // in [1, T]
};

struct Params {
  Segment seg[kMaxSegments];
  const float* left;          // (8, H)
  const float* right;         // (8, W)
  float* scores;              // (S*T,)
  int32_t* fps;               // (S*T, 2)
  float* new_frame;           // (S, H, W)
  float* new_mafd;            // (S,)
  uint8_t* new_has_prev;      // (S,)
  // Form 1's scratch (per call) and arrival counters (per stream, at 0).
  float* part;                // (S*T, bands, 64)
  int* sad;                   // (S*T, bands)
  unsigned* arrive;           // (>= S*T,)
  long long frames;           // S*T
  int T, H, W;
  int band_rows, bands;       // form 1
};

// Byte k of a word as a float, exactly: 0x4B0000bb is 2^23 + b.
__device__ __forceinline__ float byte_f(uint32_t word, int k) {
  return __int_as_float(__byte_perm(word, 0x4B000000u, 0x7440 | k)) - 8388608.0f;
}

// Median threshold + MSB-first pack of the 64 coefficients in s_low.
// Called by all 256 threads (it synchronises once); thread 4i+j counts
// #{u in [16j, 16j+16) : low[u] <= low[i]}, the four counts summed by two
// shuffles; order statistics 31 and 32 are min{v : rank(v) >= 32} and
// min{v : rank(v) >= 33} (exact with ties). Writes 2 int32 words.
__device__ void median_threshold_pack(const float* s_low, float* s_stat,
                                      int32_t* out_words) {
  const int tid = threadIdx.x, i = tid >> 2, j = tid & 3;
  const float v = s_low[i];
  int rank = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 w = reinterpret_cast<const float4*>(s_low + 16 * j)[u];
    rank += (w.x <= v) + (w.y <= v) + (w.z <= v) + (w.w <= v);
  }
  rank += __shfl_xor_sync(kFull, rank, 1);
  rank += __shfl_xor_sync(kFull, rank, 2);
  const float inf = __int_as_float(0x7f800000);
  float lo = rank >= kBits / 2 ? v : inf;
  float hi = rank >= kBits / 2 + 1 ? v : inf;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
    hi = fminf(hi, __shfl_xor_sync(kFull, hi, off));
  }
  if ((tid & 31) == 0) {
    s_stat[2 * (tid >> 5)] = lo;
    s_stat[2 * (tid >> 5) + 1] = hi;
  }
  __syncthreads();
  if (tid < kBits) {                      // warps 0 and 1, whole
    float s_lo = s_stat[0], s_hi = s_stat[1];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      s_lo = fminf(s_lo, s_stat[2 * w]);
      s_hi = fminf(s_hi, s_stat[2 * w + 1]);
    }
    const float med = (s_lo + s_hi) * 0.5f;
    const unsigned ballot = __ballot_sync(kFull, s_low[tid] > med);
    // Lane j holds bit j of the word; MSB-first puts bit j at 31 - j.
    if ((tid & 31) == 0) out_words[tid >> 5] = (int32_t)__brev(ballot);
  }
}

// One row of X · Rᵀ by one warp, folded into L · (X · Rᵀ). Lane l
// multiplies its five columns in a fixed order; the eight sums are
// reduce-scattered over offsets 16, 8, 4 and summed over offsets 2, 1. Lane
// l keeps its operator rows in the order r = q ^ m, m = l >> 2, so at every
// step it keeps its lower half and sends its upper half (the partner's
// upper half holds the same r), and it ends with tmp[h][m]. Lanes 4m + j
// then add L[2j][h]·tmp[h][m] and L[2j+1][h]·tmp[h][m] to their two sums.
__device__ __forceinline__ void project_row(const uint8_t* row, const float* left_t,
                                            int lane, bool has_word, bool has_byte,
                                            const float (&rw)[4][kHash],
                                            const float (&rb)[kHash],
                                            float& low0, float& low1) {
  const uint32_t word = has_word ? *reinterpret_cast<const uint32_t*>(row + 4 * lane) : 0u;
  const uint32_t byte = has_byte ? (uint32_t)row[128 + lane] : 0u;
  const float x0 = byte_f(word, 0), x1 = byte_f(word, 1), x2 = byte_f(word, 2),
              x3 = byte_f(word, 3), x4 = byte_f(byte, 0);
  float a[kHash];
#pragma unroll
  for (int q = 0; q < kHash; ++q) {
    float s = x0 * rw[0][q];
    s = fmaf(x1, rw[1][q], s);
    s = fmaf(x2, rw[2][q], s);
    s = fmaf(x3, rw[3][q], s);
    a[q] = fmaf(x4, rb[q], s);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] += __shfl_xor_sync(kFull, a[q + 4], 16);
#pragma unroll
  for (int q = 0; q < 2; ++q) a[q] += __shfl_xor_sync(kFull, a[q + 2], 8);
  float d = a[0] + __shfl_xor_sync(kFull, a[1], 4);
  d += __shfl_xor_sync(kFull, d, 2);
  d += __shfl_xor_sync(kFull, d, 1);
  const float2 l2 = *reinterpret_cast<const float2*>(left_t + 2 * (lane & 3));
  low0 = fmaf(l2.x, d, low0);
  low1 = fmaf(l2.y, d, low1);
}

__device__ __forceinline__ void copy_frame_async(uint8_t* dst, const uint8_t* src,
                                                 int hw) {
  for (int q = threadIdx.x * 16; q < hw; q += kThreads * 16) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + q);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + q));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One warp's share of sum |a - b| over two u8 frames in shared memory
// (exact in int32), summed over the warp.
__device__ __forceinline__ int frame_sad(const uint8_t* a, const uint8_t* b,
                                         int hw) {
  int acc = 0;
  for (int q = threadIdx.x * 16; q < hw; q += kThreads * 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + q);
    const uint4 y = *reinterpret_cast<const uint4*>(b + q);
    acc += (int)(__vsadu4(x.x, y.x) + __vsadu4(x.y, y.y)
                 + __vsadu4(x.z, y.z) + __vsadu4(x.w, y.w));
  }
  return __reduce_add_sync(kFull, acc);
}

// A carry frame (whole-number floats) as u8 bytes in shared memory.
__device__ __forceinline__ void carry_to_bytes(uint8_t* dst, const float* carry,
                                               int hw) {
  for (int q = threadIdx.x * 4; q < hw; q += kThreads * 4) {
    const float4 f = *reinterpret_cast<const float4*>(carry + q);
    const uint32_t w = ((uint32_t)__float2int_rn(f.x) & 0xffu)
                     | (((uint32_t)__float2int_rn(f.y) & 0xffu) << 8)
                     | (((uint32_t)__float2int_rn(f.z) & 0xffu) << 16)
                     | (((uint32_t)__float2int_rn(f.w) & 0xffu) << 24);
    *reinterpret_cast<uint32_t*>(dst + q) = w;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
fingerprint_segments_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, T = p.T, hw = H * W;
  uint8_t* s_buf = smem;                                        // 3 x (H, W) u8
  float* s_left_t = reinterpret_cast<float*>(smem + 3 * hw);    // (H, 8): Lᵀ
  float* s_part = s_left_t + H * kHash;                         // (8 warps, 64)
  float* s_low = s_part + kWarps * kBits;                       // (64,)
  float* s_stat = s_low + kBits;                                // 2 per warp
  int* s_sum = reinterpret_cast<int*>(s_stat + 2 * kWarps);     // 2 per warp

  const long long n = p.frames;
  const long long lo = n * blockIdx.x / gridDim.x;
  const long long hi = n * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The operators first, so their loads do not queue behind the frames'.
  const bool has_word = 4 * lane < W, has_byte = 128 + lane < W;
  const int perm = lane >> 2;           // 4·b4 + 2·b3 + b2 (project_row)
  float rw[4][kHash], rb[kHash];
#pragma unroll
  for (int q = 0; q < kHash; ++q) {
    const int r = q ^ perm;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      rw[c][q] = has_word ? p.right[r * W + 4 * lane + c] : 0.0f;
    rb[q] = has_byte ? p.right[r * W + 128 + lane] : 0.0f;
  }
  for (int q = tid; q < kHash * H; q += kThreads) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(
        s_left_t + (q % H) * kHash + q / H);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(p.left + q));
  }
  // The ring: frame lo - 2 + j in slot j % 3. Frame lo - 1 is the
  // segment's carry where the range starts a segment; else the range also
  // computes frame lo - 1's mafd (from frame lo - 2, or the carry), its
  // first score's predecessor.
  int s = (int)(lo / T);
  int t = (int)(lo - (long long)s * T);
  const bool inside = t > 0;
  // The segment's scalars, read again only where a range enters a segment.
  bool fresh = p.seg[s].has_prev[0] == 0;
  float carried = p.seg[s].carry_mafd[0];
  if (inside) {
    if (t == 1) carry_to_bytes(s_buf, p.seg[s].carry_frame, hw);
    else copy_frame_async(s_buf, p.seg[s].luma + (size_t)(t - 2) * hw, hw);
    copy_frame_async(s_buf + hw, p.seg[s].luma + (size_t)(t - 1) * hw, hw);
  } else {
    carry_to_bytes(s_buf + hw, p.seg[s].carry_frame, hw);
  }
  copy_frame_async(s_buf + 2 * hw, p.seg[s].luma + (size_t)t * hw, hw);
  cp_async_commit();

  float prev_m = 0.0f;                  // masked mafd of frame k-1
  for (long long k = lo; k < hi; ++k) {
    const int i = (int)(k - lo);
    uint8_t* before = s_buf + (i % 3) * hw;         // frame k-2 (i = 0)
    uint8_t* pred = s_buf + ((i + 1) % 3) * hw;
    uint8_t* cur = s_buf + ((i + 2) % 3) * hw;
    if (i > 0) {
      if (++t == T) {
        t = 0;
        ++s;
        carry_to_bytes(pred, p.seg[s].carry_frame, hw);
        fresh = p.seg[s].has_prev[0] == 0;
        carried = p.seg[s].carry_mafd[0];
      }
      if (k + 1 < hi) {                 // into frame k-2's slot, now free
        const int s1 = t + 1 == T ? s + 1 : s;
        const int t1 = t + 1 == T ? 0 : t + 1;
        copy_frame_async(before, p.seg[s1].luma + (size_t)t1 * hw, hw);
      }
      cp_async_commit();
      cp_async_wait_all_but_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    const bool first_inside = i == 0 && inside;
    int acc = frame_sad(cur, pred, hw);
    if (lane == 0) s_sum[warp] = acc;
    if (first_inside) {
      acc = frame_sad(pred, before, hw);
      if (lane == 0) s_sum[kWarps + warp] = acc;
    }
    {
      // Warp w takes rows w, w + 8, ...; lane 4m + j sums low[2j][m] and
      // low[2j + 1][m] over them.
      float low0 = 0.0f, low1 = 0.0f;
#pragma unroll 2
      for (int h = warp; h < H; h += kWarps)
        project_row(cur + h * W, s_left_t + h * kHash, lane, has_word,
                    has_byte, rw, rb, low0, low1);
      s_part[warp * kBits + (2 * (lane & 3)) * kHash + (lane >> 2)] = low0;
      s_part[warp * kBits + (2 * (lane & 3) + 1) * kHash + (lane >> 2)] = low1;
    }
    __syncthreads();
    if (i == 0) {                       // frame lo + 1 into frame lo - 2's slot
      if (k + 1 < hi) {
        const int s1 = t + 1 == T ? s + 1 : s;
        const int t1 = t + 1 == T ? 0 : t + 1;
        copy_frame_async(before, p.seg[s1].luma + (size_t)t1 * hw, hw);
      }
      cp_async_commit();
    }
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_sum[w];
    if (first_inside) {                 // frame lo - 1's masked mafd
      int total_pred = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total_pred += s_sum[kWarps + w];
      prev_m = (t == 1 && fresh) ? 0.0f : (float)total_pred / (float)hw;
    }
    const bool start = t == 0 && fresh;
    const float m = start ? 0.0f : (float)total / (float)hw;

    if (tid < kBits) {                  // the warps' sums, in warp order
      float v = s_part[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += s_part[w * kBits + tid];
      s_low[tid] = v;
    }
    __syncthreads();
    median_threshold_pack(s_low, s_stat, p.fps + 2 * k);
    if (tid == 0) {
      const float pm = t == 0 ? carried : prev_m;
      float sc = fminf(m, fabsf(m - pm)) / 100.0f;
      sc = fminf(fmaxf(sc, 0.0f), 1.0f);
      p.scores[k] = start ? 0.0f : sc;
    }
    if (t == p.seg[s].valid_t - 1) {
      float* dst = p.new_frame + (size_t)s * hw;
      for (int q = tid * 4; q < hw; q += kThreads * 4) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(cur + q);
        *reinterpret_cast<float4*>(dst + q) = make_float4(
            (float)(w & 0xffu), (float)((w >> 8) & 0xffu),
            (float)((w >> 16) & 0xffu), (float)(w >> 24));
      }
      if (tid == 0) {
        p.new_mafd[s] = m;
        p.new_has_prev[s] = 1;
      }
    }
    prev_m = m;
    __syncthreads();                      // frame k-1's ring slot is free
  }
}

// -- form 1: row bands over CTAs ----------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// One arrival that also expects ``bytes`` from the bulk copy it pairs with.
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// A band's bytes [src, src + n) into ``slot`` by one bulk copy: the 16-byte
// chunks that hold them, the first chunk at the slot's start, so byte src
// lands at slot + (src & 15).
__device__ __forceinline__ void copy_band(uint8_t* slot, uint64_t* bar,
                                          const uint8_t* src, int n) {
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)15;
  const uintptr_t e = ((uintptr_t)src + (uintptr_t)n + 15) & ~(uintptr_t)15;
  const uint32_t bytes = (uint32_t)(e - a);
  // Generic reads and writes of the slot came before (a barrier ordered
  // them); the copy writes through the async proxy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_bytes(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(slot)), "l"((const void*)a), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The four bytes at byte offset o of a slot (any alignment), as one word.
__device__ __forceinline__ uint32_t word_at(const uint32_t* slot, int o) {
  return __funnelshift_r(slot[o >> 2], slot[(o >> 2) + 1], 8 * (o & 3));
}

// The score of a frame of masked mafd m after one of masked mafd pm.
__device__ __forceinline__ float score_of(float m, float pm) {
  const float sc = fminf(m, fabsf(m - pm)) / 100.0f;
  return fminf(fmaxf(sc, 0.0f), 1.0f);
}

// The warp's sum of 32 values a lane, reduce-scattered: lane l ends with
// the sum of value l (offsets 16, 8, 4, 2, 1; at each, a lane keeps the
// half its lane bit names and sends the other).
__device__ __forceinline__ float warp_scatter32(const float (&v)[32], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2,
             b0 = lane & 1;
  float a[16], c[8], d[4], e[2];
#pragma unroll
  for (int q = 0; q < 16; ++q)
    a[q] = (b4 ? v[q + 16] : v[q]) + __shfl_xor_sync(kFull, b4 ? v[q] : v[q + 16], 16);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    c[q] = (b3 ? a[q + 8] : a[q]) + __shfl_xor_sync(kFull, b3 ? a[q] : a[q + 8], 8);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    d[q] = (b2 ? c[q + 4] : c[q]) + __shfl_xor_sync(kFull, b2 ? c[q] : c[q + 4], 4);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    e[q] = (b1 ? d[q + 2] : d[q]) + __shfl_xor_sync(kFull, b1 ? d[q] : d[q + 2], 2);
  return (b0 ? e[1] : e[0]) + __shfl_xor_sync(kFull, b0 ? e[0] : e[1], 1);
}

// One item's rows: u[j][c] += L[j][h] x[h][c0 + c] in row order and the
// SAD against the predecessor. kAligned: every word of the band starts on a
// 4-byte boundary of its slot (W % 4 == 0 and both heads too), so one LDS a
// word; kMasked: the item's last columns lie past W.
template <bool kAligned, bool kMasked>
__device__ __forceinline__ void item_rows(const uint32_t* cur, int oc,
                                          const uint32_t* pred, int op, int step,
                                          int g, int groups, int rows, uint32_t mask,
                                          const float4* s_lt, float (&u)[kHash][4],
                                          int& sad) {
#pragma unroll 2
  for (int hh = g; hh < rows; hh += groups, oc += step, op += step) {
    uint32_t wc = kAligned ? cur[oc >> 2] : word_at(cur, oc);
    uint32_t wp = kAligned ? pred[op >> 2] : word_at(pred, op);
    if (kMasked) {
      wc &= mask;
      wp &= mask;
    }
    sad += (int)__vsadu4(wc, wp);
    const float4 la = s_lt[2 * hh], lb = s_lt[2 * hh + 1];
    const float l[kHash] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
    const float x[4] = {byte_f(wc, 0), byte_f(wc, 1), byte_f(wc, 2), byte_f(wc, 3)};
#pragma unroll
    for (int j = 0; j < kHash; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) u[j][c] = fmaf(l[j], x[c], u[j][c]);
  }
}

// R's four columns c0.. of an item, r[q][c] (0 past ``valid``): one float4
// a row where R's rows are 16-byte aligned, else four loads. Issued before
// the item's rows, so that the loads (from L2 where R outgrows L1) land
// while the rows are summed.
__device__ __forceinline__ void item_right(const float* right, int W, int c0, int valid,
                                           float (&r)[kHash][4]) {
  if (valid == 4 && (W & 3) == 0 && ((uintptr_t)right & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kHash; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(right + (size_t)q * W + c0));
      r[q][0] = x.x;
      r[q][1] = x.y;
      r[q][2] = x.z;
      r[q][3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kHash; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        r[q][c] = c < valid ? __ldg(right + (size_t)q * W + c0 + c) : 0.0f;
  }
}

// An item's 64 sums v[j][q] = sum_c u[j][c] r[q][c] (c in order, the
// ``valid`` columns), in two halves of 32, each reduce-scattered over the
// warp and added to acc[half].
__device__ __forceinline__ void fold_item(const float (&u)[kHash][4],
                                          const float (&r)[kHash][4], int valid,
                                          int lane, float (&acc)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) v[q] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < valid) {
#pragma unroll
        for (int j = 0; j < kHash; ++j)
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            v[j * 4 + qq] = fmaf(u[j][c], r[4 * h + qq][c], v[j * 4 + qq]);
      }
    }
    acc[h] += warp_scatter32(v, lane);
  }
}

// One band of one frame: sum |cur - pred| over it (exact) and its 64 sums
// of L[:, band] · X[band] · Rᵀ into s_red (per warp, [j][q]) and s_wsad.
// ``cur`` / ``pred`` are the slots, the band's first byte at cur_head /
// pred_head; ``s_lt`` is Lᵀ's band rows, 8 floats a row.
template <bool kAligned>
__device__ __forceinline__ void band_sums(const uint32_t* cur, int cur_head,
                                          const uint32_t* pred, int pred_head,
                                          const float4* s_lt, const float* right,
                                          int rows, int W, float* s_red,
                                          int* s_wsad) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncw = (W + 3) >> 2;
  const int groups = max(1, kThreads / ncw);
  const int items = groups * ncw;
  int sad = 0;
  float acc[2] = {0.0f, 0.0f};
  for (int base = 0; base < items; base += kThreads) {   // uniform rounds
    if (base + (tid & ~31) >= items) break;               // the warp has none left
    const int it = base + tid;
    const bool has = it < items;
    const int g = has ? it / ncw : 0;
    const int c0 = has ? 4 * (it - g * ncw) : 0;
    const int valid = has ? min(4, W - c0) : 0;
    float u[kHash][4], r[kHash][4];
#pragma unroll
    for (int j = 0; j < kHash; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) u[j][c] = r[j][c] = 0.0f;
    if (has) {
      item_right(right, W, c0, valid, r);
      const int oc = cur_head + g * W + c0, op = pred_head + g * W + c0;
      if (valid == 4)
        item_rows<kAligned, false>(cur, oc, pred, op, groups * W, g, groups, rows,
                                   0u, s_lt, u, sad);
      else
        item_rows<kAligned, true>(cur, oc, pred, op, groups * W, g, groups, rows,
                                  0xffffffffu >> (8 * (4 - valid)), s_lt, u, sad);
    }
    fold_item(u, r, valid, lane, acc);
  }
  // Lane l holds (j, qq) = (l >> 2, l & 3) of each half.
  const int idx = (lane >> 2) * kHash + (lane & 3);
  s_red[warp * kBits + idx] = acc[0];
  s_red[warp * kBits + idx + 4] = acc[1];
  sad = __reduce_add_sync(kFull, sad);
  if (lane == 0) s_wsad[warp] = sad;
}

// A band of a carry frame (whole-number floats) as bytes at a slot's start:
// four floats a thread and load where aligned, eight loads in flight.
__device__ __forceinline__ void carry_band(uint8_t* slot, const float* carry, int n) {
  int q0 = 0;
  if (((uintptr_t)carry & 15) == 0) {
    const float4* c4 = reinterpret_cast<const float4*>(carry);
    uint32_t* s4 = reinterpret_cast<uint32_t*>(slot);
    const int n4 = n >> 2;
    for (int base = 0; base < n4; base += 8 * kThreads) {
      float4 f[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = base + u * kThreads + threadIdx.x;
        f[u] = q < n4 ? __ldg(c4 + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int q = base + u * kThreads + threadIdx.x;
        if (q < n4)
          s4[q] = ((uint32_t)__float2int_rn(f[u].x) & 0xffu)
                | (((uint32_t)__float2int_rn(f[u].y) & 0xffu) << 8)
                | (((uint32_t)__float2int_rn(f[u].z) & 0xffu) << 16)
                | (((uint32_t)__float2int_rn(f[u].w) & 0xffu) << 24);
      }
    }
    q0 = n4 << 2;
  }
#pragma unroll 8
  for (int q = q0 + threadIdx.x; q < n; q += kThreads)
    slot[q] = (uint8_t)(__float2int_rn(__ldg(carry + q)) & 0xff);
}

// Thread 0 of a band's CTA announces frame j's band on j's counter and,
// inside a segment, on j+1's (whose score needs j's SADs); a counter is
// complete at B arrivals (a segment's frame 0) or 2 B. Frame j is combined
// by the CTA of band j % B: it polls j's counter after announcing j and
// combines j once complete. A CTA that leaves its range, or holds
// kPending frames, hands the oldest over: it adds kHandoff to the counter,
// and the arrival that then completes the count combines it (or the CTA
// itself, had the count been complete). So every frame is combined once,
// no CTA waits on another, and the combines spread over the bands.
constexpr unsigned kHandoff = 1u << 24;     // > 2 B for any band count
constexpr int kPending = 4;

struct Announce {
  long long j = -1;
  unsigned a0 = 0, a1 = 0;
  bool next = false;
};

__device__ __forceinline__ unsigned frame_need(const Params& p, long long j) {
  return j % p.T > 0 ? 2u * p.bands : (unsigned)p.bands;
}

__device__ __forceinline__ Announce announce(const Params& p, long long j) {
  Announce a;
  a.j = j;
  a.next = (j + 1) % p.T != 0;
  __threadfence();                     // release the band's sums (after a barrier)
  a.a0 = atomicAdd(p.arrive + j, 1u);
  if (a.next) a.a1 = atomicAdd(p.arrive + j + 1, 1u);
  return a;
}

// The handed-over frames an announcement completed, into done[]; their count.
__device__ __forceinline__ int completed(const Params& p, const Announce& a,
                                         long long* done) {
  int nd = 0;
  if (a.j < 0) return 0;
  if (a.a0 + 1 == (frame_need(p, a.j) | kHandoff)) done[nd++] = a.j;
  if (a.next && a.a1 + 1 == (frame_need(p, a.j + 1) | kHandoff)) done[nd++] = a.j + 1;
  return nd;
}

// Hands frame j over; true if its count was complete (the caller combines).
__device__ __forceinline__ bool hand_off(const Params& p, long long j) {
  return atomicAdd(p.arrive + j, kHandoff) == frame_need(p, j);
}

// Frame j, whose bands (and, inside a segment, frame j-1's) have all
// arrived, by the whole CTA: the bands' 64 sums in band order, the median
// and pack, the masked mafd of j and j-1 from their exact SADs, the score,
// and the carry's mafd. Leaves j's counter at 0.
__device__ void combine_frame(const Params& p, long long j, float* s_low,
                              float* s_stat, int* s_tot) {
  const int tid = threadIdx.x, lane = tid & 31, B = p.bands;
  const int sj = (int)(j / p.T), tj = (int)(j - (long long)sj * p.T);
  if (tid == 0) __threadfence();       // acquire the other bands' sums
  __syncthreads();
  if (tid < kBits) {
    const float* part = p.part + (size_t)j * B * kBits + tid;
    float v = 0.0f;
    for (int b0 = 0; b0 < B; b0 += 16) {   // 16 loads in flight, then added in order
      float x[16];
#pragma unroll
      for (int q = 0; q < 16; ++q)
        x[q] = b0 + q < B ? __ldcg(part + (size_t)(b0 + q) * kBits) : 0.0f;
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (b0 + q < B) v = b0 + q == 0 ? x[q] : v + x[q];
    }
    s_low[tid] = v;
  } else if (tid < kBits + 64) {       // warps 2 and 3: the SADs of j and j-1
    const int which = (tid - kBits) >> 5;
    int total = 0;
    if (which == 0 || tj > 0) {
      const int* sad = p.sad + (size_t)(j - which) * B;
      for (int bb = lane; bb < B; bb += 32) total += __ldcg(sad + bb);
    }
    total = __reduce_add_sync(kFull, total);
    if (lane == 0) s_tot[which] = total;
  }
  __syncthreads();
  median_threshold_pack(s_low, s_stat, p.fps + 2 * j);
  if (tid == 0) {
    const Segment& sg = p.seg[sj];
    const float hw = (float)((size_t)p.H * p.W);
    const bool fresh = sg.has_prev[0] == 0, start = tj == 0 && fresh;
    const float m = start ? 0.0f : (float)s_tot[0] / hw;
    const float pm = tj == 0 ? sg.carry_mafd[0]
                   : (tj == 1 && fresh) ? 0.0f : (float)s_tot[1] / hw;
    p.scores[j] = start ? 0.0f : score_of(m, pm);
    if (tj == sg.valid_t - 1) {
      p.new_mafd[sj] = m;
      p.new_has_prev[sj] = 1;
    }
    p.arrive[j] = 0u;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fingerprint_bands_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, T = p.T, B = p.bands;
  const size_t hw = (size_t)H * W;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem);          // kSlots
  float* s_red = reinterpret_cast<float*>(smem + 32);           // (8 warps, 64)
  float* s_low = s_red + kWarps * kBits;                        // (64,)
  float* s_stat = s_low + kBits;                                // 2 per warp
  int* s_wsad = reinterpret_cast<int*>(s_stat + 2 * kWarps);    // 1 per warp
  int* s_misc = s_wsad + kWarps;                                // frames done, 2 SADs
  long long* s_done = reinterpret_cast<long long*>(s_misc + 4); // up to 9 frames
  float4* s_lt = reinterpret_cast<float4*>(smem + kBandHeader); // (rows, 8)
  uint8_t* s_slot0 = smem + kBandHeader + 32 * p.band_rows;
  const int slot_bytes = ((p.band_rows * W + 15) & ~15) + 48;

  const int b = (int)(blockIdx.x % B);
  const long long ranges = gridDim.x / B, r = blockIdx.x / B;
  const long long n = p.frames;
  const long long lo = n * r / ranges, hi = n * (r + 1) / ranges;
  if (lo >= hi) return;
  const int tid = threadIdx.x;
  const int h0 = b * p.band_rows, rows = min(p.band_rows, H - h0);
  const int nbytes = rows * W;
  auto slot = [&](int j) { return s_slot0 + j * slot_bytes; };
  auto band_of = [&](long long k) {
    const int ss = (int)(k / T);
    return p.seg[ss].luma + (size_t)(k - (long long)ss * T) * hw + (size_t)h0 * W;
  };

  int s = (int)(lo / T), t = (int)(lo - (long long)s * T);
  // The ring: frame lo - 1 + j in slot j % 3; frame lo - 1 is the carry
  // where the range starts a segment. The copies go first; Lᵀ's band rows
  // are staged while they land.
  if (tid == 0) {
    for (int j = 0; j < kSlots; ++j) mbar_init(s_bar + j);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (t > 0) copy_band(slot(0), s_bar + 0, band_of(lo - 1), nbytes);
    copy_band(slot(1), s_bar + 1, band_of(lo), nbytes);
    if (lo + 1 < hi) copy_band(slot(2), s_bar + 2, band_of(lo + 1), nbytes);
  }
#pragma unroll 4
  for (int q = tid; q < kHash * rows; q += kThreads) {          // left is (8, H)
    const int j = q / rows, hh = q - j * rows;
    reinterpret_cast<float*>(s_lt)[hh * kHash + j] = __ldg(p.left + (size_t)j * H + h0 + hh);
  }
  unsigned pending = (t > 0 ? 1u : 0u) | 2u | (lo + 1 < hi ? 4u : 0u);
  unsigned parity = 0;
  int pred_head = t > 0 ? (int)((uintptr_t)band_of(lo - 1) & 15) : 0;
  if (t == 0) carry_band(slot(0), p.seg[s].carry_frame + (size_t)h0 * W, nbytes);
  __syncthreads();                      // the barriers are initialised
  // Thread 0 announces frame k-1's band while frame k is computed, and
  // reads what it completed one frame later still, so the fences and
  // atomics wait behind the arithmetic; pend[] holds the frames this CTA
  // is to combine, oldest first.
  Announce ann;
  long long pend[kPending + 1];
  int npend = 0;
  auto pop_pending = [&]() {
    for (int q = 1; q < npend; ++q) pend[q - 1] = pend[q];
    --npend;
  };

  for (long long k = lo; k < hi; ++k) {
    const int i = (int)(k - lo);
    if (i > 0 && ++t == T) {
      t = 0;
      ++s;
    }
    const int ps = i % kSlots, cs = (i + 1) % kSlots;
    if (i > 0 && t == 0) {              // frame k-1's band is done with
      carry_band(slot(ps), p.seg[s].carry_frame + (size_t)h0 * W, nbytes);
      pred_head = 0;
    }
    const int cur_head = (int)((uintptr_t)band_of(k) & 15);
    for (int j2 = 0; j2 < 2; ++j2) {
      const int j = j2 == 0 ? ps : cs;
      if (pending & (1u << j)) {
        mbar_wait(s_bar + j, (parity >> j) & 1u);
        parity ^= 1u << j;
        pending &= ~(1u << j);
      }
    }
    __syncthreads();
    // The oldest frame this CTA combines: its counter, read now and looked
    // at after the band (a stale read is caught at the next frame).
    unsigned seen = 0;
    if (tid == 0 && npend > 0) seen = *reinterpret_cast<volatile const unsigned*>(p.arrive + pend[0]);
    const uint32_t* sc = reinterpret_cast<const uint32_t*>(slot(cs));
    const uint32_t* sp = reinterpret_cast<const uint32_t*>(slot(ps));
    if (((W | cur_head | pred_head) & 3) == 0)
      band_sums<true>(sc, cur_head, sp, pred_head, s_lt, p.right, rows, W, s_red, s_wsad);
    else
      band_sums<false>(sc, cur_head, sp, pred_head, s_lt, p.right, rows, W, s_red, s_wsad);
    if (t == p.seg[s].valid_t - 1) {    // the new carry frame, this band
      float* dst = p.new_frame + (size_t)s * hw + (size_t)h0 * W;
      int q0 = 0;
      if ((((uintptr_t)dst & 15) | (cur_head & 3)) == 0) {
        float4* d4 = reinterpret_cast<float4*>(dst);
        for (int q = tid; q < nbytes >> 2; q += kThreads) {
          const uint32_t w = sc[(cur_head >> 2) + q];
          d4[q] = make_float4(byte_f(w, 0), byte_f(w, 1), byte_f(w, 2), byte_f(w, 3));
        }
        q0 = nbytes & ~3;
      }
      const uint8_t* src = slot(cs) + cur_head;
      for (int q = q0 + tid; q < nbytes; q += kThreads)
        dst[q] = __int_as_float(0x4B000000 | src[q]) - 8388608.0f;
    }
    __syncthreads();
    if (tid == 0) {
      int nd = completed(p, ann, s_done);
      if (npend > 0 && seen == frame_need(p, pend[0])) {
        s_done[nd++] = pend[0];
        pop_pending();
      }
      ann = i > 0 ? announce(p, k - 1) : Announce();
      if (i > 0 && (k - 1) % B == b) {
        if (npend == kPending) {
          if (hand_off(p, pend[0])) s_done[nd++] = pend[0];
          pop_pending();
        }
        pend[npend++] = k - 1;
      }
      s_misc[0] = nd;
      if (k + 2 < hi) copy_band(slot(ps), s_bar + ps, band_of(k + 2), nbytes);
    }
    if (k + 2 < hi) pending |= 1u << ps;
    pred_head = cur_head;
    // This band's sums (the warps' in warp order) and SAD, to scratch.
    if (tid < kBits) {
      float v = s_red[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += s_red[w * kBits + tid];
      __stcg(p.part + ((size_t)k * B + b) * kBits + tid, v);
    } else if (tid == kBits) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += s_wsad[w];
      __stcg(p.sad + (size_t)k * B + b, total);
    }
    __syncthreads();
    const int nd = s_misc[0];
    for (int d = 0; d < nd; ++d) combine_frame(p, s_done[d], s_low, s_stat, s_misc + 1);
  }
  // The range's last frame: announce it, and take every outstanding result.
  __syncthreads();
  if (tid == 0) {
    int nd = completed(p, ann, s_done);
    ann = announce(p, hi - 1);
    nd += completed(p, ann, s_done + nd);
    if ((hi - 1) % B == b) pend[npend++] = hi - 1;
    for (int q = 0; q < npend; ++q)
      if (hand_off(p, pend[q])) s_done[nd++] = pend[q];
    s_misc[0] = nd;
  }
  __syncthreads();
  const int nd = s_misc[0];
  for (int d = 0; d < nd; ++d) combine_frame(p, s_done[d], s_low, s_stat, s_misc + 1);
}

__global__ void __launch_bounds__(kThreads)
median_pack_kernel(const float* __restrict__ low,   // (N, 64)
                   int32_t* __restrict__ out) {     // (N, 2)
  __shared__ __align__(16) float s_low[kBits];
  __shared__ float s_stat[2 * kWarps];
  if (threadIdx.x < kBits)
    s_low[threadIdx.x] = low[(size_t)blockIdx.x * kBits + threadIdx.x];
  __syncthreads();
  median_threshold_pack(s_low, s_stat, out + (size_t)blockIdx.x * 2);
}

// Form 0: three frames, Lᵀ and the common sums; form 1: the header, Lᵀ's
// band rows and three band slots (each band widened to whole 16-byte
// chunks, plus the word a funnel shift reads past its end).
size_t smem_bytes(int form, int H, int W, int band_rows) {
  if (form == 0)
    return (size_t)3 * H * W + sizeof(float) * kHash * H
         + sizeof(float) * (kWarps * kBits + kBits + 2 * kWarps) + sizeof(int) * 2 * kWarps;
  return (size_t)kBandHeader + sizeof(float) * kHash * band_rows
       + (size_t)kSlots * ((((size_t)band_rows * W + 15) & ~(size_t)15) + 48);
}

// Whether form ``form`` takes (H, W) with ``band_rows`` (form 1; ops/fused.py
// k1_form and k1_band_rows decide).
bool form_takes(int form, int H, int W, int band_rows) {
  if (H < 1 || W < 1 || (long long)H * W > kMaxPixels) return false;
  if (form == 1 && (W > kMaxWidthGeneral || band_rows < 1 || band_rows > H))
    return false;
  if (smem_bytes(form, H, W, band_rows) > (size_t)kMaxSmem) return false;
  return form == 1 || (form == 0 && W >= 4 && W <= kMaxWidth && W % 4 == 0 &&
                       (H * W) % 16 == 0);
}

// CTAs of a form's kernel resident on the whole card, per device. The
// largest dynamic shared memory opted into is kept per device and form, so
// a later call with a smaller frame never lowers it under an earlier one.
int resident_ctas(int form, size_t smem, int* out) {
  static int cached_smem[2][16], cached_ctas[2][16], opted_in[2][16];
  const void* fn = form == 0 ? (const void*)fingerprint_segments_kernel
                             : (const void*)fingerprint_bands_kernel;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 16 && cached_smem[form][dev] == (int)smem && cached_ctas[form][dev] > 0) {
    *out = cached_ctas[form][dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024 && (dev >= 16 || (int)smem > opted_in[form][dev])) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 16) opted_in[form][dev] = (int)smem;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  if (dev < 16) {
    cached_ctas[form][dev] = *out;
    cached_smem[form][dev] = (int)smem;
  }
  return 0;
}

// The CTAs a launch runs: ``bands`` (1 for form 0) x frame ranges, the
// ranges filling what is resident, at least one and at most one a frame.
long long launch_grid(long long frames, long long bands, int ctas) {
  long long ranges = ctas / bands;
  if (ranges < 1) ranges = 1;
  if (ranges > frames) ranges = frames;
  return ranges * bands;
}

}  // namespace

extern "C" {

const char* tvz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One launch over S segments of T frames, by form 0 or 1 (see the header).
// ``table`` is a host array of 10 + 5 S int64: the left and right
// operators, then the outputs (allocated by the caller): scores (S*T,)
// f32, fps (S*T, 2) i32, new_frame (S, H, W) f32, new_mafd (S,) f32,
// new_has_prev (S,) u8; then form 1's scratch, (S*T, bands, 64) f32 and
// (S*T, bands) i32, and its counters, at least S*T uint32 holding 0 (left
// so again; null for form 0); then per
// segment the luma pointers, carry-frame pointers, carry-mafd pointers,
// has-prev pointers and valid_t, S of each. Form 0 needs the luma and
// carry-frame pointers 16-byte aligned. ``band_rows`` is form 1's band
// height (ops/fused.py k1_band_rows; ignored by form 0).
int tvz_fingerprint_segments(int form, int S, int T, int H, int W, int band_rows,
                             const long long* table, void* stream) {
  if (form == 0) band_rows = H;
  if (S < 1 || S > kMaxSegments || T < 1 || (form != 0 && form != 1) ||
      !form_takes(form, H, W, band_rows)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.left = (const float*)table[0];
  p.right = (const float*)table[1];
  p.scores = (float*)table[2];
  p.fps = (int32_t*)table[3];
  p.new_frame = (float*)table[4];
  p.new_mafd = (float*)table[5];
  p.new_has_prev = (uint8_t*)table[6];
  p.part = (float*)table[7];
  p.sad = (int*)table[8];
  p.arrive = (unsigned*)table[9];
  if (form == 1 && (!p.part || !p.sad || !p.arrive)) return (int)cudaErrorInvalidValue;
  const long long* segs = table + 10;
  for (int s = 0; s < S; ++s) {
    p.seg[s].luma = (const uint8_t*)segs[s];
    p.seg[s].carry_frame = (const float*)segs[S + s];
    p.seg[s].carry_mafd = (const float*)segs[2 * S + s];
    p.seg[s].has_prev = (const uint8_t*)segs[3 * S + s];
    p.seg[s].valid_t = (int)segs[4 * S + s];
    if (p.seg[s].valid_t < 1 || p.seg[s].valid_t > T ||
        (form == 0 && ((segs[s] & 15) || (segs[S + s] & 15)))) {
      return (int)cudaErrorInvalidValue;
    }
  }
  p.frames = (long long)S * T;
  p.T = T;
  p.H = H;
  p.W = W;
  p.band_rows = band_rows;
  p.bands = (H + band_rows - 1) / band_rows;
  const size_t smem = smem_bytes(form, H, W, band_rows);
  int ctas = 0;
  const int rc = resident_ctas(form, smem, &ctas);
  if (rc != 0) return rc;
  const unsigned grid = (unsigned)launch_grid(p.frames, p.bands, ctas);
  if (form == 0)
    fingerprint_segments_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  else
    fingerprint_bands_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The grid a call of form ``form`` over ``frames`` frames of (H, W) (form
// 1: in bands of ``band_rows``) launches on this device.
int tvz_fingerprint_grid(int form, long long frames, int H, int W, int band_rows,
                         int* out) {
  if (form == 0) band_rows = H;
  if ((form != 0 && form != 1) || frames < 1 || !form_takes(form, H, W, band_rows))
    return (int)cudaErrorInvalidValue;
  int ctas = 0;
  const int rc = resident_ctas(form, smem_bytes(form, H, W, band_rows), &ctas);
  if (rc != 0) return rc;
  *out = (int)launch_grid(frames, (H + band_rows - 1) / band_rows, ctas);
  return 0;
}

// Median threshold + pack alone, from given (N, 64) coefficients: the exact
// device code K1 runs, exposed so its tie handling can be checked bit for
// bit against the plain version.
int tvz_median_pack(const void* low, int N, void* out, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  median_pack_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)low, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
