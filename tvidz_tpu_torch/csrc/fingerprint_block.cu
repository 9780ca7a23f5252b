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
// Every other geometry (form 1, fingerprint_general_kernel): the same
// persistent ranges, segment table, score and carry logic and median, but
// frames are read from global memory (L2) byte by byte, so any H, W and
// alignment works: a ring of whole frames does not fit at 180x320 three to
// an SM, nor at all at 720x1280. A warp takes groups of 4 rows; lane l
// takes columns l, l + 32, ... of them, reading Rᵀ's column as two float4
// from shared memory once for the 4 rows, and the predecessor's bytes (or
// the carry) beside the frame's, so mafd is summed in the same pass as
// an exact int32 (255 H W < 2^31: H W <= 8,421,504). It is bound by
// memory latency: at T = 128 a CTA holds one frame with 8 warps (PERF.md). A row's 8 sums go
// through the same reduce-scatter tree with selects in place of the
// permuted R rows, then L (read from global) is folded in row by row and
// the warps' sums added in warp order: the bit rules of form 0 hold here
// too, per geometry. Rᵀ takes 32 W bytes of shared memory: W <= 7,187.

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
constexpr int kGroup = 4;              // form 1: rows a warp projects at once
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
  long long frames;           // S*T
  int T, H, W;
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

// Form 1's predecessor of a pixel: a byte of frame t-1 (kCarry false), or
// at a segment's frame 0 the carry frame's whole-number float.
template <bool kCarry>
__device__ __forceinline__ int pred_at(const void* pred, size_t q) {
  return kCarry ? (__float2int_rn(__ldg(static_cast<const float*>(pred) + q)) & 0xff)
                : (int)__ldg(static_cast<const uint8_t*>(pred) + q);
}

// sum |cur - pred| over a whole frame (exact in int32), summed over the
// warp; unrolled so that many loads are in flight (frames come from L2).
template <bool kCarry>
__device__ __forceinline__ int frame_sad_general(const uint8_t* cur, const void* pred,
                                                 int hw) {
  int acc = 0;
#pragma unroll 8
  for (int q = threadIdx.x; q < hw; q += kThreads)
    acc += abs((int)__ldg(cur + q) - pred_at<kCarry>(pred, q));
  return __reduce_add_sync(kFull, acc);
}

// A lane's 8 sums of one row -> tmp[h][lane >> 2], summed over the warp:
// reduce-scatter over offsets 16, 8, 4 (selects keep the lane's half),
// then sums over offsets 2, 1.
__device__ __forceinline__ float row_tree(const float (&a)[kHash], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float v[4], u[2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = (b4 ? a[q + 4] : a[q]) + __shfl_xor_sync(kFull, b4 ? a[q] : a[q + 4], 16);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    u[q] = (b3 ? v[q + 2] : v[q]) + __shfl_xor_sync(kFull, b3 ? v[q] : v[q + 2], 8);
  float d = (b2 ? u[1] : u[0]) + __shfl_xor_sync(kFull, b2 ? u[0] : u[1], 4);
  d += __shfl_xor_sync(kFull, d, 2);
  d += __shfl_xor_sync(kFull, d, 1);
  return d;
}

// One frame's share of form 1's work for a warp: sum |cur - pred| over its
// rows and L · (X · Rᵀ) folded into low0 / low1 (lane 4m + j: low[2j][m],
// low[2j + 1][m]). Warp w takes the row groups w, w + 8, ...; lane l the
// columns l, l + 32, ..., unrolled so that the loads of several columns
// are in flight at once (the frame comes from L2 or HBM).
template <bool kCarry>
__device__ __forceinline__ void project_frame(const uint8_t* cur, const void* pred,
                                              const float* left, const float4* s_r,
                                              int H, int W, int lane, int warp,
                                              int& sad, float& low0, float& low1) {
  const int j2 = 2 * (lane & 3);
  for (int h0 = kGroup * warp; h0 < H; h0 += kGroup * kWarps) {
    const int nr = min(kGroup, H - h0);
    float a[kGroup][kHash];
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
#pragma unroll
      for (int q = 0; q < kHash; ++q) a[r][q] = 0.0f;
    const size_t row0 = (size_t)h0 * W;
#pragma unroll 4
    for (int c = lane; c < W; c += 32) {
      const float4 r0 = s_r[c], r1 = s_r[W + c];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        if (r < nr) {
          const size_t q = row0 + (size_t)r * W + c;
          const int x = __ldg(cur + q);
          sad += abs(x - pred_at<kCarry>(pred, q));
          const float xf = (float)x;
          a[r][0] = fmaf(xf, r0.x, a[r][0]);
          a[r][1] = fmaf(xf, r0.y, a[r][1]);
          a[r][2] = fmaf(xf, r0.z, a[r][2]);
          a[r][3] = fmaf(xf, r0.w, a[r][3]);
          a[r][4] = fmaf(xf, r1.x, a[r][4]);
          a[r][5] = fmaf(xf, r1.y, a[r][5]);
          a[r][6] = fmaf(xf, r1.z, a[r][6]);
          a[r][7] = fmaf(xf, r1.w, a[r][7]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      if (r < nr) {                     // the same for the whole warp
        const float d = row_tree(a[r], lane);
        const float* lcol = left + h0 + r;
        low0 = fmaf(__ldg(lcol + (size_t)j2 * H), d, low0);
        low1 = fmaf(__ldg(lcol + (size_t)(j2 + 1) * H), d, low1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fingerprint_general_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H, W = p.W, T = p.T, hw = H * W;
  float4* s_r = reinterpret_cast<float4*>(smem);              // R[0..3][c], R[4..7][c]
  float* s_part = reinterpret_cast<float*>(s_r + 2 * W);      // (8 warps, 64)
  float* s_low = s_part + kWarps * kBits;                     // (64,)
  float* s_stat = s_low + kBits;                              // 2 per warp
  int* s_sum = reinterpret_cast<int*>(s_stat + 2 * kWarps);   // 2 per warp

  const long long n = p.frames;
  const long long lo = n * blockIdx.x / gridDim.x;
  const long long hi = n * (blockIdx.x + 1) / gridDim.x;
  if (lo >= hi) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j2 = 2 * (lane & 3);

  float* s_rf = reinterpret_cast<float*>(s_r);
  for (int q = tid; q < kHash * W; q += kThreads) {           // right is (8, W)
    const int r = q / W, c = q - r * W;
    s_rf[((r >> 2) * W + c) * 4 + (r & 3)] = p.right[q];
  }
  int s = (int)(lo / T);
  int t = (int)(lo - (long long)s * T);
  const bool inside = t > 0;
  bool fresh = p.seg[s].has_prev[0] == 0;
  float carried = p.seg[s].carry_mafd[0];
  __syncthreads();

  float prev_m = 0.0f;                  // masked mafd of frame k-1
  for (long long k = lo; k < hi; ++k) {
    const int i = (int)(k - lo);
    if (i > 0 && ++t == T) {
      t = 0;
      ++s;
      fresh = p.seg[s].has_prev[0] == 0;
      carried = p.seg[s].carry_mafd[0];
    }
    const uint8_t* cur = p.seg[s].luma + (size_t)t * hw;
    const bool first_inside = i == 0 && inside;
    if (first_inside) {                 // frame lo - 1 against lo - 2 or the carry
      const int acc = t == 1
          ? frame_sad_general<true>(cur - hw, p.seg[s].carry_frame, hw)
          : frame_sad_general<false>(cur - hw, cur - 2 * (size_t)hw, hw);
      if (lane == 0) s_sum[kWarps + warp] = acc;
    }
    // Warp w takes the row groups w, w + 8, ...; lane 4m + j sums low[2j][m]
    // and low[2j + 1][m] over their rows, in row order.
    int sad = 0;
    float low0 = 0.0f, low1 = 0.0f;
    if (t == 0)
      project_frame<true>(cur, p.seg[s].carry_frame, p.left, s_r, H, W, lane,
                          warp, sad, low0, low1);
    else
      project_frame<false>(cur, cur - hw, p.left, s_r, H, W, lane, warp, sad,
                           low0, low1);
    sad = __reduce_add_sync(kFull, sad);
    if (lane == 0) s_sum[warp] = sad;
    s_part[warp * kBits + j2 * kHash + (lane >> 2)] = low0;
    s_part[warp * kBits + (j2 + 1) * kHash + (lane >> 2)] = low1;
    __syncthreads();

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
      for (int q = tid; q < hw; q += kThreads) dst[q] = (float)__ldg(cur + q);
      if (tid == 0) {
        p.new_mafd[s] = m;
        p.new_has_prev[s] = 1;
      }
    }
    prev_m = m;
    __syncthreads();                    // s_sum and s_part are free again
  }
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

size_t smem_bytes(int form, int H, int W) {
  const size_t common = sizeof(float) * (kWarps * kBits + kBits + 2 * kWarps)
                      + sizeof(int) * 2 * kWarps;
  return form == 0 ? (size_t)3 * H * W + sizeof(float) * kHash * H + common
                   : sizeof(float) * kHash * W + common;
}

// Whether form ``form`` takes (H, W) (ops/fused.py k1_form decides).
bool form_takes(int form, int H, int W) {
  if (H < 1 || W < 1 || (long long)H * W > kMaxPixels) return false;
  if (smem_bytes(form, H, W) > (size_t)kMaxSmem) return false;
  return form == 1 || (form == 0 && W >= 4 && W <= kMaxWidth && W % 4 == 0 &&
                       (H * W) % 16 == 0);
}

// CTAs of a form's kernel resident on the whole card, per device. The
// largest dynamic shared memory opted into is kept per device and form, so
// a later call with a smaller frame never lowers it under an earlier one.
int resident_ctas(int form, size_t smem, int* out) {
  static int cached_smem[2][16], cached_ctas[2][16], opted_in[2][16];
  const void* fn = form == 0 ? (const void*)fingerprint_segments_kernel
                             : (const void*)fingerprint_general_kernel;
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

}  // namespace

extern "C" {

const char* tvz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One launch over S segments of T frames, by form 0 or 1 (see the header).
// ``table`` is a host array of 7 + 5 S int64: the left and right
// operators, then the outputs (allocated by the caller): scores (S*T,)
// f32, fps (S*T, 2) i32, new_frame (S, H, W) f32, new_mafd (S,) f32,
// new_has_prev (S,) u8; then per segment the luma pointers, carry-frame
// pointers, carry-mafd pointers, has-prev pointers and valid_t, S of each.
// Form 0 needs the luma and carry-frame pointers 16-byte aligned.
int tvz_fingerprint_segments(int form, int S, int T, int H, int W,
                             const long long* table, void* stream) {
  if (S < 1 || S > kMaxSegments || T < 1 || (form != 0 && form != 1) ||
      !form_takes(form, H, W)) {
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
  const long long* segs = table + 7;
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
  const size_t smem = smem_bytes(form, H, W);
  int ctas = 0;
  const int rc = resident_ctas(form, smem, &ctas);
  if (rc != 0) return rc;
  const long long grid = p.frames < ctas ? p.frames : ctas;
  if (form == 0)
    fingerprint_segments_kernel<<<(unsigned)grid, kThreads, smem,
                                  (cudaStream_t)stream>>>(p);
  else
    fingerprint_general_kernel<<<(unsigned)grid, kThreads, smem,
                                 (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The grid a call of form ``form`` over ``frames`` frames of (H, W)
// launches on this device.
int tvz_fingerprint_grid(int form, long long frames, int H, int W, int* out) {
  if ((form != 0 && form != 1) || !form_takes(form, H, W))
    return (int)cudaErrorInvalidValue;
  int ctas = 0;
  const int rc = resident_ctas(form, smem_bytes(form, H, W), &ctas);
  if (rc != 0) return rc;
  *out = (int)(frames < ctas ? frames : ctas);
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
