// K1 — fingerprint block: scene scores + 64-bit DCT pHash for T luma frames.
//
// Replaces tvidz_tpu/ops/fused_pallas.py::_fused_kernel (and, on the port's
// path, the XLA composition tvidz_tpu/ops/fused.py::fingerprint_block it was
// raced against). Same function as ops/fused.py's plain version:
//   mafd[t]  = mean |x[t] - x[t-1]|  (x[-1] = the carry frame)
//   score[t] = clip(min(mafd, |mafd - prev_mafd|) / 100, 0, 1), with the
//              stream's frame 0 masked to 0
//   hash[t]  = MSB-first pack of (low > median(low)), low = L · X · Rᵀ,
//              L = (D·P_h)[:8] (8, H), R = (D·P_w)[:8] (8, W), float32.
//
// What bounds it on the H100: one 90x160 frame is 14.4 KB of u8 luma and
// ~0.12 MFLOP of fp32 FMA (the factored operators), so a 128-frame block
// is 1.8 MB read + 15 MFLOP — far below both rooflines; at this size the
// launch and the per-CTA serial phases (a 160-long dot per output, the
// 64x64 rank count) dominate. Design, right first and simple:
// - one CTA per frame; it reads frame t and frame t-1 straight from u8
//   (4x fewer bytes than widening to f32 first) and sums |Δ| in int32.
//   The sum is < 2^24 at 90x160, so it is exact in any order, and
//   mafd = (float)sum / (float)(H*W) is a true division like jnp.mean;
// - the frame stays in shared memory as u8; tmp = X·Rᵀ (H x 8) then
//   low = L·tmp (8 x 8), plain fp32 FMA in a fixed order;
// - the median of the 64 values by rank counting (exact with ties:
//   s_m = min{v : #{u <= v} >= m+1}), then strict '>' and a warp ballot;
// - the TPU kernel carried prev_mafd in SMEM across a sequential grid.
//   CUDA blocks run in parallel and in no order, so a second one-CTA launch
//   turns the T mafd values into scores (stream-start mask, carry
//   prev_mafd, '/100.0f', clip) and writes the new carry's prev_mafd at
//   valid_t-1; the frame CTA for valid_t-1 writes the carry frame.
// The carry frame holds whole numbers (it is a previous u8 frame), so
// converting it to int for frame 0's difference is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHash = 8;
constexpr int kBits = kHash * kHash;   // 64 coefficients, 2 words
constexpr int kThreads = 256;

// Median threshold + MSB-first pack of 64 coefficients in shared memory.
// Called by every thread of the block (it synchronises); threads 0..63
// each own one coefficient. Writes 2 int32 words (uint32 bit patterns).
__device__ void median_threshold_pack(const float* s_low, float* s_stat,
                                      int32_t* out_words) {
  const int i = threadIdx.x;
  float v = 0.0f;
  float lo = __int_as_float(0x7f800000);   // +inf
  float hi = lo;
  if (i < kBits) {
    v = s_low[i];
    int rank = 0;                           // #{u : u <= v}
    for (int j = 0; j < kBits; ++j) rank += (s_low[j] <= v) ? 1 : 0;
    if (rank >= kBits / 2) lo = v;          // candidates for order stat 31
    if (rank >= kBits / 2 + 1) hi = v;      // candidates for order stat 32
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fminf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if ((i & 31) == 0) {
      s_stat[(i >> 5) * 2] = lo;
      s_stat[(i >> 5) * 2 + 1] = hi;
    }
  }
  __syncthreads();
  if (i < kBits) {
    const float s_lo = fminf(s_stat[0], s_stat[2]);
    const float s_hi = fminf(s_stat[1], s_stat[3]);
    const float med = (s_lo + s_hi) * 0.5f;
    const unsigned ballot = __ballot_sync(0xffffffffu, v > med);
    // Lane j holds bit j of the word; MSB-first puts bit j at 31 - j.
    if ((i & 31) == 0) out_words[i >> 5] = (int32_t)__brev(ballot);
  }
}

__global__ void __launch_bounds__(kThreads)
fingerprint_frames_kernel(const uint8_t* __restrict__ luma,     // (T, H, W)
                          const float* __restrict__ carry_frame,  // (H, W)
                          const float* __restrict__ left,         // (8, H)
                          const float* __restrict__ right,        // (8, W)
                          int H, int W, int last,
                          float* __restrict__ mafd,               // (T,)
                          int32_t* __restrict__ fps,              // (T, 2)
                          float* __restrict__ new_frame) {        // (H, W)
  extern __shared__ float smem[];
  const int hw = H * W;
  float* s_right_t = smem;                  // (W, 8): s_right_t[w*8+r]
  float* s_left = s_right_t + W * kHash;    // (8, H)
  float* s_tmp = s_left + kHash * H;        // (H, 8)
  float* s_low = s_tmp + H * kHash;         // (64,)
  float* s_stat = s_low + kBits;            // 4 order-statistic partials
  int* s_sum = reinterpret_cast<int*>(s_stat + 4);             // 8 warps
  uint8_t* s_x = reinterpret_cast<uint8_t*>(s_sum + kThreads / 32);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* x = luma + (size_t)t * hw;

  int acc = 0;
  if (t > 0) {
    const uint8_t* p = x - hw;
    for (int i = tid; i < hw; i += kThreads) {
      const int a = x[i];
      s_x[i] = (uint8_t)a;
      acc += abs(a - (int)p[i]);
    }
  } else {
    for (int i = tid; i < hw; i += kThreads) {
      const int a = x[i];
      s_x[i] = (uint8_t)a;
      acc += abs(a - __float2int_rn(carry_frame[i]));
    }
  }
  if (t == last) {
    for (int i = tid; i < hw; i += kThreads) new_frame[i] = (float)x[i];
  }
  for (int i = tid; i < W * kHash; i += kThreads) {
    const int w = i / kHash, r = i % kHash;
    s_right_t[i] = right[r * W + w];
  }
  for (int i = tid; i < kHash * H; i += kThreads) s_left[i] = left[i];

  acc = __reduce_add_sync(0xffffffffu, acc);
  if ((tid & 31) == 0) s_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int k = 0; k < kThreads / 32; ++k) total += s_sum[k];
    mafd[t] = (float)total / (float)hw;
  }

  // tmp[h][r] = sum_w x[h][w] * R[r][w]
  for (int o = tid; o < H * kHash; o += kThreads) {
    const int h = o / kHash, r = o % kHash;
    const uint8_t* row = s_x + h * W;
    float a = 0.0f;
    for (int w = 0; w < W; ++w) a = fmaf((float)row[w], s_right_t[w * kHash + r], a);
    s_tmp[o] = a;
  }
  __syncthreads();
  // low[s][r] = sum_h L[s][h] * tmp[h][r]
  if (tid < kBits) {
    const int s = tid / kHash, r = tid % kHash;
    const float* lrow = s_left + s * H;
    float a = 0.0f;
    for (int h = 0; h < H; ++h) a = fmaf(lrow[h], s_tmp[h * kHash + r], a);
    s_low[tid] = a;
  }
  __syncthreads();
  median_threshold_pack(s_low, s_stat, fps + (size_t)t * 2);
}

__global__ void scene_scores_kernel(const float* __restrict__ mafd,
                                    const float* __restrict__ carry_mafd,
                                    const uint8_t* __restrict__ has_prev,
                                    int T, int last,
                                    float* __restrict__ scores,
                                    float* __restrict__ new_mafd,
                                    uint8_t* __restrict__ new_has_prev) {
  const bool start = has_prev[0] == 0;
  const float carried = carry_mafd[0];
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const float m = (start && i == 0) ? 0.0f : mafd[i];
    const float pm = (i == 0) ? carried
                   : ((start && i == 1) ? 0.0f : mafd[i - 1]);
    float s = fminf(m, fabsf(m - pm)) / 100.0f;
    s = fminf(fmaxf(s, 0.0f), 1.0f);
    scores[i] = (start && i == 0) ? 0.0f : s;
    if (i == last) new_mafd[0] = m;
  }
  if (threadIdx.x == 0) new_has_prev[0] = 1;
}

__global__ void median_pack_kernel(const float* __restrict__ low,  // (N, 64)
                                   int32_t* __restrict__ out) {    // (N, 2)
  __shared__ float s_low[kBits];
  __shared__ float s_stat[4];
  const int n = blockIdx.x;
  s_low[threadIdx.x] = low[(size_t)n * kBits + threadIdx.x];
  __syncthreads();
  median_threshold_pack(s_low, s_stat, out + (size_t)n * 2);
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

const char* tvz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One 64-bit-hash fingerprint block. valid_t in [1, T]: the carry is taken
// at frame valid_t-1. Outputs and scratch are allocated by the caller.
int tvz_fingerprint_block(const void* luma, const void* carry_frame,
                          const void* carry_mafd, const void* has_prev,
                          const void* left, const void* right,
                          int T, int H, int W, int valid_t,
                          void* mafd_scratch, void* scores, void* fps,
                          void* new_frame, void* new_mafd, void* new_has_prev,
                          void* stream) {
  if (T <= 0 || H <= 0 || W <= 0 || valid_t < 1 || valid_t > T ||
      (long long)H * W * 255 >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = sizeof(float) * (W * kHash + kHash * H + H * kHash + kBits + 4)
                    + sizeof(int) * (kThreads / 32) + (size_t)H * W;
  cudaError_t e = set_smem((const void*)fingerprint_frames_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  fingerprint_frames_kernel<<<T, kThreads, smem, s>>>(
      (const uint8_t*)luma, (const float*)carry_frame, (const float*)left,
      (const float*)right, H, W, valid_t - 1, (float*)mafd_scratch,
      (int32_t*)fps, (float*)new_frame);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scene_scores_kernel<<<1, kThreads, 0, s>>>(
      (const float*)mafd_scratch, (const float*)carry_mafd,
      (const uint8_t*)has_prev, T, valid_t - 1, (float*)scores,
      (float*)new_mafd, (uint8_t*)new_has_prev);
  return (int)cudaGetLastError();
}

// Median threshold + pack alone, from given (N, 64) coefficients: the exact
// device code K1 runs, exposed so its tie handling can be checked bit for
// bit against the plain version.
int tvz_median_pack(const void* low, int N, void* out, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  median_pack_kernel<<<N, kBits, 0, (cudaStream_t)stream>>>(
      (const float*)low, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
