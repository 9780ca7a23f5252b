// K3 — fragment alignment: Q packed 64-bit query sequences against a bucket
// of V corpus sequences, best temporal offset of each query in each video.
//
// Replaces tvidz_tpu/ops/align_pallas.py::_fragment_kernel (wrappers
// fragment_search_pallas_batch / fragment_search_pallas); the contract is
// ops/align.fragment_core's, exactly:
//   score[q, v, o] = #{ t < q_len[q] : 0 <= t+o < len[v],
//                       popcount(qs[q, t] ^ corpus[v, t+o]) <= thr }
//   for o in [-(Tq_pad-1), Tc-1], d = o + Tq_pad - 1 the score row index;
//   scores[q, v] = max_o score,  offs[q, v] = the FIRST o attaining it
// (an all-zero row reports -(Tq_pad-1)). Rows are two 32-bit words read as
// one 64-bit value, as in K2. Counts are int32 throughout.
//
// What the TPU kernel did and this one does not: it reversed the query rows
// on the host, unpacked bits to +-1 bf16 for the MXU, transposed the corpus
// word-major and summed anti-diagonals with a halves-split roll tree — all
// Mosaic workarounds. K3 reads the packed row-major (V, Tc, 2) bucket as the
// corpus syncs it.
//
// What bounds it on the H100: the work is q_len x len[v] (XOR, POPC,
// compare, add) per (query, video) — 805 M pairs at the service's 1k-video
// x 1024-frame bucket with a 768-frame query — against 8 MB of corpus, so
// integer issue (two POPC per pair), not HBM. Design, right first:
// - grid (V x offset tiles, Q); each thread owns one offset d of a
//   256-offset tile and keeps its count in a register;
// - query rows are staged 256 at a time in shared memory and broadcast; the
//   corpus window those rows touch for the tile's offsets (512 rows) is
//   staged beside them, so a thread reads corpus row t+o from shared memory
//   (neighbouring threads, neighbouring rows);
// - a thread loops only over the rows valid for its offset (t < q_len,
//   0 <= t+o < len[v]), so padding needs no sentinel value;
// - the tile's best is one 64-bit key (score << 32 | 0x7fffffff - d): the
//   maximum key is the maximum score at the FIRST d. A warp shuffle max and
//   one shared pass reduce the tile, and one global 64-bit atomicMax per
//   (tile, query, video) combines the tiles — exact across tiles, like K2's
//   packed argmin key. Keys start at the all-zero row's answer (score 0,
//   d 0), so a tile with no match issues no atomic;
// - a small second launch unpacks the keys into (offs, scores).
// An int8 tensor-core +-1 formulation or tiling both axes through shared
// memory are the levers for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // offsets per CTA (one per thread)
constexpr int kRows = 256;      // query rows staged per step
constexpr unsigned long long kZeroKey = 0x7fffffffull;   // score 0 at d = 0

__global__ void init_keys_kernel(unsigned long long* __restrict__ keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = kZeroKey;
}

__global__ void __launch_bounds__(kThreads)
fragment_search_kernel(const unsigned long long* __restrict__ qs,
                       const int32_t* __restrict__ q_lens, int Tq_pad,
                       const unsigned long long* __restrict__ corpus,
                       const int32_t* __restrict__ lens, int V, int Tc,
                       int thr, int tiles,
                       unsigned long long* __restrict__ keys) {
  __shared__ unsigned long long s_q[kRows];
  __shared__ unsigned long long s_c[kRows + kThreads];
  __shared__ unsigned long long s_warp[kThreads / 32];

  const int tid = threadIdx.x;
  const int qi = blockIdx.y;
  const int v = blockIdx.x / tiles;
  const int d0 = (blockIdx.x % tiles) * kThreads;
  const int nd = Tq_pad + Tc - 1;           // score row length
  const int d = d0 + tid;
  const int o = d - (Tq_pad - 1);           // this thread's offset
  const int o0 = d0 - (Tq_pad - 1);         // the tile's first offset
  const int q_len = min(max(q_lens[qi], 0), Tq_pad);
  const int c_len = min(max(lens[v], 0), Tc);
  const unsigned long long* qrow = qs + (size_t)qi * Tq_pad;
  const unsigned long long* crow = corpus + (size_t)v * Tc;

  // Rows some offset of the tile can use: t + o0 + kThreads - 1 >= 0 and
  // t + o0 < c_len, t < q_len.
  const int t_begin = max(0, -(o0 + kThreads - 1));
  const int t_end = min(q_len, c_len - o0);
  int count = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += kRows) {
    __syncthreads();
    for (int i = tid; i < kRows; i += kThreads) {
      const int t = t0 + i;
      s_q[i] = t < t_end ? qrow[t] : 0ull;
    }
    const int j0 = t0 + o0;                 // corpus row of (t0, o0)
    for (int i = tid; i < kRows + kThreads; i += kThreads) {
      const int j = j0 + i;
      s_c[i] = (j >= 0 && j < c_len) ? crow[j] : 0ull;
    }
    __syncthreads();
    if (d < nd) {
      const int lo = max(t0, -o);
      const int hi = min(min(t0 + kRows, q_len), c_len - o);
#pragma unroll 4
      for (int t = lo; t < hi; ++t) {
        const int r = t - t0;
        count += __popcll(s_q[r] ^ s_c[r + tid]) <= thr;
      }
    }
  }

  unsigned long long key = (d < nd && count > 0)
      ? ((unsigned long long)count << 32) | (unsigned long long)(0x7fffffff - d)
      : 0ull;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, s);
    key = other > key ? other : key;
  }
  if ((tid & 31) == 0) s_warp[tid >> 5] = key;
  __syncthreads();
  if (tid == 0) {
    unsigned long long best = s_warp[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) best = s_warp[w] > best ? s_warp[w] : best;
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
  const long long tiles = (nd + kThreads - 1) / kThreads;
  if (nd >= 0x7fffffffll || tiles * V >= 0x7fffffffll ||
      (long long)Q * V >= 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = Q * V;
  init_keys_kernel<<<(n + 255) / 256, 256, 0, s>>>((unsigned long long*)keys, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(tiles * V), (unsigned)Q);
  fragment_search_kernel<<<grid, kThreads, 0, s>>>(
      (const unsigned long long*)qs, (const int32_t*)q_lens, Tq_pad,
      (const unsigned long long*)corpus, (const int32_t*)lens, V, Tc, thr,
      (int)tiles, (unsigned long long*)keys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  unpack_keys_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      (const unsigned long long*)keys, n, Tq_pad, (int32_t*)offs,
      (int32_t*)scores);
  return (int)cudaGetLastError();
}

}  // extern "C"
