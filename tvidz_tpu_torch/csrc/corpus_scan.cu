// K2 — corpus scan: M packed query fingerprints against N corpus
// fingerprints, rows of W 32-bit words (W = 2: the 64-bit pHash).
//
// Replaces tvidz_tpu/ops/hamming.py::_corpus_scan_kernel (the XOR+popcount
// contract and bit-parity baseline) and ::_corpus_scan_kernel_mxu_twophase
// (the TPU production scan behind DeviceCorpus.nearest_video_counts); both
// have one contract:
//   frame_min[n] = min_m popcount(q[m] ^ c[n])            (N,) int32
//   q_min[m]     = min_n popcount(q[m] ^ c[n])            (M,) int32
//   q_arg[m]     = the FIRST n attaining q_min[m]          (M,) int32
// At W = 2 rows are two 32-bit words read as one 64-bit value: the
// distance is __popcll of the XOR whichever way the words are packed, as
// long as query and corpus are packed alike. Any other W runs
// corpus_scan_chunked_kernel: one row a thread, 256 rows a CTA, the words
// walked in chunks of kChunkWords staged word-major in shared memory (word
// w of row r at w * kThreads + r, no bank conflicts on the reads; staged
// once when a row fits one chunk), the query words read by every thread
// from global memory (one broadcast), 16 queries' distances held in
// registers across the chunks, so that the min and the key see only the
// whole distance (the key packs distance << 8 | row in the CTA; its
// distance field is 24 bits: W < 2^19). frame_min is optional (null
// pointer), and
// tvz_corpus_frame_min computes frame_min alone: its instance skips the
// per-query key work (warp minimum, atomics, key unpack) entirely — the
// search_fingerprints contract, raced against K4's frame_min mode.
//
// What bounds it on the H100: the corpus is read once, 8 bytes a row
// (8 MB at 2^20 rows, a few microseconds of HBM at 3.35 TB/s), while the
// work is M x N (XOR, popcount, min) — ~134 M pairs at M=128, N=2^20 —
// so it is bound by integer issue, not memory. Design, right first:
// - queries (M x 8 B) sit in shared memory and are broadcast to the warp;
// - each thread holds 4 corpus rows in registers (coalesced: neighbouring
//   threads, neighbouring rows) and keeps their frame_min in registers;
// - per query, a warp packs (distance << 16 | row-in-block) into 32 bits,
//   takes the warp minimum with one __reduce_min_sync, and lane 0 does a
//   shared atomicMin; after the rows, one global 64-bit atomicMin per
//   (CTA, query) on (distance << 32 | global row). The key orders by
//   distance, then by row, so the minimum is the first-index argmin
//   exactly, ties included — it replaces the TPU kernel's sequential
//   accumulator, which CUDA's unordered blocks cannot keep;
// - a tiny second launch unpacks the keys into (q_min, q_arg).
// The two-phase gate of the TPU kernel (argmin only where a query
// improves) has no counterpart yet; here the argmin costs one warp
// reduction per query, which a later change can gate the same way.
// 1 <= M <= 16384 a launch (the wrapper, ops/hamming.py, splits more).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;   // < 2^16
// The chunked instance (W != 2): words staged a chunk at a time, distances
// of kChunkQueries queries held per thread; its key packs (distance << 8 |
// row in the CTA), so W < 2^19.
constexpr int kChunkWords = 32;
constexpr int kChunkQueries = 16;
constexpr int kMaxKeyWords = (1 << 19) - 1;
constexpr int kMaxSmem = 232448;             // a block's shared memory on Hopper

template <bool kKeys>
__global__ void __launch_bounds__(kThreads)
corpus_scan_kernel(const unsigned long long* __restrict__ q, int M,
                   const unsigned long long* __restrict__ corpus, int N,
                   int32_t* __restrict__ frame_min,
                   unsigned long long* __restrict__ keys) {
  extern __shared__ unsigned long long s_q[];               // (M,)
  unsigned int* s_key = reinterpret_cast<unsigned int*>(s_q + M);   // (M,)
  const int tid = threadIdx.x;
  for (int i = tid; i < M; i += kThreads) {
    s_q[i] = q[i];
    if (kKeys) s_key[i] = 0xffffffffu;
  }
  __syncthreads();

  const int base = blockIdx.x * kRowsPerBlock;
  unsigned long long c[kRowsPerThread];
  bool valid[kRowsPerThread];
  int fmin[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int row = base + k * kThreads + tid;
    valid[k] = row < N;
    c[k] = valid[k] ? corpus[row] : 0ull;
    fmin[k] = 0x7fffffff;
  }

  for (int m = 0; m < M; ++m) {
    const unsigned long long qm = s_q[m];
    unsigned int best = 0xffffffffu;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (valid[k]) {
        const int d = __popcll(qm ^ c[k]);
        fmin[k] = min(fmin[k], d);
        if (kKeys)
          best = min(best, ((unsigned)d << 16) | (unsigned)(k * kThreads + tid));
      }
    }
    if (kKeys) {
      best = __reduce_min_sync(0xffffffffu, best);
      if ((tid & 31) == 0 && best != 0xffffffffu) atomicMin(&s_key[m], best);
    }
  }

  if (frame_min != nullptr) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (valid[k]) frame_min[base + k * kThreads + tid] = fmin[k];
    }
  }
  if (!kKeys) return;
  __syncthreads();
  for (int m = tid; m < M; m += kThreads) {
    const unsigned int lk = s_key[m];
    if (lk != 0xffffffffu) {
      const unsigned long long g =
          ((unsigned long long)(lk >> 16) << 32) |
          (unsigned long long)(unsigned)(base + (int)(lk & 0xffffu));
      atomicMin(&keys[m], g);
    }
  }
}

template <bool kKeys>
__global__ void __launch_bounds__(kThreads)
corpus_scan_chunked_kernel(const uint32_t* __restrict__ q, int M,
                           const uint32_t* __restrict__ corpus, int N, int W,
                           int32_t* __restrict__ frame_min,
                           unsigned long long* __restrict__ keys) {
  extern __shared__ unsigned int s_dyn[];
  unsigned int* s_key = s_dyn;                               // (M,) if kKeys
  uint32_t* s_c = s_dyn + (kKeys ? M : 0);                   // (kChunkWords, kThreads)
  const int tid = threadIdx.x;
  if (kKeys)
    for (int i = tid; i < M; i += kThreads) s_key[i] = 0xffffffffu;
  const int base = blockIdx.x * kThreads;
  const int rows = min(kThreads, N - base);
  const bool valid = tid < rows;
  int fmin = 0x7fffffff;
  for (int q0 = 0; q0 < M; q0 += kChunkQueries) {
    const int qn = min(kChunkQueries, M - q0);
    int d[kChunkQueries];
#pragma unroll
    for (int j = 0; j < kChunkQueries; ++j) d[j] = 0;
    for (int c0 = 0; c0 < W; c0 += kChunkWords) {
      const int wc = min(kChunkWords, W - c0);
      if (q0 == 0 || W > kChunkWords) {      // one chunk: staged once
        __syncthreads();                     // the last chunk was read
        for (int i = tid; i < rows * wc; i += kThreads) {
          const int r = i / wc, w = i - r * wc;
          s_c[w * kThreads + r] = corpus[(size_t)(base + r) * W + c0 + w];
        }
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < kChunkQueries; ++j) {
        if (j < qn) {
          const uint32_t* qm = q + (size_t)(q0 + j) * W + c0;
          int sum = 0;
          for (int w = 0; w < wc; ++w) sum += __popc(__ldg(qm + w) ^ s_c[w * kThreads + tid]);
          d[j] += sum;
        }
      }
    }
    // The whole distances: the row's min and the queries' keys.
#pragma unroll
    for (int j = 0; j < kChunkQueries; ++j) {
      if (j < qn) {
        if (valid) fmin = min(fmin, d[j]);
        if (kKeys) {
          unsigned int best = valid ? ((unsigned)d[j] << 8) | (unsigned)tid : 0xffffffffu;
          best = __reduce_min_sync(0xffffffffu, best);
          if ((tid & 31) == 0 && best != 0xffffffffu) atomicMin(&s_key[q0 + j], best);
        }
      }
    }
  }
  if (frame_min != nullptr && valid) frame_min[base + tid] = fmin;
  if (!kKeys) return;
  __syncthreads();
  for (int m = tid; m < M; m += kThreads) {
    const unsigned int lk = s_key[m];
    if (lk != 0xffffffffu) {
      const unsigned long long g =
          ((unsigned long long)(lk >> 8) << 32) |
          (unsigned long long)(unsigned)(base + (int)(lk & 0xffu));
      atomicMin(&keys[m], g);
    }
  }
}

__global__ void unpack_keys_kernel(const unsigned long long* __restrict__ keys,
                                   int M, int32_t* __restrict__ q_min,
                                   int32_t* __restrict__ q_arg) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < M) {
    q_min[m] = (int32_t)(keys[m] >> 32);
    q_arg[m] = (int32_t)(keys[m] & 0xffffffffull);
  }
}

// Opts ``fn`` in to the most dynamic shared memory a block may have where
// ``smem`` is above the default 48 KB: never less than an earlier call
// asked for, so a narrower call never lowers the limit under a wider one.
cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

// One scan launch, frame_min into ``frame_min`` if not null and the keys
// into ``keys`` if not null (the keys instance).
cudaError_t scan(const void* q, int M, const void* corpus, int N, int W,
                 void* frame_min, void* keys, cudaStream_t s) {
  const int blocks = (int)(((long long)N + kRowsPerBlock - 1) / kRowsPerBlock);
  const bool with_keys = keys != nullptr;
  cudaError_t e;
  if (W == 2) {
    const size_t smem = (size_t)M * (sizeof(unsigned long long) +
                                     (with_keys ? sizeof(unsigned int) : 0));
    const void* fn = with_keys ? (const void*)corpus_scan_kernel<true>
                               : (const void*)corpus_scan_kernel<false>;
    if ((e = allow_smem(fn, smem)) != cudaSuccess) return e;
    if (with_keys)
      corpus_scan_kernel<true><<<blocks, kThreads, smem, s>>>(
          (const unsigned long long*)q, M, (const unsigned long long*)corpus, N,
          (int32_t*)frame_min, (unsigned long long*)keys);
    else
      corpus_scan_kernel<false><<<blocks, kThreads, smem, s>>>(
          (const unsigned long long*)q, M, (const unsigned long long*)corpus, N,
          (int32_t*)frame_min, nullptr);
  } else {
    const size_t smem = sizeof(unsigned int) *
                        ((with_keys ? (size_t)M : 0) + (size_t)kChunkWords * kThreads);
    const int cblocks = (int)(((long long)N + kThreads - 1) / kThreads);
    const void* fn = with_keys ? (const void*)corpus_scan_chunked_kernel<true>
                               : (const void*)corpus_scan_chunked_kernel<false>;
    if ((e = allow_smem(fn, smem)) != cudaSuccess) return e;
    if (with_keys)
      corpus_scan_chunked_kernel<true><<<cblocks, kThreads, smem, s>>>(
          (const uint32_t*)q, M, (const uint32_t*)corpus, N, W,
          (int32_t*)frame_min, (unsigned long long*)keys);
    else
      corpus_scan_chunked_kernel<false><<<cblocks, kThreads, smem, s>>>(
          (const uint32_t*)q, M, (const uint32_t*)corpus, N, W,
          (int32_t*)frame_min, nullptr);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tvz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (M, W) and corpus (N, W) int32 rows, 1 <= M <= 16384 and W in
// [1, kMaxKeyWords] (the chunked instance's key); frame_min (N,) int32
// or null; keys (M,) uint64 scratch; q_min, q_arg (M,) int32.
int tvz_corpus_scan(const void* q, int M, const void* corpus, int N, int W,
                    void* frame_min, void* keys, void* q_min, void* q_arg,
                    void* stream) {
  if (M <= 0 || M > 16384 || N <= 0 || W < 1 || W > kMaxKeyWords)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(keys, 0xff, (size_t)M * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  e = scan(q, M, corpus, N, W, frame_min, keys, s);
  if (e != cudaSuccess) return (int)e;
  unpack_keys_kernel<<<(M + 255) / 256, 256, 0, s>>>(
      (const unsigned long long*)keys, M, (int32_t*)q_min, (int32_t*)q_arg);
  return (int)cudaGetLastError();
}

// frame_min (N,) int32 only: no keys, no atomics, one launch.
int tvz_corpus_frame_min(const void* q, int M, const void* corpus, int N, int W,
                         void* frame_min, void* stream) {
  if (M <= 0 || M > 16384 || N <= 0 || W < 1 || W > kMaxKeyWords ||
      frame_min == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)scan(q, M, corpus, N, W, frame_min, nullptr, (cudaStream_t)stream);
}

}  // extern "C"
