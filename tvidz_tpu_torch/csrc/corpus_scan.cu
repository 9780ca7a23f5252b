// K2 — corpus scan: M packed 64-bit query hashes against N corpus hashes.
//
// Replaces tvidz_tpu/ops/hamming.py::_corpus_scan_kernel (the XOR+popcount
// contract and bit-parity baseline) and ::_corpus_scan_kernel_mxu_twophase
// (the TPU production scan behind DeviceCorpus.nearest_video_counts); both
// have one contract:
//   frame_min[n] = min_m popcount(q[m] ^ c[n])            (N,) int32
//   q_min[m]     = min_n popcount(q[m] ^ c[n])            (M,) int32
//   q_arg[m]     = the FIRST n attaining q_min[m]          (M,) int32
// Rows are two 32-bit words read as one 64-bit value: the distance is
// __popcll of the XOR whichever way the words are packed, as long as query
// and corpus are packed alike. frame_min is optional (null pointer).
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kRowsPerBlock = kThreads * kRowsPerThread;   // < 2^16

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
    s_key[i] = 0xffffffffu;
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
        best = min(best, ((unsigned)d << 16) | (unsigned)(k * kThreads + tid));
      }
    }
    best = __reduce_min_sync(0xffffffffu, best);
    if ((tid & 31) == 0 && best != 0xffffffffu) atomicMin(&s_key[m], best);
  }

  if (frame_min != nullptr) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      if (valid[k]) frame_min[base + k * kThreads + tid] = fmin[k];
    }
  }
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

__global__ void unpack_keys_kernel(const unsigned long long* __restrict__ keys,
                                   int M, int32_t* __restrict__ q_min,
                                   int32_t* __restrict__ q_arg) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < M) {
    q_min[m] = (int32_t)(keys[m] >> 32);
    q_arg[m] = (int32_t)(keys[m] & 0xffffffffull);
  }
}

}  // namespace

extern "C" {

const char* tvz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (M,) and corpus (N,) 64-bit rows; frame_min (N,) int32 or null;
// keys (M,) uint64 scratch; q_min, q_arg (M,) int32.
int tvz_corpus_scan(const void* q, int M, const void* corpus, int N,
                    void* frame_min, void* keys, void* q_min, void* q_arg,
                    void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)M * (sizeof(unsigned long long) + sizeof(unsigned int));
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute((const void*)corpus_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaMemsetAsync(keys, 0xff, (size_t)M * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)(((long long)N + kRowsPerBlock - 1) / kRowsPerBlock);
  corpus_scan_kernel<<<blocks, kThreads, smem, s>>>(
      (const unsigned long long*)q, M, (const unsigned long long*)corpus, N,
      (int32_t*)frame_min, (unsigned long long*)keys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  unpack_keys_kernel<<<(M + 255) / 256, 256, 0, s>>>(
      (const unsigned long long*)keys, M, (int32_t*)q_min, (int32_t*)q_arg);
  return (int)cudaGetLastError();
}

}  // extern "C"
