// Fused descriptor matcher: the Hamming distances of packed binary
// descriptors, the pair mask, and best-match selection (distance threshold,
// best / second-best ratio, mutual consistency) in one pass, without the
// (B, Na, Nb) distance matrix ever reaching device memory.
//
// Computes exactly svin_tpu_torch/ops/hamming.py::match_descriptors_plain,
// i.e. match(hamming_matrix_plain(a, b), valid_a x valid_b & mask, ...):
// masked pairs read BIG = 1 << 20; the row argmin takes the lowest column
// among ties and the column argmin the lowest row; a fully masked row gives
// best 0 at distance BIG; the ratio test compares in float32; mutual means
// col_best[best] == row.
//
// Replaces: svin_tpu/ops/hamming.py::hamming_matrix_pallas (kernel body
// _hamming_kernel) together with the selection that consumes its output
// (svin_tpu/ops/hamming.py::match), on the map, stereo and temporal
// matchers.
//
// What bounds it on the H100: bytes. The inputs, the mask, the validity
// flags and the outputs are 460,096 B at the map matcher's shape (2 x 400
// keypoints against 512 landmarks, mask 409,600 B) -> 0.137 us at 3.35
// TB/s; the 3.3 M popcounts are below any compute bound. What it does
// about it: the distance matrix (1.6 MB of int32 at that shape) and the ten
// eager selection launches that read it back are gone.
//
// Design:
//  - One block per (camera, kRows = 8 rows of a), 256 threads. The block's
//    rows are staged in shared memory and read as broadcasts; each thread
//    holds kCpt = 2 columns' descriptors of b in registers (b, 16 KB at
//    Nb = 512, is read from L2 by every block) and walks the rows. Columns
//    come in chunks of 512, so any Nb works.
//  - Per row, each thread keeps (best key, second distance) over its
//    columns, with key = dist << 32 | col, so a minimum over keys is the
//    argmin with the lowest column among ties. A warp butterfly merges the
//    32 lanes; lane 0 folds the warp's result into a shared slot per (row,
//    warp); after the block barrier one thread per row merges the 8 warps
//    and applies the threshold and the ratio test.
//  - Per column, each thread keeps the minimum of dist << 32 | row over the
//    block's rows in registers (masked pairs included, as BIG), then one
//    64-bit atomicMin per column and block into a (B, Nb) scratch. A
//    minimum over a total order does not depend on the order of the
//    atomics, so the result is deterministic. No float atomics.
//  - A second small launch applies the mutual check (it needs every
//    block's column minima). With the scratch fill that is 3 launches per
//    call when mutual, 1 when not.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;               // rows of a per block
constexpr int kCpt = 2;                // columns per thread per chunk
constexpr int kChunk = kThreads * kCpt;
constexpr int kMaxWords = 8;
constexpr int kBig = 1 << 20;          // ops/hamming.py BIG
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kNoKey = ~0ull;
constexpr unsigned kNoDist = ~0u;

// (best key, second distance) of the union of two disjoint sets
__device__ __forceinline__ void merge(u64& best, unsigned& second, u64 ob, unsigned os) {
  if (ob < best) {
    second = min(os, static_cast<unsigned>(best >> 32));
    best = ob;
  } else {
    second = min(second, min(os, static_cast<unsigned>(ob >> 32)));
  }
}

__global__ void __launch_bounds__(kThreads)
match_rows_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
                  const unsigned char* __restrict__ valid_a,
                  const unsigned char* __restrict__ valid_b,
                  const unsigned char* __restrict__ mask, int Na, int Nb, int W,
                  long long b_bstride, long long vb_bstride, int max_distance,
                  int use_ratio, float ratio, int mutual, u64* __restrict__ col_best,
                  int* __restrict__ idx_out, int* __restrict__ dist_out,
                  bool* __restrict__ valid_out) {
  __shared__ unsigned a_s[kRows][kMaxWords];
  __shared__ bool va_s[kRows];
  __shared__ u64 best_s[kRows][kWarps];
  __shared__ unsigned second_s[kRows][kWarps];

  const long long z = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, Na - row0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned* az = a + (z * Na + row0) * W;
  const unsigned* bz = b + z * b_bstride;
  const unsigned char* vbz = valid_b + z * vb_bstride;
  const unsigned char* mz = mask ? mask + (z * Na + row0) * Nb : nullptr;

  for (int idx = tid; idx < kRows * kMaxWords; idx += kThreads) {
    const int r = idx / kMaxWords, w = idx - r * kMaxWords;
    a_s[r][w] = r < nrows && w < W ? az[r * W + w] : 0u;
  }
  if (tid < kRows) {
    va_s[tid] = tid < nrows && valid_a[z * Na + row0 + tid];
    for (int w = 0; w < kWarps; ++w) {
      best_s[tid][w] = kNoKey;
      second_s[tid][w] = kNoDist;
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < Nb; c0 += kChunk) {
    unsigned bw[kCpt][kMaxWords];
    bool cv[kCpt];
    int col[kCpt];
    u64 cmin[kCpt];
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      col[k] = c0 + tid + k * kThreads;
      const bool live = col[k] < Nb;
      cv[k] = live && vbz[col[k]];
      cmin[k] = kNoKey;
#pragma unroll
      for (int w = 0; w < kMaxWords; ++w) {
        bw[k][w] = live && w < W ? bz[static_cast<long long>(col[k]) * W + w] : 0u;
      }
    }
    for (int r = 0; r < nrows; ++r) {
      u64 best = kNoKey;
      unsigned second = kNoDist;
#pragma unroll
      for (int k = 0; k < kCpt; ++k) {
        if (col[k] < Nb) {
          unsigned d = 0;
#pragma unroll
          for (int w = 0; w < kMaxWords; ++w) d += __popc(a_s[r][w] ^ bw[k][w]);
          const bool ok = va_s[r] && cv[k] && (mz == nullptr || mz[r * Nb + col[k]]);
          if (!ok) d = kBig;
          const u64 key = static_cast<u64>(d) << 32 | static_cast<unsigned>(col[k]);
          merge(best, second, key, kNoDist);
          cmin[k] = min(cmin[k], static_cast<u64>(d) << 32 | static_cast<unsigned>(row0 + r));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const u64 ob = __shfl_xor_sync(kFull, best, off);
        const unsigned os = __shfl_xor_sync(kFull, second, off);
        merge(best, second, ob, os);
      }
      if (lane == 0) merge(best_s[r][warp], second_s[r][warp], best, second);
    }
    if (mutual) {
#pragma unroll
      for (int k = 0; k < kCpt; ++k) {
        if (col[k] < Nb) atomicMin(col_best + z * Nb + col[k], cmin[k]);
      }
    }
  }
  __syncthreads();

  if (tid < nrows) {
    u64 best = kNoKey;
    unsigned second = kNoDist;
    for (int w = 0; w < kWarps; ++w) merge(best, second, best_s[tid][w], second_s[tid][w]);
    // the plain version's second best is the row minimum with the best set to BIG
    second = min(second, static_cast<unsigned>(kBig));
    const int bd = static_cast<int>(best >> 32);
    const int bc = static_cast<int>(best & 0xffffffffu);
    bool ok = bd <= max_distance;
    if (use_ratio) ok = ok && static_cast<float>(bd) <= ratio * static_cast<float>(second);
    const long long o = z * Na + row0 + tid;
    dist_out[o] = bd;
    idx_out[o] = mutual || ok ? bc : -1;  // mutual: finished by match_mutual_kernel
    valid_out[o] = ok;
  }
}

__global__ void match_mutual_kernel(const u64* __restrict__ col_best, int Na, int Nb,
                                    long long total, int* __restrict__ idx_out,
                                    bool* __restrict__ valid_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long z = i / Na;
  const unsigned row = static_cast<unsigned>(i - z * Na);
  const int bc = idx_out[i];
  const bool ok = valid_out[i] &&
                  static_cast<unsigned>(col_best[z * Nb + bc] & 0xffffffffu) == row;
  valid_out[i] = ok;
  idx_out[i] = ok ? bc : -1;
}

}  // namespace

extern "C" int hamming_match_max_words() { return kMaxWords; }

// a: (batch, Na, W) int32 words; b: (batch or 1, Nb, W); valid_a: (batch,
// Na) bool; valid_b: (batch or 1, Nb) bool; mask: (batch, Na, Nb) bool or
// null; col_best: (batch, Nb) 64-bit scratch (used when mutual); outputs
// (batch, Na). All contiguous on the current device; b_bstride /
// vb_bstride = 0 share b / valid_b across the batch. Returns the
// cudaError_t of the launches.
extern "C" int hamming_match(const int* a, const int* b, const bool* valid_a,
                             const bool* valid_b, const bool* mask, int batch, int Na, int Nb,
                             int W, long long b_bstride, long long vb_bstride, int max_distance,
                             int use_ratio, float ratio, int mutual, void* col_best,
                             int* idx_out, int* dist_out, bool* valid_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* cb = static_cast<u64*>(col_best);
  if (mutual) {
    cudaError_t err = cudaMemsetAsync(cb, 0xff, sizeof(u64) * batch * Nb, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Na + kRows - 1) / kRows, batch);
  match_rows_kernel<<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const unsigned*>(a), reinterpret_cast<const unsigned*>(b),
      reinterpret_cast<const unsigned char*>(valid_a),
      reinterpret_cast<const unsigned char*>(valid_b),
      reinterpret_cast<const unsigned char*>(mask), Na, Nb, W, b_bstride, vb_bstride,
      max_distance, use_ratio, ratio, mutual, cb, idx_out, dist_out, valid_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !mutual) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * Na;
  const int threads = 256;
  match_mutual_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, s>>>(
      cb, Na, Nb, total, idx_out, valid_out);
  return static_cast<int>(cudaGetLastError());
}
