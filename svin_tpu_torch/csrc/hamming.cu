// All-pairs Hamming distance between packed binary descriptors:
// out[z, i, j] = sum_w popc(a[z, i, w] ^ b[z, j, w]).
//
// Replaces: svin_tpu/ops/hamming.py::hamming_matrix_pallas (kernel body
// _hamming_kernel), the TPU kernel computing the (Na, Nb) distance matrix
// of 256-bit descriptors (8 words) in 128x128 tiles. On the TPU the
// matcher used an MXU matmul form instead; on Hopper XOR + __popc is the
// native form and this kernel is the matcher's distance matrix.
//
// What bounds it on the H100: at the matcher's shapes (2 cameras x 400
// keypoints x 512 landmarks) the inputs are 29 KB and the output 1.6 MB of
// int32, and the arithmetic is 8 XOR + 8 POPC + 8 adds per output. It is
// bound by writing the output and, at this size, by launch latency.
//
// What the design does about it:
//  - A block computes a 64-row x 32-column output tile with 256 threads
//    (32 x 8). The tile's 64 a-descriptors are staged in shared memory;
//    every thread of a warp reads the same a-word (a broadcast).
//  - Each thread keeps its column's b-descriptor in registers and walks 8
//    rows, so b is read from device memory once per block.
//  - Adjacent threads write adjacent output columns: coalesced stores.
//  - Ragged edges are masked (rows beyond Na stage zeros and are not
//    stored; columns beyond Nb store nothing).
//  - blockIdx.z runs the batch (cameras): the slice's two cameras are one
//    launch. b may be shared by the whole batch (stride 0).
//  - Descriptors cross into torch as int32 (bit-identical to the uint32
//    words); the kernel reads them as unsigned.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;
constexpr int kRowThreads = 8;
constexpr int kRows = 64;
constexpr int kMaxWords = 8;

__global__ void __launch_bounds__(kCols * kRowThreads)
hamming_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
               int* __restrict__ out, int Na, int Nb, int W,
               long long a_bstride, long long b_bstride) {
  __shared__ unsigned a_s[kRows][kMaxWords];
  const long long z = blockIdx.z;
  const unsigned* az = a + z * a_bstride;
  const unsigned* bz = b + z * b_bstride;
  int* oz = out + z * static_cast<long long>(Na) * Nb;

  const int col = blockIdx.x * kCols + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.y * kCols + threadIdx.x;

  for (int idx = tid; idx < kRows * W; idx += kCols * kRowThreads) {
    const int r = idx / W;
    const int w = idx - r * W;
    const int gr = row0 + r;
    a_s[r][w] = gr < Na ? az[static_cast<long long>(gr) * W + w] : 0u;
  }
  unsigned bw[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    bw[w] = (col < Nb && w < W) ? bz[static_cast<long long>(col) * W + w] : 0u;
  }
  __syncthreads();
  if (col >= Nb) return;

  for (int r = threadIdx.y; r < kRows; r += kRowThreads) {
    const int gr = row0 + r;
    if (gr >= Na) break;
    int acc = 0;
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      if (w < W) acc += __popc(a_s[r][w] ^ bw[w]);
    }
    oz[static_cast<long long>(gr) * Nb + col] = acc;
  }
}

}  // namespace

extern "C" int hamming_max_words() { return kMaxWords; }

// a: (batch, Na, W) int32 words, b: (batch or 1, Nb, W), out: (batch, Na, Nb)
// int32, all contiguous on the device; b_bstride = 0 shares b across the
// batch. Returns the cudaError_t of the launch.
extern "C" int hamming_matrix(const int* a, const int* b, int* out, int batch,
                              int Na, int Nb, int W, long long a_bstride,
                              long long b_bstride, void* stream) {
  const dim3 grid((Nb + kCols - 1) / kCols, (Na + kRows - 1) / kRows, batch);
  hamming_kernel<<<grid, dim3(kCols, kRowThreads), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const unsigned*>(a), reinterpret_cast<const unsigned*>(b),
      out, Na, Nb, W, a_bstride, b_bstride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* svin_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
