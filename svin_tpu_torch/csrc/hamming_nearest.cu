// Nearest codeword by Hamming distance: out[z, k] = the first v that
// minimizes sum_w popc(desc[z, k, w] ^ vocab[z, v, w]), i.e.
// argmin(hamming_matrix(desc, vocab), -1) with the lowest index among ties,
// without the (B, K, V) distance matrix.
//
// Replaces: svin_tpu/ops/hamming.py::hamming_matrix_pallas (kernel body
// _hamming_kernel) together with the argmin that every caller of the
// distance matrix takes on the loop path (loopclosure/retrieval.py
// assign_words: the product vocabulary's two 256-word halves per keyframe,
// bow_vector, the k-medoids of train_vocabulary).
//
// What bounds it on the H100: the popcounts. At the retrieval shape,
// (2, 1012, 4) x (2, 256, 4), the inputs are 36,608 B and the output
// 16,192 B (0.0158 us at 3.35 TB/s), and the 2,072,576 word comparisons
// take an XOR, a popcount and an add each: 6.2 M operations, 0.093 us at
// the float32 rate (67 TFLOP/s), but __popc issues at 16 per clock per SM
// on sm_90 (1/8 of the float32 rate), so the popcounts alone take 0.50 us
// at 1.98 GHz on 132 SMs. At train_vocabulary's (32768, 8) x (1024, 8):
// 268 M popcounts, 64 us.
//
// What the design does about it:
//  - No distance matrix: the (B, K, V) int32 matrix (2 MB at the retrieval
//    shape, 134 MB at the training one) is neither written nor read back
//    by an argmin launch. One launch in all.
//  - A block is 32 queries x 8 codeword slices (256 threads): lane l holds
//    query l's W words in registers, warp w scans codewords w, w + 8, ...
//    of the codebook tile staged in shared memory (up to 32 KB: 1024
//    codewords of 8 words; longer codebooks in several tiles). Every lane of
//    a warp reads the same codeword: a broadcast.
//  - Each thread keeps its running minimum with a strict <, visiting its
//    codewords in increasing order, so it holds the first index of its
//    minimum; the 8 slices merge as packed keys dist << 32 | index (as
//    hamming_match.cu does), so the lowest index wins among equal
//    distances, as torch.argmin's and jnp.argmin's.
//  - The batch (the product vocabulary's two halves) is gridDim.y; the
//    codebook is shared by the batch (stride 0) or one per batch entry.
//  - W is a template parameter (1..8): the loops unroll fully.
//  - Descriptors cross into torch as int32 (bit-identical to the uint32
//    words); the kernel reads them as unsigned.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kQueries = 32;                 // queries per block (lanes)
constexpr int kSlices = 8;                   // codeword slices per block (warps)
constexpr int kThreads = kQueries * kSlices;
constexpr int kTileWords = 8192;             // codebook tile: 32 KB
constexpr int kMaxWords = 8;

template <int W>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const unsigned* __restrict__ desc, const unsigned* __restrict__ vocab,
               long long* __restrict__ out, int K, int V, long long v_bstride) {
  __shared__ __align__(16) unsigned cb[kTileWords];
  __shared__ u64 best_s[kSlices][kQueries];
  constexpr int kTile = kTileWords / W;      // codewords per tile
  const long long z = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * kQueries + lane;
  const unsigned* dz = desc + z * K * W;
  const unsigned* vz = vocab + z * v_bstride;

  unsigned d[W];
#pragma unroll
  for (int w = 0; w < W; ++w) d[w] = q < K ? dz[static_cast<long long>(q) * W + w] : 0u;
  unsigned best = ~0u;
  int best_v = 0;
  for (int c0 = 0; c0 < V; c0 += kTile) {
    const int n = min(kTile, V - c0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < n * W; i += kThreads) cb[i] = vz[static_cast<long long>(c0) * W + i];
    __syncthreads();
    for (int v = warp; v < n; v += kSlices) {
      const unsigned* c = cb + v * W;
      unsigned dist = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) dist += __popc(d[w] ^ c[w]);
      if (dist < best) {
        best = dist;
        best_v = c0 + v;
      }
    }
  }
  best_s[warp][lane] = static_cast<u64>(best) << 32 | static_cast<unsigned>(best_v);
  __syncthreads();
  if (warp == 0 && q < K) {
    u64 m = best_s[0][lane];
#pragma unroll
    for (int s = 1; s < kSlices; ++s) m = min(m, best_s[s][lane]);
    out[z * K + q] = static_cast<long long>(m & 0xffffffffu);
  }
}

template <int W>
int launch(const int* desc, const int* vocab, long long* out, int batch, int K, int V,
           long long v_bstride, cudaStream_t stream) {
  const dim3 grid((K + kQueries - 1) / kQueries, batch);
  nearest_kernel<W><<<grid, kThreads, 0, stream>>>(reinterpret_cast<const unsigned*>(desc),
                                                   reinterpret_cast<const unsigned*>(vocab), out, K,
                                                   V, v_bstride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hamming_nearest_max_words() { return kMaxWords; }

// desc: (batch, K, W) int32 words, vocab: (batch or 1, V, W), out: (batch,
// K) int64, all contiguous on the device; v_bstride = 0 shares the codebook
// across the batch; 1 <= W <= kMaxWords, V >= 1. Returns the cudaError_t of
// the launch.
extern "C" int hamming_nearest(const int* desc, const int* vocab, long long* out, int batch, int K,
                               int V, int W, long long v_bstride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return launch<1>(desc, vocab, out, batch, K, V, v_bstride, s);
    case 2: return launch<2>(desc, vocab, out, batch, K, V, v_bstride, s);
    case 3: return launch<3>(desc, vocab, out, batch, K, V, v_bstride, s);
    case 4: return launch<4>(desc, vocab, out, batch, K, V, v_bstride, s);
    case 5: return launch<5>(desc, vocab, out, batch, K, V, v_bstride, s);
    case 6: return launch<6>(desc, vocab, out, batch, K, V, v_bstride, s);
    case 7: return launch<7>(desc, vocab, out, batch, K, V, v_bstride, s);
    case 8: return launch<8>(desc, vocab, out, batch, K, V, v_bstride, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
