// Dense SPD solve x = H^-1 b by pivot-free Gauss-Jordan elimination, one
// thread block per system, the whole augmented [H | b] in shared memory.
//
// Replaces: svin_tpu/ops/solve.py::solve_spd_pallas (kernel body _gj_kernel),
// the TPU kernel that solves the Levenberg-damped, Jacobi-equilibrated
// reduced camera system once per LM iteration
// (svin_tpu/estimator/gauss_newton.py::_solve_step).
//
// What bounds it on the H100: not FLOPs (D^3/2 ~ 0.9 MFMA at D = 120) and
// not device memory (58 KB in, 480 B out), but the serial chain of D
// elimination steps inside one SM: each step is a rank-1 update of the
// trailing columns followed by a block-wide barrier, so the solve costs
// about D barrier round trips plus D^2(D+1)/2 shared-memory FMAs spread over
// the block's threads.
//
// What the design does about it:
//  - The TPU kernel padded H to a multiple of 128 with identity and found
//    pivot row/column by masked lane reductions, because Mosaic cannot
//    index a dynamic lane. Here shared memory is indexed directly, so there
//    is no padding and column k is read by address.
//  - Each step touches only the trailing columns j > k (and the right-hand
//    side): the columns <= k are never read again, so they are not updated.
//    That halves the work of the TPU form.
//  - 1024 threads as a 32x32 tile: threadIdx.x walks the columns (adjacent
//    threads hit adjacent words: no bank conflicts; the row stride D + 1 is
//    odd, so column reads are conflict-free too) and threadIdx.y the rows,
//    without integer division in the inner loop.
//  - Two barriers per step: one after staging column k and the scaled
//    pivot row k in shared buffers, one after the update.
//  - The augmented matrix is (D, D+1) f32: 58 KB at D = 120 and 70 KB at
//    D = 132, above the 48 KB static limit, so the launcher raises the
//    kernel's dynamic shared-memory limit first. D up to 239 fits the
//    227 KB a block may use.
//  - gridDim.x runs independent systems, one per block (batched solves).
//
// Pivot-free elimination is stable for the SPD systems the solver produces:
// the pivots are Schur-complement diagonals, which stay positive.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;

__global__ void __launch_bounds__(kTile * kTile)
spd_solve_gj_kernel(const float* __restrict__ H, const float* __restrict__ b,
                    float* __restrict__ x, int D) {
  extern __shared__ float sm[];
  const int ld = D + 1;
  float* A = sm;              // (D, D+1) augmented matrix, row-major
  float* col = A + D * ld;    // column k, staged
  float* prow = col + D;      // row k scaled by 1/pivot, staged

  const long long sys = blockIdx.x;
  const float* Hs = H + sys * D * D;
  const float* bs = b + sys * D;
  float* xs = x + sys * D;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int nt = kTile * kTile;

  for (int idx = tid; idx < D * D; idx += nt) {
    const int i = idx / D;
    A[i * ld + (idx - i * D)] = Hs[idx];
  }
  for (int i = tid; i < D; i += nt) A[i * ld + D] = bs[i];
  __syncthreads();

  for (int k = 0; k < D; ++k) {
    const float inv = 1.0f / A[k * ld + k];
    for (int i = tid; i < D; i += nt) col[i] = A[i * ld + k];
    for (int j = k + 1 + tid; j <= D; j += nt) prow[j] = A[k * ld + j] * inv;
    __syncthreads();
    for (int i = ty; i < D; i += kTile) {
      float* Ai = A + i * ld;
      if (i == k) {
        for (int j = k + 1 + tx; j <= D; j += kTile) Ai[j] = prow[j];
      } else {
        const float ci = col[i];
        for (int j = k + 1 + tx; j <= D; j += kTile) Ai[j] -= ci * prow[j];
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < D; i += nt) xs[i] = A[i * ld + D];
}

// augmented matrix + staged column + staged pivot row
size_t smem_bytes(int D) {
  return (static_cast<size_t>(D) * (D + 1) + D + (D + 1)) * sizeof(float);
}

}  // namespace

// H: (batch, D, D) f32, b: (batch, D) f32, x: (batch, D) f32, all
// contiguous on the device. Returns the cudaError_t of the launch.
extern "C" int spd_solve_gj(const float* H, const float* b, float* x,
                            int batch, int D, void* stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      spd_solve_gj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  spd_solve_gj_kernel<<<batch, dim3(kTile, kTile), smem,
                        static_cast<cudaStream_t>(stream)>>>(H, b, x, D);
  return static_cast<int>(cudaGetLastError());
}
