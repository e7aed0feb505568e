// Dense SPD solve x = H^-1 b by a blocked Cholesky factorization and the
// two triangular solves, one thread block per system, in one launch.
//
// Replaces: svin_tpu/ops/solve.py::solve_spd_pallas (kernel body
// _gj_kernel), the TPU kernel that solves the Levenberg-damped,
// Jacobi-equilibrated reduced camera system once per LM iteration
// (svin_tpu/estimator/gauss_newton.py::_solve_step).
//
// What bounds it on the H100: the least time for the work is the larger of
// its bytes, the lower triangle of H, b and x, (D(D+1)/2 + 2D) * 4 over
// 3.35 TB/s (30,000 B -> 0.00896 us at D = 120; 36,168 B -> 0.0108 us at
// D = 132), and its D^3/3 + 2D^2 flops over 67 TFLOP/s f32 (604,800 ->
// 0.00903 us at D = 120; 801,504 -> 0.0120 us at D = 132): the operations
// bound it, barely. One block on one SM stays far from either: the solve is
// a chain of D dependent pivots (square root, scale, update) plus block
// barriers, so latency bounds it.
//
// What the design does about it:
//  - Cholesky, not Gauss-Jordan: D^3/6 FMAs instead of D^3/2, and only the
//    lower triangle is read and kept. The triangle is packed in shared
//    memory (row i starts at i(i+1)/2), D padded to a multiple of the
//    panel width kNB with identity: 42 KB at D = 120 with the panel buffer
//    (under the 48 KB that needs no opt-in), 52 KB at D = 132.
//  - b rides along as one more row of the triangle, so the forward
//    substitution L y = b is done by the factorization itself (row Dp ends
//    up holding y) at no extra barrier.
//  - Right-looking, panel width kNB = 16. Per panel, every warp factors the
//    kNB x kNB diagonal block redundantly in registers (lanes 0..15 hold its
//    rows, pivots broadcast by shuffles): no barrier and no shared-memory
//    round trip for the pivots. The warp's other 16 lanes each carry one
//    trailing row through the same column sweep, so L11 and L21 come out of
//    one chain of kNB steps (8 warps carry 128 trailing rows per sweep; a
//    taller panel takes a second sweep). Then one barrier, and all 256 threads apply the
//    symmetric rank-kNB update of the trailing triangle from 4x4 register
//    micro-tiles, reading the panel (kept column-major) as conflict-free
//    16-byte loads; a second barrier.
//    2 barriers per panel, 1 per panel of the back substitution: 25 block
//    barriers at D = 120, against 240 for the Gauss-Jordan kernel of the
//    first port. Width 16 rather than 8 halves both the passes over the
//    trailing triangle and the barriers.
//  - Back substitution L^T x = y, panel by panel from the bottom: every
//    warp solves the diagonal block redundantly (lane l holds column l of
//    L11, and the reciprocal of its diagonal, so the chain multiplies), then
//    each thread updates its own entries of y above the panel.
//  - Staging reads the lower triangle of H only, 8 loads in flight per
//    thread.
//  - A pivot that is <= 0 or not finite marks the system; its whole x is
//    then NaN, as the plain Cholesky version and the JAX cho_factor path
//    give, so the LM loop rejects the step. Every lane sees the same
//    broadcast pivots, so the flag needs no communication.
//  - No tensor cores: their float32 path is TF32, which the estimator's
//    precision rule keeps off this solve (svin_tpu/__init__.py).
//  - gridDim.x runs independent systems, one per block (batched solves).
//  - Above 48 KB of shared memory (D > 128) the launcher raises the
//    kernel's dynamic shared-memory limit once per device, not per launch,
//    to the device's opt-in maximum (227 KB on the H100: D <= 320,
//    spd_solve_chol_max_d). A larger D fails at launch, and the launch's
//    CUDA error is returned; solve_spd sends it to spd_solve_cluster.cu.

#include <cuda_runtime.h>

namespace {

constexpr int kNB = 16;                   // panel width
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 32 - kNB;    // trailing rows a warp carries per sweep
constexpr int kTile = 4;                  // trailing-update micro-tile
constexpr int kLoadUnroll = 8;            // loads in flight per thread while staging H
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__host__ __device__ __forceinline__ int padded(int D) { return (D + kNB - 1) / kNB * kNB; }
__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }
// the row i of packed index p: tri(i) <= p < tri(i + 1)
__device__ __forceinline__ int tri_row(int p) {
  int i = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while (tri(i) > p) --i;
  while (tri(i + 1) <= p) ++i;
  return i;
}
// the panel buffer starts on a 16-byte boundary after the triangle and
// holds kNB columns of panel_ld(Dp) rows each
__host__ __device__ __forceinline__ int panel_offset(int Dp) {
  return ((Dp + 1) * (Dp + 2) / 2 + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int panel_ld(int Dp) { return (Dp + 1 + 3) / 4 * 4; }

__global__ void __launch_bounds__(kThreads)
spd_solve_chol_kernel(const float* __restrict__ H, const float* __restrict__ b,
                      float* __restrict__ x, int D) {
  extern __shared__ float sm[];
  const int Dp = padded(D);
  float* A = sm;                         // packed lower triangle, rows 0..Dp (row Dp: b, then y)
  float* P = sm + panel_offset(Dp);      // the panel's trailing rows (L21), column-major
  const int ld = panel_ld(Dp);
  const long long sys = blockIdx.x;
  const float* Hs = H + sys * D * D;
  const float* bs = b + sys * D;
  float* xs = x + sys * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the lower triangle of H, entry (i, j <= i) to packed index tri(i) + j;
  // the upper triangle is never read. kLoadUnroll loads in flight per
  // thread before their stores, so the copy pays the memory latency a few
  // times, not once per row
  const int n_tri = tri(D);
  for (int base = 0; base < n_tri; base += kThreads * kLoadUnroll) {
    float v[kLoadUnroll];
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int p = base + u * kThreads + tid;
      const int i = p < n_tri ? tri_row(p) : 0;
      v[u] = p < n_tri ? Hs[i * D + p - tri(i)] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoadUnroll; ++u) {
      const int p = base + u * kThreads + tid;
      if (p < n_tri) A[p] = v[u];
    }
  }
  // identity on the padding rows, b as row Dp
  for (int i = D + warp; i <= Dp; i += kWarps) {
    float* Ai = A + tri(i);
    for (int j = lane; j <= i; j += 32) Ai[j] = i < Dp ? (i == j ? 1.0f : 0.0f) : (j < D ? bs[j] : 0.0f);
  }
  __syncthreads();

  bool bad = false;
  for (int k0 = 0; k0 < Dp; k0 += kNB) {
    const int t0 = k0 + kNB;             // first trailing row
    const int R = Dp + 1 - t0;           // trailing rows, the b row included
    float r[kNB];
    for (int base = 0; base < R; base += kWarps * kRowsPerWarp) {
      // lanes < kNB: the diagonal block's rows; the others: trailing rows
      const int t = base + warp * kRowsPerWarp + (lane - kNB);
      const bool diag = lane < kNB;
      const bool live = diag || t < R;
      const int row = diag ? k0 + lane : t0 + t;
      const float* Ar = A + (live ? tri(row) + k0 : 0);
#pragma unroll
      for (int c = 0; c < kNB; ++c) r[c] = live && (!diag || c <= lane) ? Ar[c] : 0.0f;
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const float piv = __shfl_sync(kFull, r[j], j);
        bad |= !(piv > 0.0f && piv <= 3.402823466e+38f);  // <= 0, NaN or inf
        const float rinv = rsqrtf(piv);
        r[j] = lane == j ? piv * rinv : r[j] * rinv;
#pragma unroll
        for (int c = j + 1; c < kNB; ++c) {
          const float lcj = __shfl_sync(kFull, r[j], c);  // L[k0+c][k0+j]
          r[c] -= r[j] * lcj;
        }
      }
      if (!diag && live) {
        float* Aw = A + tri(row) + k0;
#pragma unroll
        for (int c = 0; c < kNB; ++c) {
          Aw[c] = r[c];
          P[c * ld + t] = r[c];
        }
      }
    }
    __syncthreads();  // the panel is in P, and every warp has read A11
    if (warp == 0 && lane < kNB) {
      float* Aw = A + tri(k0 + lane) + k0;
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        if (c <= lane) Aw[c] = r[c];
      }
    }
    // trailing update A22 -= L21 L21^T on the lower triangle, 4x4 tiles
    const int RT = (R + kTile - 1) / kTile;
    const int n_tiles = RT * (RT + 1) / 2;
    for (int tt = tid; tt < n_tiles; tt += kThreads) {
      const int ti = tri_row(tt);
      const int tj = tt - tri(ti);
      // rows 4ti..4ti+3 and 4tj..4tj+3 of each panel column as one 16-byte
      // load each: lanes of a warp walk consecutive tj, so the loads of pj
      // are conflict-free and those of pi broadcast (rows past R hold stale
      // values that only reach entries that are not written)
      const float4* P4 = reinterpret_cast<const float4*>(P);
      float acc[kTile][kTile] = {};
#pragma unroll
      for (int c = 0; c < kNB; ++c) {
        const float4 u4 = P4[(c * ld) / 4 + ti], v4 = P4[(c * ld) / 4 + tj];
        const float u[kTile] = {u4.x, u4.y, u4.z, u4.w}, v[kTile] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
#pragma unroll
          for (int bb = 0; bb < kTile; ++bb) acc[a][bb] += u[a] * v[bb];
        }
      }
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        const int i = ti * kTile + a;
        if (i >= R) break;
        float* Ai = A + tri(t0 + i) + t0;
#pragma unroll
        for (int bb = 0; bb < kTile; ++bb) {
          const int j = tj * kTile + bb;
          if (j > i) break;
          Ai[j] -= acc[a][bb];
        }
      }
    }
    __syncthreads();
  }

  // back substitution L^T x = y, y (row Dp) overwritten by the running rhs
  float* y = A + tri(Dp);
  for (int k0 = Dp - kNB; k0 >= 0; k0 -= kNB) {
    float lt[kNB];  // lane l: column l of the diagonal block
#pragma unroll
    for (int q = 0; q < kNB; ++q) {
      lt[q] = lane < kNB && q >= lane ? A[tri(k0 + q) + k0 + lane] : 0.0f;
    }
    float yv = lane < kNB ? y[k0 + lane] : 0.0f;
    // one reciprocal per lane ahead of the chain (a division by the zeros
    // of the other lanes would take the slow path inside it)
    const float dinv = lane < kNB ? 1.0f / A[tri(k0 + lane) + k0 + lane] : 0.0f;
    float xl = 0.0f;
#pragma unroll
    for (int c = kNB - 1; c >= 0; --c) {
      const float xc = __shfl_sync(kFull, yv * dinv, c);
      if (lane == c) xl = xc;
      if (lane < c) yv -= lt[c] * xc;
    }
    float xp[kNB];
#pragma unroll
    for (int c = 0; c < kNB; ++c) xp[c] = __shfl_sync(kFull, xl, c);
    for (int i = tid; i < k0; i += kThreads) {
      float acc = y[i];
#pragma unroll
      for (int c = 0; c < kNB; ++c) acc -= A[tri(k0 + c) + i] * xp[c];
      y[i] = acc;
    }
    if (tid < kNB && k0 + tid < D) xs[k0 + tid] = bad ? __int_as_float(0x7fc00000) : xl;
    __syncthreads();
  }
}

// shared-memory bytes of one system: the packed (Dp+1)-row triangle and the
// panel buffer
size_t smem_bytes(int D) {
  const int Dp = padded(D);
  return (static_cast<size_t>(panel_offset(Dp)) + kNB * panel_ld(Dp)) * sizeof(float);
}

}  // namespace

// The largest D whose system fits one block's shared memory on the current
// device (320 on the H100), or -1 with no device.
extern "C" int spd_solve_chol_max_d() {
  int dev = 0, max_optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    return -1;
  }
  int D = kNB;
  while (smem_bytes(D + kNB) <= static_cast<size_t>(max_optin)) D += kNB;
  return D;
}

// H: (batch, D, D) f32 (only the lower triangle is read), b: (batch, D),
// x: (batch, D), all contiguous on the current device. Returns the
// cudaError_t of the launch.
extern "C" int spd_solve_chol(const float* H, const float* b, float* x, int batch, int D,
                              void* stream) {
  static bool opted_in[kMaxDevices] = {};
  const size_t smem = smem_bytes(D);
  if (smem > kDefaultSmem) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!opted_in[dev]) {
      int max_optin = 0;
      err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaFuncSetAttribute(spd_solve_chol_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, max_optin);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in[dev] = true;
    }
  }
  spd_solve_chol_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(H, b, x, D);
  return static_cast<int>(cudaGetLastError());
}
