// Dense SPD solve x = H^-1 b for the systems too large for one block's
// shared memory (320 < D <= 1024 on the H100): a right-looking blocked
// Cholesky factorization and the two triangular solves, computed by one
// thread-block cluster of kCluster CTAs per system, in one launch.
//
// Replaces: svin_tpu/ops/solve.py::solve_spd_pallas (kernel body
// _gj_kernel) at the sizes past spd_solve_chol.cu: the reference runs its
// Pallas kernel for every float32 system up to D = 1024 (a window of S >= 22
// states, D = 15 S >= 330; the global bundle adjustment's D = 6K).
//
// What bounds it on the H100: the operations. D^3/3 + 2D^2 flops over 67
// TFLOP/s f32 (3.60e8 -> 5.37 us at D = 1024; 1.92e7 -> 0.286 us at D = 384)
// against its bytes, the lower triangle of H, b and x, (D(D+1)/2 + 2D) * 4
// over 3.35 TB/s (2.1 MB -> 0.629 us at D = 1024; 0.299 MB -> 0.0892 us at
// D = 384). Like the one-block kernel it stays far from either: the
// factorization is a chain of D / kNB dependent panels, each a diagonal
// block, a triangular solve of the panel and a rank-kNB update, with a
// barrier across the cluster between them.
//
// What the design does about it:
//  - The packed triangle does not fit in one SM (2.1 MB at D = 1024 against
//    227 KB of shared memory) but sits in the 50 MB L2. The working matrix
//    lives in a global workspace, (Dp + 1) rows of Dp floats per system,
//    written and read with .cg accesses (cached in L2 only, never in a
//    stale L1 line of another SM); only its lower triangle is touched.
//  - b rides as row Dp, so the factorization leaves y = L^-1 b there and
//    the forward substitution is free, as in spd_solve_chol.cu.
//  - kCluster = 8 CTAs (the portable cluster size) share one system and
//    meet at cluster.sync(), whose arrive/wait carry release/acquire at
//    cluster scope, so one CTA's global writes are visible to the others
//    after it. Per panel of width kNB = 32:
//      1. every CTA's warp 0 factors the diagonal block redundantly in
//         registers (pivots broadcast by shuffles), so every CTA holds L11
//         and the same pivot flag with no exchange (the leader writes L11
//         back after the barrier below). Then the panel's trailing rows
//         (the b row included) are split over the cluster's 4,096 threads,
//         one row each, and each thread solves its row against L11 in
//         registers;
//      2. cluster.sync();
//      3. each CTA copies the whole panel L21 (up to 1,025 x 32 floats,
//         128 KB) from L2 into its shared memory, column-major, and takes
//         every kCluster-th 64 x 64 tile of the trailing lower triangle,
//         two tiles at a time (256 threads each, a 4 x 4 register
//         micro-tile per thread), each next tile's old values fetched
//         before this one's products so the L2 latency overlaps them;
//      4. cluster.sync().
//    The shared-memory request (the panel buffer at the largest D, 132 KB)
//    is the same at every D, so no two CTAs of a cluster share an SM; 512
//    threads per CTA (16 warps, 128 registers each) keep the SM's FMA and
//    load pipes busier than 256 did (tools/profile_cluster_solve.py: the
//    trailing tiles are the largest phase at D >= 512).
//  - Back substitution L^T x = y by the leader CTA alone, panel by panel
//    from the bottom: warp 0 solves the diagonal block by shuffles, then
//    every thread updates its entries of y above the panel reading L's
//    rows coalesced from L2.
//  - D not a multiple of kNB: padded with identity rows (x = 0 there).
//  - A pivot that is <= 0 or not finite marks the system: its whole x is
//    NaN, as spd_solve_chol.cu and the plain Cholesky give.
//  - No tensor cores: their float32 path is TF32, which the estimator's
//    precision rule keeps off this solve.
//  - gridDim.x = kCluster x the batch: one cluster per system.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNB = 32;                  // panel width
constexpr int kCluster = 8;              // CTAs per system
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTS = 64;                  // trailing-update tile
constexpr int kTileThreads = 256;        // threads per tile: a 4 x 4 micro-tile each
constexpr int kSlots = kThreads / kTileThreads;  // tiles a CTA updates at once
constexpr int kMaxD = 1024;
constexpr int kPanelLd = (kMaxD + 1 + 3) / 4 * 4;  // panel buffer: rows per column
constexpr size_t kPanelBytes = static_cast<size_t>(kNB) * kPanelLd * sizeof(float);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

#ifdef SVIN_PHASE_TIMES
// Built only by tools/profile_cluster_solve.py: the leader's thread 0 sums
// SM cycles per phase (0 staging, 1 diagonal block, 2 panel rows, 3 cluster
// barriers, 4 panel copy, 5 trailing tiles, 6 back substitution).
__device__ unsigned long long svin_phase_cycles[8];
#define PHASE_BEGIN unsigned long long phase_[8] = {}, last_ = clock64();
#define PHASE(k)                                          \
  do {                                                    \
    if (rank == 0 && tid == 0) {                          \
      const unsigned long long t_ = clock64();            \
      phase_[k] += t_ - last_;                            \
      last_ = t_;                                         \
    }                                                     \
  } while (0)
#define PHASE_END \
  if (tid == 0)   \
    for (int k = 0; k < 8; ++k) svin_phase_cycles[k] = phase_[k];
#else
#define PHASE_BEGIN
#define PHASE(k) \
  do {           \
  } while (0)
#define PHASE_END
#endif

__host__ __device__ __forceinline__ int padded(int D) { return (D + kNB - 1) / kNB * kNB; }
__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }
__device__ __forceinline__ int tri_row(int p) {
  int i = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while (tri(i) > p) --i;
  while (tri(i + 1) <= p) ++i;
  return i;
}

// The entries of trailing tile tt that thread (ty, tx) updates: rows i0 + a
// (a < 4), columns j0 .. j0 + n[a] - 1 of the trailing block (the lower
// triangle, the b row included, columns < C).
__device__ __forceinline__ void tile_owned(int tt, int ty, int tx, int R, int C, int& i0, int& j0,
                                           int (&n)[4]) {
  const int ti = tri_row(tt), tj = tt - tri(ti);
  i0 = ti * kTS + 4 * ty;
  j0 = tj * kTS + 4 * tx;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + a;
    n[a] = i < R ? max(0, min(4, min(i - j0 + 1, C - j0))) : 0;
  }
}

// Those entries' current values, a 16-byte load per full row of four.
__device__ __forceinline__ void fetch_tile(const float* A, long long ld, int t0, int R, int Dp,
                                           int tt, int ty, int tx, float (&old)[4][4]) {
  int i0, j0, n[4];
  tile_owned(tt, ty, tx, R, Dp - t0, i0, j0, n);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* Ai = A + (t0 + i0 + a) * ld + t0 + j0;
    if (n[a] == 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(Ai));
      old[a][0] = v.x;
      old[a][1] = v.y;
      old[a][2] = v.z;
      old[a][3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) old[a][c] = c < n[a] ? __ldcg(Ai + c) : 0.0f;
    }
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
spd_solve_cluster_kernel(const float* __restrict__ H, const float* __restrict__ b,
                         float* __restrict__ x, float* __restrict__ work, int D) {
  extern __shared__ __align__(16) float P[];  // the panel L21, column-major, kPanelLd rows
  __shared__ float L11[kNB][kNB + 1];
  __shared__ float dinv[kNB];
  __shared__ float ys[kMaxD];
  __shared__ int bad_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long sys = blockIdx.x / kCluster;
  const int Dp = padded(D);
  const long long ld = Dp;
  float* A = work + sys * (Dp + 1) * ld;
  const float* Hs = H + sys * D * static_cast<long long>(D);
  const float* bs = b + sys * D;
  float* xs = x + sys * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PHASE_BEGIN

  // the lower triangle of H, identity on the padding rows, b as row Dp;
  // rows over the cluster's warps, columns over lanes (coalesced)
  for (int i = rank * kWarps + warp; i <= Dp; i += kCluster * kWarps) {
    float* Ai = A + i * ld;
    for (int j = lane; j <= i && j < Dp; j += 32) {
      const float v = i < D ? Hs[i * static_cast<long long>(D) + j]
                            : (i < Dp ? (i == j ? 1.0f : 0.0f) : (j < D ? bs[j] : 0.0f));
      __stcg(Ai + j, v);
    }
  }
  cluster.sync();
  PHASE(0);

  bool bad = false;  // warp 0: every lane sees the same broadcast pivots
  for (int k0 = 0; k0 < Dp; k0 += kNB) {
    const int t0 = k0 + kNB;       // first trailing row
    const int R = Dp + 1 - t0;     // trailing rows, the b row included
    if (warp == 0) {
      float r[kNB];  // lane l: row k0 + l of the diagonal block
      float diag = 1.0f;  // lane l: L[k0+l][k0+l] (r is indexed by constants only)
      const float* Ar = A + (k0 + lane) * ld + k0;
#pragma unroll
      for (int c = 0; c < kNB; ++c) r[c] = c <= lane ? __ldcg(Ar + c) : 0.0f;
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const float piv = __shfl_sync(kFull, r[j], j);
        bad |= !(piv > 0.0f && piv <= FLT_MAX);  // <= 0, NaN or inf
        const float rinv = rsqrtf(piv);
        if (lane == j) diag = piv * rinv;
        r[j] = lane == j ? diag : (lane > j ? r[j] * rinv : 0.0f);
#pragma unroll
        for (int c = j + 1; c < kNB; ++c) {
          const float lcj = __shfl_sync(kFull, r[j], c);  // L[k0+c][k0+j]
          r[c] -= r[j] * lcj;
        }
      }
#pragma unroll
      for (int c = 0; c < kNB; ++c) L11[lane][c] = r[c];
      dinv[lane] = 1.0f / diag;
    }
    __syncthreads();
    PHASE(1);
    // the panel's trailing rows: l L11^T = a, one row per thread
    for (int t = rank + kCluster * tid; t < R; t += kCluster * kThreads) {
      float4* Ar = reinterpret_cast<float4*>(A + (t0 + t) * ld + k0);
      float a[kNB];
#pragma unroll
      for (int q = 0; q < kNB / 4; ++q) {
        const float4 v = __ldcg(Ar + q);
        a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const float v = a[j] * dinv[j];
        a[j] = v;
#pragma unroll
        for (int c = j + 1; c < kNB; ++c) a[c] -= v * L11[c][j];
      }
#pragma unroll
      for (int q = 0; q < kNB / 4; ++q) {
        __stcg(Ar + q, make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]));
      }
    }
    PHASE(2);
    cluster.sync();
    PHASE(3);
    // the leader keeps L11 for the back substitution (after the barrier:
    // the other CTAs have read A11 by now)
    if (rank == 0 && warp == 0) {
      float* Ar = A + (k0 + lane) * ld + k0;
      for (int c = 0; c <= lane; ++c) __stcg(Ar + c, L11[lane][c]);
    }

    // the trailing update A22 -= L21 L21^T on the lower triangle, the b row
    // included (b -= L21_b L21^T: the forward substitution)
    if (R > 1) {
      // two rows per thread and pass: 16 loads in flight
      for (int t = tid; t < R; t += 2 * kThreads) {
        float4 v[2][kNB / 4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = t + h * kThreads;
          const float4* Ar = reinterpret_cast<const float4*>(A + (t0 + row) * ld + k0);
#pragma unroll
          for (int q = 0; q < kNB / 4; ++q) v[h][q] = row < R ? __ldcg(Ar + q) : float4{};
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = t + h * kThreads;
          if (row >= R) break;
#pragma unroll
          for (int q = 0; q < kNB / 4; ++q) {
            P[(4 * q) * kPanelLd + row] = v[h][q].x;
            P[(4 * q + 1) * kPanelLd + row] = v[h][q].y;
            P[(4 * q + 2) * kPanelLd + row] = v[h][q].z;
            P[(4 * q + 3) * kPanelLd + row] = v[h][q].w;
          }
        }
      }
      __syncthreads();
      PHASE(4);
      // this CTA's tiles, every kCluster-th of the tri(RT) lower tiles,
      // kSlots at once (one per kTileThreads threads); each slot fetches its
      // next tile's old values before this one's products
      const int RT = (R + kTS - 1) / kTS, n_tiles = tri(RT);
      const int slot = tid / kTileThreads, ty = tid % kTileThreads / 16, tx = tid % 16;
      const int first = rank + kCluster * slot, step = kCluster * kSlots;
      float cur[4][4] = {};
      if (first < n_tiles) fetch_tile(A, ld, t0, R, Dp, first, ty, tx, cur);
      for (int tt = first; tt < n_tiles; tt += step) {
        float nxt[4][4] = {};
        if (tt + step < n_tiles) fetch_tile(A, ld, t0, R, Dp, tt + step, ty, tx, nxt);
        int i0, j0, n[4];
        tile_owned(tt, ty, tx, R, Dp - t0, i0, j0, n);
        float acc[4][4] = {};
#pragma unroll 8
        for (int c = 0; c < kNB; ++c) {
          const float4 u = *reinterpret_cast<const float4*>(P + c * kPanelLd + i0);
          const float4 v = *reinterpret_cast<const float4*>(P + c * kPanelLd + j0);
          const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][e] += uu[a] * vv[e];
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float* Ai = A + (t0 + i0 + a) * ld + t0 + j0;
          if (n[a] == 4) {
            __stcg(reinterpret_cast<float4*>(Ai),
                   make_float4(cur[a][0] - acc[a][0], cur[a][1] - acc[a][1],
                               cur[a][2] - acc[a][2], cur[a][3] - acc[a][3]));
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (c < n[a]) __stcg(Ai + c, cur[a][c] - acc[a][c]);
            }
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) cur[a][c] = nxt[a][c];
        }
      }
    }
    PHASE(5);
    cluster.sync();
    PHASE(3);
  }

  // back substitution L^T x = y by the leader; y (row Dp) becomes x in ys
  if (rank != 0) return;
  if (tid == 0) bad_s = bad;
  for (int j = tid; j < Dp; j += kThreads) ys[j] = __ldcg(A + Dp * ld + j);
  __syncthreads();
  for (int k0 = Dp - kNB; k0 >= 0; k0 -= kNB) {
    if (warp == 0) {
      float lt[kNB];  // lane l: column l of the diagonal block
#pragma unroll
      for (int q = 0; q < kNB; ++q) lt[q] = q >= lane ? __ldcg(A + (k0 + q) * ld + k0 + lane) : 0.0f;
      float yv = ys[k0 + lane];
      const float dv = 1.0f / __ldcg(A + (k0 + lane) * ld + k0 + lane);
      float xl = 0.0f;
#pragma unroll
      for (int c = kNB - 1; c >= 0; --c) {
        const float xc = __shfl_sync(kFull, yv * dv, c);
        if (lane == c) xl = xc;
        if (lane < c) yv -= lt[c] * xc;
      }
      ys[k0 + lane] = xl;
    }
    __syncthreads();
    for (int i = tid; i < k0; i += kThreads) {
      float acc = ys[i];
#pragma unroll
      for (int c = 0; c < kNB; ++c) acc -= __ldcg(A + (k0 + c) * ld + i) * ys[k0 + c];
      ys[i] = acc;
    }
    __syncthreads();
  }
  const bool marked = bad_s != 0;
  for (int i = tid; i < D; i += kThreads) xs[i] = marked ? __int_as_float(0x7fc00000) : ys[i];
  PHASE(6);
  PHASE_END
}

}  // namespace

extern "C" int spd_solve_cluster_max_d() { return kMaxD; }

#ifdef SVIN_PHASE_TIMES
// the last launch's per-phase cycles (8 values) into host memory
extern "C" int spd_solve_cluster_phase_cycles(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, svin_phase_cycles, sizeof(svin_phase_cycles)));
}
#endif

// floats of workspace one system needs: (Dp + 1) rows of Dp
extern "C" long long spd_solve_cluster_workspace(int D) {
  const long long Dp = padded(D);
  return (Dp + 1) * Dp;
}

// H: (batch, D, D) f32 (only the lower triangle is read), b: (batch, D),
// x: (batch, D), work: batch x spd_solve_cluster_workspace(D) floats, all
// contiguous on the current device; 1 <= D <= kMaxD. Returns the
// cudaError_t of the launch.
extern "C" int spd_solve_cluster(const float* H, const float* b, float* x, float* work, int batch,
                                 int D, void* stream) {
  static bool opted_in[kMaxDevices] = {};
  if (D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(spd_solve_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kPanelBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  spd_solve_cluster_kernel<<<batch * kCluster, kThreads, kPanelBytes,
                             static_cast<cudaStream_t>(stream)>>>(H, b, x, work, D);
  return static_cast<int>(cudaGetLastError());
}
