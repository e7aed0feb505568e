// Dense SPD solve x = H^-1 b for the systems too large for one block's
// shared memory (320 < D <= 1024 on the H100): a right-looking blocked
// Cholesky factorization and the two triangular solves, computed by one
// thread-block cluster per system with the whole matrix held in the
// cluster's distributed shared memory, in one launch.
//
// Replaces: svin_tpu/ops/solve.py::solve_spd_pallas (kernel body
// _gj_kernel) at the sizes past spd_solve_chol.cu: the reference runs its
// Pallas kernel for every float32 system up to D = 1024 (a window of S >= 22
// states, D = 15 S >= 330; the global bundle adjustment's D = 6K).
//
// What bounds it on the H100: the operations. D^3/3 + 2D^2 flops over 67
// TFLOP/s f32 (3.60e8 -> 5.37 us at D = 1024; 1.92e7 -> 0.286 us at D = 384)
// against its bytes, the lower triangle of H, b and x, (D(D+1)/2 + 2D) * 4
// over 3.35 TB/s (2.1 MB -> 0.629 us at D = 1024). It stays far from both:
// the factorization is a chain of D / 32 dependent panels, and the cluster's
// SMs (8 or 16 of 132) do all of its work.
//
// What the design does about it (the launch plan comes from
// svin_tpu_torch/ops/solve.py::cluster_plan, passed in as an int array):
//  - The padded lower triangle is cut into 32 x 32 tiles; block row r lives
//    whole in the shared memory of CTA owner[r], tile (r, j) at tile index
//    base[r] + j there. The plan packs the block rows first-fit decreasing
//    under the least per-CTA tile count that fits (pairs (r, NT-1-r) when
//    there are as many CTAs as pairs), on 8 CTAs while the triangle fits
//    them and 16 (a non-portable cluster) past it. No global workspace:
//    every tile is staged from H once and stays on chip.
//  - Tiles are row-major with the float4 index XOR-swizzled by (row & 7), so
//    the tile products read conflict-free float4s.
//  - b is distributed with its block rows and updated with them, so the
//    factorization leaves y = L^-1 b on chip (the forward substitution).
//  - Per panel k: the owner of block row k factors the diagonal tile by one
//    warp in registers and overwrites it with Linv = L_kk^-1 (and b_k with
//    y_k = Linv b_k). Every CTA copies Linv and y_k through DSMEM and solves
//    its panel tiles as products, L_ik = A_ik Linv^T (no serial substitution
//    per row), then b_i -= L_ik y_k. After a cluster barrier every CTA
//    updates its trailing tiles A_ij -= L_ik L_jk^T, reading the L_jk it does
//    not own through DSMEM (cluster.map_shared_rank) into a ring of slots, a
//    chunk of tiles at a time, the next chunk's loads in flight during this
//    chunk's products; each 64 threads compute one tile product (a 4 x 4
//    register micro-tile per thread).
//  - One cluster barrier per panel, with a look-ahead: between two, each CTA
//    applies update k, solves its part of panel k + 1, and the owner of
//    block row k + 2 then brings that diagonal tile up to date (its last
//    update comes from its own panel tile) and factors it, so the next
//    barrier finds panel k + 1 complete and Linv_{k+2} published.
//  - Back substitution L^T x = y by the whole cluster: block row k's owner
//    sums the cluster's partial products for x_k (fixed order, so the
//    result does not depend on timing), applies Linv^T, then adds its row's
//    products L_kj^T x_k into its own partials for j < k.
//  - D not a multiple of 32: padded with identity rows (x = 0 there).
//  - A pivot that is <= 0 or not finite marks the system: its whole x is
//    NaN, as spd_solve_chol.cu and the plain Cholesky give.
//  - No tensor cores: their float32 path is TF32, which the estimator's
//    precision rule keeps off this solve.
//  - gridDim.x = cluster x the batch: one cluster per system.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNB = 32;                             // tile and panel width
constexpr int kTileFloats = kNB * kNB;
constexpr int kThreads = 512;
constexpr int kGroupThreads = 64;                   // threads per tile product
constexpr int kGroups = kThreads / kGroupThreads;
constexpr int kMaxNT = 32;                          // block rows: D <= 1024
constexpr int kMaxD = kMaxNT * kNB;
constexpr int kMaxCluster = 16;
constexpr int kMaxRing = 16;                        // two halves of up to kMaxChunk
constexpr int kMaxChunk = kMaxRing / 2;
constexpr int kSmemPerBlock = 232448;               // the H100's opt-in limit
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
static_assert(kThreads * 2 == kTileFloats, "a tile pull gives half the threads one float4 each");

// The launch plan (ops/solve.py::cluster_plan): cluster size, tiles and
// ring slots per CTA, dynamic shared bytes, and per block row its owner CTA,
// its first tile's index there and its row slot (b, y and x).
struct Plan {
  int cluster, ntiles, ring, smem;
  signed char owner[kMaxNT];
  signed char slot[kMaxNT];
  short base[kMaxNT];
};

#ifdef SVIN_PHASE_TIMES
// Built only by tools/profile_cluster_solve.py: rank 0's thread 0 sums SM
// cycles per phase (0 staging, 1 diagonal block, 2 panel solve, 3 cluster
// barriers, 4 panel pulls through DSMEM, 5 trailing tiles, 6 back
// substitution).
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
#define PHASE_END                        \
  if (rank == 0 && tid == 0 && sys == 0) \
    for (int k = 0; k < 8; ++k) svin_phase_cycles[k] = phase_[k];
#else
#define PHASE_BEGIN
#define PHASE(k) \
  do {           \
  } while (0)
#define PHASE_END
#endif

// element (r, c) of a tile: row-major, the float4 index XOR (r & 7)
__device__ __forceinline__ int sw(int r, int c) {
  return r * kNB + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// The dynamic shared memory, at the same offsets in every CTA of the cluster
// (a remote tile is map_shared_rank of the local address of the same index).
struct Smem {
  float* tiles;  // ntiles tiles
  float* ring;   // ring slots for the panel tiles other CTAs own
  float* linv;   // the current panel's Linv
  float* part;   // back substitution: this CTA's partial sums, kMaxNT x 32
  float* ls;     // diagonal block scratch, 32 x 33
  float* red;    // back substitution: the cluster's partials of one block
  float* yk;     // the current panel's y_k
  int* flags;    // [0]: a bad pivot seen here
  float* bseg;   // b (then y, then x) of this CTA's block rows, 32 per row slot
};

__device__ __forceinline__ Smem carve(float* s, const Plan& p) {
  Smem m;
  m.tiles = s;
  m.ring = s + p.ntiles * kTileFloats;
  m.linv = m.ring + p.ring * kTileFloats;
  m.part = m.linv + kTileFloats;
  m.ls = m.part + kMaxNT * kNB;
  m.red = m.ls + kNB * (kNB + 1);
  m.yk = m.red + kMaxCluster * kNB;
  m.flags = reinterpret_cast<int*>(m.yk + kNB);
  m.bseg = m.yk + kNB + 4;
  return m;
}

// acc = A B^T for tiles A, B, by 64 threads: thread g holds a 4 x 4
// register micro-tile, rows ty + 8a and columns tx + 8e (ty = g & 7, tx =
// g >> 3). The critical CTA has few tiles per panel, so a tile's latency
// (512 FMAs per thread) matters more than its shared-memory loads (8 float4
// per 64 FMAs).
__device__ __forceinline__ void tile_product(const float* A, const float* B, int g,
                                             float (&acc)[4][4]) {
  const int ty = g & 7, tx = g >> 3;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.0f;
  }
#pragma unroll 2
  for (int q = 0; q < kNB / 4; ++q) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = *reinterpret_cast<const float4*>(A + sw(ty + 8 * a, 4 * q));
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = *reinterpret_cast<const float4*>(B + sw(tx + 8 * e, 4 * q));
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = acc[a][e];
        s = fmaf(av[a].x, bv[e].x, s);
        s = fmaf(av[a].y, bv[e].y, s);
        s = fmaf(av[a].z, bv[e].z, s);
        s = fmaf(av[a].w, bv[e].w, s);
        acc[a][e] = s;
      }
    }
  }
}

// The diagonal tile T of block row k (one warp): T = L L^T by Cholesky in
// registers (pivots broadcast by shuffles), then T := Linv = L^-1 (column
// lane by substitution against L in ls), and y := Linv y on the row's b.
// Returns whether a pivot was <= 0 or not finite.
__device__ bool factor_diagonal(float* T, float* ls, float* y, int lane) {
  float r[kNB];  // lane l: row l of the tile's lower triangle
#pragma unroll
  for (int c = 0; c < kNB; ++c) r[c] = c <= lane ? T[sw(lane, c)] : 0.0f;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const float piv = __shfl_sync(kFull, r[j], j);
    bad |= !(piv > 0.0f && piv <= FLT_MAX);  // <= 0, NaN or inf
    const float rinv = rsqrtf(piv);
    r[j] = lane == j ? piv * rinv : (lane > j ? r[j] * rinv : 0.0f);
#pragma unroll
    for (int c = j + 1; c < kNB; ++c) {
      const float lcj = __shfl_sync(kFull, r[j], c);  // L[c][j]
      r[c] -= r[j] * lcj;
    }
  }
#pragma unroll
  for (int c = 0; c < kNB; ++c) ls[lane * (kNB + 1) + c] = r[c];
  __syncwarp();
  // column `lane` of L^-1: x = L^-1 e_lane, column-oriented
  float xv[kNB];
#pragma unroll
  for (int i = 0; i < kNB; ++i) xv[i] = i == lane ? 1.0f : 0.0f;
#pragma unroll
  for (int m = 0; m < kNB; ++m) {
    xv[m] *= 1.0f / ls[m * (kNB + 1) + m];
#pragma unroll
    for (int i = m + 1; i < kNB; ++i) xv[i] -= ls[i * (kNB + 1) + m] * xv[m];
  }
#pragma unroll
  for (int i = 0; i < kNB; ++i) T[sw(i, lane)] = xv[i];  // Linv[i][lane]
  __syncwarp();
  const float bl = y[lane];
  float yl = 0.0f;
#pragma unroll
  for (int c = 0; c < kNB; ++c) yl = fmaf(T[sw(lane, c)], __shfl_sync(kFull, bl, c), yl);
  y[lane] = yl;
  return bad;
}

__global__ void __launch_bounds__(kThreads, 1)
spd_solve_cluster_kernel(const float* __restrict__ H, const float* __restrict__ b,
                         float* __restrict__ x, int D, const Plan p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_rows[kMaxNT];                  // this CTA's block rows, ascending
  __shared__ int s_nrows;
  __shared__ int s_boff[kMaxNT];                  // an update's L_jk tiles, by j (offsets in smem)
  __shared__ const float4* s_src[kMaxNT];         // the update's remote tiles, in order
  __shared__ int s_jend[kMaxNT];                  // each chunk's last j
  __shared__ int s_chunk[2];                      // chunks, remote tiles
  __shared__ int s_bad;
  __shared__ int s_owner[kMaxNT], s_base[kMaxNT], s_slot[kMaxNT];
  __shared__ const float* s_rtile[kMaxNT];        // tile (j, 0) in its owner, generic
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long sys = blockIdx.x / C;
  const int NT = (D + kNB - 1) / kNB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = tid / kGroupThreads, g = tid % kGroupThreads;
  const int ty = g & 7, tx = g >> 3;
  const float* Hs = H + sys * D * static_cast<long long>(D);
  const float* bs = b + sys * D;
  float* xs = x + sys * D;
  const Smem m = carve(smem, p);
  auto tile = [&](int i, int j) { return m.tiles + (s_base[i] + j) * kTileFloats; };
  auto bseg = [&](int i) { return m.bseg + s_slot[i] * kNB; };
  PHASE_BEGIN

  if (tid < kMaxNT) {
    s_owner[tid] = p.owner[tid];
    s_base[tid] = p.base[tid];
    s_slot[tid] = p.slot[tid];
    if (tid < NT) {
      s_rtile[tid] = cluster.map_shared_rank(m.tiles + p.base[tid] * kTileFloats, p.owner[tid]);
    }
  }
  if (tid == 0) {
    int n = 0;
    for (int r = 0; r < NT; ++r) {
      if (p.owner[r] == rank) s_rows[n++] = r;
    }
    s_nrows = n;
    m.flags[0] = 0;
  }
  for (int i = tid; i < kMaxNT * kNB; i += kThreads) m.part[i] = 0.0f;
  __syncthreads();
  const int nrows = s_nrows;
  const int maxrow = nrows ? s_rows[nrows - 1] : -1;

  // stage this CTA's block rows of the lower triangle (identity on the
  // padding rows) and their b; a warp reads 32 consecutive columns
  for (int s = 0; s < nrows; ++s) {
    const int i = s_rows[s];
    for (int idx = tid; idx < (i + 1) * kTileFloats; idx += kThreads) {
      const int j = idx >> 10, r = (idx >> 5) & 31, c = idx & 31;
      const int gr = i * kNB + r, gc = j * kNB + c;
      float v;
      if (gr >= D) {
        v = gr == gc ? 1.0f : 0.0f;
      } else {
        v = gc < D && (j < i || c <= r) ? Hs[gr * static_cast<long long>(D) + gc] : 0.0f;
      }
      tile(i, j)[sw(r, c)] = v;
    }
    if (tid < kNB) bseg(i)[tid] = i * kNB + tid < D ? bs[i * kNB + tid] : 0.0f;
  }
  __syncthreads();
  PHASE(0);
  if (s_owner[0] == rank && warp == 0) {
    const bool bad = factor_diagonal(tile(0, 0), m.ls, bseg(0), lane);
    if (lane == 0 && bad) m.flags[0] = 1;
  }
  PHASE(1);
  cluster.sync();
  PHASE(3);

  // A_ij -= L_ik L_jk^T for this CTA's tiles with jlo <= j <= jhi; `skip`
  // leaves out tile (skip, skip) (its owner applied update k to it before
  // factoring it), -1 none. The L_jk
  // of other CTAs come through DSMEM in chunks of up to p.ring / 2 tiles into
  // alternate halves of the ring; chunk c + 1's loads are in flight (in
  // registers, one float4 of each tile per thread) while chunk c's products
  // run.
  auto trailing = [&](int k, int jlo, int jhi, int skip) {
    jhi = min(jhi, maxrow);
    if (jlo > jhi) return;
    const int chunk = p.ring / 2;
    if (warp == 0) {  // lane l takes j = jlo + l; the remote ones are numbered by a ballot
      const int j = jlo + lane;
      const bool in = j <= jhi, remote = in && s_owner[j] != rank;
      const unsigned rm = __ballot_sync(kFull, remote);
      const int n = __popc(rm & ((1u << lane) - 1u));
      if (remote) {
        s_src[n] = reinterpret_cast<const float4*>(s_rtile[j] + k * kTileFloats);
        s_boff[lane] = static_cast<int>(m.ring - smem) +
                       (((n / chunk) & 1) * chunk + n % chunk) * kTileFloats;
        if ((n + 1) % chunk == 0) s_jend[n / chunk] = j;
      } else if (in) {
        s_boff[lane] = static_cast<int>(tile(j, k) - smem);
      }
      __syncwarp();
      if (lane == 0) {
        int nch = __popc(rm) / chunk;
        if (nch == 0 || s_jend[nch - 1] != jhi) s_jend[nch++] = jhi;
        s_chunk[0] = nch;
        s_chunk[1] = __popc(rm);
      }
    }
    __syncthreads();
    const int nch = s_chunk[0], nrem = s_chunk[1];
    // tile u of a chunk: float4 tid & 255 by the threads with tid >> 8 == u & 1
    float4 v[kMaxChunk / 2];
    const int half = tid >> 8, q4 = tid & 255;
    auto fetch = [&](int c) {
#pragma unroll
      for (int u2 = 0; u2 < kMaxChunk / 2; ++u2) {
        const int u = 2 * u2 + half, n = c * chunk + u;
        if (u < chunk && n < nrem) v[u2] = s_src[n][q4];
      }
    };
    fetch(0);
    PHASE(5);
    for (int c = 0, j0 = jlo; c < nch; ++c) {
#pragma unroll
      for (int u2 = 0; u2 < kMaxChunk / 2; ++u2) {
        const int u = 2 * u2 + half, n = c * chunk + u;
        if (u < chunk && n < nrem) {
          reinterpret_cast<float4*>(m.ring + ((c & 1) * chunk + u) * kTileFloats)[q4] = v[u2];
        }
      }
      __syncthreads();
      PHASE(4);
      if (c + 1 < nch) fetch(c + 1);
      const int j1 = s_jend[c];
      int item = 0;
      for (int s = 0; s < nrows; ++s) {
        const int i = s_rows[s];
        for (int j = j0; j <= min(j1, i); ++j) {
          if ((i == skip && j == skip) || item++ % kGroups != group) continue;
          float acc[4][4];
          tile_product(tile(i, k), smem + s_boff[j - jlo], g, acc);
          float* Cij = tile(i, j);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int e = 0; e < 4; ++e) Cij[sw(ty + 8 * a, tx + 8 * e)] -= acc[a][e];
          }
        }
      }
      j0 = j1 + 1;
      PHASE(5);
    }
    __syncthreads();
    PHASE(5);
  };

  // the panel k: Linv_k and y_k from row k's owner, then L_ik = A_ik Linv^T
  // and b_i -= L_ik y_k for this CTA's rows i > k
  auto panel = [&](int k) {
    {
      const int own = s_owner[k];
      const float4* src = reinterpret_cast<const float4*>(s_rtile[k] + k * kTileFloats);
      if (tid < kTileFloats / 4) reinterpret_cast<float4*>(m.linv)[tid] = src[tid];
      if (tid < kNB) m.yk[tid] = *cluster.map_shared_rank(m.bseg + s_slot[k] * kNB + tid, own);
    }
    __syncthreads();
    int first = 0;
    while (first < nrows && s_rows[first] <= k) ++first;
    for (int s0 = first; s0 < nrows; s0 += kGroups) {
      const int s = s0 + group;
      float acc[4][4];
      if (s < nrows) tile_product(tile(s_rows[s], k), m.linv, g, acc);
      __syncthreads();
      if (s < nrows) {
        float* Lik = tile(s_rows[s], k);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int e = 0; e < 4; ++e) Lik[sw(ty + 8 * a, tx + 8 * e)] = acc[a][e];
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < (nrows - first) * kNB; idx += kThreads) {
      const int i = s_rows[first + (idx >> 5)], r = idx & 31;
      const float* Lik = tile(i, k);
      float acc = 0.0f;
#pragma unroll 8
      for (int c = 0; c < kNB; ++c) acc = fmaf(Lik[sw(r, c)], m.yk[c], acc);
      bseg(i)[r] -= acc;
    }
    __syncthreads();
    PHASE(2);
  };
  // the owner of block row k: A_kk -= L_{k,k-1} L_{k,k-1}^T (its last update,
  // from its own panel tile), then Linv_k and y_k
  auto diagonal = [&](int k) {
    if (s_owner[k] != rank) return;
    if (warp < kGroupThreads / 32) {  // one group: tile (k, k) alone
      float acc[4][4];
      tile_product(tile(k, k - 1), tile(k, k - 1), g, acc);
      float* T = tile(k, k);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int e = 0; e < 4; ++e) T[sw(ty + 8 * a, tx + 8 * e)] -= acc[a][e];
      }
    }
    __syncthreads();
    if (warp == 0) {
      const bool bad = factor_diagonal(tile(k, k), m.ls, bseg(k), lane);
      if (lane == 0 && bad) m.flags[0] = 1;
    }
    PHASE(1);
  };

  // one cluster barrier per panel: between two, each CTA applies update k,
  // solves its part of panel k + 1, and the owner of block row k + 2 factors
  // that diagonal tile (look-ahead), so the next barrier finds panel k + 1
  // complete and Linv_{k+2} published
  panel(0);
  if (NT > 1) diagonal(1);
  cluster.sync();
  PHASE(3);
  for (int k = 0; k + 1 < NT; ++k) {
    trailing(k, k + 1, NT - 1, s_owner[k + 1] == rank ? k + 1 : -1);
    panel(k + 1);
    if (k + 2 < NT) diagonal(k + 2);
    cluster.sync();
    PHASE(3);
  }

  // back substitution L^T x = y, block rows from the bottom; part[j] of a
  // CTA holds the sum of L_ij^T x_i over its rows i whose x is known
  for (int k = NT - 1; k >= 0; --k) {
    if (s_owner[k] == rank) {
      for (int i = tid; i < C * kNB; i += kThreads) {
        m.red[i] = *cluster.map_shared_rank(m.part + k * kNB + (i & 31), i >> 5);
      }
      __syncthreads();
      float* xk = bseg(k);
      if (warp == 0) {
        float s = xk[lane];
        for (int q = 0; q < C; ++q) s -= m.red[q * kNB + lane];
        const float* T = tile(k, k);  // Linv
        float xl = 0.0f;
#pragma unroll
        for (int r = 0; r < kNB; ++r) xl = fmaf(T[sw(r, lane)], __shfl_sync(kFull, s, r), xl);
        xk[lane] = xl;
      }
      __syncthreads();
      for (int idx = tid; idx < k * kNB; idx += kThreads) {
        const int j = idx >> 5, c = idx & 31;
        const float* Lkj = tile(k, j);
        float acc = 0.0f;
#pragma unroll 8
        for (int r = 0; r < kNB; ++r) acc = fmaf(Lkj[sw(r, c)], xk[r], acc);
        m.part[idx] += acc;
      }
    }
    cluster.sync();
  }
  PHASE(6);

  if (tid == 0) {
    int bad = 0;
    for (int q = 0; q < C; ++q) bad |= *cluster.map_shared_rank(m.flags, q);
    s_bad = bad;
  }
  __syncthreads();
  const bool marked = s_bad != 0;
  for (int s = 0; s < nrows; ++s) {
    const int i = s_rows[s];
    if (tid < kNB && i * kNB + tid < D) {
      xs[i * kNB + tid] = marked ? __int_as_float(0x7fc00000) : bseg(i)[tid];
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
  PHASE_END
}

cudaError_t read_plan(const int* in, int D, Plan& p) {
  const int NT = (D + kNB - 1) / kNB;
  p.cluster = in[0];
  p.ntiles = in[1];
  p.ring = in[2];
  p.smem = in[3];
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.ring < 2 || p.ring > kMaxRing || p.ring % 2 ||
      p.ntiles < 1 || p.smem < 1) {
    return cudaErrorInvalidValue;
  }
  for (int r = 0; r < kMaxNT; ++r) {
    p.owner[r] = static_cast<signed char>(in[4 + r]);
    p.slot[r] = static_cast<signed char>(in[4 + kMaxNT + r]);
    p.base[r] = static_cast<short>(in[4 + 2 * kMaxNT + r]);
    if (r < NT && (p.owner[r] < 0 || p.owner[r] >= p.cluster || p.slot[r] < 0 || p.base[r] < 0 ||
                   p.base[r] + r + 1 > p.ntiles)) {
      return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

// Once per device: the dynamic shared memory past 48 KB and clusters past 8.
cudaError_t opt_in() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, spd_solve_cluster_kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(spd_solve_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemPerBlock - static_cast<int>(attr.sharedSizeBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(spd_solve_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  done[dev] = true;
  return cudaSuccess;
}

void launch_config(const Plan& p, int batch, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                   cudaLaunchAttribute (&attr)[1]) {
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.cluster * batch));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

}  // namespace


#ifdef SVIN_PHASE_TIMES
// the last launch's per-phase cycles (8 values) into host memory
extern "C" int spd_solve_cluster_phase_cycles(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, svin_phase_cycles, sizeof(svin_phase_cycles)));
}
#endif

// How many clusters of the plan the card can hold at once
// (cudaOccupancyMaxActiveClusters); 0 means it cannot schedule one.
extern "C" int spd_solve_cluster_max_active(int D, const int* plan, int* out) {
  Plan p;
  cudaError_t err = read_plan(plan, D, p);
  if (err == cudaSuccess) err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(p, 1, nullptr, cfg, attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, reinterpret_cast<const void*>(spd_solve_cluster_kernel),
                                     &cfg));
}

// H: (batch, D, D) f32 (only the lower triangle is read), b: (batch, D),
// x: (batch, D), all contiguous on the current device; 1 <= D <= kMaxD;
// plan: 4 + 3 kMaxNT ints from ops/solve.py::cluster_plan(D) (a plan past
// the shared memory left beside the kernel's static share fails to launch). Returns the
// cudaError_t of the launch.
extern "C" int spd_solve_cluster(const float* H, const float* b, float* x, int batch, int D,
                                 const int* plan, void* stream) {
  if (D < 1 || D > kMaxD || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  cudaError_t err = read_plan(plan, D, p);
  if (err == cudaSuccess) err = opt_in();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(p, batch, static_cast<cudaStream_t>(stream), cfg, attr);
  err = cudaLaunchKernelEx(&cfg, spd_solve_cluster_kernel, H, b, x, D, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
