// Fused descriptor matcher: the Hamming distances of packed binary
// descriptors, the pair mask, and best-match selection (distance threshold,
// best / second-best ratio, mutual consistency) in one launch, without the
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
// matchers and loop verification.
//
// What bounds it on the H100: bytes. The inputs, the mask, the validity
// flags and the outputs are 460,096 B at the map matcher's shape (2 x 400
// keypoints against 512 landmarks, mask 409,600 B) -> 0.137 us at 3.35
// TB/s; its 3.3 M word popcounts take 0.79 us at 16 __popc per clock per SM,
// and here run on the tensor cores instead.
//
// Design (the launch plan: ops/hamming.py::match_plan):
//  - One thread-block cluster of kCluster = 16 CTAs (non-portable) per batch
//    element (camera), one launch per call. The rows of a are split over the
//    cluster's CTAs, up to 32 rows (two 16-row tiles) per pass, 8 warps each.
//  - b and the pass's mask rows come through shared memory in chunks of 256
//    columns by asynchronous copies (cp.async; the mask in 4-byte words when
//    its row length allows), double-buffered: chunk c + 1 lands while chunk
//    c is matched; a pass's rows of a come in the same group as its first
//    chunk, and each thread loads the next chunk's valid_b flag ahead.
//  - Distances on the tensor cores: mma.m16n8k256 on 1-bit operands with
//    AND + popcount gives popc(a & b) for a 16 x 8 tile of pairs per
//    instruction (a 256-bit descriptor is one k256 step; W < 8 words are
//    zero-padded), and d = popc(a) + popc(b) - 2 popc(a & b). Each warp
//    takes 4 of a chunk's 32 column tiles against all of the pass's row
//    tiles.
//  - Per row, each thread keeps (best key, second distance) over its
//    columns, key = dist << 23 | col in 32 bits (BIG as 511), so a minimum over
//    keys is the argmin with the lowest column among ties; lane shuffles and
//    one shared slot per (row, warp) merge them at the end of the pass in a
//    fixed order.
//  - Per column (mutual), the minimum of dist << 23 | row over the warp's
//    rows by shuffles, then one min reduction per column and CTA, one per
//    lane (red.shared::cluster.min.u32), into the table of the CTA that
//    owns the column, in distributed shared memory.
//    A minimum over a total order does not depend on the order of the
//    atomics, so the result is deterministic. After a cluster barrier each
//    row's mutual check reads its best column's minimum from the owner.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;                 // CTAs per batch element (a non-portable cluster)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTiles = 2;                 // 16-row tiles per pass
constexpr int kPassRows = 16 * kRowTiles;
constexpr int kChunk = 256;                  // columns of b per shared-memory chunk
constexpr int kTilesPerWarp = kChunk / 8 / kWarps;
constexpr int kMaxWords = 8;
constexpr int kMaxColsPerCta = 2048;         // the column-minimum table: 8 KB per CTA
constexpr int kMaskLd = kChunk + 4;          // a mask row's bytes in shared memory (no bank conflicts)
constexpr int kMaxDevices = 64;
constexpr int kBig = 1 << 20;                // ops/hamming.py BIG
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoKey = ~0u;

// A key in 32 bits: a distance (at most 256; BIG, a masked pair, as 511)
// over kIdxBits bits of index, so a 32-bit minimum over keys is the argmin
// with the lowest index among ties: rows' best columns and (mutual) the
// columns' best rows. (64-bit min reductions on distributed shared memory
// lost updates on the H100.)
constexpr int kIdxBits = 23;
constexpr unsigned kIdxMask = (1u << kIdxBits) - 1u;
constexpr unsigned kBigCode = 511;

__device__ __forceinline__ int dist_of(unsigned code) {
  return code >= kBigCode ? kBig : static_cast<int>(code);
}
// (best key, second distance code) of the union of two disjoint sets
__device__ __forceinline__ void merge(unsigned& best, unsigned& second, unsigned ob, unsigned os) {
  second = min(min(second, os), max(best, ob) >> kIdxBits);
  best = min(best, ob);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// *remote = min(*remote, v) on a 32-bit word in the shared memory of CTA
// `rank` of the cluster (the address of the same variable here)
__device__ __forceinline__ void dsmem_min(const unsigned* local, int rank, unsigned v) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(local))), "r"(rank));
  asm volatile("red.shared::cluster.min.u32 [%0], %1;\n" ::"r"(remote), "r"(v) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// d = popc(A & B) for A 16 x 256 bits (a[0..3]: rows g and g + 8, words t
// and t + 4) and B 256 x 8 bits (column g, words t and t + 4), g = lane / 4,
// t = lane % 4; d[0..1] rows g, d[2..3] row g + 8, columns 2t and 2t + 1
__device__ __forceinline__ void mma_and_popc(const unsigned (&a)[4], unsigned b0, unsigned b1,
                                             int (&d)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0), "r"(0), "r"(0),
        "r"(0));
}

__global__ void __launch_bounds__(kThreads)
match_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
             const unsigned char* __restrict__ valid_a, const unsigned char* __restrict__ valid_b,
             const unsigned char* __restrict__ mask, int Na, int Nb, int W, long long b_bstride,
             long long vb_bstride, int max_distance, int use_ratio, float ratio, int mutual,
             int rows_per_cta, int cols_per_cta, int* __restrict__ idx_out,
             int* __restrict__ dist_out, bool* __restrict__ valid_out) {
  __shared__ unsigned colmin[kMaxColsPerCta];                   // this CTA's columns' keys
  __shared__ __align__(16) unsigned b_s[2][kChunk * kMaxWords];  // column-major, 8 words each
  __shared__ unsigned char vb_s[2][kChunk];
  __shared__ __align__(16) unsigned char m_s[2][kPassRows][kMaskLd];  // the chunk's mask rows
  __shared__ unsigned a_s[kPassRows][kMaxWords];
  __shared__ bool va_s[kPassRows];
  __shared__ unsigned best_s[kPassRows][kWarps];
  __shared__ unsigned second_s[kPassRows][kWarps];
  __shared__ unsigned cm_s[kWarps][kTilesPerWarp * 8];  // a warp's column minima of a chunk
  static_assert(kChunk == kThreads, "one valid_b flag of a chunk per thread");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long z = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, t = lane & 3;
  const int row_lo = min(Na, rank * rows_per_cta), row_hi = min(Na, row_lo + rows_per_cta);
  const unsigned* az = a + z * Na * W;
  const unsigned* bz = b + z * b_bstride;
  const unsigned char* vbz = valid_b + z * vb_bstride;
  const unsigned char* mz = mask ? mask + z * Na * static_cast<long long>(Nb) : nullptr;
  const int nchunks = (Nb + kChunk - 1) / kChunk;

  if (mutual) {
    for (int i = tid; i < cols_per_cta; i += kThreads) colmin[i] = kNoKey;
    cluster_arrive();  // the table is set: the other CTAs' reductions wait for it
  }
  if (W < kMaxWords) {  // the words past W stay zero (the copies write words < W)
    for (int i = tid; i < 2 * kChunk * kMaxWords; i += kThreads) (&b_s[0][0])[i] = 0u;
  }
  bool waited = false;
  // a CTA with one pass keeps its rows' results for the mutual check in registers
  const bool single = row_hi - row_lo <= kPassRows;
  int my_bc = 0;
  bool my_ok = false;

  // chunk c of b, and of the mask rows p0 .. p0 + nr, into buffer c & 1 by
  // asynchronous copies (4-byte words of the mask where its rows allow it)
  auto issue = [&](int c, int p0, int nr) {
    const int s = c & 1, c0 = c * kChunk, ncols = min(kChunk, Nb - c0);
    for (int i = tid; i < ncols * W; i += kThreads) {
      const int col = i / W, w = i - col * W;
      cp_async4(&b_s[s][col * kMaxWords + w], bz + static_cast<long long>(c0) * W + i);
    }
    if (mz == nullptr) return;
    if ((Nb & 3) == 0) {
      const int nw = ncols >> 2;  // words per row (ncols is a multiple of 4 here)
      for (int i = tid; i < nr * nw; i += kThreads) {
        const int r = i / nw, w = i - r * nw;
        cp_async4(&m_s[s][r][4 * w], mz + static_cast<long long>(p0 + r) * Nb + c0 + 4 * w);
      }
    } else {
      for (int i = tid; i < nr * ncols; i += kThreads) {
        const int r = i / ncols, col = i - r * ncols;
        m_s[s][r][col] = mz[static_cast<long long>(p0 + r) * Nb + c0 + col];
      }
    }
  };
  auto valid_b_of = [&](int c) -> unsigned char {
    const int col = c * kChunk + tid;
    return col < Nb ? vbz[col] : 0;
  };

  for (int p0 = row_lo; p0 < row_hi; p0 += kPassRows) {
    const int nr = min(kPassRows, row_hi - p0);
    __syncthreads();  // the previous pass is done with a_s, best_s and the buffers
    // the pass's rows of a and b's first chunk in one group of copies
    for (int i = tid; i < kPassRows * kMaxWords; i += kThreads) {
      const int r = i / kMaxWords, w = i % kMaxWords;
      if (r < nr && w < W) {
        cp_async4(&a_s[r][w], az + static_cast<long long>(p0 + r) * W + w);
      } else {
        a_s[r][w] = 0u;
      }
    }
    const bool va_mine = tid < nr && valid_a[z * Na + p0 + tid];
    // two chunks in flight from the start: chunk c + 2 is asked for as soon
    // as chunk c's buffer is free
    issue(0, p0, nr);
    cp_async_commit();
    unsigned char vb_even = valid_b_of(0), vb_odd = 0;
    if (nchunks > 1) {
      issue(1, p0, nr);
      cp_async_commit();
      vb_odd = valid_b_of(1);
    }
    unsigned af[kRowTiles][4];
    int pa[kRowTiles][2];
    unsigned rbest[kRowTiles][2], rsec[kRowTiles][2];
#pragma unroll
    for (int rt = 0; rt < kRowTiles; ++rt) {
      rbest[rt][0] = rbest[rt][1] = kNoKey;
      rsec[rt][0] = rsec[rt][1] = kNoKey;
    }

    for (int c = 0; c < nchunks; ++c) {
      const int s = c & 1, c0 = c * kChunk;
      vb_s[s][tid] = s ? vb_odd : vb_even;
      if (c == 0 && tid < kPassRows) va_s[tid] = va_mine;
      if (c + 1 < nchunks) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk c (and at c = 0 the rows) visible to every thread
      if (c == 0) {
#pragma unroll
        for (int rt = 0; rt < kRowTiles; ++rt) {
          af[rt][0] = a_s[rt * 16 + grp][t];
          af[rt][1] = a_s[rt * 16 + grp + 8][t];
          af[rt][2] = a_s[rt * 16 + grp][t + 4];
          af[rt][3] = a_s[rt * 16 + grp + 8][t + 4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // popc of rows grp and grp + 8, summed over the 4 lanes
            int pc = __popc(af[rt][h]) + __popc(af[rt][h + 2]);
            pc += __shfl_xor_sync(kFull, pc, 1);
            pa[rt][h] = pc + __shfl_xor_sync(kFull, pc, 2);
          }
        }
      }
      bool va[kRowTiles][2];
#pragma unroll
      for (int rt = 0; rt < kRowTiles; ++rt) {
        va[rt][0] = va_s[rt * 16 + grp];
        va[rt][1] = va_s[rt * 16 + grp + 8];
      }
#pragma unroll
      for (int q = 0; q < kTilesPerWarp; ++q) {
        const int ct = warp * kTilesPerWarp + q;
        const unsigned* bw = &b_s[s][(ct * 8 + grp) * kMaxWords];
        const unsigned b0 = bw[t], b1 = bw[t + 4];
        int pb = __popc(b0) + __popc(b1);  // popc of column ct*8 + grp
        pb += __shfl_xor_sync(kFull, pb, 1);
        pb += __shfl_xor_sync(kFull, pb, 2);
        const int pb0 = __shfl_sync(kFull, pb, 8 * t), pb1 = __shfl_sync(kFull, pb, 8 * t + 4);
        const int lc = ct * 8 + 2 * t;  // this thread's columns lc, lc + 1 of the chunk
        const int gc = c0 + lc;
        const bool cl[2] = {gc < Nb, gc + 1 < Nb};  // columns inside b
        const bool cv[2] = {cl[0] && vb_s[s][lc], cl[1] && vb_s[s][lc + 1]};
        const int pbe[2] = {pb0, pb1};
        unsigned cmin[2] = {kNoKey, kNoKey};
#pragma unroll
        for (int rt = 0; rt < kRowTiles; ++rt) {
          if (rt * 16 >= nr) break;
          int d[4];
          mma_and_popc(af[rt], b0, b1, d);
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // branch-free: a pair outside a or b gets key kNoKey
            const int lr = rt * 16 + grp + 8 * h;
            const bool rl = lr < nr;
            const unsigned char* mrow = &m_s[s][lr][lc];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool ok = va[rt][h] && cv[e] && (mz == nullptr || mrow[e]);
              const unsigned dist =
                  ok ? static_cast<unsigned>(pa[rt][h] + pbe[e] - 2 * d[2 * h + e]) : kBigCode;
              const bool live = rl && cl[e];
              const unsigned key = live ? dist << kIdxBits | static_cast<unsigned>(gc + e) : kNoKey;
              rsec[rt][h] = min(rsec[rt][h], max(rbest[rt][h], key) >> kIdxBits);
              rbest[rt][h] = min(rbest[rt][h], key);
              cmin[e] = min(cmin[e], live ? dist << kIdxBits | static_cast<unsigned>(p0 + lr) : kNoKey);
            }
          }
        }
        if (mutual) {  // the warp's column minima: over its rows by shuffles, then to cm_s
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            cmin[0] = min(cmin[0], __shfl_xor_sync(kFull, cmin[0], off));
            cmin[1] = min(cmin[1], __shfl_xor_sync(kFull, cmin[1], off));
          }
          if (grp == 0) {
            cm_s[warp][q * 8 + 2 * t] = cmin[0];
            cm_s[warp][q * 8 + 2 * t + 1] = cmin[1];
          }
        }
      }
      if (mutual) {
        if (!waited) {
          cluster_wait();
          waited = true;
        }
        // one reduction per lane: lane l sends the warp's column l
        __syncwarp();
        const unsigned v = cm_s[warp][lane];
        const int col = c0 + warp * kTilesPerWarp * 8 + lane;
        if (col < Nb && v != kNoKey) {
          const int own = col / cols_per_cta;
          dsmem_min(&colmin[col - own * cols_per_cta], own, v);
        }
      }
      __syncthreads();  // buffer c & 1 free for chunk c + 2
      if (c + 2 < nchunks) {
        issue(c + 2, p0, nr);
        cp_async_commit();
        (s ? vb_odd : vb_even) = valid_b_of(c + 2);
      }
    }

    // the pass's rows: merge the 4 lanes of a group, then the 8 warps
#pragma unroll
    for (int rt = 0; rt < kRowTiles; ++rt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          merge(rbest[rt][h], rsec[rt][h], __shfl_xor_sync(kFull, rbest[rt][h], off),
                __shfl_xor_sync(kFull, rsec[rt][h], off));
        }
        if (t == 0) {
          best_s[rt * 16 + grp + 8 * h][warp] = rbest[rt][h];
          second_s[rt * 16 + grp + 8 * h][warp] = rsec[rt][h];
        }
      }
    }
    __syncthreads();
    if (tid < nr) {
      unsigned best = kNoKey, second = kNoKey;
      for (int w = 0; w < kWarps; ++w) merge(best, second, best_s[tid][w], second_s[tid][w]);
      // the plain version's second best is the row minimum with the best set to BIG
      const int bd = dist_of(best >> kIdxBits), sd = dist_of(second);
      const int bc = static_cast<int>(best & kIdxMask);
      bool ok = bd <= max_distance;
      if (use_ratio) ok = ok && static_cast<float>(bd) <= ratio * static_cast<float>(sd);
      const long long o = z * Na + p0 + tid;
      dist_out[o] = bd;
      my_bc = bc;
      my_ok = ok;
      if (!mutual || !single) {
        idx_out[o] = mutual || ok ? bc : -1;  // mutual: finished below
        valid_out[o] = ok;
      }
    }
  }

  if (!mutual) return;
  if (!waited) cluster_wait();
  cluster.sync();  // every CTA's column minima are in
  for (int r = row_lo + tid; r < row_hi; r += kThreads) {
    const long long o = z * Na + r;
    const int bc = single ? my_bc : idx_out[o];
    bool ok = single ? my_ok : valid_out[o];
    if (ok) {
      const int own = bc / cols_per_cta;
      const unsigned key = *cluster.map_shared_rank(&colmin[bc - own * cols_per_cta], own);
      ok = (key & kIdxMask) == static_cast<unsigned>(r);
    }
    valid_out[o] = ok;
    idx_out[o] = ok ? bc : -1;
  }
  cluster.sync();  // no CTA leaves while another reads its table
}

}  // namespace

extern "C" int hamming_match_max_words() { return kMaxWords; }
extern "C" int hamming_match_cluster() { return kCluster; }
extern "C" int hamming_match_chunk() { return kChunk; }
extern "C" int hamming_match_max_cols_per_cta() { return kMaxColsPerCta; }

// a: (batch, Na, W) int32 words; b: (batch or 1, Nb, W); valid_a: (batch,
// Na) bool; valid_b: (batch or 1, Nb) bool; mask: (batch, Na, Nb) bool or
// null; outputs (batch, Na). All contiguous on the current device; b_bstride
// / vb_bstride = 0 share b / valid_b across the batch; rows_per_cta and
// cols_per_cta from ops/hamming.py::match_plan. One launch. Returns its
// cudaError_t.
extern "C" int hamming_match(const int* a, const int* b, const bool* valid_a,
                             const bool* valid_b, const bool* mask, int batch, int Na, int Nb,
                             int W, long long b_bstride, long long vb_bstride, int max_distance,
                             int use_ratio, float ratio, int mutual, int rows_per_cta,
                             int cols_per_cta, int* idx_out, int* dist_out, bool* valid_out,
                             void* stream) {
  if (W < 1 || W > kMaxWords || Nb < 1 || Na < 1 || Na > static_cast<int>(kIdxMask) ||
      Nb > kCluster * kMaxColsPerCta || batch < 1 ||
      rows_per_cta < 1 ||
      cols_per_cta < 1 || cols_per_cta > kMaxColsPerCta ||
      static_cast<long long>(rows_per_cta) * kCluster < Na ||
      static_cast<long long>(cols_per_cta) * kCluster < Nb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(match_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, match_kernel, reinterpret_cast<const unsigned*>(a),
                           reinterpret_cast<const unsigned*>(b),
                           reinterpret_cast<const unsigned char*>(valid_a),
                           reinterpret_cast<const unsigned char*>(valid_b),
                           reinterpret_cast<const unsigned char*>(mask), Na, Nb, W, b_bstride,
                           vb_bstride, max_distance, use_ratio, ratio, mutual, rows_per_cta,
                           cols_per_cta, idx_out, dist_out, valid_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
