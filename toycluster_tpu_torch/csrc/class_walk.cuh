// The list walk shared by solve_density.cu, wvt_displacement.cu,
// fused_wvt.cu and stream_curl.cu: one receiver block (a row) per CTA of
// 512 threads, or per thread-block cluster of up to 8 such CTAs.
//
// 1. Member test, once per call.  A row lists block ids, or superblock ids
//    whose members below nb are its source blocks; -1 entries stand
//    anywhere.  Entry e of the expanded list belongs to CTA e mod C of the
//    row's cluster (C = 1 without one): a share by list position, so the
//    blocks a CTA sums do not depend on what the test keeps.  One thread
//    per entry runs the chunk cross test of stream_pair.member_keep -- the
//    8 x 8 minimum-image gaps between the receiver block's and the source
//    block's 16-particle chunk hulls against the receiver chunk's largest
//    cap (density) or 0.5 (its largest h_i + the source chunk's largest h)
//    box (displacement), both inflated by `infl` -- rounding operation by
//    operation as the plain test does, and warp ballots compact the kept
//    block ids, in list order, into a list in shared memory.  Block ids
//    are stored whole (32 bits), so no list position type bounds a row;
//    the launcher refuses a share that does not fit the shared memory.
//    solve_density.cu and fused_wvt.cu run the same test again before
//    each sweep, over the kept blocks, against the sweep's own ranges
//    (`compact`).  fused_wvt.cu and stream_curl.cu keep more of the test
//    than its verdict (`keep_tiles`): a warp serves 32 receiver lanes (two
//    receiver chunks) and 32 sources of a block (two source chunks), a
//    tile, and the 8 x 8 gaps say for each of the 16 warps whether any of
//    its 2 x 2 chunk pairs is in range; a warp whose bit is clear skips
//    the block's pairs, which would add exact zeros.
// 2. Walk.  Source blocks are 128 (x, y, z, w) records of 16 bytes (2 KB,
//    contiguous; stream_curl.cu: two records a source, 4 KB), streamed
//    through a ring of STAGES slots with cp.async so that STAGES - 1 copies
//    are in flight while a block's pairs run.
//    SPLIT = 4 threads serve each receiver lane, each taking 32 sources of
//    every block; a pair reads its source with one broadcast 16-byte load.
// 3. Sums are two-level (per source block, then across blocks), then the
//    four parts of a lane are added in a fixed order, then, in a cluster,
//    every CTA writes its 128 partial sums to its own shared memory and,
//    after cluster.sync(), reads all C partials through distributed shared
//    memory in rank order: all CTAs of a row hold the same sums, so they
//    take the same Newton step and the same vote, and results repeat from
//    run to run.  A block the test drops adds exact zeros to the parts of
//    the CTA that owns its list position: pruned and unpruned runs agree
//    to the bit; runs of different cluster sizes agree to rounding.

#pragma once
#include <cooperative_groups.h>

#include "pair_common.cuh"

namespace class_walk {

namespace cg = cooperative_groups;
using pair_common::BLOCK;
using pair_common::SUPER;

constexpr int SPLIT = 4;               // threads per receiver lane
constexpr int NT = BLOCK * SPLIT;      // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int NJ = BLOCK / SPLIT;      // sources of a block per thread
constexpr int SRC_FLOATS = 4 * BLOCK;  // x, y, z, w of a source block
constexpr int STAGES = 4;              // cp.async ring depth
constexpr int NCHUNK = 8;              // 16-particle chunks per block
constexpr int MAX_CLUSTER = 8;         // the portable cluster size limit
constexpr int MAX_SHARE = 1 << 14;     // list entries of one CTA

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a CTA knows of its row: the list, its share of it, the tables of
// the member test.
struct Row {
  const float* src;   // (nb, 128, 4) source records
  const float* ctab;  // (nb, 8, 8) source chunks: cen xyz, ext xyz, max h, 0
  const int* list;    // (M,) the row's list entries
  int n_entries;      // M, or M * SUPER with superblock ids
  int nb, sb, prune;
  int rank, csize;    // this CTA in its cluster
  float box, inv_box, infl;
};

// Minimum-image gap^2 between receiver chunk ri and source chunk cj (cen
// xyz, ext xyz), without contraction, as stream_pair.member_keep rounds it.
__device__ __forceinline__ float hull_gap2(const float* ri, const float* cj,
                                           float box, float inv_box) {
  float g2 = 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float dd = __fsub_rn(ri[d], cj[d]);
    dd = __fsub_rn(dd, __fmul_rn(box, rintf(__fmul_rn(dd, inv_box))));
    const float gp =
        fmaxf(__fsub_rn(fabsf(dd), __fadd_rn(ri[3 + d], cj[3 + d])), 0.0f);
    g2 = d == 0 ? __fmul_rn(gp, gp) : __fadd_rn(g2, __fmul_rn(gp, gp));
  }
  return g2;
}

// The chunk cross test of source block b against the receiver chunks s_rt
// (8 x 8 floats: cen, ext, max cap, max h_i): the density range with the
// squared thresholds s_td2, or (DISP) the displacement range.
template <bool DISP>
__device__ __forceinline__ bool keep_block(const Row& r, int b,
                                           const float* s_rt,
                                           const float* s_td2) {
  const float4* cj4 = reinterpret_cast<const float4*>(r.ctab) + (size_t)b * 16;
  bool keep = false;
  for (int mc = 0; mc < NCHUNK && !keep; ++mc) {
    const float4 c0 = __ldg(cj4 + 2 * mc);
    const float4 c1 = __ldg(cj4 + 2 * mc + 1);
    const float cj[7] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z};
#pragma unroll
    for (int rc = 0; rc < NCHUNK; ++rc) {
      const float* ri = s_rt + rc * 8;
      const float g2 = hull_gap2(ri, cj, r.box, r.inv_box);
      if (DISP) {
        const float tx = __fadd_rn(
            __fmul_rn(__fmul_rn(0.5f, __fadd_rn(ri[7], cj[6])), r.box),
            r.infl);
        keep = keep || g2 <= __fmul_rn(tx, tx);
      } else {
        keep = keep || g2 <= s_td2[rc];
      }
    }
  }
  return keep;
}

// The same test, kept per warp tile: bit w of the low half (DENS) or of the
// high half (DISP) is set if a chunk pair of warp w's tile -- receiver
// chunks 2 (w % 4) and 2 (w % 4) + 1 against source chunks 2 (w / 4) and
// 2 (w / 4) + 1, the lanes and sources of thread w * 32 .. w * 32 + 31 --
// is in range.  A half is nonzero where keep_block holds for its consumer.
template <bool DENS, bool DISP>
__device__ __forceinline__ unsigned keep_tiles(const Row& r, int b,
                                               const float* s_rt,
                                               const float* s_td2) {
  static_assert(NWARP == 16 && NCHUNK == 8 && SPLIT == 4,
                "16 tiles of 2 x 2 chunk pairs");
  const float4* cj4 = reinterpret_cast<const float4*>(r.ctab) + (size_t)b * 16;
  unsigned md = 0u, mx = 0u;
  for (int mc = 0; mc < NCHUNK; ++mc) {
    const float4 c0 = __ldg(cj4 + 2 * mc);
    const float4 c1 = __ldg(cj4 + 2 * mc + 1);
    const float cj[7] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z};
#pragma unroll
    for (int rc = 0; rc < NCHUNK; ++rc) {
      const float* ri = s_rt + rc * 8;
      const float g2 = hull_gap2(ri, cj, r.box, r.inv_box);
      const unsigned bit = 1u << ((mc >> 1) * 4 + (rc >> 1));
      if (DENS && g2 <= s_td2[rc]) md |= bit;
      if (DISP) {
        const float tx = __fadd_rn(
            __fmul_rn(__fmul_rn(0.5f, __fadd_rn(ri[7], cj[6])), r.box),
            r.infl);
        if (g2 <= __fmul_rn(tx, tx)) mx |= bit;
      }
    }
  }
  return md | (mx << 16);
}

// Compact the entries k of 0 .. n whose fetch(k) is valid (>= 0) and whose
// test(fetch(k), k, v) holds: the value v it leaves goes into `out`, in
// order.  s_wc holds 2 * NWARP * 2 ints.  Every thread runs the same trip
// count, so ballots and barriers are uniform.
template <class T, class Fetch, class Test>
__device__ __forceinline__ void compact(int n, Fetch fetch, Test test,
                                        int* s_wc, T* out, int& n_out,
                                        int& n_valid) {
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const unsigned lt = (1u << (tid & 31)) - 1u;
  n_out = n_valid = 0;
  for (int base = 0, pass = 0; base < n; base += NT, ++pass) {
    const int k = base + tid;
    const int b = k < n ? fetch(k) : -1;
    const bool valid = b >= 0;
    T v;
    const bool keep = valid && test(b, k, v);
    const unsigned bk = __ballot_sync(0xffffffffu, keep);
    const unsigned bv = __ballot_sync(0xffffffffu, valid);
    // warp totals, double-buffered by pass parity: one barrier a pass
    int* wc = s_wc + (pass & 1) * NWARP * 2;
    if ((tid & 31) == 0) {
      wc[w * 2 + 0] = __popc(bk);
      wc[w * 2 + 1] = __popc(bv);
    }
    __syncthreads();
    int off = n_out;
    for (int u = 0; u < NWARP; ++u) {
      if (u < w) off += wc[u * 2 + 0];
      n_out += wc[u * 2 + 0];
      n_valid += wc[u * 2 + 1];
    }
    if (keep) out[off + __popc(bk & lt)] = v;
  }
  __syncthreads();
}

// The source block of entry k of this CTA's share of the row's list, or -1
// (an empty entry, a member past nb).
__device__ __forceinline__ int entry_block(const Row& r, int k) {
  const int e = k * r.csize + r.rank;
  const int id = __ldg(r.list + (r.sb ? e >> 3 : e));
  const int b = r.sb ? id * SUPER + (e & 7) : id;
  return id >= 0 && b < r.nb ? b : -1;
}

// Entries of this CTA's share of a row of n_entries entries.
__device__ __forceinline__ int share_entries(const Row& r) {
  return r.n_entries > r.rank
             ? (r.n_entries - r.rank + r.csize - 1) / r.csize
             : 0;
}

// Test this CTA's share of the row's entries and write the kept block ids,
// in list order, into `kept`.
template <bool DISP>
__device__ void build_list(const Row& r, const float* s_rt,
                           const float* s_td2, int* s_wc, int* kept,
                           int& n_kept, int& n_listed) {
  compact(
      share_entries(r), [&](int k) { return entry_block(r, k); },
      [&](int b, int, int& v) {
        v = b;
        return !r.prune || keep_block<DISP>(r, b, s_rt, s_td2);
      },
      s_wc, kept, n_kept, n_listed);
}

// As build_list at the density range, for a kernel whose warps skip their
// tiles: an entry of `kept` is (block id, keep_tiles' density bits; all
// set without the test).
__device__ void build_tile_list(const Row& r, const float* s_rt,
                                const float* s_td2, int* s_wc, int2* kept,
                                int& n_kept, int& n_listed) {
  compact(
      share_entries(r), [&](int k) { return entry_block(r, k); },
      [&](int b, int, int2& v) {
        const unsigned m =
            r.prune ? keep_tiles<true, false>(r, b, s_rt, s_td2) : 0xffffu;
        v = make_int2(b, (int)m);
        return m != 0u;
      },
      s_wc, kept, n_kept, n_listed);
}

// Stream the blocks kept[0 .. n) through the ring and call body(sm) on
// each, sm the block's RECS x 128 float4 records in shared memory (all
// threads take part; the first RECS x 128 each copy one record).
template <int RECS = 1, class Ids, class Body>
__device__ __forceinline__ void walk(const float* src, Ids kept, int n,
                                     float* ring, Body body) {
  const int t = threadIdx.x;
  auto start_copy = [&](int k) {
    if (t < RECS * BLOCK)
      cp_async16(ring + (k % STAGES) * RECS * SRC_FLOATS + 4 * t,
                 src + (size_t)kept[k] * RECS * SRC_FLOATS + 4 * t);
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < n) start_copy(k);
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    cp_async_wait<STAGES - 2>();  // this thread's piece of block k landed
    // block k visible to all; every thread is done with block k - 1,
    // whose slot the next copy reuses
    __syncthreads();
    if (k + STAGES - 1 < n) start_copy(k + STAGES - 1);
    cp_async_commit();
    body(reinterpret_cast<const float4*>(ring +
                                         (k % STAGES) * RECS * SRC_FLOATS));
  }
  // the ring is free for the next walk
  __syncthreads();
}

// The NQ sums of each receiver lane from its SPLIT threads' parts v, added
// in part order through s_part (SPLIT * NQ * 128 floats); with CL then
// across the cluster's CTAs in rank order through s_cl (NQ * 128 floats of
// every CTA's shared memory).  Every thread of every CTA returns with the
// row's sums of its lane in v.  A caller that reduces more than once
// alternates between two s_cl buffers, so that one cluster.sync() a
// reduction is enough; it ends with a cluster.sync() of its own, before
// any CTA whose shared memory may still be read exits.
template <int NQ, bool CL>
__device__ __forceinline__ void reduce_row(float (&v)[NQ], float* s_part,
                                           float* s_cl, int csize) {
  const int t = threadIdx.x;
  const int li = t % BLOCK;
  const int p = t / BLOCK;
#pragma unroll
  for (int q = 0; q < NQ; ++q) s_part[(p * NQ + q) * BLOCK + li] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float acc = s_part[q * BLOCK + li];
#pragma unroll
    for (int pp = 1; pp < SPLIT; ++pp)
      acc += s_part[(pp * NQ + q) * BLOCK + li];
    v[q] = acc;
  }
  if (CL) {
    cg::cluster_group cluster = cg::this_cluster();
    if (p == 0) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) s_cl[q * BLOCK + li] = v[q];
    }
    cluster.sync();
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float acc = cluster.map_shared_rank(s_cl, 0)[q * BLOCK + li];
      for (int rk = 1; rk < csize; ++rk)
        acc += cluster.map_shared_rank(s_cl, rk)[q * BLOCK + li];
      v[q] = acc;
    }
  }
}

// Totals over the cluster of the N counts each CTA left in its s_cnt
// (after a cluster.sync() that followed the writes).
template <int N, bool CL>
__device__ __forceinline__ void cluster_counts(const int* s_cnt, int csize,
                                               int* total) {
  for (int q = 0; q < N; ++q) total[q] = s_cnt[q];
  if (CL) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int q = 0; q < N; ++q) total[q] = 0;
    for (int rk = 0; rk < csize; ++rk) {
      const int* c = cluster.map_shared_rank(s_cnt, rk);
      for (int q = 0; q < N; ++q) total[q] += c[q];
    }
  }
}

// Dynamic shared memory of a launch: the ring (blocks of `recs` records a
// source) and `lists` lists of one CTA's share of a row; 0 if the share
// exceeds MAX_SHARE.
inline size_t smem_bytes(int n_entries, int cluster, int lists,
                         int recs = 1) {
  const int share = (n_entries + cluster - 1) / cluster;
  if (share > MAX_SHARE) return 0;
  return (size_t)STAGES * recs * SRC_FLOATS * sizeof(float) +
         (size_t)lists * (share > 0 ? share : 1) * sizeof(int);
}

// Launch kern<<<S * cluster CTAs of NT threads>>> with `smem` bytes of
// dynamic shared memory; with cluster > 1 as clusters of `cluster`
// consecutive CTAs.
template <class Args>
int launch(void (*kern)(Args), const Args& a, int S, int cluster, size_t smem,
           cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S * (unsigned)cluster);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace class_walk
