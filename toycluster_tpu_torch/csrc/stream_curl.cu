// SPH curl of the vector potential over block or superblock candidate
// lists, hand-written for Hopper (sm_90a):
//   B_i = wfac_i * sum_j dW(r, h_i)/dr / r * (dx x (A_i - A_j)),
// over r < h_i, r > 0, j valid (Price 2010 eq. 79, reference sph.c:216-300),
// with wfac = -m varHsmlFac / rho.
//
// Replaces: toycluster_tpu/ops/pallas_pair.py _curl_stream_kernel
// (launched by stream_curl_pallas), the TPU kernel of the B-field stage
// (models/bfield.py), in both of its list modes: superblock ids (the
// stream engine's lists and the count-class engine's far-tail rows) and
// block ids (the count-class engine's lists; there it also replaces the
// XLA pair operator toycluster_tpu/ops/pair_ops.py sph_curl), together with
// the skip-bit pass that pruned its members (stream_skip_bits at the curl's
// range).
//
// Work (the list walk of class_walk.cuh): a row is one receiver block, on
// one CTA of 512 threads, four per receiver lane, or on a thread-block
// cluster of up to 8 such CTAs that share the row's list by list position
// (the far-tail rows and the wide classes: calls with too few rows to fill
// the card).  Every CTA tests its share of the first min(cnt, M) list
// entries once -- the chunk hulls' gaps against the receiver chunk's
// largest hsml -- and walks the blocks that pass, streamed as 4 KB (two
// 16-byte records a source: x, y, z, valid and A0, A1, A2, 0) through a
// cp.async ring.  The test leaves a bit for each of the 16 warps
// (class_walk::keep_tiles): a warp runs a block's pairs only where a chunk
// pair of its 32 lanes and 32 sources is in range.  A pair reads its position record with one broadcast load
// and its A record only when it is in range.  Sums are two-level (per
// source block, then across blocks); the four parts of a lane are added in
// a fixed order and, in a cluster, the CTAs' partial sums in rank order
// through distributed shared memory; rank 0 writes the row.  Rows whose
// reach (receiver extent + largest hsml) lies inside the box skip the
// periodic wrap (bit-identical: the wrap is the identity on every pair in
// range there; see stream_wvt.cu).  Rows are taken longest list first.
//
// What bounds it: fp32 pair arithmetic (8 operations for a pair's
// separation, 12 more with the wrap, the range test; ~60 in range) against
// 4 KB of copies per kept block reused 128 times from shared memory: the
// SMs' fp32 instruction rate, not HBM.  It runs once per pipeline, after
// the relaxation.
//
// dA = A_i - A_j is formed per pair: the TPU kernel records that a split
// into receiver and source partial sums cancels badly in f32 (up to 5e-2
// relative where A varies slowly).

#include "class_walk.cuh"

namespace {

using namespace pair_common;
using namespace class_walk;

constexpr int RECS = 2;   // 16-byte records a source
constexpr int GROUP = 4;  // sources a pass of the pair loop takes

struct Args {
  const float* src;    // (nb, 2, 128, 4): x y z valid, then a0 a1 a2 0
  const float* ctab;   // (nb, 8, 8) source chunks
  const float* rtab;   // (S, 8, 8) receiver chunks: cen, ext, max hsml, -
  const int* cand;     // (S, M) block ids, or superblock ids with sb
  const int* cnt;      // (S,)
  const int* flag;     // (S,) 1: the row skips the periodic wrap
  const int* order;    // (S,) rows, longest list first
  const float* xi;     // (S, 3, 128)
  const float* hsml;   // (S, 128)
  const float* wfac;   // (S, 128)
  const float* apot;   // (S, 3, 128) the receivers' vector potential
  float* out;          // (S, 128, 3)
  int* stats;          // (S, 5) or null: 1, blocks kept, blocks listed,
                       // blocks walked (= kept), tiles walked
  int M, nb, prune, sb;
  float box, inv_box, infl;
};

struct Lane {
  float x0, x1, x2, a0, a1, a2, h, h2, inv_h, inv_h5;
};

// The block ids of the kept list, for class_walk::walk.
struct KeptIds {
  const int2* kept;
  __device__ __forceinline__ int operator[](int k) const { return kept[k].x; }
};

template <int KIND, bool WRAP>
__device__ __forceinline__ void curl_pass(const Row& r, const int2* kept,
                                          int n_kept, float* ring,
                                          const Lane& ln, float (&v)[3]) {
  const int j0 = (threadIdx.x / BLOCK) * NJ;
  const float box = r.box;
  const float inv_box = 1.0f / box;
  const int w = threadIdx.x >> 5;
  float bx = 0.0f, by = 0.0f, bz = 0.0f;
  int k = 0;
  walk<RECS>(r.src, KeptIds{kept}, n_kept, ring, [&](const float4* sm) {
    // no chunk pair of this warp's lanes and sources is in range
    if (!(kept[k++].y >> w & 1)) return;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    // GROUP sources at a time: their separations and range tests are
    // independent chains the scheduler overlaps, and one branch guards the
    // few pairs in range, which add their terms in source order.  Products
    // that feed a sum are written as the fused operations they become, so
    // that the wrapped and the unwrapped build round alike.
    for (int j = j0; j < j0 + NJ; j += GROUP) {
      float dx[GROUP], dy[GROUP], dz[GROUP], r2[GROUP];
      unsigned in = 0u;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float4 q = sm[j + g];  // one broadcast load per pair
        dx[g] = ln.x0 - q.x;
        dy[g] = ln.x1 - q.y;
        dz[g] = ln.x2 - q.z;
        if (WRAP) {
          dx[g] = __fmaf_rn(-box, rintf(dx[g] * inv_box), dx[g]);
          dy[g] = __fmaf_rn(-box, rintf(dy[g] * inv_box), dy[g]);
          dz[g] = __fmaf_rn(-box, rintf(dz[g] * inv_box), dz[g]);
        }
        r2[g] = __fmaf_rn(dz[g], dz[g],
                          __fmaf_rn(dy[g], dy[g], __fmul_rn(dx[g], dx[g])));
        if (q.w > 0.0f && r2[g] < ln.h2 && r2[g] > 0.0f) in |= 1u << g;
      }
      if (in == 0u) continue;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        if (!(in >> g & 1u)) continue;
        const float u = sqrtf(r2[g]) * ln.inv_h;
        const float t = fmaxf(1.0f - u, 0.0f);
        float w;
        if (KIND == M4) {
          if (u < 0.5f) {
            w = __fmaf_rn(45.836623610466f, u, -30.557749073644f) * ln.inv_h5;
          } else {
            const float inv_u = rsqrtf(fmaxf(r2[g], 1e-30f)) * ln.h;
            w = (-15.278874536822f * t * t * inv_u) * ln.inv_h5;
          }
        } else {
          const float t3 = t * t * t;
          w = (WC6_NORM * ln.inv_h5) * (-22.0f) * t3 * t3 * t *
              __fmaf_rn(u, __fmaf_rn(16.0f, u, 7.0f), 1.0f);
        }
        const float4 aj = sm[BLOCK + j + g];
        const float da0 = ln.a0 - aj.x;
        const float da1 = ln.a1 - aj.y;
        const float da2 = ln.a2 - aj.z;
        cx = __fmaf_rn(
            w, __fmaf_rn(dz[g], da1, -__fmul_rn(dy[g], da2)), cx);
        cy = __fmaf_rn(
            w, __fmaf_rn(dx[g], da2, -__fmul_rn(dz[g], da0)), cy);
        cz = __fmaf_rn(
            w, __fmaf_rn(dy[g], da0, -__fmul_rn(dx[g], da1)), cz);
      }
    }
    bx += cx;
    by += cy;
    bz += cz;
  });
  v[0] = bx;
  v[1] = by;
  v[2] = bz;
}

template <int KIND, bool CL>
__global__ void __launch_bounds__(NT, 2) stream_curl_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  int2* kept = reinterpret_cast<int2*>(ring + STAGES * RECS * SRC_FLOATS);
  __shared__ float s_rt[NCHUNK * 8];
  __shared__ float s_td2[NCHUNK];
  __shared__ int s_wc[2 * NWARP * 2];
  __shared__ float s_part[SPLIT * 3 * BLOCK];
  __shared__ float s_cl[3 * BLOCK];
  __shared__ int s_cnt[4];

  int csize = 1, rank = 0;
  if (CL) {
    cg::cluster_group cluster = cg::this_cluster();
    csize = cluster.num_blocks();
    rank = cluster.block_rank();
  }
  const int s = a.order[blockIdx.x / csize];
  const int t = threadIdx.x;
  const int i = t % BLOCK;
  const size_t lane = (size_t)s * BLOCK + i;
  const int n = max(min(a.cnt[s], a.M), 0);
  const Row r{a.src, a.ctab, a.cand + (size_t)s * a.M, a.sb ? n * SUPER : n,
              a.nb, a.sb, a.prune, rank, csize, a.box, a.inv_box, a.infl};
  const bool safe = a.flag[s] != 0;
  const float h = a.hsml[lane];
  const float inv_h = 1.0f / h;
  const Lane ln{a.xi[((size_t)s * 3 + 0) * BLOCK + i],
                a.xi[((size_t)s * 3 + 1) * BLOCK + i],
                a.xi[((size_t)s * 3 + 2) * BLOCK + i],
                a.apot[((size_t)s * 3 + 0) * BLOCK + i],
                a.apot[((size_t)s * 3 + 1) * BLOCK + i],
                a.apot[((size_t)s * 3 + 2) * BLOCK + i],
                h,
                h * h,
                inv_h,
                inv_h * inv_h * inv_h * inv_h * inv_h};

  if (t < NCHUNK * 8) s_rt[t] = a.rtab[(size_t)s * NCHUNK * 8 + t];
  __syncthreads();
  if (t < NCHUNK) {
    const float td = __fadd_rn(s_rt[t * 8 + 6], a.infl);
    s_td2[t] = __fmul_rn(td, td);
  }
  __syncthreads();
  int n_kept, n_listed;
  build_tile_list(r, s_rt, s_td2, s_wc, kept, n_kept, n_listed);
  float v[3];
  if (safe)
    curl_pass<KIND, false>(r, kept, n_kept, ring, ln, v);
  else
    curl_pass<KIND, true>(r, kept, n_kept, ring, ln, v);
  reduce_row<3, CL>(v, s_part, s_cl, csize);
  if (rank == 0 && t < BLOCK) {
    const float wf = n > 0 ? a.wfac[lane] : 0.0f;
    a.out[lane * 3 + 0] = wf * v[0];
    a.out[lane * 3 + 1] = wf * v[1];
    a.out[lane * 3 + 2] = wf * v[2];
  }
  if (a.stats != nullptr) {
    if (t == 0) {
      int n_tiles = 0;
      for (int k = 0; k < n_kept; ++k) n_tiles += __popc(kept[k].y);
      s_cnt[0] = n_kept;
      s_cnt[1] = n_listed;
      s_cnt[2] = n_kept;
      s_cnt[3] = n_tiles;
    }
    if (CL) cg::this_cluster().sync();
    if (rank == 0 && t == 0) {
      int* so = a.stats + (size_t)s * 5;
      so[0] = 1;
      cluster_counts<4, CL>(s_cnt, csize, so + 1);
    }
  }
  // no CTA leaves while another may still read its shared memory
  if (CL) cg::this_cluster().sync();
}

template <int KIND>
int launch_kind(const Args& a, int S, int cluster, size_t smem,
                cudaStream_t st) {
  if (cluster > 1)
    return launch(stream_curl_kernel<KIND, true>, a, S, cluster, smem, st);
  return launch(stream_curl_kernel<KIND, false>, a, S, 1, smem, st);
}

}  // namespace

extern "C" int stream_curl_launch(
    const float* src, const float* ctab, const float* rtab, const int* cand,
    const int* cnt, const int* flag, const int* order, const float* xi,
    const float* hsml, const float* wfac, const float* apot, float* out,
    int* stats, int S, int M, int nb, int kind, int sb_mode, int prune,
    int cluster, float box, float inv_box, float infl, void* stream) {
  if (S <= 0) return 0;
  if (cluster < 1 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  // two ints an entry of the kept list: the block and its tiles
  const size_t smem = smem_bytes(sb_mode ? M * SUPER : M, cluster, 2, RECS);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{src, ctab, rtab, cand, cnt, flag, order, xi, hsml, wfac, apot, out,
         stats, M, nb, prune, sb_mode, box, inv_box, infl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == M4) return launch_kind<M4>(a, S, cluster, smem, st);
  return launch_kind<WC6>(a, S, cluster, smem, st);
}
