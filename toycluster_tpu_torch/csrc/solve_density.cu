// Count-class SPH density + adaptive-hsml solve over block or superblock
// candidate lists, hand-written for Hopper (sm_90a).
//
// Replaces: toycluster_tpu/ops/pallas_pair.py _density_kernel (launched by
// solve_density_pallas), and with it the XLA pair operator
// toycluster_tpu/ops/pair_ops.py solve_density that the JAX package's
// count-class engine runs per class (models/sph.py, models/wvt.py).
//
// Work (the list walk of class_walk.cuh): a row is one receiver block; it
// runs on one CTA of 512 threads, four per receiver lane, or, for the long
// far-tail rows, on a thread-block cluster of up to 8 such CTAs that share
// the row's list by list position.  Once per call every CTA tests its
// share of the listed source blocks against the receiver chunks' largest
// cap and keeps the block ids that pass in shared memory.  Before each
// sweep it tests those again against the sweep's own ranges -- the largest
// current h of each receiver chunk's lanes, of the lanes not yet done in a
// sweep that is not the last (a done lane's sums are not read there) -- and
// walks only the blocks that pass, streaming 2 KB blocks of (x, y, z,
// valid) records through a cp.async ring: the caps are up to twice the
// solved h, and late sweeps serve a few straggling lanes.  Either test
// drops only blocks whose every pair lies beyond the lane's h, which add
// exact zeros.  After a sweep the lane sums are reduced over
// the four parts and, in a cluster, over the CTAs in rank order through
// distributed shared memory, so every CTA of the row runs the same
// Newton/bisection update on the same sums and takes the same vote.  The
// solve runs n_sweeps sweeps as the TPU kernel's grid does: once every
// lane of the block is done (a CTA-wide vote) it skips to the last sweep,
// which always measures, and records rho, wkNgb and varHsmlFac at the h it
// measured.  In a sweep that is not the last, a warp whose 32 lanes are all
// done skips its pair arithmetic: a frozen lane's h cannot change and its
// sums are not read before the last sweep measures them again.  Rows whose
// reach (receiver extent + largest cap) lies inside the box skip the
// periodic wrap: every source in range is stored at its minimum image, so
// the wrap is the identity on every pair in range and the other pairs only
// come out farther (bit-identical; see stream_wvt.cu).  Rows are taken
// longest list first.
//
// What bounds it: fp32 pair arithmetic (8 operations for a pair's
// separation, 12 more with the wrap, the range test; ~30 in range) against
// 2 KB of copies per kept block and sweep reused 128 times from shared
// memory: the SMs' fp32 instruction rate, not HBM.  The rows with the longest
// lists set the end of the grid; the cluster split shortens them.

#include "class_walk.cuh"

namespace {

using namespace pair_common;
using namespace class_walk;

struct Args {
  const float* src;    // (nb, 128, 4) x y z valid per source
  const float* ctab;   // (nb, 8, 8) source chunks
  const float* rtab;   // (S, 8, 8) receiver chunks: cen, ext, max cap, -
  const int* cand;     // (S, M) block ids, or superblock ids with sb
  const int* flag;     // (S,) 1: the row skips the periodic wrap
  const int* order;    // (S,) rows, longest list first
  const float* xi;     // (S, 3, 128)
  const float* h0;     // (S, 128)
  const float* cap;    // (S, 128)
  float* out;          // (S, 128, 5): rho h vf wk done
  int* stats;          // (S, 4) or null: sweeps, blocks kept, blocks listed,
                       // blocks walked over all sweeps
  int M, nb, n_sweeps, prune, sb;
  float mpart, box, inv_box, infl, desnngb, rho_corr;
};

// Density sums of one receiver lane at h over this thread's sources of the
// kept blocks, two-level.
template <int KIND, bool WRAP>
__device__ __forceinline__ void dens_pass(const Row& r, const int* kept,
                                          int n_kept, float* ring, float x0,
                                          float x1, float x2, float h,
                                          bool skip, float& aw, float& ardw) {
  const int j0 = (threadIdx.x / BLOCK) * NJ;
  const float box = r.box;
  const float inv_box = 1.0f / box;
  const float inv_h2 = 1.0f / (h * h);
  float sw = 0.0f, srdw = 0.0f;
  walk(r.src, kept, n_kept, ring, [&](const float4* sm) {
    if (skip) return;
    float bw = 0.0f, brdw = 0.0f;
    for (int j = j0; j < j0 + NJ; ++j) {
      const float4 q = sm[j];  // one broadcast load per pair
      if (!(q.w > 0.0f)) continue;
      float dx = x0 - q.x;
      float dy = x1 - q.y;
      float dz = x2 - q.z;
      if (WRAP) {
        dx -= box * rintf(dx * inv_box);
        dy -= box * rintf(dy * inv_box);
        dz -= box * rintf(dz * inv_box);
      }
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (KIND == WC6) {
        const float qq = r2 * inv_h2;
        if (qq < 1.0f) dens_pair<KIND>(sqrtf(qq), h, bw, brdw);
      } else {
        dens_pair<KIND>(sqrtf(r2), h, bw, brdw);
      }
    }
    sw += bw;
    srdw += brdw;
  });
  aw = sw;
  ardw = srdw;
}

template <int KIND, bool CL>
__global__ void __launch_bounds__(NT, 2) solve_density_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  int* kept = reinterpret_cast<int*>(ring + STAGES * SRC_FLOATS);
  __shared__ float s_rt[NCHUNK * 8];
  __shared__ float s_td2[NCHUNK];
  __shared__ int s_wc[2 * NWARP * 2];
  __shared__ float s_part[SPLIT * 2 * BLOCK];
  __shared__ float s_cl[2][2 * BLOCK];
  __shared__ int s_cnt[3];

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
  const Row r{a.src, a.ctab, a.cand + (size_t)s * a.M,
              a.sb ? a.M * SUPER : a.M, a.nb, a.sb, a.prune, rank, csize,
              a.box, a.inv_box, a.infl};
  const bool safe = a.flag[s] != 0;
  const float x0 = a.xi[((size_t)s * 3 + 0) * BLOCK + i];
  const float x1 = a.xi[((size_t)s * 3 + 1) * BLOCK + i];
  const float x2 = a.xi[((size_t)s * 3 + 2) * BLOCK + i];
  const float cap = a.cap[lane];

  if (t < NCHUNK * 8) s_rt[t] = a.rtab[(size_t)s * NCHUNK * 8 + t];
  __syncthreads();
  if (t < NCHUNK) {
    const float td = __fadd_rn(s_rt[t * 8 + 6], a.infl);
    s_td2[t] = __fmul_rn(td, td);
  }
  __syncthreads();
  int n_kept, n_listed;
  build_list<false>(r, s_rt, s_td2, s_wc, kept, n_kept, n_listed);
  // the blocks of a sweep: the kept list itself without the member test
  int* walked = a.prune ? kept + (r.n_entries + csize - 1) / csize : kept;

  Solve st{fminf(a.h0[lane], cap), 0.0f, cap, 0.0f};
  float v[2];
  int sweeps = 0, n_walked = 0;
  auto measure = [&](bool last) {
    int n = n_kept;
    if (a.prune) {
      // the sweep's range per receiver chunk: its 16 lanes' largest h
      float hm = (last || !(st.done > 0.5f)) ? st.h : -1.0f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        hm = fmaxf(hm, __shfl_xor_sync(0xffffffffu, hm, off));
      if (t < BLOCK && (t & 15) == 0) {
        const float td = __fadd_rn(hm, a.infl);
        s_td2[t >> 4] = hm < 0.0f ? -1.0f : __fmul_rn(td, td);
      }
      __syncthreads();
      int n_valid;
      compact(
          n_kept, [&](int k) { return kept[k]; },
          [&](int b, int, int& v) {
            v = b;
            return keep_block<false>(r, b, s_rt, s_td2);
          },
          s_wc, walked, n, n_valid);
    }
    n_walked += n;
    const bool skip = !last && __all_sync(0xffffffffu, st.done > 0.5f);
    if (safe)
      dens_pass<KIND, false>(r, walked, n, ring, x0, x1, x2, st.h, skip,
                             v[0], v[1]);
    else
      dens_pass<KIND, true>(r, walked, n, ring, x0, x1, x2, st.h, skip,
                            v[0], v[1]);
    reduce_row<2, CL>(v, s_part, s_cl[sweeps & 1], csize);
    ++sweeps;
  };
  for (int k = 0; k < a.n_sweeps - 1; ++k) {
    // converged blocks skip to the recording sweep
    if (__syncthreads_and(st.done > 0.5f)) break;
    measure(false);
    update<KIND>(st, v[0], v[1], cap, a.mpart, a.desnngb);
  }
  // the last sweep always measures, at the current h
  measure(true);
  if (rank == 0 && t < BLOCK)
    record<KIND>(a.out + lane * 5, st.h, v[0], v[1], st.done, a.mpart,
                 a.desnngb, a.rho_corr);
  if (a.stats != nullptr) {
    if (t == 0) {
      s_cnt[0] = n_kept;
      s_cnt[1] = n_listed;
      s_cnt[2] = n_walked;
    }
    if (CL) cg::this_cluster().sync();
    if (rank == 0 && t == 0) {
      int* so = a.stats + (size_t)s * 4;
      so[0] = sweeps;
      cluster_counts<3, CL>(s_cnt, csize, so + 1);
    }
  }
  // no CTA leaves while another may still read its shared memory
  if (CL) cg::this_cluster().sync();
}

template <int KIND>
int launch_kind(const Args& a, int S, int cluster, size_t smem,
                cudaStream_t st) {
  if (cluster > 1)
    return launch(solve_density_kernel<KIND, true>, a, S, cluster, smem, st);
  return launch(solve_density_kernel<KIND, false>, a, S, 1, smem, st);
}

}  // namespace

extern "C" int solve_density_launch(
    const float* src, const float* ctab, const float* rtab, const int* cand,
    const int* flag, const int* order, const float* xi, const float* h0,
    const float* cap, float* out, int* stats, int S, int M, int nb, int kind,
    int sb_mode, int n_sweeps, int prune, int cluster, float mpart, float box,
    float inv_box, float infl, float desnngb, float rho_corr, void* stream) {
  if (S <= 0) return 0;
  if (cluster < 1 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(sb_mode ? M * SUPER : M, cluster, 2);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{src, ctab, rtab, cand, flag, order, xi, h0, cap, out, stats, M, nb,
         n_sweeps, prune, sb_mode, mpart, box, inv_box, infl, desnngb,
         rho_corr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == M4) return launch_kind<M4>(a, S, cluster, smem, st);
  return launch_kind<WC6>(a, S, cluster, smem, st);
}
