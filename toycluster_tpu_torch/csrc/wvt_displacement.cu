// Count-class WVT displacement over block or superblock candidate lists,
// hand-written for Hopper (sm_90a):
//   delta_i = step sum_j h_i W(r/hbar) dx/r,  0 < r < hbar = (h_i + h_j)/2,
// in box units over valid sources j (wvt_relax.c:126-171).
//
// Replaces: toycluster_tpu/ops/pallas_pair.py _displacement_kernel
// (launched by wvt_displacement_pallas), and with it the XLA pair
// operator toycluster_tpu/ops/pair_ops.py wvt_displacement that the JAX
// package's count-class engine runs for its wide classes and far-tail
// rows (models/wvt.py).
//
// Work (the list walk of class_walk.cuh): a row is one receiver block, on
// one CTA of 512 threads, four per receiver lane, or on a thread-block
// cluster of up to 8 such CTAs that share the row's list by list position.
// Every CTA tests its share of the listed source blocks once -- the chunk
// hulls' gaps against 0.5 (the receiver chunk's largest h_i + the source
// chunk's largest h) box -- and walks the blocks that pass, streamed as
// 2 KB of (x, y, z, h) records (h < 0 marks a source that takes part in no
// pair) through a cp.async ring.  Sums are two-level (per source block,
// then across blocks): a displacement component is a near-cancelling sum
// of up to ~1e5 terms, where one running f32 sum loses digits.  The four
// parts of a lane are added in a fixed order and, in a cluster, the CTAs'
// partial sums in rank order through distributed shared memory; rank 0
// writes the row.  Rows whose reach (receiver extent + widest pair range)
// lies inside the box skip the periodic wrap (bit-identical: the wrap is
// the identity on every pair in range there; see stream_wvt.cu).  Rows are
// taken longest list first.
//
// What bounds it: fp32 pair arithmetic (~14 operations a pair out of
// range, 12 more with the wrap) against 2 KB of copies per kept block
// reused 128 times from shared memory: the SMs' fp32 instruction rate.

#include "class_walk.cuh"

namespace {

using namespace pair_common;
using namespace class_walk;

struct Args {
  const float* src;    // (nb, 128, 4) x y z h per source, h in box units
  const float* ctab;   // (nb, 8, 8) source chunks
  const float* rtab;   // (S, 8, 8) receiver chunks: cen, ext, -, max h_i
  const int* cand;     // (S, M) block ids, or superblock ids with sb
  const int* flag;     // (S,) 1: the row skips the periodic wrap
  const int* order;    // (S,) rows, longest list first
  const float* xi;     // (S, 3, 128)
  const float* h_i;    // (S, 128) metric hsml, box units
  float* out;          // (S, 128, 3)
  int* stats;          // (S, 4) or null: 1, blocks kept, blocks listed,
                       // blocks walked (= kept)
  int M, nb, prune, sb;
  float step, box, inv_box, infl;
};

template <int KIND, bool WRAP>
__device__ __forceinline__ void disp_pass(const Row& r, const int* kept,
                                          int n_kept, float* ring, float x0,
                                          float x1, float x2, float hi,
                                          float (&v)[3]) {
  const int j0 = (threadIdx.x / BLOCK) * NJ;
  const float box = r.box;
  const float inv_box = 1.0f / box;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  walk(r.src, kept, n_kept, ring, [&](const float4* sm) {
    float bx = 0.0f, by = 0.0f, bz = 0.0f;
    for (int j = j0; j < j0 + NJ; ++j) {
      const float4 q = sm[j];  // one broadcast load per pair
      if (!(q.w >= 0.0f)) continue;
      float dx = x0 - q.x;
      float dy = x1 - q.y;
      float dz = x2 - q.z;
      if (WRAP) {
        dx = (dx - box * rintf(dx * inv_box)) * inv_box;
        dy = (dy - box * rintf(dy * inv_box)) * inv_box;
        dz = (dz - box * rintf(dz * inv_box)) * inv_box;
      } else {
        dx *= inv_box;
        dy *= inv_box;
        dz *= inv_box;
      }
      const float r2 = dx * dx + dy * dy + dz * dz;
      const float hbar = 0.5f * (q.w + hi);
      if (!(r2 < hbar * hbar && r2 > 0.0f)) continue;
      const float rr = sqrtf(r2);
      const float coef = wflat_raw<KIND>(rr / hbar) / rr;
      bx += coef * dx;
      by += coef * dy;
      bz += coef * dz;
    }
    ax += bx;
    ay += by;
    az += bz;
  });
  v[0] = ax;
  v[1] = ay;
  v[2] = az;
}

template <int KIND, bool CL>
__global__ void __launch_bounds__(NT, 2) wvt_displacement_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  int* kept = reinterpret_cast<int*>(ring + STAGES * SRC_FLOATS);
  __shared__ float s_rt[NCHUNK * 8];
  __shared__ int s_wc[2 * NWARP * 2];
  __shared__ float s_part[SPLIT * 3 * BLOCK];
  __shared__ float s_cl[3 * BLOCK];
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
  const float hi = a.h_i[lane];

  if (t < NCHUNK * 8) s_rt[t] = a.rtab[(size_t)s * NCHUNK * 8 + t];
  __syncthreads();
  int n_kept, n_listed;
  build_list<true>(r, s_rt, nullptr, s_wc, kept, n_kept, n_listed);
  float v[3];
  if (safe)
    disp_pass<KIND, false>(r, kept, n_kept, ring, x0, x1, x2, hi, v);
  else
    disp_pass<KIND, true>(r, kept, n_kept, ring, x0, x1, x2, hi, v);
  reduce_row<3, CL>(v, s_part, s_cl, csize);
  if (rank == 0 && t < BLOCK) {
    const float scale = a.step * (KIND == M4 ? 1.0f : WC6_NORM) * hi;
    a.out[lane * 3 + 0] = scale * v[0];
    a.out[lane * 3 + 1] = scale * v[1];
    a.out[lane * 3 + 2] = scale * v[2];
  }
  if (a.stats != nullptr) {
    if (t == 0) {
      s_cnt[0] = n_kept;
      s_cnt[1] = n_listed;
      s_cnt[2] = n_kept;
    }
    if (CL) cg::this_cluster().sync();
    if (rank == 0 && t == 0) {
      int* so = a.stats + (size_t)s * 4;
      so[0] = 1;
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
    return launch(wvt_displacement_kernel<KIND, true>, a, S, cluster, smem,
                  st);
  return launch(wvt_displacement_kernel<KIND, false>, a, S, 1, smem, st);
}

}  // namespace

extern "C" int wvt_displacement_launch(
    const float* src, const float* ctab, const float* rtab, const int* cand,
    const int* flag, const int* order, const float* xi, const float* h_i,
    float* out, int* stats, int S, int M, int nb, int kind, int sb_mode,
    int prune, int cluster, float step, float box, float inv_box, float infl,
    void* stream) {
  if (S <= 0) return 0;
  if (cluster < 1 || cluster > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(sb_mode ? M * SUPER : M, cluster, 1);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{src, ctab, rtab, cand, flag, order, xi, h_i, out, stats, M, nb,
         prune, sb_mode, step, box, inv_box, infl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == M4) return launch_kind<M4>(a, S, cluster, smem, st);
  return launch_kind<WC6>(a, S, cluster, smem, st);
}
