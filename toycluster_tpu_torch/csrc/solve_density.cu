// Count-class SPH density + adaptive-hsml solve over block or superblock
// candidate lists, hand-written for Hopper (sm_90a).
//
// Replaces: toycluster_tpu/ops/pallas_pair.py _density_kernel (launched by
// solve_density_pallas), and with it the XLA pair operator
// toycluster_tpu/ops/pair_ops.py solve_density that the JAX package's
// count-class engine runs per class (models/sph.py, models/wvt.py).
//
// Work: one CTA of 128 threads per receiver block, one thread per receiver
// lane.  A sweep walks every entry of the block's list (block ids, or the
// member blocks of superblock ids in sb mode; -1 entries anywhere are
// skipped); each source block's x, y, z, valid rows (2 KB) are staged in
// shared memory and every thread sums its lane's density terms over them,
// in two levels (per source block, then across blocks).  The solve runs
// n_sweeps sweeps as the TPU kernel's grid does: once every lane of the
// block is done (a CTA-wide vote) it skips to the last sweep, which always
// measures, and records rho, wkNgb and varHsmlFac at the h it measured.
//
// What bounds it: pair arithmetic (~15 fp32 operations for a pair out of
// range, ~30 in range) against 2 KB of shared-memory staging per source
// block reused by 128 threads, so the SMs' FP32/issue rate and not HBM is
// the limit.  Rows with long lists set the tail of the grid.

#include "pair_common.cuh"

namespace {

using namespace pair_common;

struct Args {
  const float* pos;    // (nb, 3, 128)
  const float* valid;  // (nb, 1, 128)
  const int* cand;     // (S, M) block ids, or superblock ids with sb
  const float* xi;     // (S, 3, 128)
  const float* h0;     // (S, 128)
  const float* cap;    // (S, 128)
  float* out;          // (S, 128, 5): rho h vf wk done
  int M, nb, n_sweeps;
  float mpart, box, desnngb, rho_corr;
};

template <int KIND, bool SB>
__device__ void dens_pass(const Args& a, float* s_src, int s, float x0,
                          float x1, float x2, float h, float& aw,
                          float& ardw) {
  const float* base[4] = {a.pos, a.pos + BLOCK, a.pos + 2 * BLOCK, a.valid};
  const int stride[4] = {3 * BLOCK, 3 * BLOCK, 3 * BLOCK, BLOCK};
  const int* row = a.cand + (size_t)s * a.M;
  aw = 0.0f;
  ardw = 0.0f;
  for (int g = 0; g < a.M; ++g) {
    int first = 0;
    const int n = entry_blocks(row[g], SB, a.nb, first);
    for (int f = 0; f < n; ++f) {
      stage(s_src, 4, base, stride, first + f);
      float bw, brdw;
      dens_block<KIND>(s_src, 3, x0, x1, x2, h, a.box, bw, brdw);
      aw += bw;
      ardw += brdw;
    }
  }
}

template <int KIND, bool SB>
__global__ void __launch_bounds__(BLOCK) solve_density_kernel(Args a) {
  __shared__ float s_src[4 * BLOCK];
  const int s = blockIdx.x;
  const int i = threadIdx.x;
  const size_t lane = (size_t)s * BLOCK + i;
  const float x0 = a.xi[((size_t)s * 3 + 0) * BLOCK + i];
  const float x1 = a.xi[((size_t)s * 3 + 1) * BLOCK + i];
  const float x2 = a.xi[((size_t)s * 3 + 2) * BLOCK + i];
  const float cap = a.cap[lane];
  Solve st{fminf(a.h0[lane], cap), 0.0f, cap, 0.0f};
  float aw, ardw;
  for (int k = 0; k < a.n_sweeps - 1; ++k) {
    // converged blocks skip to the recording sweep
    if (__syncthreads_and(st.done > 0.5f)) break;
    dens_pass<KIND, SB>(a, s_src, s, x0, x1, x2, st.h, aw, ardw);
    update<KIND>(st, aw, ardw, cap, a.mpart, a.desnngb);
  }
  // the last sweep always measures, at the current h
  dens_pass<KIND, SB>(a, s_src, s, x0, x1, x2, st.h, aw, ardw);
  record<KIND>(a.out + lane * 5, st.h, aw, ardw, st.done, a.mpart,
               a.desnngb, a.rho_corr);
}

}  // namespace

extern "C" int solve_density_launch(const float* pos, const float* valid,
                                    const int* cand, const float* xi,
                                    const float* h0, const float* cap,
                                    float* out, int S, int M, int nb,
                                    int kind, int sb_mode, int n_sweeps,
                                    float mpart, float box, float desnngb,
                                    float rho_corr, void* stream) {
  if (S <= 0) return 0;
  Args a{pos, valid, cand, xi, h0, cap, out, M, nb, n_sweeps,
         mpart, box, desnngb, rho_corr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == M4) {
    if (sb_mode) solve_density_kernel<M4, true><<<S, BLOCK, 0, st>>>(a);
    else solve_density_kernel<M4, false><<<S, BLOCK, 0, st>>>(a);
  } else {
    if (sb_mode) solve_density_kernel<WC6, true><<<S, BLOCK, 0, st>>>(a);
    else solve_density_kernel<WC6, false><<<S, BLOCK, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
