// Count-class fused WVT iteration: the adaptive-hsml density solve and the
// WVT displacement of one receiver block in one kernel, over block or
// superblock candidate lists, hand-written for Hopper (sm_90a).
//
// Replaces: toycluster_tpu/ops/pallas_pair.py _fused_kernel (launched by
// fused_wvt_pallas), which the count-class WVT loop runs for its narrow
// classes (models/wvt.py).
//
// Work: one CTA of 128 threads per receiver block, one thread per receiver
// lane.  The CTA reads the first min(cnt, M) entries of its list (block
// ids, or the member blocks of superblock ids in sb mode); each source
// block's x, y, z, hm rows (2 KB) are staged in shared memory; hm == 0
// marks a source that takes part in no pair.  Newton/bisection sweeps
// repeat until every lane of the block is done (a CTA-wide vote, the TPU
// kernel's while-loop condition) or n_sweeps were taken; the record uses
// the last sweep's sums, normalised at the final h.  The displacement
// pass reads the same list once.  Optional per-source-block bounds prune
// exact-zero work: a block whose distance bound gdist exceeds the row's
// largest cap is skipped in the density sweeps, and a block with dkeep
// == 0 in the displacement pass.  Skipping adds nothing that was not an
// exact zero, so the outputs are bit-identical with and without bounds.
//
// The TPU kernel keeps the class's whole candidate set in VMEM (at most
// 128 blocks, 256 KB); a Hopper CTA has 227 KB of shared memory, so this
// first version re-streams the sources from L2 every sweep instead.
//
// What bounds it: pair arithmetic against shared-memory staging reused by
// 128 threads (FP32/issue rate); sums are two-level (per source block,
// then across blocks).

#include "pair_common.cuh"

namespace {

using namespace pair_common;

struct Args {
  const float* pos;            // (nb, 3, 128)
  const float* hm;             // (nb, 1, 128), 0 = no pair
  const int* cand;             // (S, M)
  const int* cnt;              // (S,)
  const float* xi;             // (S, 3, 128)
  const float* h0;             // (S, 128)
  const float* cap;            // (S, 128)
  const float* hm_i;           // (S, 128)
  const float* gdist;          // (S, MB) or null; MB = M (x SUPER in sb)
  const unsigned char* dkeep;  // (S, MB) or null
  float* out;                  // (S, 128, 8): rho h vf wk done dx dy dz
  int M, nb, n_sweeps;
  float mpart, box, desnngb, rho_corr;
};

constexpr int MB_FAN = SUPER;

// Walks the first n entries of row s, calling body(block, e) for each
// source block, e its index in the (S, MB) bound arrays.
template <bool SB, typename F>
__device__ __forceinline__ void for_blocks(const Args& a, int s, int n,
                                           F body) {
  const int* row = a.cand + (size_t)s * a.M;
  for (int g = 0; g < n; ++g) {
    int first = 0;
    const int m = entry_blocks(row[g], SB, a.nb, first);
    for (int f = 0; f < m; ++f) body(first + f, SB ? g * MB_FAN + f : g);
  }
}

template <int KIND, bool SB, bool DISP>
__global__ void __launch_bounds__(BLOCK) fused_wvt_kernel(Args a) {
  __shared__ float s_src[4 * BLOCK];
  __shared__ float s_red[BLOCK / 32];
  const int s = blockIdx.x;
  const int i = threadIdx.x;
  const size_t lane = (size_t)s * BLOCK + i;
  float* o = a.out + lane * 8;
  const int n = min(a.cnt[s], a.M);
  if (n <= 0) {  // uniform over the CTA
    for (int k = 0; k < 8; ++k) o[k] = 0.0f;
    return;
  }
  const float x0 = a.xi[((size_t)s * 3 + 0) * BLOCK + i];
  const float x1 = a.xi[((size_t)s * 3 + 1) * BLOCK + i];
  const float x2 = a.xi[((size_t)s * 3 + 2) * BLOCK + i];
  const float cap = a.cap[lane];
  const float hmi = a.hm_i[lane];
  const float box = a.box;
  const size_t mb = (size_t)a.M * (SB ? MB_FAN : 1);
  const float* gd = a.gdist ? a.gdist + (size_t)s * mb : nullptr;
  const unsigned char* dk = a.dkeep ? a.dkeep + (size_t)s * mb : nullptr;
  // no pair of a block farther than the row's largest cap is in range of
  // any lane's h (h <= cap always)
  const float cap_max = cta_max(cap, s_red);
  const float* base[4] = {a.pos, a.pos + BLOCK, a.pos + 2 * BLOCK, a.hm};
  const int stride[4] = {3 * BLOCK, 3 * BLOCK, 3 * BLOCK, BLOCK};

  Solve st{fminf(a.h0[lane], cap), 0.0f, cap, 0.0f};
  float aw = 0.0f, ardw = 0.0f;
  for (int k = 0; k < a.n_sweeps; ++k) {
    if (__syncthreads_and(st.done > 0.5f)) break;
    aw = 0.0f;
    ardw = 0.0f;
    const float h = st.h;
    for_blocks<SB>(a, s, n, [&](int b, int e) {
      if (gd && gd[e] > cap_max) return;
      stage(s_src, 4, base, stride, b);
      float bw, brdw;
      dens_block<KIND>(s_src, 3, x0, x1, x2, h, box, bw, brdw);
      aw += bw;
      ardw += brdw;
    });
    update<KIND>(st, aw, ardw, cap, a.mpart, a.desnngb);
  }
  record<KIND>(o, st.h, aw, ardw, st.done, a.mpart, a.desnngb, a.rho_corr);

  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  if (DISP) {
    const float inv_box = 1.0f / box;
    for_blocks<SB>(a, s, n, [&](int b, int e) {
      if (dk && !dk[e]) return;
      stage(s_src, 4, base, stride, b);
      float bx = 0.0f, by = 0.0f, bz = 0.0f;
      for (int j = 0; j < BLOCK; ++j) {
        const float hj = s_src[3 * BLOCK + j];
        if (!(hj > 0.0f)) continue;
        float dx = x0 - s_src[j];
        float dy = x1 - s_src[BLOCK + j];
        float dz = x2 - s_src[2 * BLOCK + j];
        dx = (dx - box * rintf(dx * inv_box)) * inv_box;
        dy = (dy - box * rintf(dy * inv_box)) * inv_box;
        dz = (dz - box * rintf(dz * inv_box)) * inv_box;
        const float r2 = dx * dx + dy * dy + dz * dz;
        const float hbar = 0.5f * (hj + hmi);
        if (!(r2 < hbar * hbar && r2 > 0.0f)) continue;
        const float r = sqrtf(r2);
        const float coef = wflat_raw<KIND>(r / hbar) / r;
        bx += coef * dx;
        by += coef * dy;
        bz += coef * dz;
      }
      ax += bx;
      ay += by;
      az += bz;
    });
  }
  const float dnorm = hmi * (KIND == M4 ? 1.0f : WC6_NORM);
  o[5] = dnorm * ax;
  o[6] = dnorm * ay;
  o[7] = dnorm * az;
}

template <int KIND, bool SB>
void launch(const Args& a, int S, int do_disp, cudaStream_t st) {
  if (do_disp) fused_wvt_kernel<KIND, SB, true><<<S, BLOCK, 0, st>>>(a);
  else fused_wvt_kernel<KIND, SB, false><<<S, BLOCK, 0, st>>>(a);
}

}  // namespace

extern "C" int fused_wvt_launch(const float* pos, const float* hm,
                                const int* cand, const int* cnt,
                                const float* xi, const float* h0,
                                const float* cap, const float* hm_i,
                                const float* gdist,
                                const unsigned char* dkeep, float* out, int S,
                                int M, int nb, int kind, int sb_mode,
                                int do_disp, int n_sweeps, float mpart,
                                float box, float desnngb, float rho_corr,
                                void* stream) {
  if (S <= 0) return 0;
  Args a{pos, hm,  cand, cnt,   xi,  h0,     cap,     hm_i,
         gdist, dkeep, out, M, nb, n_sweeps, mpart, box, desnngb, rho_corr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == M4) {
    if (sb_mode) launch<M4, true>(a, S, do_disp, st);
    else launch<M4, false>(a, S, do_disp, st);
  } else {
    if (sb_mode) launch<WC6, true>(a, S, do_disp, st);
    else launch<WC6, false>(a, S, do_disp, st);
  }
  return static_cast<int>(cudaGetLastError());
}
