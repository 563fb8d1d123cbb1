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
// Work: one CTA of 128 threads per receiver block, one thread per receiver
// lane; the CTA walks every entry of the list (-1 entries anywhere are
// skipped), staging each source block's x, y, z, valid, h rows (2.5 KB)
// in shared memory.  Sums are two-level (per source block, then across
// blocks): a displacement component is a near-cancelling sum of up to
// ~1e5 terms, where one running f32 sum loses digits.
//
// What bounds it: pair arithmetic (~20 fp32 operations a pair) against
// shared-memory staging reused by 128 threads: the SMs' FP32/issue rate.

#include "pair_common.cuh"

namespace {

using namespace pair_common;

struct Args {
  const float* pos;    // (nb, 3, 128)
  const float* valid;  // (nb, 1, 128)
  const float* h;      // (nb, 1, 128) metric hsml, box units
  const int* cand;     // (S, M)
  const float* xi;     // (S, 3, 128)
  const float* h_i;    // (S, 128)
  float* out;          // (S, 128, 3)
  int M, nb;
  float step, box;
};

template <int KIND, bool SB>
__global__ void __launch_bounds__(BLOCK) wvt_displacement_kernel(Args a) {
  __shared__ float s_src[5 * BLOCK];
  const int s = blockIdx.x;
  const int i = threadIdx.x;
  const size_t lane = (size_t)s * BLOCK + i;
  const float x0 = a.xi[((size_t)s * 3 + 0) * BLOCK + i];
  const float x1 = a.xi[((size_t)s * 3 + 1) * BLOCK + i];
  const float x2 = a.xi[((size_t)s * 3 + 2) * BLOCK + i];
  const float hi = a.h_i[lane];
  const float box = a.box;
  const float inv_box = 1.0f / box;
  const float* base[5] = {a.pos, a.pos + BLOCK, a.pos + 2 * BLOCK, a.valid,
                          a.h};
  const int stride[5] = {3 * BLOCK, 3 * BLOCK, 3 * BLOCK, BLOCK, BLOCK};
  const int* row = a.cand + (size_t)s * a.M;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int g = 0; g < a.M; ++g) {
    int first = 0;
    const int n = entry_blocks(row[g], SB, a.nb, first);
    for (int f = 0; f < n; ++f) {
      stage(s_src, 5, base, stride, first + f);
      float bx = 0.0f, by = 0.0f, bz = 0.0f;
      for (int j = 0; j < BLOCK; ++j) {
        if (!(s_src[3 * BLOCK + j] > 0.5f)) continue;
        float dx = x0 - s_src[j];
        float dy = x1 - s_src[BLOCK + j];
        float dz = x2 - s_src[2 * BLOCK + j];
        dx = (dx - box * rintf(dx * inv_box)) * inv_box;
        dy = (dy - box * rintf(dy * inv_box)) * inv_box;
        dz = (dz - box * rintf(dz * inv_box)) * inv_box;
        const float r2 = dx * dx + dy * dy + dz * dz;
        const float hbar = 0.5f * (s_src[4 * BLOCK + j] + hi);
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
    }
  }
  const float scale = a.step * (KIND == M4 ? 1.0f : WC6_NORM) * hi;
  a.out[lane * 3 + 0] = scale * ax;
  a.out[lane * 3 + 1] = scale * ay;
  a.out[lane * 3 + 2] = scale * az;
}

}  // namespace

extern "C" int wvt_displacement_launch(const float* pos, const float* valid,
                                       const float* h, const int* cand,
                                       const float* xi, const float* h_i,
                                       float* out, int S, int M, int nb,
                                       int kind, int sb_mode, float step,
                                       float box, void* stream) {
  if (S <= 0) return 0;
  Args a{pos, valid, h, cand, xi, h_i, out, M, nb, step, box};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == M4) {
    if (sb_mode) wvt_displacement_kernel<M4, true><<<S, BLOCK, 0, st>>>(a);
    else wvt_displacement_kernel<M4, false><<<S, BLOCK, 0, st>>>(a);
  } else {
    if (sb_mode) wvt_displacement_kernel<WC6, true><<<S, BLOCK, 0, st>>>(a);
    else wvt_displacement_kernel<WC6, false><<<S, BLOCK, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
