// Shared pieces of the pair kernels: the constants and the SPH density
// sums of one pair (all of them); for the count-class kernels
// (solve_density.cu, wvt_displacement.cu, fused_wvt.cu) also the WVT
// weight, the Newton/bisection h update and the record of a solved lane.
// A receiver block has BLOCK lanes; class_walk.cuh holds the list walk.

#pragma once
#include <cuda_runtime.h>

namespace pair_common {

constexpr int BLOCK = 128;
constexpr int SUPER = 8;
constexpr float WC6_NORM = (float)(1365.0 / (64.0 * 3.14159265358979323846));
constexpr float FOURPITHIRD = 4.18879032135009765f;
constexpr float NNGBDEV = 0.05f;

enum Kind { WC6 = 0, M4 = 1 };

// Raw density sums of one pair at support radius h.  WC6 accumulates the
// unnormalised t^8 poly and t^7 poly (normalised in norm_sums), given
// u = r/h; M4 accumulates w and r dW/dr with their 1/h^3, 1/h^4 factors,
// given r.
template <int KIND>
__device__ __forceinline__ void dens_pair(float u_or_r, float h, float& aw,
                                          float& ardw) {
  if (KIND == WC6) {
    const float u = u_or_r;
    if (u < 1.0f) {
      const float t = 1.0f - u;
      const float t2 = t * t;
      const float t4 = t2 * t2;
      const float t7 = t4 * t2 * t;
      aw += t4 * t4 * (1.0f + u * (8.0f + u * (25.0f + 32.0f * u)));
      ardw += t7 * (u * u * (1.0f + u * (7.0f + 16.0f * u)));
    }
  } else {
    const float r = u_or_r;
    const float u = r / h;
    if (u < 1.0f) {
      const float h3 = h * h * h;
      float w, dw;
      if (u < 0.5f) {
        w = 2.546479089470f + 15.278874536822f * (u - 1.0f) * u * u;
        dw = u * (45.836623610466f * u - 30.557749073644f);
      } else {
        const float t = 1.0f - u;
        w = 5.092958178941f * (t * t * t);
        dw = -15.278874536822f * (t * t);
      }
      aw += w / h3;
      ardw += r * (dw / (h3 * h));
    }
  }
}

template <int KIND>
__device__ __forceinline__ void norm_sums(float h, float raw_w, float raw_rdw,
                                          float& sw, float& srdw) {
  if (KIND == WC6) {
    const float inv_h = 1.0f / h;
    const float norm_h3 = WC6_NORM * (inv_h * inv_h * inv_h);
    sw = raw_w * norm_h3;
    srdw = raw_rdw * (-22.0f * norm_h3);
  } else {
    sw = raw_w;
    srdw = raw_rdw;
  }
}

// The WVT weight of u = r / hbar without the WC6 norm.
template <int KIND>
__device__ __forceinline__ float wflat_raw(float u) {
  if (KIND == WC6) {
    const float t = fmaxf(1.0f - u, 0.0f);
    const float t2 = t * t;
    const float t4 = t2 * t2;
    return t4 * t4 * (1.0f + u * (8.0f + u * (25.0f + 32.0f * u)));
  }
  if (u < 0.5f) return 2.546479089470f + 15.278874536822f * (u - 1.0f) * u * u;
  if (u < 1.0f) {
    const float t = 1.0f - u;
    return 5.092958178941f * (t * t * t);
  }
  return 0.0f;
}

struct Solve {
  float h, lo, hi, done;
};

// Newton/bisection update from the sums measured at st.h (sph.c:175-195):
// a lane freezes once |wkNgb - DESNNGB| < NNGBDEV.
template <int KIND>
__device__ __forceinline__ void update(Solve& st, float aw, float ardw,
                                       float cap, float mpart, float desnngb) {
  const float h = st.h;
  float sw, srdw;
  norm_sums<KIND>(h, aw, ardw, sw, srdw);
  const float wk = FOURPITHIRD * (h * h * h) * sw;
  const float rho = mpart * sw;
  const float drho = -mpart * (3.0f / h * sw + srdw / h);
  const float dev = fabsf(wk - desnngb);
  const bool now_done = dev < NNGBDEV;
  const float omega = 1.0f + drho * h / (3.0f * fmaxf(rho, 1e-30f));
  float fac = 1.0f - (wk - desnngb) / (3.0f * fmaxf(wk, 1e-30f) * omega);
  fac = fminf(fmaxf(fac, (float)(1.0 / 1.24)), 1.24f);
  const float hi_n = wk > desnngb ? h : st.hi;
  const float lo_n = wk < desnngb ? h : st.lo;
  const float h_bis = powf(0.5f * (lo_n * lo_n * lo_n + hi_n * hi_n * hi_n),
                           (float)(1.0 / 3.0));
  float h_new = dev < 0.5f * desnngb ? h * fac : h_bis;
  h_new = fminf(h_new, cap);
  const bool freeze = (st.done > 0.5f) || now_done;
  st.h = freeze ? h : h_new;
  st.lo = lo_n;
  st.hi = hi_n;
  st.done = freeze ? 1.0f : 0.0f;
}

// rho (with the Dehnen+12 WC6 correction rho_corr W(0, h)), h,
// varHsmlFac, wkNgb and done of a lane, from raw sums normalised at h.
template <int KIND>
__device__ __forceinline__ void record(float* o, float h, float aw, float ardw,
                                       float done, float mpart, float desnngb,
                                       float rho_corr) {
  float sw, srdw;
  norm_sums<KIND>(h, aw, ardw, sw, srdw);
  const float wk = FOURPITHIRD * (h * h * h) * sw;
  const float rho = mpart * sw;
  const float drho = -mpart * (3.0f / h * sw + srdw / h);
  const bool now_done = fabsf(wk - desnngb) < NNGBDEV;
  o[0] = rho + rho_corr * (WC6_NORM / (h * h * h));
  o[1] = h;
  o[2] = 1.0f / (1.0f + h / (3.0f * fmaxf(rho, 1e-30f)) * drho);
  o[3] = wk;
  o[4] = (done > 0.5f || now_done) ? 1.0f : 0.0f;
}

}  // namespace pair_common
