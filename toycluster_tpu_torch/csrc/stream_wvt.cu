// Fused WVT density solve + displacement over superblock candidate lists,
// hand-written for Hopper (sm_90a).
//
// Replaces: toycluster_tpu/ops/pallas_pair.py _stream_kernel (launched by
// stream_wvt_pallas), the TPU kernel of the WVT hot loop (models/wvt.py)
// and of the stand-alone density solve (models/sph.py).
//
// Work: one CTA of 128 threads per receiver block, one thread per
// receiver lane.  The CTA walks the first min(cnt, M) superblocks of its
// list and their (up to) 8 member blocks; each member block's 128 sources
// (x, y, z, hm: 2 KB) are staged in shared memory and every thread loops
// over them, accumulating its sums in registers.  Sweep 0 measures the
// density sums at h0 and (do_disp) the WVT displacement in the same
// stream; Newton/bisection sweeps then repeat until all 128 lanes of the
// block are done (a CTA-wide vote, as the TPU kernel's loop condition is
// block-wide) or n_sweeps measurements were taken.
//
// What bounds it: pair arithmetic.  Each sweep evaluates 128 x 128 pairs
// per listed member block (~20 fp32 operations for a pair out of range,
// ~40 in range) against 2 KB of shared-memory traffic per member, so the
// kernel is bound by the FP32/issue rate of the SMs, not by HBM: the
// sources of one member block are read once from L2/HBM per sweep and
// reused 128 times from shared memory.  This first version does nothing
// cleverer than that: no skip bits (member blocks out of range still pay
// their distance tests), per-pair periodic wrap, and one CTA per receiver
// block, so rows with long lists set the tail of the grid.
//
// Semantics kept from the TPU kernel: the self pair counts in the density
// (W(0)) and never in the displacement (r2 > 0); WC6 sums are raw and
// normalised after the pass; a speculatively accepted lane is re-measured
// if its block sweeps again and extrapolated to first order otherwise;
// padded list entries (cand < 0), members past nb and source lanes with
// hm == 0 take part in no pair.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;
constexpr int SUPER = 8;
constexpr int SRC_ROWS = 4;  // x, y, z, hm
constexpr float WC6_NORM = (float)(1365.0 / (64.0 * 3.14159265358979323846));
constexpr float FOURPITHIRD = 4.18879032135009765f;
constexpr float NNGBDEV = 0.05f;

enum Kind { WC6 = 0, M4 = 1 };

struct Args {
  const float* src;   // (nb_pad, 4, 128), nb_pad a multiple of SUPER
  const int* cand;    // (S, M) superblock ids, -1 padded
  const int* cnt;     // (S,)
  const float* xi;    // (S, 3, 128)
  const float* h0;    // (S, 128)
  const float* cap;   // (S, 128)
  const float* hm_i;  // (S, 128) metric hsml, box units
  float* out;         // (S, 128, 8): rho h vf wk done dx dy dz
  int M, nb, n_sweeps;
  float mpart, box, desnngb, spec_win, rho_corr;
};

// Raw density sums of one pair at support radius h.  WC6 accumulates the
// unnormalised t^8 poly and t^7 poly (normalised in norm_sums); M4
// accumulates w and r dW/dr with their 1/h^3, 1/h^4 factors.
template <int KIND>
__device__ __forceinline__ void dens_pair(float u_or_r, float h,
                                          float& aw, float& ardw) {
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

// One stream over the listed member blocks.  UNION (sweep 0 with
// do_disp) also accumulates the displacement; every thread of the CTA
// runs the same trip counts, so the barriers are uniform.  Sums are taken
// in two levels, over the 128 sources of a member block and then over
// the blocks (the TPU kernel's tile accumulators sum in two levels too):
// a displacement component is a near-cancelling sum of up to ~1e5 terms
// in dense cores, where one running f32 sum loses digits.
template <int KIND, bool UNION>
__device__ void stream_pass(const Args& a, float* s_src, int s, int n_grp,
                            float x0, float x1, float x2, float h, float hmi,
                            float& aw, float& ardw, float* disp) {
  const int lane = threadIdx.x;
  const float box = a.box;
  const float inv_box = 1.0f / box;
  const float half_box = 0.5f * box;
  const float inv_h = 1.0f / h;
  const float inv_h2 = 1.0f / (h * h);
  aw = 0.0f;
  ardw = 0.0f;
  float dax = 0.0f, day = 0.0f, daz = 0.0f;
  const int* row = a.cand + (size_t)s * a.M;
  for (int g = 0; g < n_grp; ++g) {
    const int sb = row[g];
    if (sb < 0) continue;
    const int n_mem = min(SUPER, a.nb - sb * SUPER);
    for (int f = 0; f < n_mem; ++f) {
      const float* blk = a.src + (size_t)(sb * SUPER + f) * SRC_ROWS * BLOCK;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SRC_ROWS; ++k)
        s_src[k * BLOCK + lane] = blk[k * BLOCK + lane];
      __syncthreads();
      float bw = 0.0f, brdw = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
      for (int j = 0; j < BLOCK; ++j) {
        const float hj = s_src[3 * BLOCK + j];
        if (!(hj > 0.0f)) continue;
        float dx = x0 - s_src[j];
        float dy = x1 - s_src[BLOCK + j];
        float dz = x2 - s_src[2 * BLOCK + j];
        dx -= box * rintf(dx * inv_box);
        dy -= box * rintf(dy * inv_box);
        dz -= box * rintf(dz * inv_box);
        const float r2 = dx * dx + dy * dy + dz * dz;
        if (UNION) {
          const float inv_r = rsqrtf(fmaxf(r2, 1e-30f));
          const float r = r2 * inv_r;
          dens_pair<KIND>(KIND == WC6 ? r * inv_h : r, h, bw, brdw);
          const float hbar = (hmi + hj) * half_box;
          if (r2 < hbar * hbar && r2 > 0.0f) {
            const float u = r / hbar;
            float wflat;
            if (KIND == WC6) {
              const float t = fmaxf(1.0f - u, 0.0f);
              const float t2 = t * t;
              const float t4 = t2 * t2;
              wflat = t4 * t4 * (1.0f + u * (8.0f + u * (25.0f + 32.0f * u)));
            } else if (u < 0.5f) {
              wflat = 2.546479089470f + 15.278874536822f * (u - 1.0f) * u * u;
            } else if (u < 1.0f) {
              const float t = 1.0f - u;
              wflat = 5.092958178941f * (t * t * t);
            } else {
              wflat = 0.0f;
            }
            const float coef = wflat * inv_r;
            bx += coef * dx;
            by += coef * dy;
            bz += coef * dz;
          }
        } else if (KIND == WC6) {
          const float q = r2 * inv_h2;
          if (q < 1.0f) dens_pair<KIND>(sqrtf(q), h, bw, brdw);
        } else {
          dens_pair<KIND>(sqrtf(r2), h, bw, brdw);
        }
      }
      aw += bw;
      ardw += brdw;
      if (UNION) {
        dax += bx;
        day += by;
        daz += bz;
      }
    }
  }
  if (UNION) {
    disp[0] = dax;
    disp[1] = day;
    disp[2] = daz;
  }
}

struct Solve {
  float h, h_meas, lo, hi, done;
};

// Newton/bisection update from the sums measured at st.h (sph.c:175-195),
// with the speculative accept of the TPU kernel.
template <int KIND>
__device__ __forceinline__ void update(const Args& a, Solve& st, float aw,
                                       float ardw, float cap) {
  const float h = st.h;
  float sw, srdw;
  norm_sums<KIND>(h, aw, ardw, sw, srdw);
  const float wk = FOURPITHIRD * (h * h * h) * sw;
  const float rho = a.mpart * sw;
  const float drho = -a.mpart * (3.0f / h * sw + srdw / h);
  const float dev = fabsf(wk - a.desnngb);
  const bool now_done = dev < NNGBDEV;
  const float omega = 1.0f + drho * h / (3.0f * fmaxf(rho, 1e-30f));
  float fac = 1.0f - (wk - a.desnngb) / (3.0f * fmaxf(wk, 1e-30f) * omega);
  fac = fminf(fmaxf(fac, (float)(1.0 / 1.24)), 1.24f);
  const float hi_n = wk > a.desnngb ? h : st.hi;
  const float lo_n = wk < a.desnngb ? h : st.lo;
  const float h_bis = powf(0.5f * (lo_n * lo_n * lo_n + hi_n * hi_n * hi_n),
                           (float)(1.0 / 3.0));
  float h_new = dev < 0.5f * a.desnngb ? h * fac : h_bis;
  h_new = fminf(h_new, cap);
  const bool spec = (st.done < 0.5f) && !now_done && (dev < a.spec_win) &&
                    (h * fac < cap);
  const bool freeze = (st.done > 0.5f) || now_done;
  const bool keep = freeze || spec;
  st.h = freeze ? h : h_new;
  st.h_meas = keep ? h : h_new;
  st.lo = lo_n;
  st.hi = hi_n;
  st.done = keep ? 1.0f : 0.0f;
}

template <int KIND, bool DISP>
__global__ void __launch_bounds__(BLOCK)
stream_wvt_kernel(Args a) {
  __shared__ float s_src[SRC_ROWS * BLOCK];
  const int s = blockIdx.x;
  const int i = threadIdx.x;
  const size_t lane = (size_t)s * BLOCK + i;
  const float x0 = a.xi[((size_t)s * 3 + 0) * BLOCK + i];
  const float x1 = a.xi[((size_t)s * 3 + 1) * BLOCK + i];
  const float x2 = a.xi[((size_t)s * 3 + 2) * BLOCK + i];
  const float cap = a.cap[lane];
  const float hmi = a.hm_i[lane];
  const int n_grp = min(a.cnt[s], a.M);

  const float h0c = fminf(a.h0[lane], cap);
  float aw, ardw;
  float disp[3] = {0.0f, 0.0f, 0.0f};
  // sweep 0: the union pass (density at h0 + displacement) or density
  if (DISP)
    stream_pass<KIND, true>(a, s_src, s, n_grp, x0, x1, x2, h0c, hmi, aw,
                            ardw, disp);
  else
    stream_pass<KIND, false>(a, s_src, s, n_grp, x0, x1, x2, h0c, hmi, aw,
                             ardw, nullptr);
  Solve st{h0c, h0c, 0.0f, cap, 0.0f};
  update<KIND>(a, st, aw, ardw, cap);
  for (int k = 1; k < a.n_sweeps; ++k) {
    // block-coupled termination: sweep again unless every lane is done
    if (__syncthreads_and(st.done > 0.5f)) break;
    stream_pass<KIND, false>(a, s_src, s, n_grp, x0, x1, x2, st.h, hmi, aw,
                             ardw, nullptr);
    update<KIND>(a, st, aw, ardw, cap);
  }

  // epilogue: the sums belong to h_meas; extrapolate sum w to h
  const float h = st.h;
  const float hm = st.h_meas;
  float sw, srdw;
  norm_sums<KIND>(hm, aw, ardw, sw, srdw);
  sw = sw - (3.0f * sw + srdw) / hm * (h - hm);
  const float wk = FOURPITHIRD * (h * h * h) * sw;
  const float rho = a.mpart * sw;
  const float drho = -a.mpart * (3.0f / h * sw + srdw / h);
  const bool now_done = fabsf(wk - a.desnngb) < NNGBDEV;
  const float rho_out = rho + a.rho_corr * (WC6_NORM / (h * h * h));
  float* o = a.out + lane * 8;
  o[0] = rho_out;
  o[1] = h;
  o[2] = 1.0f / (1.0f + h / (3.0f * fmaxf(rho, 1e-30f)) * drho);
  o[3] = wk;
  o[4] = (st.done > 0.5f || now_done) ? 1.0f : 0.0f;
  const float dnorm = hmi * (KIND == M4 ? 1.0f : WC6_NORM);
  o[5] = DISP ? dnorm * disp[0] : 0.0f;
  o[6] = DISP ? dnorm * disp[1] : 0.0f;
  o[7] = DISP ? dnorm * disp[2] : 0.0f;
}

template <int KIND, bool DISP>
void launch(const Args& a, int S, cudaStream_t st) {
  stream_wvt_kernel<KIND, DISP><<<S, BLOCK, 0, st>>>(a);
}

}  // namespace

extern "C" int stream_wvt_launch(const float* src, const int* cand,
                                 const int* cnt, const float* xi,
                                 const float* h0, const float* cap,
                                 const float* hm_i, float* out, int S, int M,
                                 int nb, int kind, int do_disp, int n_sweeps,
                                 float mpart, float box, float desnngb,
                                 float spec_win, float rho_corr,
                                 void* stream) {
  if (S <= 0) return 0;
  Args a{src, cand, cnt, xi, h0, cap, hm_i, out, M, nb, n_sweeps,
         mpart, box, desnngb, spec_win, rho_corr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == M4) {
    if (do_disp) launch<M4, true>(a, S, st);
    else launch<M4, false>(a, S, st);
  } else {
    if (do_disp) launch<WC6, true>(a, S, st);
    else launch<WC6, false>(a, S, st);
  }
  return static_cast<int>(cudaGetLastError());
}
