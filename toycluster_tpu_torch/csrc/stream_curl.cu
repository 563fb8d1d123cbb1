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
// XLA pair operator toycluster_tpu/ops/pair_ops.py sph_curl).
//
// Work: one CTA of 128 threads per receiver block, one thread per
// receiver lane.  The CTA walks the first min(cnt, M) entries of its list:
// in superblock mode the (up to) 8 member blocks of each, in block mode
// the block itself.  Each source block's 128 sources (x, y, z, valid, A0,
// A1, A2: 3.5 KB) are staged in shared memory and every thread loops over
// them, accumulating the three curl components in registers.
//
// What bounds it: pair arithmetic (~25 fp32 operations per pair out of
// range, ~60 in range), with each staged source block reused by 128
// threads, so the FP32/issue rate and not HBM is the limit.  It runs once
// per pipeline, after the relaxation; this first version is plain: no
// skip bits, per-pair periodic wrap.
//
// dA = A_i - A_j is formed per pair: the TPU kernel records that a split
// into receiver and source partial sums cancels badly in f32 (up to 5e-2
// relative where A varies slowly).

#include "pair_common.cuh"

namespace {

using pair_common::BLOCK;
using pair_common::M4;
using pair_common::SUPER;
using pair_common::WC6;
using pair_common::WC6_NORM;

constexpr int SRC_ROWS = 8;   // x y z valid a0 a1 a2 pad
constexpr int USED_ROWS = 7;

template <int KIND, bool SB>
__global__ void __launch_bounds__(BLOCK)
stream_curl_kernel(const float* __restrict__ src, const int* __restrict__ cand,
                   const int* __restrict__ cnt, const float* __restrict__ xi,
                   const float* __restrict__ hsml,
                   const float* __restrict__ wfac,
                   const float* __restrict__ apot, float* __restrict__ out,
                   int M, int nb, float box) {
  __shared__ float s_src[USED_ROWS * BLOCK];
  const int s = blockIdx.x;
  const int i = threadIdx.x;
  const size_t lane = (size_t)s * BLOCK + i;
  const float x0 = xi[((size_t)s * 3 + 0) * BLOCK + i];
  const float x1 = xi[((size_t)s * 3 + 1) * BLOCK + i];
  const float x2 = xi[((size_t)s * 3 + 2) * BLOCK + i];
  const float a0 = apot[((size_t)s * 3 + 0) * BLOCK + i];
  const float a1 = apot[((size_t)s * 3 + 1) * BLOCK + i];
  const float a2 = apot[((size_t)s * 3 + 2) * BLOCK + i];
  const float h = hsml[lane];
  const float h2 = h * h;
  const float inv_h = 1.0f / h;
  const float inv_h5 = inv_h * inv_h * inv_h * inv_h * inv_h;
  const float inv_box = 1.0f / box;
  const int n_grp = min(cnt[s], M);
  const int* row = cand + (size_t)s * M;

  float bx = 0.0f, by = 0.0f, bz = 0.0f;
  for (int g = 0; g < n_grp; ++g) {
    const int id = row[g];
    if (id < 0) continue;
    const int first = SB ? id * SUPER : id;
    const int n_mem = SB ? min(SUPER, nb - first) : 1;
    for (int f = 0; f < n_mem; ++f) {
      const float* blk = src + (size_t)(first + f) * SRC_ROWS * BLOCK;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < USED_ROWS; ++k)
        s_src[k * BLOCK + i] = blk[k * BLOCK + i];
      __syncthreads();
      // two-level sums: over the block's sources, then over the blocks
      float cx = 0.0f, cy = 0.0f, cz = 0.0f;
      for (int j = 0; j < BLOCK; ++j) {
        if (!(s_src[3 * BLOCK + j] > 0.0f)) continue;
        float dx = x0 - s_src[j];
        float dy = x1 - s_src[BLOCK + j];
        float dz = x2 - s_src[2 * BLOCK + j];
        dx -= box * rintf(dx * inv_box);
        dy -= box * rintf(dy * inv_box);
        dz -= box * rintf(dz * inv_box);
        const float r2 = dx * dx + dy * dy + dz * dz;
        if (!(r2 < h2 && r2 > 0.0f)) continue;
        const float u = sqrtf(r2) * inv_h;
        const float t = fmaxf(1.0f - u, 0.0f);
        float w;
        if (KIND == M4) {
          if (u < 0.5f) {
            w = (45.836623610466f * u - 30.557749073644f) * inv_h5;
          } else {
            const float inv_u = rsqrtf(fmaxf(r2, 1e-30f)) * h;
            w = (-15.278874536822f * t * t * inv_u) * inv_h5;
          }
        } else {
          const float t3 = t * t * t;
          w = (WC6_NORM * inv_h5) * (-22.0f) * t3 * t3 * t *
              (16.0f * u * u + 7.0f * u + 1.0f);
        }
        const float da0 = a0 - s_src[4 * BLOCK + j];
        const float da1 = a1 - s_src[5 * BLOCK + j];
        const float da2 = a2 - s_src[6 * BLOCK + j];
        cx += w * (dz * da1 - dy * da2);
        cy += w * (dx * da2 - dz * da0);
        cz += w * (dy * da0 - dx * da1);
      }
      bx += cx;
      by += cy;
      bz += cz;
    }
  }
  const float wf = n_grp > 0 ? wfac[lane] : 0.0f;
  out[lane * 3 + 0] = wf * bx;
  out[lane * 3 + 1] = wf * by;
  out[lane * 3 + 2] = wf * bz;
}

}  // namespace

extern "C" int stream_curl_launch(const float* src, const int* cand,
                                  const int* cnt, const float* xi,
                                  const float* hsml, const float* wfac,
                                  const float* apot, float* out, int S, int M,
                                  int nb, int kind, int sb_mode, float box,
                                  void* stream) {
  if (S <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TC_CURL(K, SBM)                                                    \
  stream_curl_kernel<K, SBM><<<S, BLOCK, 0, st>>>(src, cand, cnt, xi, hsml, \
                                                  wfac, apot, out, M, nb, box)
  if (kind == M4) {
    if (sb_mode) TC_CURL(M4, true);
    else TC_CURL(M4, false);
  } else {
    if (sb_mode) TC_CURL(WC6, true);
    else TC_CURL(WC6, false);
  }
#undef TC_CURL
  return static_cast<int>(cudaGetLastError());
}
