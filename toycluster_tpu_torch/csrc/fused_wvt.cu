// Count-class fused WVT iteration: the adaptive-hsml density solve and the
// WVT displacement of one receiver block in one kernel, over block or
// superblock candidate lists, hand-written for Hopper (sm_90a).
//
// Replaces: toycluster_tpu/ops/pallas_pair.py _fused_kernel (launched by
// fused_wvt_pallas), which the count-class WVT loop runs for its narrow
// classes (models/wvt.py).
//
// Work (the list walk of class_walk.cuh): a row is one receiver block, on
// one CTA of 512 threads, four per receiver lane; rows are taken longest
// list first.  The CTA reads the first min(cnt, M) entries of its list;
// sources are (x, y, z, hm) records, hm in box units, hm == 0 marking a
// source that takes part in no pair.
// 1. Member test, once per call: one thread per listed block runs the chunk
//    cross test for both consumers -- the density (the receiver chunk's
//    largest cap) and the displacement (0.5 (its largest hm_i + the source
//    chunk's largest hm) box) -- and, where the caller gave them, ANDs in
//    its bounds (a block whose gdist exceeds the row's largest cap leaves
//    the density, one with dkeep == 0 the displacement).  The blocks kept
//    for either consumer form the union list in shared memory, each with
//    the test's verdict on the 16 warp tiles of either consumer
//    (class_walk::keep_tiles): a warp runs a block's pairs only where a
//    chunk pair of its 32 lanes and 32 sources is in range.
// 2. Sources.  The TPU kernel keeps the class's whole candidate set on
//    chip.  Here every sweep streams its blocks from L2 through the
//    cp.async ring of class_walk::walk (8 KB), which leaves room for two
//    CTAs an SM.  Keeping a row's kept blocks in shared memory across
//    sweeps instead was built and timed on an H100 (PERF.md section 6):
//    the median row of the 1e6-particle reference run keeps 65 blocks,
//    130 KB, one CTA an SM, and that was 15% slower than the ring.
// 3. Sweeps.  Before each sweep the density blocks of the union are tested
//    again, tile by tile, against the sweep's own ranges: each receiver
//    chunk's largest current h over the lanes not yet done (caps are up to
//    twice the solved h).  Sweep 0 also runs the displacement of the blocks flagged for it,
//    off the same separations.  Newton/bisection sweeps repeat until every
//    lane of the block is done (a CTA-wide vote, the TPU kernel's while-loop
//    condition) or n_sweeps were taken; the record uses the last sums at the
//    final h, without a measuring sweep of its own (unlike
//    solve_density.cu).
// 4. Frozen lanes.  A done lane's h no longer changes, so every later sweep
//    would measure the sums of the sweep that froze it again (the blocks a
//    test drops add exact zeros to two-level sums).  The lane keeps those
//    sums instead, leaves the sweep's ranges, and a warp whose 32 lanes are
//    all done skips its pair arithmetic.
// 5. Rows whose reach (receiver extent + the larger of the largest cap and
//    the widest displacement range) lies inside the box skip the periodic
//    wrap (bit-identical: the wrap is the identity on every pair in range
//    there; see stream_wvt.cu); rows across the edge wrap per pair.
//
// Sums are two-level (per source block, then across blocks), then the four
// parts of a lane are added in a fixed order: the outputs do not depend on
// what the tests drop or on the frozen-lane skip.
//
// What bounds it: fp32 pair arithmetic (8 operations for a pair's
// separation, 12 more with the wrap, the range tests) against 2 KB copied
// once per kept block and reused 128 times a sweep from shared memory: the
// SMs' fp32 instruction rate, not HBM.

#include "class_walk.cuh"

namespace {

using namespace pair_common;
using namespace class_walk;

// A union-list entry: (block id, the density tiles at the caps in the low
// half and the displacement tiles in the high half).  A walk-list entry:
// the union position, the density tiles of this sweep above it, and F_DISP
// where sweep 0 runs the block's displacement.
constexpr int P_BITS = 14;
constexpr int P_MASK = (1 << P_BITS) - 1;
constexpr int F_DISP = 1 << 30;
static_assert(MAX_SHARE <= 1 << P_BITS, "a union position fits P_BITS");
// debug bits of the C entry point
constexpr int DBG_NO_SKIP = 1;   // frozen lanes are swept like the others
constexpr int DBG_NO_TILES = 2;  // every warp runs every kept block

// The tiles of a kept consumer all set (DBG_NO_TILES).
__device__ __forceinline__ unsigned whole_blocks(unsigned m) {
  return (m & 0xffffu ? 0xffffu : 0u) | (m >> 16 ? 0xffff0000u : 0u);
}

struct Args {
  const float* src;    // (nb, 128, 4) x y z hm per source
  const float* ctab;   // (nb, 8, 8) source chunks: cen, ext, max hm, 0
  const float* rtab;   // (S, 8, 8) receiver chunks: cen, ext, max cap, max hm_i
  const int* cand;     // (S, M) block ids, or superblock ids with sb
  const int* cnt;      // (S,)
  const int* flag;     // (S,) 1: the row skips the periodic wrap
  const int* order;    // (S,) rows, longest list first
  const float* xi;     // (S, 3, 128)
  const float* h0;     // (S, 128)
  const float* cap;    // (S, 128)
  const float* hm_i;   // (S, 128) metric hsml, box units
  const float* gdist;          // (S, MB) or null; MB = M (x SUPER with sb)
  const unsigned char* dkeep;  // (S, MB) or null
  float* out;          // (S, 128, 8): rho h vf wk done dx dy dz
  int* stats;          // (S, 5) or null: sweeps, blocks kept (union), blocks
                       // listed, density blocks and density tiles walked
                       // over all sweeps
  int M, nb, n_sweeps, prune, sb, debug;
  float mpart, box, inv_box, infl, desnngb, rho_corr;
};

// The blocks of a walk list, for class_walk::walk.
struct WalkIds {
  const int2* ulist;
  const int* wl;
  __device__ __forceinline__ int operator[](int k) const {
    return ulist[wl[k] & P_MASK].x;
  }
};

struct Lane {
  float x0, x1, x2, hmi;
};

// Pairs of one receiver lane with this thread's sources of one block:
// DENS adds the density sums at h, DISP the displacement (box units).
// Sources are taken GROUP at a time: the separations and range tests of a
// group are independent chains the scheduler overlaps, and one branch
// guards the few pairs in range, which then add their terms in source
// order, as a loop pair by pair would.
constexpr int GROUP = 4;

template <int KIND, bool WRAP, bool DENS, bool DISP>
__device__ __forceinline__ void block_pairs(const float4* sm, const Lane& ln,
                                            float h, float inv_h2, float box,
                                            float inv_box, float& bw,
                                            float& brdw, float& bx, float& by,
                                            float& bz) {
  const int j0 = (threadIdx.x / BLOCK) * NJ;
  // a pair beyond this takes no part in the M4 sums (u = r / h >= 1); the
  // WC6 sums test q = r2 / h2 < 1 themselves
  const float q_in = KIND == WC6 ? 1.0f : 1.000001f;
  for (int j = j0; j < j0 + NJ; j += GROUP) {
    float dx[GROUP], dy[GROUP], dz[GROUP], qq[GROUP], hj[GROUP];
    unsigned in_d = 0u, in_x = 0u;
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float4 q = sm[j + g];  // one broadcast load per pair
      hj[g] = q.w;
      dx[g] = ln.x0 - q.x;
      dy[g] = ln.x1 - q.y;
      dz[g] = ln.x2 - q.z;
      if (WRAP) {
        dx[g] -= box * rintf(dx[g] * inv_box);
        dy[g] -= box * rintf(dy[g] * inv_box);
        dz[g] -= box * rintf(dz[g] * inv_box);
      }
      const bool valid = hj[g] > 0.0f;
      if (DENS) {
        const float r2 = dx[g] * dx[g] + dy[g] * dy[g] + dz[g] * dz[g];
        qq[g] = r2 * inv_h2;
        if (valid && qq[g] < q_in) in_d |= 1u << g;
      }
      if (DISP) {
        const float ex = dx[g] * inv_box;
        const float ey = dy[g] * inv_box;
        const float ez = dz[g] * inv_box;
        const float r2 = ex * ex + ey * ey + ez * ez;
        const float hbar = 0.5f * (hj[g] + ln.hmi);
        if (valid && r2 < hbar * hbar && r2 > 0.0f) in_x |= 1u << g;
      }
    }
    if ((in_d | in_x) == 0u) continue;
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (DENS && (in_d >> g & 1u)) {
        if (KIND == WC6) {
          dens_pair<KIND>(sqrtf(qq[g]), h, bw, brdw);
        } else {
          const float r2 = dx[g] * dx[g] + dy[g] * dy[g] + dz[g] * dz[g];
          dens_pair<KIND>(sqrtf(r2), h, bw, brdw);
        }
      }
      if (DISP && (in_x >> g & 1u)) {
        const float ex = dx[g] * inv_box;
        const float ey = dy[g] * inv_box;
        const float ez = dz[g] * inv_box;
        const float r = sqrtf(ex * ex + ey * ey + ez * ez);
        const float hbar = 0.5f * (hj[g] + ln.hmi);
        const float coef = wflat_raw<KIND>(r / hbar) / r;
        bx += coef * ex;
        by += coef * ey;
        bz += coef * ez;
      }
    }
  }
}

// One sweep over the walk list wl: the density sums at h into v[0..1] and,
// in sweep 0 (FIRST), the displacement of the entries flagged F_DISP into
// v[2..4], each over the blocks whose tile of this warp is set.
template <int KIND, bool WRAP, bool FIRST>
__device__ __forceinline__ void sweep(const Args& a, const Lane& ln,
                                      const int2* ulist, const int* wl, int n_w,
                                      float* ring, float h, bool skip,
                                      float (&v)[5]) {
  const float box = a.box;
  const float inv_box = 1.0f / box;
  const float inv_h2 = 1.0f / (h * h);
  float sw = 0.0f, srdw = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f;
  int k = 0;
  walk(a.src, WalkIds{ulist, wl}, n_w, ring, [&](const float4* sm) {
    const int e = wl[k++];
    if (skip) return;
    float bw = 0.0f, brdw = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    const int w = threadIdx.x >> 5;
    const bool d = (e >> (P_BITS + w) & 1) != 0;
    const bool x = FIRST && (e & F_DISP) != 0 &&
                   (ulist[e & P_MASK].y >> (16 + w) & 1) != 0;
    if (d && x)
      block_pairs<KIND, WRAP, true, true>(sm, ln, h, inv_h2, box, inv_box, bw,
                                          brdw, bx, by, bz);
    else if (d)
      block_pairs<KIND, WRAP, true, false>(sm, ln, h, inv_h2, box, inv_box, bw,
                                           brdw, bx, by, bz);
    else if (x)
      block_pairs<KIND, WRAP, false, true>(sm, ln, h, inv_h2, box, inv_box, bw,
                                           brdw, bx, by, bz);
    sw += bw;
    srdw += brdw;
    if (FIRST) {
      ax += bx;
      ay += by;
      az += bz;
    }
  });
  v[0] = sw;
  v[1] = srdw;
  v[2] = ax;
  v[3] = ay;
  v[4] = az;
}

template <int KIND, bool DISP>
__global__ void __launch_bounds__(NT, 2) fused_wvt_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  int2* ulist = reinterpret_cast<int2*>(ring + STAGES * SRC_FLOATS);
  int* wl = reinterpret_cast<int*>(ulist + max(a.sb ? a.M * SUPER : a.M, 1));
  __shared__ float s_rt[NCHUNK * 8];
  __shared__ float s_td2[NCHUNK];
  __shared__ int s_wc[2 * NWARP * 2];
  __shared__ float s_part[SPLIT * 5 * BLOCK];

  const int s = a.order[blockIdx.x];
  const int t = threadIdx.x;
  const int i = t % BLOCK;
  const size_t lane = (size_t)s * BLOCK + i;
  const int n = min(a.cnt[s], a.M);
  if (n <= 0) {  // uniform over the CTA
    if (t < BLOCK)
      for (int k = 0; k < 8; ++k) a.out[lane * 8 + k] = 0.0f;
    if (a.stats != nullptr && t < 5) a.stats[(size_t)s * 5 + t] = 0;
    return;
  }
  const Row r{a.src, a.ctab, a.cand + (size_t)s * a.M, a.sb ? n * SUPER : n,
              a.nb, a.sb, a.prune, 0, 1, a.box, a.inv_box, a.infl};
  const bool safe = a.flag[s] != 0;
  const Lane ln{a.xi[((size_t)s * 3 + 0) * BLOCK + i],
                a.xi[((size_t)s * 3 + 1) * BLOCK + i],
                a.xi[((size_t)s * 3 + 2) * BLOCK + i], a.hm_i[lane]};
  const float cap = a.cap[lane];
  const bool no_skip = (a.debug & DBG_NO_SKIP) != 0;
  const bool no_tiles = (a.debug & DBG_NO_TILES) != 0;

  if (t < NCHUNK * 8) s_rt[t] = a.rtab[(size_t)s * NCHUNK * 8 + t];
  __syncthreads();
  if (t < NCHUNK) {
    const float td = __fadd_rn(s_rt[t * 8 + 6], a.infl);
    s_td2[t] = __fmul_rn(td, td);
  }
  // no pair of a block farther than the row's largest cap is in range of
  // any lane's h (h <= cap always)
  float cap_max = s_rt[6];
#pragma unroll
  for (int c = 1; c < NCHUNK; ++c) cap_max = fmaxf(cap_max, s_rt[c * 8 + 6]);
  __syncthreads();

  // the union list: the chunk test of both consumers and the caller's
  // bounds, indexed by list entry
  const size_t mb = (size_t)a.M * (a.sb ? SUPER : 1);
  const float* gd = a.gdist ? a.gdist + (size_t)s * mb : nullptr;
  const unsigned char* dk = a.dkeep ? a.dkeep + (size_t)s * mb : nullptr;
  int n_u, n_listed;
  compact(
      r.n_entries, [&](int k) { return entry_block(r, k); },
      [&](int b, int k, int2& v) {
        unsigned m = DISP ? 0xffffffffu : 0xffffu;
        if (a.prune) m = keep_tiles<true, DISP>(r, b, s_rt, s_td2);
        if (gd != nullptr && gd[k] > cap_max) m &= 0xffff0000u;
        if (dk != nullptr && !dk[k]) m &= 0xffffu;
        if (no_tiles) m = whole_blocks(m);
        v = make_int2(b, (int)m);
        return m != 0u;
      },
      s_wc, ulist, n_u, n_listed);

  Solve st{fminf(a.h0[lane], cap), 0.0f, cap, 0.0f};
  float aw = 0.0f, ardw = 0.0f, disp[3] = {0.0f, 0.0f, 0.0f};
  int sweeps = 0, n_walked = 0, n_tiles = 0;
  for (int k = 0; k < a.n_sweeps; ++k) {
    if (__syncthreads_and(st.done > 0.5f)) break;
    const bool first = k == 0;
    // a frozen lane keeps the sums of the sweep that froze it
    const bool frozen = !no_skip && st.done > 0.5f;
    if (a.prune) {
      // the sweep's range per receiver chunk: the largest h of its 16
      // lanes that are still measured
      float hm = frozen ? -1.0f : st.h;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        hm = fmaxf(hm, __shfl_xor_sync(0xffffffffu, hm, off));
      if (t < BLOCK && (t & 15) == 0) {
        const float td = __fadd_rn(hm, a.infl);
        s_td2[t >> 4] = hm < 0.0f ? -1.0f : __fmul_rn(td, td);
      }
      __syncthreads();
    }
    // the sweep's walk list
    int n_w, n_all;
    compact(
        n_u, [&](int p) { return p; },
        [&](int p, int, int& v) {
          const int2 e = ulist[p];
          unsigned d = (unsigned)e.y & 0xffffu;
          if (d != 0u && a.prune) {
            d = keep_tiles<true, false>(r, e.x, s_rt, s_td2);
            if (no_tiles) d = whole_blocks(d);
          }
          const bool x = DISP && first && ((unsigned)e.y >> 16) != 0u;
          v = p | (int)(d << P_BITS) | (x ? F_DISP : 0);
          return d != 0u || x;
        },
        s_wc, wl, n_w, n_all);
    if (a.stats != nullptr)
      for (int p = 0; p < n_w; ++p) {
        const int d = wl[p] >> P_BITS & 0xffff;
        n_walked += d != 0;
        n_tiles += __popc(d);
      }
    const bool skip = __all_sync(0xffffffffu, frozen);
    float v[5];
    if (first) {
      if (safe)
        sweep<KIND, false, true>(a, ln, ulist, wl, n_w, ring, st.h, skip, v);
      else
        sweep<KIND, true, true>(a, ln, ulist, wl, n_w, ring, st.h, skip, v);
    } else if (safe) {
      sweep<KIND, false, false>(a, ln, ulist, wl, n_w, ring, st.h, skip, v);
    } else {
      sweep<KIND, true, false>(a, ln, ulist, wl, n_w, ring, st.h, skip, v);
    }
    if (first && DISP) {
      reduce_row<5, false>(v, s_part, nullptr, 1);
      disp[0] = v[2];
      disp[1] = v[3];
      disp[2] = v[4];
    } else {
      float v2[2] = {v[0], v[1]};
      reduce_row<2, false>(v2, s_part, nullptr, 1);
      v[0] = v2[0];
      v[1] = v2[1];
    }
    if (!frozen) {
      aw = v[0];
      ardw = v[1];
    }
    update<KIND>(st, aw, ardw, cap, a.mpart, a.desnngb);
    ++sweeps;
  }
  if (t < BLOCK) {
    float* o = a.out + lane * 8;
    record<KIND>(o, st.h, aw, ardw, st.done, a.mpart, a.desnngb, a.rho_corr);
    const float dnorm = ln.hmi * (KIND == M4 ? 1.0f : WC6_NORM);
    o[5] = dnorm * disp[0];
    o[6] = dnorm * disp[1];
    o[7] = dnorm * disp[2];
  }
  if (a.stats != nullptr && t == 0) {
    int* so = a.stats + (size_t)s * 5;
    so[0] = sweeps;
    so[1] = n_u;
    so[2] = n_listed;
    so[3] = n_walked;
    so[4] = n_tiles;
  }
}

template <int KIND, bool DISP>
int launch_kernel(const Args& a, int S, cudaStream_t st) {
  // the union list's two ints an entry and the walk list's one
  const size_t smem = smem_bytes(a.sb ? a.M * SUPER : a.M, 1, 3);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(fused_wvt_kernel<KIND, DISP>, a, S, 1, smem, st);
}

}  // namespace

// `debug`: DBG_* bits, for the callers' checks that neither the frozen-lane
// skip nor the warp tiles change a bit of the results.
extern "C" int fused_wvt_launch(
    const float* src, const float* ctab, const float* rtab, const int* cand,
    const int* cnt, const int* flag, const int* order, const float* xi,
    const float* h0, const float* cap, const float* hm_i, const float* gdist,
    const unsigned char* dkeep, float* out, int* stats, int S, int M, int nb,
    int kind, int sb_mode, int do_disp, int n_sweeps, int prune, int debug,
    float mpart, float box, float inv_box, float infl, float desnngb,
    float rho_corr, void* stream) {
  if (S <= 0) return 0;
  Args a{src,  ctab,  rtab,     cand,  cnt,     flag,  order, xi,
         h0,   cap,   hm_i,     gdist, dkeep,   out,   stats, M,
         nb,   n_sweeps, prune, sb_mode, debug, mpart, box,   inv_box,
         infl, desnngb,  rho_corr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == M4)
    return do_disp ? launch_kernel<M4, true>(a, S, st)
                   : launch_kernel<M4, false>(a, S, st);
  return do_disp ? launch_kernel<WC6, true>(a, S, st)
                 : launch_kernel<WC6, false>(a, S, st);
}
