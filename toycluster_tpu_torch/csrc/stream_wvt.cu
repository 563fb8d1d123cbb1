// Fused WVT density solve + displacement over superblock candidate lists,
// hand-written for Hopper (sm_90a).
//
// Replaces: toycluster_tpu/ops/pallas_pair.py _stream_kernel (launched by
// stream_wvt_pallas), the TPU kernel of the WVT hot loop (models/wvt.py)
// and of the stand-alone density solve (models/sph.py), together with the
// XLA feeders that pruned its member blocks (build_chunk_tab,
// stream_skip_bits, compact_sb_lists).
//
// Work: one CTA of 128 x SPLIT = 512 threads per receiver block, rows
// taken longest list first (the wrapper's `order`).  SPLIT threads serve
// each receiver lane, each taking 128 / SPLIT sources of every member;
// their sums are added in a fixed order at the end of each pass, so the
// outputs differ in the last bits from a kernel of 128 threads a row.  The
// rows with the longest lists set the end of the grid, and more threads
// per row shorten them: on the 1e6 main path 512 threads measured fastest
// against 128, 256 and 1024 (PERF.md).
// 1. Member test, once per call: each thread tests one listed member
//    block (b = sb * 8 + f, b < nb) with the chunk cross test of
//    stream_skip_bits: the 8 x 8 minimum-image gaps between the receiver
//    block's and the member's 16-particle chunk hulls, against the
//    receiver chunk's largest cap (density) and 0.5 (its largest hm_i +
//    the member chunk's largest hm) box (displacement), both inflated by
//    `infl`.  Warp ballots compact the kept members, in list order, into
//    two lists of 16-bit list positions in shared memory (either consumer;
//    density), so later sweeps walk only those.  The test costs 64 hull
//    tests per listed member against 16384 pairs per kept member and
//    sweep: a few percent at most.
// 2. Sweep 0 walks the union list (density at h0 and, with do_disp, the
//    WVT displacement; a member kept for one consumer runs only its
//    part), later Newton/bisection sweeps walk the density list, until all
//    128 lanes of the block are done (a CTA-wide vote, as the TPU kernel's
//    loop condition is block-wide) or n_sweeps measurements were taken.
//    Member blocks (128 sources of x, y, z, hm: 2 KB, contiguous, laid out
//    source by source so that a pair reads its source with one broadcast
//    16-byte load) stream through a ring of STAGES slots in shared memory
//    with cp.async, so STAGES - 1 copies are in flight while a member's
//    128 x 128 pairs run.
// 3. Periodic wrap: rows flagged by the wrapper (stream_pair.prune_tables:
//    the row's reach -- receiver extent widened by its largest pair range
//    -- inside the box) skip it.  Every source within range of such a row
//    is stored at its minimum-image position, less than half a box away,
//    so the wrap is the identity on every pair in range and
//    out-of-range pairs only come out farther without it: the flagged rows
//    give the same bits as with the per-pair wrap.  The TPU kernel instead
//    centres each staged source on the row centre and wraps it once; on
//    rows across the periodic edge that re-rounds in-range separations by
//    up to an ulp of the box, which broke the displacement's tolerance
//    against the plain version on a cusp placed across the edge.  The rows
//    across the edge (a few, in the sparse outskirts) wrap per pair.
//
// What bounds it: fp32 pair arithmetic, and the longest rows.  Every
// pair of a kept member costs its separation (8 fp32 operations; 20 with
// the per-pair wrap, on rows that need it) and its range test, against
// 2 KB of copies per member and sweep reused 128 times from shared memory;
// the few percent of pairs within range pay the kernel polynomial.  So the
// bound is the SMs' fp32 rate, not HBM (chip_smoke.py computes both).  The
// tensor cores stay out: the only contraction is r2, a K = 3 product, and
// the TPU's matrix-unit version of it (the augmented quadratic identity)
// was slower and its round-off made spurious saturated lanes that set off
// rebuild storms (pallas_pair.py:1391-1397).
//
// Exactness: a pruned member's sums are exact zeros (the test is
// conservative and its arithmetic is that of stream_pair.member_keep), and
// kept members are summed in list order, two-level (per member block,
// then across blocks: a displacement component is a near-cancelling sum
// of up to ~1e5 terms), so pruned and unpruned runs agree to the bit in
// the same wrap mode.
//
// Semantics kept from the TPU kernel: the self pair counts in the density
// (W(0)) and never in the displacement (r2 > 0); WC6 sums are raw and
// normalised after the pass; a speculatively accepted lane is re-measured
// if its block sweeps again and extrapolated to first order otherwise;
// padded list entries (cand < 0), members past nb and source lanes with
// hm == 0 take part in no pair.

#include "pair_common.cuh"

namespace {

using pair_common::BLOCK;
using pair_common::dens_pair;
using pair_common::FOURPITHIRD;
using pair_common::M4;
using pair_common::NNGBDEV;
using pair_common::norm_sums;
using pair_common::SUPER;
using pair_common::WC6;
using pair_common::WC6_NORM;

constexpr int SPLIT = 4;                   // threads per receiver lane
constexpr int NT = BLOCK * SPLIT;          // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int SRC_FLOATS = 4 * BLOCK;      // x, y, z, hm of a member block
constexpr int STAGES = 4;                  // cp.async ring depth
constexpr int NCHUNK = 8;                  // 16-particle chunks per block
constexpr unsigned KEEP_D = 0x8000u;       // list entry: density part
constexpr unsigned KEEP_X = 0x4000u;       // list entry: displacement part
constexpr unsigned POS_MASK = 0x3fffu;     // list entry: list position
constexpr int MAX_MEMBERS = 0x4000;

struct Args {
  const float* src;   // (nb_pad, 128, 4) x y z hm per source, nb_pad a
                      // multiple of SUPER
  const int* cand;    // (S, M) superblock ids, -1 padded
  const int* cnt;     // (S,)
  const float* xi;    // (S, 3, 128)
  const float* h0;    // (S, 128)
  const float* cap;   // (S, 128)
  const float* hm_i;  // (S, 128) metric hsml, box units
  const float* ctab;  // (nb, 8, 8) member chunks: cen xyz, ext xyz, max hm, 0
  const float* rtab;  // (S, 8, 8) receiver chunks: cen, ext, max cap, max hm_i
  const int* flag;    // (S,) 1: the row skips the periodic wrap
  const int* order;   // (S,) rows, longest list first
  float* out;         // (S, 128, 8): rho h vf wk done dx dy dz
  int* stats;         // (S, 4) or null: sweeps, union, density, listed
  int M, nb, n_sweeps, prune;
  float mpart, box, inv_box, infl, desnngb, spec_win, rho_corr;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Minimum-image gap^2 between receiver chunk ri and member chunk cj (cen
// xyz, ext xyz), rounded operation by operation as stream_pair.member_keep
// computes it (no contraction), so kernel and plain test keep the same
// members.
__device__ __forceinline__ float hull_gap2(const float* ri, const float* cj,
                                           float box, float inv_box) {
  float g2 = 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float dd = __fsub_rn(ri[d], cj[d]);
    dd = __fsub_rn(dd, __fmul_rn(box, rintf(__fmul_rn(dd, inv_box))));
    const float gp =
        fmaxf(__fsub_rn(fabsf(dd), __fadd_rn(ri[3 + d], cj[3 + d])), 0.0f);
    g2 = d == 0 ? __fmul_rn(gp, gp) : __fadd_rn(g2, __fmul_rn(gp, gp));
  }
  return g2;
}

// The chunk cross test of member block b against the receiver chunks
// s_rt (8 x 8 floats) with density thresholds s_td2 (squared).
template <bool DISP>
__device__ __forceinline__ void member_test(const Args& a, int b,
                                            const float* s_rt,
                                            const float* s_td2, bool& kd,
                                            bool& kx) {
  const float4* cj4 = reinterpret_cast<const float4*>(a.ctab) + (size_t)b * 16;
  for (int mc = 0; mc < NCHUNK && !(kd && (kx || !DISP)); ++mc) {
    const float4 c0 = __ldg(cj4 + 2 * mc);
    const float4 c1 = __ldg(cj4 + 2 * mc + 1);
    const float cj[7] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z};
#pragma unroll
    for (int rc = 0; rc < NCHUNK; ++rc) {
      const float* ri = s_rt + rc * 8;
      const float g2 = hull_gap2(ri, cj, a.box, a.inv_box);
      kd = kd || g2 <= s_td2[rc];
      if (DISP) {
        const float tx = __fadd_rn(
            __fmul_rn(__fmul_rn(0.5f, __fadd_rn(ri[7], cj[6])), a.box),
            a.infl);
        kx = kx || g2 <= __fmul_rn(tx, tx);
      }
    }
  }
}

// Stage 1: test every listed member of row `row`, and write the kept
// members' list positions, in list order, into list_u (either consumer,
// with KEEP_D / KEEP_X flags) and list_d (density).  Every thread runs the
// same trip count, so ballots and barriers are uniform.
template <bool DISP>
__device__ void build_lists(const Args& a, const int* row, int n_mem,
                            const float* s_rt, const float* s_td2,
                            int* s_wc, unsigned short* list_u,
                            unsigned short* list_d, int& n_u, int& n_d,
                            int& n_listed) {
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const unsigned lt = (1u << (tid & 31)) - 1u;
  n_u = n_d = n_listed = 0;
  for (int base = 0, pass = 0; base < n_mem; base += NT, ++pass) {
    const int m = base + tid;
    bool valid = false, kd = false, kx = false;
    if (m < n_mem) {
      const int sb = __ldg(row + (m >> 3));
      const int b = sb * SUPER + (m & 7);
      valid = sb >= 0 && b < a.nb;
      if (valid) {
        if (a.prune) {
          member_test<DISP>(a, b, s_rt, s_td2, kd, kx);
        } else {
          kd = true;
          kx = DISP;
        }
      }
    }
    const bool ku = kd || kx;
    const unsigned bu = __ballot_sync(0xffffffffu, ku);
    const unsigned bd = __ballot_sync(0xffffffffu, kd);
    const unsigned bv = __ballot_sync(0xffffffffu, valid);
    // warp totals, double-buffered by pass parity: one barrier a pass
    int* wc = s_wc + (pass & 1) * NWARP * 3;
    if ((tid & 31) == 0) {
      wc[w * 3 + 0] = __popc(bu);
      wc[w * 3 + 1] = __popc(bd);
      wc[w * 3 + 2] = __popc(bv);
    }
    __syncthreads();
    int ou = n_u, od = n_d;
    for (int v = 0; v < NWARP; ++v) {
      if (v < w) {
        ou += wc[v * 3 + 0];
        od += wc[v * 3 + 1];
      }
      n_u += wc[v * 3 + 0];
      n_d += wc[v * 3 + 1];
      n_listed += wc[v * 3 + 2];
    }
    if (ku)
      list_u[ou + __popc(bu & lt)] = static_cast<unsigned short>(
          m | (kd ? KEEP_D : 0u) | (kx ? KEEP_X : 0u));
    if (kd) list_d[od + __popc(bd & lt)] = static_cast<unsigned short>(m);
  }
  __syncthreads();
}

// Receiver lane state of a row: coordinates, metric hsml, list row.
struct Lane {
  float x0, x1, x2, hmi;
  const int* row;
  float* part;  // (SPLIT, 5, 128) partial sums of the SPLIT parts
};

// Copy member entry `e` of the list into ring slot `slot` (threads < 128
// each copy one source, 16 bytes, of the 2 KB block).
__device__ __forceinline__ void start_copy(const Args& a, const Lane& ln,
                                           float* ring, unsigned e,
                                           int slot) {
  const int t = threadIdx.x;
  if (t >= BLOCK) return;
  const int m = e & POS_MASK;
  const int b = __ldg(ln.row + (m >> 3)) * SUPER + (m & 7);
  cp_async16(ring + slot * SRC_FLOATS + 4 * t,
             a.src + (size_t)b * SRC_FLOATS + 4 * t);
}

// Pairs of one receiver lane with the sources j0 .. j0 + NJ - 1 of a
// staged member: DENS accumulates the density sums, DPART (sweep 0 only)
// the displacement; WRAP wraps each separation (rows not flagged).
template <int KIND, bool UNION, bool DENS, bool DPART, bool WRAP, int NJ>
__device__ __forceinline__ void member_pairs(const float4* sm, int j0,
                                             const Lane& ln,
                                             float h, float inv_h,
                                             float inv_h2, float box,
                                             float inv_box, float& bw,
                                             float& brdw, float& bx,
                                             float& by, float& bz) {
  const float half_box = 0.5f * box;
  for (int j = j0; j < j0 + NJ; ++j) {
    const float4 q = sm[j];  // one broadcast load per pair
    const float hj = q.w;
    if (!(hj > 0.0f)) continue;
    float dx = ln.x0 - q.x;
    float dy = ln.x1 - q.y;
    float dz = ln.x2 - q.z;
    if (WRAP) {
      dx -= box * rintf(dx * inv_box);
      dy -= box * rintf(dy * inv_box);
      dz -= box * rintf(dz * inv_box);
    }
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (UNION) {
      const float inv_r = rsqrtf(fmaxf(r2, 1e-30f));
      const float r = r2 * inv_r;
      if (DENS) dens_pair<KIND>(KIND == WC6 ? r * inv_h : r, h, bw, brdw);
      if (DPART) {
        const float hbar = (ln.hmi + hj) * half_box;
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
      }
    } else if (KIND == WC6) {
      const float q = r2 * inv_h2;
      if (q < 1.0f) dens_pair<KIND>(sqrtf(q), h, bw, brdw);
    } else {
      dens_pair<KIND>(sqrtf(r2), h, bw, brdw);
    }
  }
}

// One stream over the members of `list`.  UNION (sweep 0 with do_disp)
// also accumulates the displacement of the members flagged KEEP_X.  Sums
// are two-level: over the 128 sources of a member, then across members.
template <int KIND, bool UNION, bool WRAP>
__device__ void stream_pass(const Args& a, const Lane& ln, float* ring,
                            const unsigned short* list, int n_list, float h,
                            float& aw, float& ardw, float* disp) {
  constexpr int NJ = BLOCK / SPLIT;
  const int t = threadIdx.x;
  const int j0 = (t / BLOCK) * NJ;
  const float box = a.box;
  const float inv_box = 1.0f / box;
  const float inv_h = 1.0f / h;
  const float inv_h2 = 1.0f / (h * h);
  aw = 0.0f;
  ardw = 0.0f;
  float dax = 0.0f, day = 0.0f, daz = 0.0f;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < n_list) start_copy(a, ln, ring, list[k], k);
    cp_async_commit();
  }
  for (int k = 0; k < n_list; ++k) {
    const float4* sm =
        reinterpret_cast<const float4*>(ring + (k % STAGES) * SRC_FLOATS);
    cp_async_wait<STAGES - 2>();  // this thread's piece of member k landed
    // member k visible to all; every thread is done with member k - 1,
    // whose slot the next copy reuses
    __syncthreads();
    if (k + STAGES - 1 < n_list)
      start_copy(a, ln, ring, list[k + STAGES - 1],
                 (k + STAGES - 1) % STAGES);
    cp_async_commit();
    float bw = 0.0f, brdw = 0.0f, bx = 0.0f, by = 0.0f, bz = 0.0f;
    if (UNION) {
      const unsigned e = list[k];
      if ((e & KEEP_D) && (e & KEEP_X))
        member_pairs<KIND, true, true, true, WRAP, NJ>(
            sm, j0, ln, h, inv_h, inv_h2, box, inv_box, bw, brdw, bx, by,
            bz);
      else if (e & KEEP_D)
        member_pairs<KIND, true, true, false, WRAP, NJ>(
            sm, j0, ln, h, inv_h, inv_h2, box, inv_box, bw, brdw, bx, by,
            bz);
      else
        member_pairs<KIND, true, false, true, WRAP, NJ>(
            sm, j0, ln, h, inv_h, inv_h2, box, inv_box, bw, brdw, bx, by,
            bz);
      if (e & KEEP_D) {
        aw += bw;
        ardw += brdw;
      }
      if (e & KEEP_X) {
        dax += bx;
        day += by;
        daz += bz;
      }
    } else {
      member_pairs<KIND, false, true, false, WRAP, NJ>(
          sm, j0, ln, h, inv_h, inv_h2, box, inv_box, bw, brdw, bx, by, bz);
      aw += bw;
      ardw += brdw;
    }
  }
  // the ring is free for the next pass
  __syncthreads();
  // the parts' sums of each lane, added in a fixed order
  const int li = t % BLOCK;
  float v[5] = {aw, ardw, dax, day, daz};
  constexpr int NQ = UNION ? 5 : 2;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    ln.part[((t / BLOCK) * 5 + q) * BLOCK + li] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    v[q] = ln.part[q * BLOCK + li];
#pragma unroll
    for (int p = 1; p < SPLIT; ++p) v[q] += ln.part[(p * 5 + q) * BLOCK + li];
  }
  aw = v[0];
  ardw = v[1];
  dax = v[2];
  day = v[3];
  daz = v[4];
  if (UNION) {
    disp[0] = dax;
    disp[1] = day;
    disp[2] = daz;
  }
}

template <int KIND, bool UNION>
__device__ __forceinline__ void pass(const Args& a, const Lane& ln,
                                     bool safe, float* ring,
                                     const unsigned short* list, int n_list,
                                     float h, float& aw, float& ardw,
                                     float* disp) {
  if (safe)
    stream_pass<KIND, UNION, false>(a, ln, ring, list, n_list, h, aw, ardw,
                                    disp);
  else
    stream_pass<KIND, UNION, true>(a, ln, ring, list, n_list, h, aw, ardw,
                                   disp);
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
__global__ void __launch_bounds__(NT) stream_wvt_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  unsigned short* list_u =
      reinterpret_cast<unsigned short*>(ring + STAGES * SRC_FLOATS);
  unsigned short* list_d = list_u + a.M * SUPER;
  __shared__ float s_rt[NCHUNK * 8];
  __shared__ float s_td2[NCHUNK];
  __shared__ int s_wc[2 * NWARP * 3];
  __shared__ float s_part[SPLIT * 5 * BLOCK];

  const int s = a.order[blockIdx.x];
  const int t = threadIdx.x;
  const int i = t % BLOCK;
  const size_t lane = (size_t)s * BLOCK + i;
  const bool safe = a.flag[s] != 0;
  Lane ln;
  ln.x0 = a.xi[((size_t)s * 3 + 0) * BLOCK + i];
  ln.x1 = a.xi[((size_t)s * 3 + 1) * BLOCK + i];
  ln.x2 = a.xi[((size_t)s * 3 + 2) * BLOCK + i];
  ln.hmi = a.hm_i[lane];
  ln.row = a.cand + (size_t)s * a.M;
  ln.part = s_part;
  const float cap = a.cap[lane];
  const int n_mem = max(min(a.cnt[s], a.M), 0) * SUPER;

  if (t < NCHUNK * 8) s_rt[t] = a.rtab[(size_t)s * NCHUNK * 8 + t];
  __syncthreads();
  if (t < NCHUNK) {
    const float td = __fadd_rn(s_rt[t * 8 + 6], a.infl);
    s_td2[t] = __fmul_rn(td, td);
  }
  __syncthreads();
  int n_u, n_d, n_listed;
  build_lists<DISP>(a, ln.row, n_mem, s_rt, s_td2, s_wc, list_u, list_d, n_u,
                    n_d, n_listed);

  const float h0c = fminf(a.h0[lane], cap);
  float aw, ardw;
  float disp[3] = {0.0f, 0.0f, 0.0f};
  // sweep 0: the union pass (density at h0 + displacement) or density
  if (DISP)
    pass<KIND, true>(a, ln, safe, ring, list_u, n_u, h0c, aw, ardw, disp);
  else
    pass<KIND, false>(a, ln, safe, ring, list_d, n_d, h0c, aw, ardw, nullptr);
  Solve st{h0c, h0c, 0.0f, cap, 0.0f};
  update<KIND>(a, st, aw, ardw, cap);
  int sweeps = 1;
  for (int k = 1; k < a.n_sweeps; ++k) {
    // block-coupled termination: sweep again unless every lane is done
    if (__syncthreads_and(st.done > 0.5f)) break;
    pass<KIND, false>(a, ln, safe, ring, list_d, n_d, st.h, aw, ardw,
                      nullptr);
    update<KIND>(a, st, aw, ardw, cap);
    ++sweeps;
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
  if (t >= BLOCK) return;
  float* o = a.out + lane * 8;
  o[0] = rho_out;
  o[1] = h;
  o[2] = 1.0f / (1.0f + h / (3.0f * fmaxf(rho, 1e-30f)) * drho);
  o[3] = wk;
  o[4] = (st.done > 0.5f || now_done) ? 1.0f : 0.0f;
  const float dnorm = ln.hmi * (KIND == M4 ? 1.0f : WC6_NORM);
  o[5] = DISP ? dnorm * disp[0] : 0.0f;
  o[6] = DISP ? dnorm * disp[1] : 0.0f;
  o[7] = DISP ? dnorm * disp[2] : 0.0f;
  if (a.stats != nullptr && t == 0) {
    int* so = a.stats + (size_t)s * 4;
    so[0] = sweeps;
    so[1] = n_u;
    so[2] = n_d;
    so[3] = n_listed;
  }
}

template <int KIND, bool DISP>
int launch(const Args& a, int S, cudaStream_t st) {
  const size_t smem = (size_t)STAGES * SRC_FLOATS * sizeof(float) +
                      (size_t)2 * a.M * SUPER * sizeof(unsigned short);
  const cudaError_t e =
      cudaFuncSetAttribute(stream_wvt_kernel<KIND, DISP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  stream_wvt_kernel<KIND, DISP><<<S, NT, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stream_wvt_launch(
    const float* src, const int* cand, const int* cnt, const float* xi,
    const float* h0, const float* cap, const float* hm_i, const float* ctab,
    const float* rtab, const int* flag, const int* order, float* out,
    int* stats, int S, int M, int nb, int kind, int do_disp, int n_sweeps,
    int prune, float mpart, float box, float inv_box, float infl,
    float desnngb, float spec_win, float rho_corr, void* stream) {
  if (S <= 0) return 0;
  if (M * SUPER > MAX_MEMBERS) return static_cast<int>(cudaErrorInvalidValue);
  Args a{src,   cand,  cnt, xi,    h0,      cap,      hm_i,   ctab,
         rtab,  flag,  order, out, stats,   M,        nb,     n_sweeps,
         prune, mpart, box, inv_box, infl,  desnngb,  spec_win, rho_corr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == M4)
    return do_disp ? launch<M4, true>(a, S, st) : launch<M4, false>(a, S, st);
  return do_disp ? launch<WC6, true>(a, S, st) : launch<WC6, false>(a, S, st);
}
