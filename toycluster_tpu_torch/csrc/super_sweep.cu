// The superblock sweep of the stream engine's candidate search in one
// launch: box distances, hit counts and each row's nearest-k selection,
// hand-written for Hopper (sm_90a).
//
// Replaces the chunked PyTorch ops of ops/blocks.py _super_sweep (the
// plain version, which a CPU tensor still runs), themselves the JAX
// package's XLA sweep _find_candidates_super_k with jax.lax.top_k
// (toycluster_tpu/ops/blocks.py).  No Pallas kernel has this role: on the
// TPU the sweep is XLA.
//
// For each receiver row r of rec_ids (block b = rec_ids[r], -1 a padded
// row with no hits) and every superblock j, under the periodic minimum
// image, with the rounding of each PyTorch op:
//
//   c = (lo + hi) / 2, w = (hi - lo) / 2 (receiver block, superblock)
//   d = c_b - c_j;  d -= box * rint(d * inv_box);  g = max(|d| - w_b - w_j, 0)
//   d2 = (g_x^2 + g_z^2) + g_y^2
//   hit when d2 <= max(radius_b, (sym_b + sym_j) / 2)^2
//
// (sym_j the largest radius_sym of the superblock's members); count[r]
// is the row's hits, idx[r] its k = min(max_cand, ns) nearest hits by the
// 64-bit key (bits of d2) << 32 | j, nearest first, ties to the lower id,
// -1 past them, and most = (max count, rows spilled).  Every op is IEEE
// single precision with round-to-nearest and no contraction (__fadd_rn,
// __fmul_rn): d2 and the range are PyTorch's bit for bit, and so the
// lists.  Two of PyTorch's CUDA roundings are not the obvious ones, and
// the card tests hold both: its division of a tensor by a Python float
// multiplies by the float reciprocal (inv_box here), and its sum over a
// last axis of three runs on two threads, the first adding x and z, the
// second's y added last.
//
// Work: a CTA of NT threads takes NT / S rows, S threads a row (S, a
// power of two, from the rows and k: ops/blocks.py _sweep_splits), and
// streams the superblocks (centre and sym, half-width and 0: two float4
// each, precomputed once a sweep) through shared memory TILE at a time.
// A hit goes to its row's slice of the CTA's on-chip key buffer (CAP
// keys, row_cap = CAP * S / NT a row); the count is exact whatever the
// slice holds.  A row whose hits fit is ranked in place (each key's rank
// among its row's keys is its column).  A row over its slice "spills":
// the whole CTA sweeps it again alone, collecting its hits into the
// CAP-key buffer and sorting them (bitonic); where they exceed the
// buffer, each time it fills it is sorted and cut to its k smallest
// keys, and from then on only keys below the k-th are admitted.  Where
// k + NT exceeds CAP that buffer is the CTA's slice of a scratch array
// the wrapper allocates.  Atomics fill the buffers in any order; the
// final order is the keys', a total order, so a rerun is bit-identical.
//
// What bounds it: fp32 arithmetic, ~35 operations a box test (three
// axes of difference, wrap, gap and square, the sum, the range and the
// compare), T x ns tests: 1.9e10 at 1e8 particles (390,625 rows x
// 48,829 superblocks), 6.7e11 operations, ~10 ms at 67 TFLOP/s.  The
// superblocks (ns x 32 B, 1.6 MB at 1e8) stay in L2 and shared memory;
// the lists (T x max_cand x 4 B, 0.4 GB at 1e8 and width 256) are written
// once.  No (T, ns) array exists in device memory, and the selection
// runs on chip.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;       // threads a CTA
constexpr int TILE = 256;     // superblocks a shared-memory tile
constexpr u64 NONE = ~0ull;   // the key of a miss; sorts past every hit

struct Row {
  float cx, cy, cz, wx, wy, wz, rad, sym;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ lo,
                                        const float* __restrict__ hi,
                                        const float* __restrict__ radius,
                                        const float* __restrict__ sym,
                                        int b) {
  const float* l = lo + 3 * (size_t)b;
  const float* h = hi + 3 * (size_t)b;
  Row w;
  w.cx = __fmul_rn(0.5f, __fadd_rn(l[0], h[0]));
  w.cy = __fmul_rn(0.5f, __fadd_rn(l[1], h[1]));
  w.cz = __fmul_rn(0.5f, __fadd_rn(l[2], h[2]));
  w.wx = __fmul_rn(0.5f, __fsub_rn(h[0], l[0]));
  w.wy = __fmul_rn(0.5f, __fsub_rn(h[1], l[1]));
  w.wz = __fmul_rn(0.5f, __fsub_rn(h[2], l[2]));
  w.rad = radius[b];
  w.sym = sym[b];
  return w;
}

__device__ __forceinline__ float gap2(float c1, float c2, float w,
                                      float box, float inv) {
  float d = __fsub_rn(c1, c2);
  d = __fsub_rn(d, __fmul_rn(box, rintf(__fmul_rn(d, inv))));
  const float g = fmaxf(__fsub_rn(fabsf(d), w), 0.0f);
  return __fmul_rn(g, g);
}

// the key of superblock j (c: centre and sym, h: half-width) for row w,
// or NONE where it misses
__device__ __forceinline__ u64 box_key(const Row& w, float4 c, float4 h,
                                       int j, float box, float inv) {
  const float d2 = __fadd_rn(
      __fadd_rn(gap2(w.cx, c.x, __fadd_rn(w.wx, h.x), box, inv),
                gap2(w.cz, c.z, __fadd_rn(w.wz, h.z), box, inv)),
      gap2(w.cy, c.y, __fadd_rn(w.wy, h.y), box, inv));
  const float rng = fmaxf(w.rad, __fmul_rn(0.5f, __fadd_rn(w.sym, c.w)));
  if (!(d2 <= __fmul_rn(rng, rng))) return NONE;
  return (static_cast<u64>(__float_as_uint(d2)) << 32) |
         static_cast<unsigned>(j);
}

// ascending bitonic sort of b[0, n) by the whole CTA, over the next
// power of two with NONE past n; begins and ends with a barrier
__device__ void cta_sort(u64* b, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + threadIdx.x; i < p; i += NT) b[i] = NONE;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (p >> 1); i += NT) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const u64 x = b[lo], y = b[hi];
        if ((x > y) == ((lo & size) == 0)) {
          b[lo] = y;
          b[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// a spilled row (n hits) swept again by the whole CTA into buffer b of
// capb keys (a power of two): all its hits where they fit, else the k
// nearest kept as the sweep goes (k + NT <= capb); writes its first
// min(n, k) columns
__device__ void spill_row(const Row& w, const float4* __restrict__ sbp,
                          int ns, int k, int n, u64* b, int capb,
                          float box, float inv, int* __restrict__ out,
                          int* fill_s) {
  const bool select = n > capb;
  u64 thr = NONE;   // keys at or past it cannot be among the k nearest
  int fill = 0;     // the same in every thread
  if (threadIdx.x == 0) *fill_s = 0;
  __syncthreads();
  for (int j0 = 0; j0 < ns; j0 += NT) {
    const int j = j0 + threadIdx.x;
    bool take = false;
    u64 key = NONE;
    if (j < ns) {
      key = box_key(w, sbp[2 * j], sbp[2 * j + 1], j, box, inv);
      take = key < thr;
    }
    if (take) b[atomicAdd(fill_s, 1)] = key;
    fill += __syncthreads_count(take);
    if (select && fill > capb - NT) {
      cta_sort(b, fill);
      thr = b[k - 1];
      fill = k;
      if (threadIdx.x == 0) *fill_s = k;
      __syncthreads();
    }
  }
  cta_sort(b, fill);
  const int m = min(fill, k);
  for (int i = threadIdx.x; i < m; i += NT)
    out[i] = static_cast<int>(static_cast<unsigned>(b[i]));
  __syncthreads();
}

__global__ void __launch_bounds__(NT) super_sweep_kernel(
    const float* __restrict__ bb_lo, const float* __restrict__ bb_hi,
    const float4* __restrict__ sbp, const int* __restrict__ rec_ids,
    const float* __restrict__ radius, const float* __restrict__ radius_sym,
    int* __restrict__ idx, int* __restrict__ count, int* __restrict__ most,
    u64* __restrict__ scratch, int ns, int T, int max_cand, int k,
    int splits, int cap, int capg, float box, float inv) {
  extern __shared__ u64 smem[];
  u64* buf = smem;                                      // cap keys
  float4* tile = reinterpret_cast<float4*>(smem + cap);  // 2 x TILE
  __shared__ int n_row[NT];
  __shared__ int cta_max, cta_spills, fill_s;

  const int rpc = NT / splits;
  const int row_cap = cap / rpc;
  const int slot = threadIdx.x / splits;
  const int part = threadIdx.x % splits;
  const int r0 = blockIdx.x * rpc;
  const int r = r0 + slot;
  const int rec = r < T ? rec_ids[r] : -1;
  Row w{};
  if (rec >= 0) w = load_row(bb_lo, bb_hi, radius, radius_sym, rec);
  if (threadIdx.x < rpc) n_row[threadIdx.x] = 0;
  if (threadIdx.x == 0) cta_max = cta_spills = 0;
  u64* mine = buf + (size_t)slot * row_cap;

  // every row against every superblock, TILE at a time
  for (int j0 = 0; j0 < ns; j0 += TILE) {
    const int nt = min(TILE, ns - j0);
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * nt; i += NT) tile[i] = sbp[2 * j0 + i];
    __syncthreads();
    if (rec >= 0) {
#pragma unroll 4
      for (int i = part; i < nt; i += splits) {
        const u64 key = box_key(w, tile[2 * i], tile[2 * i + 1], j0 + i,
                                box, inv);
        if (key != NONE) {
          const int p = atomicAdd(&n_row[slot], 1);
          if (p < row_cap) mine[p] = key;
        }
      }
    }
  }
  __syncthreads();

  // rows whose hits fit their slice: a key's rank is its column
  for (int f = threadIdx.x; f < rpc * row_cap; f += NT) {
    const int s = f / row_cap, p = f - s * row_cap;
    const int n = n_row[s];
    if (n > row_cap || p >= n) continue;
    const u64* row = buf + (size_t)s * row_cap;
    const u64 key = row[p];
    int rank = 0;
    for (int q = 0; q < n; ++q) rank += row[q] < key;
    if (rank < k)
      idx[(size_t)(r0 + s) * max_cand + rank] =
          static_cast<int>(static_cast<unsigned>(key));
  }
  // counts, -1 past each row's min(n, k) columns, the CTA's maxima
  if (part == 0 && r < T) {
    const int n = n_row[slot];
    count[r] = n;
    atomicMax(&cta_max, n);
    if (n > row_cap) atomicAdd(&cta_spills, 1);
  }
  const int rows = min(rpc, T - r0);
  for (int f = threadIdx.x; f < rows * max_cand; f += NT) {
    const int s = f / max_cand, c = f - s * max_cand;
    if (c >= min(n_row[s], k)) idx[(size_t)r0 * max_cand + f] = -1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicMax(&most[0], cta_max);
    if (cta_spills) atomicAdd(&most[1], cta_spills);
  }

  // the spilled rows, one at a time by the whole CTA
  for (int s = 0; s < rows; ++s) {
    const int n = n_row[s];
    if (n <= row_cap) continue;
    const Row v = load_row(bb_lo, bb_hi, radius, radius_sym,
                           rec_ids[r0 + s]);
    const bool wide = n > cap && k + NT > cap;
    spill_row(v, sbp, ns, k, n,
              wide ? scratch + (size_t)blockIdx.x * capg : buf,
              wide ? capg : cap, box, inv,
              idx + (size_t)(r0 + s) * max_cand, &fill_s);
  }
}

}  // namespace

// bb_lo, bb_hi: (nb, 3) float32 block boxes; sbp: (ns, 8) float32, each
// superblock's centre, sym, half-width and 0; rec_ids: (T,) int32;
// radius, radius_sym: (nb,) float32; idx: (T, max_cand) int32; count:
// (T,) int32; most: (2,) int32, zeroed; scratch: (grid, capg) int64 or
// null where k + NT <= cap; cap: the on-chip buffer's keys, a power of
// two; splits: threads a row, a power of two <= NT.
extern "C" int super_sweep_launch(
    const float* bb_lo, const float* bb_hi, const float* sbp,
    const int* rec_ids, const float* radius, const float* radius_sym,
    int* idx, int* count, int* most, unsigned long long* scratch, int ns,
    int T, int max_cand, int k, int splits, int cap, int capg, float box,
    float inv, void* stream) {
  if (T <= 0) return 0;
  if (splits < 1 || splits > NT || NT % splits || cap % (NT / splits) ||
      (k + NT > cap && (scratch == nullptr || k + NT > capg)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpc = NT / splits;
  const int grid = (T + rpc - 1) / rpc;
  const size_t smem = (size_t)cap * sizeof(u64) + 2 * TILE * sizeof(float4);
  const cudaError_t e = cudaFuncSetAttribute(
      super_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  super_sweep_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      bb_lo, bb_hi, reinterpret_cast<const float4*>(sbp), rec_ids, radius,
      radius_sym, idx, count, most, scratch, ns, T, max_cand, k, splits, cap,
      capg, box, inv);
  return static_cast<int>(cudaGetLastError());
}
