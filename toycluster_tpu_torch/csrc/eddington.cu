// The Eddington integral of every halo's f(E) table in one launch, in
// float64, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds the f(E) tables on the
// host in NumPy (toycluster_tpu/models/eddington.py
// _exact_eddington_integral), one halo at a time.  The port's velocity
// stage computes the same closed form here for all H halos at once
// (ops/eddington.py; plain version _eddington_integral_reference):
//
//   I(E) = 2 m2_0 sqrt((E - x_0)_+) + (4/3) sum_k d_k ((E - x_k)_+)^(3/2)
//   c1_k = (m2_{k+1} - m2_k) / (x_{k+1} - x_k),  d_0 = c1_0,
//   d_k = c1_k - c1_{k-1},  k = 0 .. K-2
//
// over a halo's K ascending psi knots x and the rho(psi) spline's second
// derivatives m2 there, for each of its M energies E.
//
// Work: a CTA takes ROWS energies of one halo, one a thread.  Each thread
// finds by bisection the knots below its E (x ascends; a knot at or above
// E adds an exact zero), and the CTA walks the knots below its largest E,
// staging (x_k, d_k) through shared memory CHUNK knots at a time; the
// CTA computes c1 and d itself from x and m2 with the same IEEE float64
// operations as NumPy's diff and divide, so no (H, M, K) array exists
// anywhere.  Each thread sums its terms in knot order, so a rerun is
// bit-identical.  IEEE float64 sqrt and division throughout (no fast
// math).
//
// What bounds it: float64 arithmetic, a sqrt and three multiply-adds a
// term, about half of the H x M x (K-1) terms (those with x_k < E); the
// inputs (H x (2K + M) doubles, ~4 MB at 51 halos) are read once from
// device memory by each of a halo's M / ROWS CTAs.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 128;     // energies (threads) a CTA
constexpr int CHUNK = 2048;   // knots staged a pass: 32 KB of (x, d)

__global__ void __launch_bounds__(ROWS)
eddington_kernel(const double* __restrict__ x, const double* __restrict__ m2,
                 const double* __restrict__ E, double* __restrict__ out,
                 int* __restrict__ terms, int K, int M) {
  __shared__ double sx[CHUNK];
  __shared__ double sd[CHUNK];
  __shared__ int cta_end;
  const int h = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x;
  const double* xh = x + static_cast<size_t>(h) * K;
  const double* mh = m2 + static_cast<size_t>(h) * K;
  const bool live = row < M;
  const double e = live ? E[static_cast<size_t>(h) * M + row] : 0.0;

  // the knots k < K-1 with x_k < e are 0 .. end-1
  int end = 0;
  if (live) {
    int hi = K - 1;
    while (end < hi) {
      const int mid = (end + hi) >> 1;
      if (xh[mid] < e) end = mid + 1;
      else hi = mid;
    }
  }
  if (threadIdx.x == 0) cta_end = 0;
  __syncthreads();
  atomicMax(&cta_end, end);
  __syncthreads();
  const int n_all = cta_end;

  double acc = 0.0;
  for (int c0 = 0; c0 < n_all; c0 += CHUNK) {
    const int n = min(CHUNK, n_all - c0);
    for (int j = threadIdx.x; j < n; j += ROWS) {
      const int k = c0 + j;
      const double c1 = (mh[k + 1] - mh[k]) / (xh[k + 1] - xh[k]);
      sx[j] = xh[k];
      sd[j] = k == 0 ? c1 : c1 - (mh[k] - mh[k - 1]) / (xh[k] - xh[k - 1]);
    }
    __syncthreads();
    const int mine = min(n, end - c0);
    for (int j = 0; j < mine; ++j) {
      const double s = e - sx[j];
      acc += (s * sqrt(s)) * sd[j];
    }
    __syncthreads();
  }
  if (live) {
    const double s0 = fmax(e - xh[0], 0.0);
    out[static_cast<size_t>(h) * M + row] =
        2.0 * mh[0] * sqrt(s0) + (4.0 / 3.0) * acc;
    terms[static_cast<size_t>(h) * M + row] = end;
  }
}

}  // namespace

// x, m2: (H, K) float64, each row's x ascending; E, out: (H, M) float64;
// terms: (H, M) int32, the knots each energy summed.
extern "C" int eddington_launch(const double* x, const double* m2,
                                const double* E, double* out, int* terms,
                                int H, int K, int M, void* stream) {
  if (H <= 0 || M <= 0) return 0;
  if (K < 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + ROWS - 1) / ROWS, H);
  eddington_kernel<<<grid, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, m2, E, out, terms, K, M);
  return static_cast<int>(cudaGetLastError());
}
