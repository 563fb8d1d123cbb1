// The WVT loop's model density in one launch: every gas-bearing halo's
// beta model at every gas lane and the max over the halos, hand-written
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's global_density_model
// (toycluster_tpu/models/sph.py) is a lax.fori_loop over the halos of XLA
// elementwise ops.  The port's plain version, which a CPU tensor still
// runs, is the per-halo PyTorch loop of ops/density_model.py
// (_density_model_reference), some 13 device ops over all lanes a halo.
//
// For lane i at box position x_i and halo j of the packed table (the
// wrapper's model_table: centre c_j = d_com_j + box/2, rcut, rcore, rho0,
// the exponent e_j = -1.5 beta_j, the cool-core bit, rho0 rho0_fac and
// rcore / rc_fac):
//
//   r = |x_i - c_j|,  taper = 1 + (r / rcut)^4,  x2 = 1 + (r / rcore)^2
//   rho_j = rho0 x2^e_j / taper          (1 / x2 in place of the power
//                                         where the static beta is 2/3)
//   rho_j += cuspy (rho0 rho0_fac) / (1 + (r / (rcore / rc_fac))^2) / taper
//                                        (cool cores only)
//   rho_i = max(0, rho_0, rho_1, ...)    (in table order, NaN kept)
//
// Every op is the float32 op of the plain version, with round-to-nearest
// and no contraction (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn), so
// that the result is PyTorch's bit for bit: its vector_norm over a last
// axis of three squares each component and adds (x^2 + z^2) + y^2 (two
// threads, as its sum does); ** 4 is powf(t, 4), ** 2 is t * t, a tensor
// power is powf, and 1.0 / x2 is reciprocal (1 / x2) times 1.  The
// powers cannot be had cheaper: PyTorch's powf(t, 4) is not the
// correctly rounded t^4 (t^2 squared in double differs on 1.6% of all
// floats t >= 0), nor powf(x, -1) the correctly rounded 1 / x (6% of x
// >= 1); this file's powf is PyTorch's on every float checked.  The terms
// built from Python floats (the centre, the exponent of a static beta,
// the cool-core factors) are computed by the wrapper with the same
// PyTorch ops and arrive in the table.
//
// Work: one thread a lane, grid-stride over tiles of NT lanes; a tile's
// positions come in as float4 loads through shared memory where the
// array is 16-byte aligned.  The table is staged in shared memory CHUNK
// halos at a time; each lane keeps its max in a register and writes it
// once.  No distance cut-off: every halo is evaluated at every lane.
//
// What bounds it: fp32 instruction issue.  On an H100, 5e7 lanes x 72
// halos take ~34.5 ms, ~285 issue slots a lane-halo, most of them the
// two powf (the taper's and the beta model's), besides a square root and
// three to five IEEE divisions; the memory traffic is one read of the
// positions (12 B a lane) and one write (4 B a lane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads (lanes) a CTA
constexpr int CHUNK = 256;    // halos a shared-memory stage
constexpr int COLS = 10;      // floats a halo in the table
// the table's columns (ops/density_model.py COLUMNS)
enum { CX, CY, CZ, RCUT, RCORE, RHO0, EXPO, CUSPY, RHO_CC, RC_CC };

// torch.maximum: NaN wins, else the larger
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

template <bool RECIP, bool COOL>
__global__ void __launch_bounds__(NT)
density_model_kernel(const float* __restrict__ pos,
                     const float* __restrict__ tab, float* __restrict__ rho,
                     int n, int H, int aligned) {
  __shared__ float sp[3 * NT];
  __shared__ float st[CHUNK * COLS];
  const int tid = threadIdx.x;
  for (long long base = (long long)blockIdx.x * NT; base < n;
       base += (long long)gridDim.x * NT) {
    const int live = (int)min((long long)NT, n - base);
    const float* src = pos + 3 * base;
    __syncthreads();
    if (aligned && live == NT) {
      if (tid < 3 * NT / 4)
        reinterpret_cast<float4*>(sp)[tid] =
            reinterpret_cast<const float4*>(src)[tid];
    } else {
      for (int k = tid; k < 3 * live; k += NT) sp[k] = src[k];
    }
    __syncthreads();
    // lanes past n read stale positions, compute and write nothing
    const float x = sp[3 * tid], y = sp[3 * tid + 1], z = sp[3 * tid + 2];
    float m = 0.0f;
    for (int h0 = 0; h0 < H; h0 += CHUNK) {
      const int nh = min(CHUNK, H - h0);
      __syncthreads();
      for (int k = tid; k < nh * COLS; k += NT) st[k] = tab[h0 * COLS + k];
      __syncthreads();
      for (int j = 0; j < nh; ++j) {
        const float* t = st + j * COLS;
        const float dx = __fsub_rn(x, t[CX]);
        const float dy = __fsub_rn(y, t[CY]);
        const float dz = __fsub_rn(z, t[CZ]);
        const float r = __fsqrt_rn(__fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)),
            __fmul_rn(dy, dy)));
        const float taper =
            __fadd_rn(1.0f, powf(__fdiv_rn(r, t[RCUT]), 4.0f));
        const float q = __fdiv_rn(r, t[RCORE]);
        const float x2 = __fadd_rn(1.0f, __fmul_rn(q, q));
        const float xp = RECIP ? __fdiv_rn(1.0f, x2) : powf(x2, t[EXPO]);
        float v = __fdiv_rn(__fmul_rn(t[RHO0], xp), taper);
        if (COOL) {
          const float qc = __fdiv_rn(r, t[RC_CC]);
          const float cc = __fdiv_rn(
              __fdiv_rn(t[RHO_CC], __fadd_rn(1.0f, __fmul_rn(qc, qc))),
              taper);
          v = __fadd_rn(v, __fmul_rn(t[CUSPY], cc));
        }
        m = nan_max(m, v);
      }
    }
    if (tid < live) rho[base + tid] = m;
  }
}

template <bool RECIP, bool COOL>
int launch(const float* pos, const float* tab, float* rho, int n, int H,
           int aligned, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = ((long long)n + NT - 1) / NT;
  const int grid = (int)min(tiles, (long long)max(sms, 1) * 8);
  density_model_kernel<RECIP, COOL><<<grid, NT, 0, stream>>>(
      pos, tab, rho, n, H, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pos: (n, 3) float32 box positions; tab: (H, 10) float32 (the columns
// above); rho: (n,) float32.  recip: 1 where the static beta is 2/3 (1 /
// x2 in place of the power); cool: 1 with the cool-core term.
extern "C" int density_model_launch(const float* pos, const float* tab,
                                    float* rho, int n, int H, int recip,
                                    int cool, void* stream) {
  if (n <= 0) return 0;
  if (H < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = (reinterpret_cast<uintptr_t>(pos) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (recip)
    return cool ? launch<true, true>(pos, tab, rho, n, H, aligned, s)
                : launch<true, false>(pos, tab, rho, n, H, aligned, s);
  return cool ? launch<false, true>(pos, tab, rho, n, H, aligned, s)
              : launch<false, false>(pos, tab, rho, n, H, aligned, s);
}
