// The contact-trap block W_ct of the power system in one launch: each
// (contact, trap) pair's geometry, its eligibility and its energy-integrated
// WKB transmission, summed in a register over the pair's own energy window.
// It computes what solvers/current.py's plain build computes for the
// integrated block (wkb_block with integrate=True: _pair_dist_m, the ok mask,
// _ct_loop_bound, _wkb_contact_trap in f64), bit for bit:
//
//     W[i, j] = ok ? sum over s < n of exp(E2 > 0 ? q * (E1^1.5 - E2^1.5)
//                                                 : q * E1^1.5)
//                  : 0
//     iv = s * dE_step,  E1 = E0 + iv,  E2 = E1 - dE,  the step taken while iv < dE
//     dE = |cb_a[i] - cb_b[j]|,  q = prefac * ((ang * d) / dE)
//     d = sqrt((dx*dx + dy*dy) + dz*dz), dy and dz folded by rint under PBC
//     ok = mask_a[i] and mask_b[j] and idx_a[i] != idx_b[j]
//          and not (d < nn_dist) and dE > tol
//
// with the terms added one after the other in ascending s, as the plain
// build adds its planes' steps. The plain build runs every pair of a chunk
// of trap columns to the chunk's shared bound (its largest window,
// ceil(dE / dE_step) + 1 capped at ne_max) and adds an exact +0 for each
// step past a pair's own window; a sum >= +0 stays the same bits under +0,
// so stopping at the pair's own window keeps the bits. The pair's own bound
// min(ceil(dE * inv_step) + 1, ne_max) is at most the chunk's, and every
// step at or past it already fails iv < dE, so the steps taken are those of
// the plain build. Each chunk's bound comes out as a by-product: the largest
// pair bound of its columns (atomicMax), min(1, ne_max) where none is ok.
//
// Replaces no Pallas kernel: akmc_tpu runs the integral as a fori_loop to a
// shared bound over XLA-fused planes. Written because PyTorch put each step
// of that loop through device memory: about fifteen elementwise kernels over
// the (contacts x 1,024 traps) plane a step, each reading or writing 100-300
// MB, every pair run to its chunk's largest window.
//
// Bound on this card: f64 issue. A term needs one exp and, where E2 > 0, one
// pow (the library's, as PyTorch calls them), a few f64 operations more; the
// card issues 132 SMs x 64 f64 lanes x 1.98 GHz = 16.7 T f64 instructions a
// second. chip_smoke.py's wkb_kernel phase reads the instructions of a term
// from this kernel's SASS and sets them against the terms the kernel counted.
//
// Design. A block is 32 contacts (the lanes of a warp) x 8 traps (one a
// warp). Contacts run in atom order, which follows the slices, so the CB
// edges of a warp's contacts, and so their windows at one trap, lie close:
// the lanes of a warp leave the loop at nearly the same step. E1^1.5 depends
// on the step alone: the block builds a table of iv, E1 and E1^1.5 for the
// steps it needs (kTable at a time) in shared memory, read by broadcast, so
// a term costs its own exp and, where E2 > 0, its own pow. Nothing but W_ct
// and the chunk bounds is written. Two counters in device memory (the
// module's own, wkb_ct_counts: terms evaluated, lane-steps issued) take one
// add of each block's totals; their ratio is the share of issued lanes that
// did a term.
//
// Rounding: every operation of the chain is spelled with an _rn intrinsic,
// so none is contracted; pow and exp are the CUDA math library's, as
// PyTorch's pow and exp kernels call them. PyTorch builds those with nvcc's
// default -fmad=true, under which the library's pow rounds otherwise than
// under -fmad=false (87 of 20 M values differed in the last bit on the H100,
// exp none), so ops/cuda_build.py builds this source with -fmad=true
// (FMAD_AS_TORCH); no setting contracts an _rn intrinsic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct WkbCtArgs {
  const double* pos_a;            // (R, 3) contact positions [Angstrom]
  const double* pos_b;            // (C, 3) trap positions
  const double* cb_a;             // (R,) CB edge [J]
  const double* cb_b;             // (C,)
  const unsigned char* mask_a;    // (R,) bool
  const unsigned char* mask_b;    // (C,) bool
  const long long* idx_a;         // (R,) atom indices
  const long long* idx_b;         // (C,)
  const double* lattice;          // (3,) [Angstrom]
  double* out;                    // (R, C)
  long long* bounds;              // (ceil(C / chunk),) min(1, ne_max) on entry
  long long R, C, chunk, ne_max;
  double nn_dist, tol, prefac, E0, dE_step, inv_step, ang;
  int pbc;
};

// terms evaluated, lane-steps issued: running totals on this device
__device__ unsigned long long wkb_ct_counts[2];

namespace {

constexpr int kLanes = 32;                    // contacts a block: a warp's lanes
constexpr int kWarps = 8;                     // traps a block: one a warp
constexpr int kThreads = kLanes * kWarps;
constexpr int kTable = 1024;                  // energy steps of the table held at a time
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) wkb_ct(const WkbCtArgs a) {
  __shared__ double t_iv[kTable], t_e1[kTable], t_e1p[kTable];
  __shared__ int block_steps;
  __shared__ unsigned long long block_counts[2];

  const int lane = threadIdx.x & (kLanes - 1), warp = threadIdx.x / kLanes;
  const long long i = static_cast<long long>(blockIdx.x) * kLanes + lane;
  const long long j = static_cast<long long>(blockIdx.y) * kWarps + warp;
  if (threadIdx.x == 0) {
    block_steps = 0;
    block_counts[0] = block_counts[1] = 0ull;
  }

  // the pair: geometry, eligibility, its factor and its bound
  bool ok = false;
  double dE = 0.0, q = 0.0;
  int nb = 0;
  if (i < a.R && j < a.C) {
    const double* pa = a.pos_a + 3 * i;
    const double* pb = a.pos_b + 3 * j;
    const double dx = __dsub_rn(pa[0], pb[0]);
    double dy = __dsub_rn(pa[1], pb[1]);
    double dz = __dsub_rn(pa[2], pb[2]);
    if (a.pbc) {
      const double ly = a.lattice[1], lz = a.lattice[2];
      dy = __ddiv_rn(dy, ly);
      dy = __dmul_rn(__dsub_rn(dy, rint(dy)), ly);
      dz = __ddiv_rn(dz, lz);
      dz = __dmul_rn(__dsub_rn(dz, rint(dz)), lz);
    }
    const double d2 = __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)),
                                __dmul_rn(dz, dz));
    const double d = __dsqrt_rn(d2);
    dE = fabs(__dsub_rn(a.cb_a[i], a.cb_b[j]));
    ok = a.mask_a[i] && a.mask_b[j] && a.idx_a[i] != a.idx_b[j] && !(d < a.nn_dist) &&
         dE > a.tol;
    if (ok) {
      q = __dmul_rn(a.prefac, __ddiv_rn(__dmul_rn(a.ang, d), dE));
      const double w = ceil(__dmul_rn(dE, a.inv_step));   // an integer
      nb = w + 1.0 >= static_cast<double>(a.ne_max) ? static_cast<int>(a.ne_max)
                                                    : static_cast<int>(w) + 1;
    }
  }
  __syncthreads();

  // the block's table length, and each chunk's bound (its columns' largest)
  const unsigned warp_bound = __reduce_max_sync(kFull, static_cast<unsigned>(nb));
  if (lane == 0 && warp_bound > 0) {
    atomicMax(&block_steps, static_cast<int>(warp_bound));
    long long* b = a.bounds + j / a.chunk;
    if (static_cast<long long>(warp_bound) > *reinterpret_cast<volatile long long*>(b))
      atomicMax(b, static_cast<long long>(warp_bound));
  }
  __syncthreads();
  const int steps = block_steps;

  // the pair's terms in ascending s, to its own window
  double acc = 0.0;
  int s = 0;
  bool live = ok;
  for (int c0 = 0; c0 < steps; c0 += kTable) {
    const int c1 = min(c0 + kTable, steps);
    if (c0 > 0) __syncthreads();             // every lane is done with the last table
    for (int k = c0 + threadIdx.x; k < c1; k += kThreads) {
      const double iv = __dmul_rn(static_cast<double>(k), a.dE_step);
      const double e1 = __dadd_rn(a.E0, iv);
      t_iv[k - c0] = iv;
      t_e1[k - c0] = e1;
      t_e1p[k - c0] = pow(e1, 1.5);
    }
    __syncthreads();
    const int end = min(c1, nb);
    for (; live && s < end; ++s) {
      if (!(t_iv[s - c0] < dE)) {
        live = false;
        break;
      }
      const double e2 = __dsub_rn(t_e1[s - c0], dE);
      const double e1p = t_e1p[s - c0];
      const double expo = e2 > 0.0 ? __dmul_rn(q, __dsub_rn(e1p, pow(e2, 1.5)))
                                   : __dmul_rn(q, e1p);
      acc = __dadd_rn(acc, exp(expo));
    }
  }

  // the counters: each warp's terms and its issued lane-steps, once a block
  const unsigned terms = __reduce_add_sync(kFull, static_cast<unsigned>(s));
  const unsigned issued = __reduce_max_sync(kFull, static_cast<unsigned>(s));
  if (lane == 0) {
    atomicAdd(&block_counts[0], static_cast<unsigned long long>(terms));
    atomicAdd(&block_counts[1], static_cast<unsigned long long>(kLanes) * issued);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&wkb_ct_counts[0], block_counts[0]);
    atomicAdd(&wkb_ct_counts[1], block_counts[1]);
  }
  if (i < a.R && j < a.C) a.out[i * a.C + j] = ok ? acc : 0.0;
}

}  // namespace

extern "C" int wkb_ct_launch(const WkbCtArgs* a, void* stream) {
  if (a->R > 0 && a->C > 0) {
    const long long gy = (a->C + kWarps - 1) / kWarps;
    const long long gx = (a->R + kLanes - 1) / kLanes;
    if (gy > 65535 || gx > 0x7fffffffLL || a->chunk <= 0 || a->ne_max > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
    wkb_ct<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the counters of the current device, after every launch before has ended
extern "C" int wkb_ct_counts_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, wkb_ct_counts, sizeof(wkb_ct_counts));
  return static_cast<int>(e);
}

extern "C" int wkb_ct_counts_reset(void) {
  const unsigned long long zero[2] = {0ull, 0ull};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(wkb_ct_counts, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}
