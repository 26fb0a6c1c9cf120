// The whole Jacobi-preconditioned CG of one boundary-potential K solve in one
// cooperative launch, written for Hopper (sm_90a).
//
// Together with dia_matvec.cu it replaces
// akmc_tpu/ops/pallas_dia.py::dia_combined_matvec_pallas (the TPU kernel) and
// the lax.while_loop around it (akmc_tpu/solvers/cg.py::jacobi_cg): akmc_tpu
// keeps the CG loop on the device, and so does this kernel. It computes
// exactly solvers/cg.py::jacobi_cg with the operator of solvers/dia.py:
//
//     A(v)_i = is_int_i ? diag_i*v_i - (W v)_i - dgc_i*(adj vv)_i : v_i,
//     vv_j = cvac_j ? v_j : 0
//     r = b - A(x0); z = r*inv_diag; p = z; rz = r.z; k = 1
//     while k <= max_iterations and rz / b.b > tol2:
//         Ap = A(p); a = rz / p.Ap; x += a p; r -= a Ap; z = r*inv_diag
//         rz_new = r.z; beta = rz_new / rz; p = z + beta p; rz = rz_new; ++k
//
// and returns x, r, k and rz.
//
// What bounds it. One iteration touches D*N code bytes and about ten f64
// vectors, a few MB at the crossbar's N = 58,752, D = 32: microseconds of
// memory traffic even from L2. A host loop pays a kernel launch per small op
// and a device-to-host read per stop test instead, two orders of magnitude
// more. So the design removes the host from the loop and keeps the working
// set on the chip:
//
//  * One cooperative launch per solve; cooperative_groups grid syncs order
//    the three phases of an iteration (A(p) and p.Ap | x, r, z and r.z | p).
//    Every block is resident (grid <= occupancy * SMs, checked by the
//    launcher, which fails rather than fall back).
//  * Fast case (D <= 32 and one row per thread fits the resident grid): a
//    thread owns one row and keeps it in registers for the whole solve: its
//    codes packed once into three 32-bit masks (edge, high_G edge, neighbour
//    is a conductive vacancy), diag_i, dgc, inv_diag, x, r, p, Ap. The int8
//    codes, cvac and the vectors are read once per solve. Only p crosses
//    rows: each iteration writes it once to global memory (it stays in L2)
//    and gathers it at i + o_d, eight independent loads at a time.
//  * General case (any D <= 256, any N): blocks loop over chunks of rows,
//    the per-row state lives in global workspace (L2), codes are re-read.
//    Same arithmetic, same order, same result.
//
// Rounding is part of the function. The K system has a condition number
// near 1e8, and a CG trajectory reacts to the last bit of every product:
// a contracted FMA in the matvec moved one solve from 161 to 228 iterations
// (measured on an H100). Every product, sum and quotient below is an
// explicit round-to-nearest intrinsic in the order of the plain twin
// (solvers/dia_cg.py::dia_cg_solve_plain), and the file is compiled with
// -fmad=false, so kernel and twin agree bit for bit.
//
// Order of the dot products (the twin's blocked_vdot repeats it). It is fixed
// by N alone, never by the grid:
//   1. products a_i*b_i, rounded; rows >= N count as +0.0;
//   2. per chunk of kChunk = 256 consecutive rows: within each run of 32 rows
//      a halving tree (v[t] += v[t+16], then +8, +4, +2, +1), then the same
//      halving tree over the 8 run sums (s[w] += s[w+4], +2, +1);
//   3. over the chunk sums c_0..c_{C-1}, padded with +0.0 to a multiple of
//      256: acc[t] = c_t, then acc[t] += c_{256 m + t} for m = 1, 2, ... in
//      ascending m, then the tree of step 2 over acc[0..255].
// Step 3 is done by every block on the same chunk sums after a grid sync, so
// all blocks hold the same scalar and take the same branch. No atomics.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 256;            // rows per block pass = threads per block
constexpr int kWarps = kChunk / 32;
constexpr int kMaskDiags = 32;         // diagonals a register mask can hold
constexpr int kMaxDiags = 256;         // offsets staged in shared memory
constexpr int kGather = 8;             // independent gathers in flight per thread

struct Params {
  const int8_t* diags;        // (D, N) codes, row-major
  const int64_t* offsets;     // (D,) ascending
  int D;
  int64_t N;
  int64_t chunks;             // ceil(N / kChunk)
  double val_low, val_high;
  const uint8_t* cvac;        // (N,) bool
  const uint8_t* is_int;      // (N,) bool
  const double* diag_i;       // (N,)
  const double* dgc;          // (N,)
  const double* inv_diag;     // (N,)
  const double* rhs;          // (N,)
  const double* x0;           // (N,)
  double tol2;
  int max_iterations;
  double* x;                  // (N,) out
  double* r;                  // (N,) out
  double* p;                  // (N,) workspace: the search direction, shared by all rows
  double* Ap;                 // (N,) workspace (general case only)
  double* cs_a;               // (chunks,) chunk sums of p.Ap
  double* cs_b;               // (chunks,) chunk sums of r.z
  double* cs_c;               // (chunks,) chunk sums of b.b
  int* iterations;            // out: final k
  double* residual_sq;        // out: final r.z
  long long* iterations_total;  // running sum of k over every solve on this device
};

// Halving tree over the block's 256 values (step 2 above); every thread
// returns the sum. All threads of the block must call it.
__device__ __forceinline__ double block_tree_sum(double v, double* s_warp) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, s));
  __syncthreads();                       // s_warp may still be read from the last call
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  const double a0 = __dadd_rn(s_warp[0], s_warp[4]);
  const double a1 = __dadd_rn(s_warp[1], s_warp[5]);
  const double a2 = __dadd_rn(s_warp[2], s_warp[6]);
  const double a3 = __dadd_rn(s_warp[3], s_warp[7]);
  return __dadd_rn(__dadd_rn(a0, a2), __dadd_rn(a1, a3));
}

// Step 3 above: the same scalar in every thread of every block. The chunk
// sums were written by other blocks before a grid sync: read them from L2.
__device__ __forceinline__ double sum_chunks(const double* cs, int64_t chunks, double* s_warp) {
  const int t = threadIdx.x;
  double acc = t < chunks ? __ldcg(cs + t) : 0.0;
  for (int64_t m = kChunk; m < chunks; m += kChunk)
    acc = __dadd_rn(acc, m + t < chunks ? __ldcg(cs + m + t) : 0.0);
  return block_tree_sum(acc, s_warp);
}

// (W v)_i and (adj vv)_i from the register masks, ascending d, with kGather
// loads issued before the ordered adds that use them. (Walking only the set
// bits with __ffs, as dia_matvec.cu does, measured no faster per iteration
// here, and this form is the simpler one.)
__device__ __forceinline__ void matvec_masks(
    uint32_t edge, uint32_t high, uint32_t cvn, int D, int64_t i,
    const int64_t* s_off, const double* v, double val_low, double val_high,
    double& mv, double& corr) {
  double acc = 0.0, s = 0.0;
  for (int d0 = 0; d0 < D; d0 += kGather) {
    double g[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int d = d0 + u;              // <= 31: D <= kMaskDiags = 32, and bits >= D are 0
      g[u] = ((edge >> d) & 1u) ? v[i + s_off[d]] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int d = d0 + u;
      if ((edge >> d) & 1u) {
        acc = __dadd_rn(acc, __dmul_rn(((high >> d) & 1u) ? val_high : val_low, g[u]));
        if ((cvn >> d) & 1u) s = __dadd_rn(s, g[u]);
      }
    }
  }
  mv = acc;
  corr = s;
}

// The same two sums from the int8 codes in global memory.
__device__ __forceinline__ void matvec_codes(
    const Params& a, int64_t i, const int64_t* s_off, const double* v,
    double& mv, double& corr) {
  double acc = 0.0, s = 0.0;
  for (int d = 0; d < a.D; ++d) {
    const int8_t c = a.diags[static_cast<int64_t>(d) * a.N + i];
    if (c == 0) continue;
    const int64_t j = i + s_off[d];
    if (j < 0 || j >= a.N) continue;
    const double vj = v[j];
    acc = __dadd_rn(acc, __dmul_rn(c == 2 ? a.val_high : a.val_low, vj));
    if (a.cvac[j]) s = __dadd_rn(s, vj);
  }
  mv = acc;
  corr = s;
}

// What a thread keeps of its row across the solve (registers in the fast
// case; re-read from global memory per phase in the general case).
struct Row {
  double diag_i, dgc, inv_diag, x, r, p, Ap;
  uint32_t edge, high, cvn;
  bool interior;
};

template <bool kRegs>
__device__ __forceinline__ double apply_A(
    const Params& a, const Row& row, int64_t i, const int64_t* s_off,
    const double* v, double v_i) {
  if (!row.interior) return v_i;
  double mv, corr;
  if constexpr (kRegs)
    matvec_masks(row.edge, row.high, row.cvn, a.D, i, s_off, v, a.val_low, a.val_high, mv, corr);
  else
    matvec_codes(a, i, s_off, v, mv, corr);
  return __dsub_rn(__dsub_rn(__dmul_rn(row.diag_i, v_i), mv), __dmul_rn(row.dgc, corr));
}

template <bool kRegs>
__global__ void __launch_bounds__(kChunk, 2) dia_cg_kernel(const Params a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int64_t s_off[kMaxDiags];
  __shared__ double s_warp[kWarps];
  const int t = threadIdx.x;
  for (int d = t; d < a.D; d += kChunk) s_off[d] = a.offsets[d];
  __syncthreads();

  Row row = {};   // fast case: this thread's row, chunk blockIdx.x

  // ---- start: r = b - A(x0), z = r*inv_diag, p = z; chunk sums of b.b and r.z
  for (int64_t c = blockIdx.x; c < a.chunks; c += gridDim.x) {
    const int64_t i = c * kChunk + t;
    double bb = 0.0, rz = 0.0;
    if (i < a.N) {
      row.interior = a.is_int[i] != 0;
      row.diag_i = a.diag_i[i];
      row.dgc = a.dgc[i];
      row.inv_diag = a.inv_diag[i];
      if constexpr (kRegs) {
        row.edge = row.high = row.cvn = 0u;
        for (int d = 0; d < a.D; ++d) {
          const int8_t code = a.diags[static_cast<int64_t>(d) * a.N + i];
          const int64_t j = i + s_off[d];
          if (code != 0 && j >= 0 && j < a.N) {
            row.edge |= 1u << d;
            if (code == 2) row.high |= 1u << d;
            if (a.cvac[j]) row.cvn |= 1u << d;
          }
        }
      }
      const double b = a.rhs[i];
      row.x = a.x0[i];
      row.r = __dsub_rn(b, apply_A<kRegs>(a, row, i, s_off, a.x0, row.x));
      row.p = __dmul_rn(row.r, row.inv_diag);
      bb = __dmul_rn(b, b);
      rz = __dmul_rn(row.r, row.p);
      a.p[i] = row.p;
      if constexpr (!kRegs) {
        a.x[i] = row.x;
        a.r[i] = row.r;
      }
    }
    const double sum_bb = block_tree_sum(bb, s_warp);
    const double sum_rz = block_tree_sum(rz, s_warp);
    if (t == 0) {
      a.cs_c[c] = sum_bb;
      a.cs_b[c] = sum_rz;
    }
  }
  grid.sync();
  const double norm2_rhs = sum_chunks(a.cs_c, a.chunks, s_warp);
  double rz = sum_chunks(a.cs_b, a.chunks, s_warp);

  int k = 1;
  while (k <= a.max_iterations && __ddiv_rn(rz, norm2_rhs) > a.tol2) {
    // ---- phase 1: Ap = A(p), chunk sums of p.Ap
    for (int64_t c = blockIdx.x; c < a.chunks; c += gridDim.x) {
      const int64_t i = c * kChunk + t;
      double pAp = 0.0;
      if (i < a.N) {
        if constexpr (!kRegs) {
          row.interior = a.is_int[i] != 0;
          row.diag_i = a.diag_i[i];
          row.dgc = a.dgc[i];
          row.p = a.p[i];
        }
        row.Ap = apply_A<kRegs>(a, row, i, s_off, a.p, row.p);
        if constexpr (!kRegs) a.Ap[i] = row.Ap;
        pAp = __dmul_rn(row.p, row.Ap);
      }
      const double sum = block_tree_sum(pAp, s_warp);
      if (t == 0) a.cs_a[c] = sum;
    }
    grid.sync();
    const double alpha = __ddiv_rn(rz, sum_chunks(a.cs_a, a.chunks, s_warp));

    // ---- phase 2: x += alpha p, r -= alpha Ap, z = r*inv_diag, chunk sums of r.z
    double z = 0.0;
    for (int64_t c = blockIdx.x; c < a.chunks; c += gridDim.x) {
      const int64_t i = c * kChunk + t;
      double prod = 0.0;
      if (i < a.N) {
        if constexpr (!kRegs) {
          row.inv_diag = a.inv_diag[i];
          row.x = a.x[i];
          row.r = a.r[i];
          row.p = a.p[i];
          row.Ap = a.Ap[i];
        }
        row.x = __dadd_rn(row.x, __dmul_rn(alpha, row.p));
        row.r = __dsub_rn(row.r, __dmul_rn(alpha, row.Ap));
        z = __dmul_rn(row.r, row.inv_diag);
        prod = __dmul_rn(row.r, z);
        if constexpr (!kRegs) {
          a.x[i] = row.x;
          a.r[i] = row.r;
        }
      }
      const double sum = block_tree_sum(prod, s_warp);
      if (t == 0) a.cs_b[c] = sum;
    }
    grid.sync();
    const double rz_new = sum_chunks(a.cs_b, a.chunks, s_warp);
    const double beta = __ddiv_rn(rz_new, rz);

    // ---- phase 3: p = z + beta p, published for the neighbours' gathers
    for (int64_t c = blockIdx.x; c < a.chunks; c += gridDim.x) {
      const int64_t i = c * kChunk + t;
      if (i < a.N) {
        if constexpr (!kRegs) {
          z = __dmul_rn(a.r[i], a.inv_diag[i]);   // the same product as in phase 2
          row.p = a.p[i];
        }
        row.p = __dadd_rn(z, __dmul_rn(beta, row.p));
        a.p[i] = row.p;
      }
    }
    rz = rz_new;
    ++k;
    grid.sync();
  }

  if constexpr (kRegs) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kChunk + t;
    if (i < a.N) {
      a.x[i] = row.x;
      a.r[i] = row.r;
    }
  }
  if (blockIdx.x == 0 && t == 0) {
    *a.iterations = k;
    *a.residual_sq = rz;
    *a.iterations_total += k;
  }
}

// Nothing but grid syncs, on the grid and block size of a solve: what the
// three syncs of an iteration cost with no work between them.
__global__ void __launch_bounds__(kChunk, 2) grid_sync_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < syncs; ++s) grid.sync();
}

// What the launcher learns once per device.
struct DeviceInfo {
  bool known = false;
  int cooperative = 0;
  int sms = 0;
  int blocks_per_sm_regs = 0;
  int blocks_per_sm_general = 0;
};
constexpr int kMaxDevices = 64;
DeviceInfo g_info[kMaxDevices];

}  // namespace

// Error codes of this file, beside cudaError_t values (> 0).
enum {
  kErrTooManyDiags = -1,       // D > kMaxDiags
  kErrNoCooperativeLaunch = -2,
  kErrNotResident = -3,        // occupancy gives no resident block
  kErrBadArgument = -4,        // N or D not positive, or a device index beyond the table
};

extern "C" int dia_cg_chunk() { return kChunk; }
extern "C" int dia_cg_max_diags() { return kMaxDiags; }

// One cooperative launch on `stream`. `work` holds 2*N + 3*chunks doubles.
// `info` receives {blocks, 1 if the register-resident case ran else 0}.
// Returns 0, a cudaError_t, or one of the negative codes above. Allocates
// nothing and does not synchronise.
extern "C" int dia_cg_solve_launch(
    const void* diags, const void* offsets, int D, long long N,
    double val_low, double val_high, const void* cvac, const void* is_int,
    const void* diag_i, const void* dgc, const void* inv_diag, const void* rhs,
    const void* x0, double tol2, int max_iterations, void* x, void* r,
    void* work, void* iterations, void* residual_sq, void* iterations_total,
    void* stream, int* info) {
  if (N <= 0 || D <= 0) return kErrBadArgument;
  if (D > kMaxDiags) return kErrTooManyDiags;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrBadArgument;
  DeviceInfo& di = g_info[dev];
  if (!di.known) {
    if ((err = cudaDeviceGetAttribute(&di.cooperative, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &di.blocks_per_sm_regs, dia_cg_kernel<true>, kChunk, 0)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &di.blocks_per_sm_general, dia_cg_kernel<false>, kChunk, 0)) != cudaSuccess)
      return static_cast<int>(err);
    di.known = true;
  }
  if (!di.cooperative) return kErrNoCooperativeLaunch;

  Params a;
  a.diags = static_cast<const int8_t*>(diags);
  a.offsets = static_cast<const int64_t*>(offsets);
  a.D = D;
  a.N = N;
  a.chunks = (N + kChunk - 1) / kChunk;
  a.val_low = val_low;
  a.val_high = val_high;
  a.cvac = static_cast<const uint8_t*>(cvac);
  a.is_int = static_cast<const uint8_t*>(is_int);
  a.diag_i = static_cast<const double*>(diag_i);
  a.dgc = static_cast<const double*>(dgc);
  a.inv_diag = static_cast<const double*>(inv_diag);
  a.rhs = static_cast<const double*>(rhs);
  a.x0 = static_cast<const double*>(x0);
  a.tol2 = tol2;
  a.max_iterations = max_iterations;
  a.x = static_cast<double*>(x);
  a.r = static_cast<double*>(r);
  double* w = static_cast<double*>(work);
  a.p = w;
  a.Ap = w + N;
  a.cs_a = w + 2 * N;
  a.cs_b = a.cs_a + a.chunks;
  a.cs_c = a.cs_b + a.chunks;
  a.iterations = static_cast<int*>(iterations);
  a.residual_sq = static_cast<double*>(residual_sq);
  a.iterations_total = static_cast<long long*>(iterations_total);

  const long long resident_regs = static_cast<long long>(di.blocks_per_sm_regs) * di.sms;
  const bool regs = D <= kMaskDiags && a.chunks <= resident_regs;
  const long long resident =
      regs ? resident_regs : static_cast<long long>(di.blocks_per_sm_general) * di.sms;
  if (resident <= 0) return kErrNotResident;
  const long long blocks = a.chunks < resident ? a.chunks : resident;
  info[0] = static_cast<int>(blocks);
  info[1] = regs ? 1 : 0;

  void* args[] = {&a};
  const void* fn = regs ? reinterpret_cast<const void*>(dia_cg_kernel<true>)
                        : reinterpret_cast<const void*>(dia_cg_kernel<false>);
  err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(blocks)), dim3(kChunk),
                                    args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `syncs` grid syncs and nothing else on `blocks` blocks of a solve's size:
// the floor under an iteration, measured beside the solve. Returns 0 or a
// cudaError_t (a grid too large to be resident is refused by the runtime).
extern "C" int dia_cg_sync_floor_launch(int blocks, int syncs, void* stream) {
  void* args[] = {&syncs};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_sync_kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kChunk), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
