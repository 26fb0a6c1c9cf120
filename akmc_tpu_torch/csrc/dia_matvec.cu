// DIA (offset-diagonal) combined matvec of the boundary-potential K-CG,
// written for Hopper (sm_90a).
//
// Replaces akmc_tpu/ops/pallas_dia.py::dia_combined_matvec_pallas (the TPU
// kernel). Same function, per row i of an N-row operator with D int8-coded
// offset diagonals (code 0 = no edge, 1 = low_G edge, 2 = metal-metal high_G
// edge):
//     y_i = sum_{d: c_d[i] != 0} w(c_d[i]) * x[i + o_d],  w(1) = val_low, w(2) = val_high
//     v_i = sum_{d: c_d[i] != 0} xv[i + o_d]
// Columns i + o_d outside [0, N) contribute nothing.
//
// Design. The TPU kernel carried f64 as hi/lo f32 pairs with a twoSum chain
// and clustered the offsets into sliding windows staged through VMEM; both
// were TPU workarounds. Here f64 is native, and one thread owns one row
// (grid-stride): for each d in ascending order it reads the code
// diags[d*N + i] (consecutive threads read consecutive bytes: coalesced) and,
// where the code is nonzero and the column is in range, x[i+o_d] and
// xv[i+o_d] (consecutive threads again read consecutive addresses; the
// windows of neighbouring offsets overlap and hit in L1/L2). No shared
// memory, no windows, no padding.
//
// Order of the sums. Each row adds w*x term by term in ascending d with
// explicit round-to-nearest multiplies and adds, the order of the plain twin
// (ops/dia_matvec.py) and of akmc_tpu/solvers/dia.py::dia_combined_matvec,
// so the result equals both bit for bit. The K system has a condition number
// near 1e8 and metal rows whose high_G terms cancel against the diagonal, and
// its CG reacts to how W x is rounded: the factored form val_low*A +
// val_high*B, which nvcc contracts into an FMA, moved one K solve of the
// n_yz=24 crossbar sweep from 161 to 228 CG iterations and its potentials by
// 11% (measured on an H100); the same form without the FMA, or this order,
// stays within 1e-5 of the CPU.
//
// Bound. Per call the kernel must move D*N code bytes plus two f64 vectors
// in and two out: at the crossbar's N = 58,752, D = 32 that is
// 1.88 MB + 1.88 MB = 3.76 MB, about 1.1 us at 3.35 TB/s. The arithmetic
// (2 flops per nonzero code) is far below the f64 rate, so the kernel is
// bound by bytes, and at this size in practice by its launch. That is why
// the simple design is enough for now: tiling the codes through shared
// memory, fusing the CG's elementwise ops into the kernel, or capturing the
// CG iteration in a CUDA graph is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void dia_combined_matvec_kernel(
    const int8_t* __restrict__ diags,      // (D, N) codes, row-major
    const int64_t* __restrict__ offsets,   // (D,) ascending offsets
    int D,
    int64_t N,
    const double* __restrict__ x,          // (N,)
    const double* __restrict__ xv,         // (N,)
    double val_low,
    double val_high,
    double* __restrict__ y,                // (N,) out
    double* __restrict__ v) {              // (N,) out
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < N; i += stride) {
    double acc = 0.0, s = 0.0;
    for (int d = 0; d < D; ++d) {
      const int8_t c = diags[static_cast<int64_t>(d) * N + i];
      if (c == 0) continue;
      const int64_t j = i + offsets[d];
      if (j < 0 || j >= N) continue;
      // explicit round-to-nearest multiply and add: no FMA contraction
      acc = __dadd_rn(acc, __dmul_rn(c == 2 ? val_high : val_low, x[j]));
      s = __dadd_rn(s, xv[j]);
    }
    y[i] = acc;
    v[i] = s;
  }
}

}  // namespace

// Launches on `stream` (a cudaStream_t passed as a pointer) and returns the
// cudaGetLastError() code, 0 on success. Allocates nothing and does not
// synchronise.
extern "C" int dia_combined_matvec_launch(
    const void* diags, const void* offsets, int D, long long N,
    const void* x, const void* xv, double val_low, double val_high,
    void* y, void* v, void* stream) {
  if (N <= 0) return 0;
  const int threads = 256;
  long long blocks = (N + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;   // grid-stride covers the rest
  dia_combined_matvec_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(diags), static_cast<const int64_t*>(offsets),
      D, static_cast<int64_t>(N), static_cast<const double*>(x),
      static_cast<const double*>(xv), val_low, val_high,
      static_cast<double*>(y), static_cast<double*>(v));
  return static_cast<int>(cudaGetLastError());
}
