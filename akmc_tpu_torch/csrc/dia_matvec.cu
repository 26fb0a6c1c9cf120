// DIA (offset-diagonal) combined matvec of the boundary-potential K solve,
// written for Hopper (sm_90a).
//
// Replaces akmc_tpu/ops/pallas_dia.py::dia_combined_matvec_pallas (the TPU
// kernel). Same function, per row i of an N-row operator with D int8-coded
// offset diagonals (code 0 = no edge, 1 = low_G edge, 2 = metal-metal high_G
// edge):
//     y_i = sum_{d: c_d[i] != 0} w(c_d[i]) * x[i + o_d],  w(1) = val_low, w(2) = val_high
//     v_i = sum_{d: c_d[i] != 0} xv[i + o_d]
// Columns i + o_d outside [0, N) contribute nothing. The K solve calls it once
// per solve for the conductive-vacancy degrees; the CG's own matvecs are fused
// into dia_cg.cu, which computes the same sums in the same order.
//
// Row window. The kernel computes rows [row0, row0 + R) of the N-row operator
// from a (D, R) array of their codes, reading x and xv over all N columns: a
// rank of a sharded K solve (solvers/dia_cg.py) holds only its rows' codes and
// calls it in every CG iteration. row0 = 0, R = N is the whole operator. The
// range checks use the global N, so a window's rows give the sums the whole
// operator gives them, bit for bit. The codes are staged with 16-byte loads
// when R is a multiple of 16 and the array is 16-byte aligned: an array of its
// own is, a view into a larger array at an odd row0 is not and takes the byte
// loads.
//
// Design. The TPU kernel carried f64 as hi/lo f32 pairs with a twoSum chain
// and clustered the offsets into sliding windows staged through VMEM; both
// were TPU workarounds. Here f64 is native, one thread owns one row, and a
// bounds check on i + o_d replaces the padded buffer. The working set (codes
// and four vectors, 3.76 MB at N = 58,752, D = 32) sits in L2 between calls,
// and with one row per thread the card holds only N threads, a fraction of
// what it can keep resident, so the kernel is bound by the latency of its
// dependent loads, not by bytes: a first version that walked the diagonals
// one by one (load a code, branch, load x, add) took 8.6 us on an H100, a
// chain of 32 round trips to L2. What this design does about it:
//  * a block of 128 rows stages its 32 x 128 tile of codes in shared memory
//    with two 16-byte loads per thread (byte loads where N or the pointer is
//    not 16-byte aligned, or at the ragged edge), and the group's offsets
//    beside it, so no thread waits on a chain of code loads;
//  * each thread packs its 32 codes into two masks (edge, high_G), then walks
//    the set bits in ascending d, sixteen at a time: the gathers x[i+o_d]
//    and xv[i+o_d] of sixteen edges are issued together (neighbouring rows
//    read neighbouring addresses, and the windows of nearby offsets overlap
//    in L1/L2), and only then the ordered adds run. A crossbar row has about
//    9 edges among its 32 diagonals, so most rows need one round.
//
// Order of the sums. Each row adds w*x term by term in ascending d with
// explicit round-to-nearest multiplies and adds, the order of the plain twin
// (ops/dia_matvec.py) and of akmc_tpu/solvers/dia.py::dia_combined_matvec,
// so the result equals both bit for bit. The K system has a condition number
// near 1e8 and metal rows whose high_G terms cancel against the diagonal, and
// its CG reacts to how W x is rounded: the factored form val_low*A +
// val_high*B, which nvcc contracts into an FMA, moved one K solve of the
// n_yz=24 crossbar sweep from 161 to 228 CG iterations and its potentials by
// 11% (measured on an H100). Hence the intrinsics, and -fmad=false for the
// whole file.
//
// Bound. Per call the kernel must move D*N code bytes plus two f64 vectors
// in and two out: 3.76 MB at the crossbar's size, about 1.1 us at 3.35 TB/s.
// The arithmetic (2 flops per nonzero code) is far below the f64 rate, so the
// bound is bytes, and it lies below what one launch of an empty kernel on
// this grid takes (dia_empty_launch measures that floor).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // rows per block
constexpr int kGroup = 32;     // diagonals packed into one pair of masks
constexpr int kGather = 16;    // edges whose gathers are in flight together

__global__ void __launch_bounds__(kThreads) dia_combined_matvec_kernel(
    const int8_t* __restrict__ diags,      // (D, R) codes of rows [row0, row0 + R), row-major
    const int64_t* __restrict__ offsets,   // (D,) ascending offsets
    int D,
    int64_t N,                             // rows and columns of the whole operator
    int64_t row0,                          // first row of the window
    int64_t R,                             // rows of the window
    const double* __restrict__ x,          // (N,)
    const double* __restrict__ xv,         // (N,)
    double val_low,
    double val_high,
    double* __restrict__ y,                // (R,) out
    double* __restrict__ v) {              // (R,) out
  __shared__ __align__(16) int8_t s_codes[kGroup * kThreads];
  __shared__ int64_t s_off[kGroup];
  __shared__ int64_t s_span[2];              // least and largest offset of the group (or 0)
  const int t = threadIdx.x;
  const bool aligned = (R & 15) == 0 && (reinterpret_cast<uintptr_t>(diags) & 15) == 0;
  const int64_t tiles = (R + kThreads - 1) / kThreads;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t l0 = tile * kThreads;      // the tile's first row in the window
    const int64_t l = l0 + t;                // this thread's row in the window
    const int64_t r0 = row0 + l0;            // and both in the whole operator
    const int64_t i = row0 + l;
    double acc = 0.0, s = 0.0;
    for (int d0 = 0; d0 < D; d0 += kGroup) {
      const int nd = D - d0 < kGroup ? D - d0 : kGroup;
      // ---- stage the group's offsets and this tile's codes
      if (t < 32) {                          // warp 0; kGroup is one warp wide
        const int64_t o = t < nd ? offsets[d0 + t] : 0;
        if (t < nd) s_off[t] = o;
        long long lo = o, hi = o;
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) {
          const long long lo2 = __shfl_xor_sync(0xffffffffu, lo, w);
          const long long hi2 = __shfl_xor_sync(0xffffffffu, hi, w);
          lo = lo2 < lo ? lo2 : lo;
          hi = hi2 > hi ? hi2 : hi;
        }
        if (t == 0) {
          s_span[0] = lo;
          s_span[1] = hi;
        }
      }
      if (aligned && l0 + kThreads <= R) {
        constexpr int kWords = kThreads / 16;          // 16-byte words per diagonal
        uint4* dst = reinterpret_cast<uint4*>(s_codes);
        for (int q = t; q < nd * kWords; q += kThreads) {
          const int d = q / kWords, w = q % kWords;
          dst[q] = *(reinterpret_cast<const uint4*>(
                         diags + static_cast<int64_t>(d0 + d) * R + l0) + w);
        }
      } else {
        for (int d = 0; d < nd; ++d)
          s_codes[d * kThreads + t] =
              l < R ? diags[static_cast<int64_t>(d0 + d) * R + l] : int8_t(0);
      }
      __syncthreads();
      // ---- this row's edges of the group, as masks
      // (a tile whose every column i + o_d lies in [0, N) skips the range checks)
      const bool inside = r0 + s_span[0] >= 0 && r0 + kThreads - 1 + s_span[1] < N;
      uint32_t edge = 0u, high = 0u;
      if (l < R) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (u < nd) {
            const int8_t c = s_codes[u * kThreads + t];
            bool on = c != 0;
            if (!inside) {
              const int64_t j = i + s_off[u];
              on = on && j >= 0 && j < N;
            }
            edge |= static_cast<uint32_t>(on) << u;
            high |= static_cast<uint32_t>(c == 2) << u;   // read only where edge is set
          }
        }
      }
      // ---- set bits in ascending d, kGather gathers in flight, then the adds
      while (edge != 0u) {
        double gx[kGather], gv[kGather];
        uint32_t m = edge;
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const bool on = m != 0u;
          const int d = on ? __ffs(m) - 1 : 0;
          m &= m - 1u;                       // clears the lowest set bit; 0 stays 0
          gx[u] = on ? x[i + s_off[d]] : 0.0;
          gv[u] = on ? xv[i + s_off[d]] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          if (edge != 0u) {
            const int d = __ffs(edge) - 1;
            edge &= edge - 1u;
            // explicit round-to-nearest multiply and add: no FMA contraction
            acc = __dadd_rn(acc, __dmul_rn(((high >> d) & 1u) ? val_high : val_low, gx[u]));
            s = __dadd_rn(s, gv[u]);
          }
        }
      }
      __syncthreads();                       // the tile is staged again for the next group
    }
    if (l < R) {
      y[l] = acc;
      v[l] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

unsigned grid_for(long long N) {
  long long blocks = (N + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > 65535 ? 65535 : blocks);   // grid-stride covers the rest
}

}  // namespace

// The static operator, validated and filled in once by the wrapper: the codes
// of rows [row0, row0 + rows) of an N x N operator (row0 = 0, rows = N: all of
// it), as a (D, rows) array of their own.
struct DiaOp {
  const int8_t* diags;
  const int64_t* offsets;
  int D;
  long long N;
  double val_low, val_high;
  long long row0, rows;
};

// Launches on `stream` (a cudaStream_t passed as a pointer) and returns the
// cudaGetLastError() code, 0 on success. x and xv hold all N columns; y and v
// are the two halves of one (2, rows) output. Allocates nothing and does not
// synchronise.
extern "C" int dia_combined_matvec_launch(
    const DiaOp* op, const void* x, const void* xv, void* out, void* stream) {
  if (op->rows <= 0) return 0;
  double* y = static_cast<double*>(out);
  dia_combined_matvec_kernel<<<grid_for(op->rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op->diags, op->offsets, op->D, static_cast<int64_t>(op->N),
      static_cast<int64_t>(op->row0), static_cast<int64_t>(op->rows),
      static_cast<const double*>(x), static_cast<const double*>(xv),
      op->val_low, op->val_high, y, y + op->rows);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid the matvec uses for N rows: the floor that a
// single launch cannot go below, measured beside the matvec.
extern "C" int dia_empty_launch(long long N, void* stream) {
  if (N <= 0) return 0;
  empty_kernel<<<grid_for(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
