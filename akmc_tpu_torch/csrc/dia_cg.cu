// The whole Jacobi-preconditioned CG of one boundary-potential K solve in one
// cooperative launch, written for Hopper (sm_90a). The launch can be captured
// into a CUDA graph; the kernel's arithmetic is the same either way.
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
// Schedule: two grid syncs per iteration. An iteration has two reductions
// (p.Ap, then r.z), so it needs two syncs; the update p = z + beta p, which
// needs the second one's result, is folded into the next iteration's first
// phase:
//   phase 1 (k): p_k = z + beta_{k-1} p_{k-1} for the own row, and for every
//     neighbour j that A gathers, p_k[j] = z[j] + beta_{k-1} p_{k-1}[j] from
//     the published z and p_{k-1} with the same two roundings, so the value
//     is the owner's to the bit (iteration 1 takes p_1 = z as it is);
//     publish p_k, Ap = A(p_k), chunk sums of p.Ap.          -- grid sync --
//   phase 2 (k): x += a p_k, r -= a Ap, z = r*inv_diag, publish z, chunk
//     sums of r.z.                                           -- grid sync --
// p alternates between two buffers (p_k in p[k & 1]) so that phase 1 reads
// p_{k-1} while it writes p_k.
//
// The operator's codes and cvac are read once per solve: each row packs them
// into three 32-bit words per group of 32 diagonals (edge: code != 0 and
// 0 <= i + o_d < N; high: code == 2; cvn: the neighbour is a conductive
// vacancy), what solvers/dia_cg.py::pack_row_masks_plain computes and what
// akmc_tpu folds once per solve (akmc_tpu/solvers/dia.py::fold_cvac_codes).
// A row's matvec walks the set bits of its edge word in ascending d and
// issues a batch of gathers before the ordered adds that use them: a crossbar
// row has about 9 edges of its 32 diagonals, so one to three rounds of loads.
//
// What bounds it, by size (H100: 132 SMs, 50 MB L2, 3.35 TB/s):
//  * Resident case (D <= 32 and one row per thread fits the resident grid:
//    N up to about 67,000 at two blocks of 256 per SM). A thread owns one
//    row for the whole solve and keeps it in registers (masks, diag_i, dgc,
//    inv_diag, x, r, z, p). Per iteration only z and p cross rows, through
//    L2. An iteration is latency, not bytes: two grid syncs (1.29 us each on
//    the sweep's 230 blocks, measured with no work between them), a read of
//    the chunk sums after each, a round or two of gathers and four block
//    trees; the 5.9 MB of the streaming bound would take 1.8 us from device
//    memory. On an H100 it takes about 7.6-8.0 us (three syncs took 8.6).
//    Two other waits were measured in place of the grid sync and were
//    slower: one arrival counter polled by a thread per block, and the chunk
//    sums themselves as flags polled by every thread.
//  * Streaming case (D > 32 or more rows): the per-row state lives in device
//    memory and is streamed every phase. The blocks (four of 256 per SM, 64
//    registers a thread, one row in flight per thread) walk the chunks in a
//    grid-stride order, so at any moment the grid works on a window of
//    consecutive chunks: the gathers at +-1, +-n_yz hit L1 and those at
//    +-n_yz^2, +-2 n_yz^2 hit L2 lines that a nearby window loaded moments
//    before. Phase 1 loads a row's mask words beside its other own-row data,
//    without waiting for is_int, and stores p and Ap only after the gathers,
//    so a row's chain is one round trip to device memory and one to three
//    rounds of gathers. Per row and iteration it moves 125 bytes (masks 12,
//    is_int 1, and 14 f64 loads or stores); the least an iteration must
//    stream is 101 (the words, is_int and eleven f64 passes: chip_smoke.py's
//    streaming bound). At N = 409,600 that is about the L2; from N =
//    1,081,600 on it is a stream from device memory, 0.14 ms per iteration at
//    the 4,622,500-row flagship. An H100 reaches about half of that bound
//    (PERF.md §6). The rest: the three f64 passes above the bound, two grid
//    syncs (about 1.65 us each on 528 blocks), the read of every chunk sum by
//    every block after each sync (L2 traffic that grows with N times the
//    grid), and a __syncthreads per chunk. Slower on an H100 at every crossbar
//    size (chip_smoke.py --only schedules, PERF.md §6): contiguous runs of
//    chunks per block, cp.async of the next chunk's mask words into shared
//    memory, two rows in flight, eight gathers in flight, three blocks per
//    SM; and, earlier, one column of step 3 per block, so that each block
//    folds its own chunk sums (256 blocks of 512 threads).
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

constexpr int kChunk = 256;            // rows per chunk = threads per block
constexpr int kWarps = kChunk / 32;
constexpr int kMaskDiags = 32;         // diagonals per group of mask words
constexpr int kMaxDiags = 256;         // offsets staged in shared memory
constexpr int kSyncsPerIteration = 2;
constexpr int kLoadBatch = 8;          // chunk sums loaded ahead of their adds
constexpr int kPackBatch = 8;          // codes and cvac bytes loaded at a time when packing
constexpr int kResidentBlocksPerSM = 2;
constexpr int kGatherResident = 8;     // gathers in flight per row
// Streaming case. Measured alternatives (chip_smoke.py --only schedules
// compiles this file with other values and times each): kContiguousRuns
// gives each block one contiguous run of chunks in place of the grid-stride
// walk; kPrefetch stages the next group's mask words in shared memory by
// cp.async while the current group gathers.
constexpr int kStreamBlocksPerSM = 4;
constexpr int kGatherStream = 4;
constexpr int kRows = 1;               // rows in flight per thread, one chunk each
constexpr bool kContiguousRuns = false;
constexpr bool kPrefetch = false;

struct Params {
  const int8_t* diags;        // (D, N) codes, row-major
  const int64_t* offsets;     // (D,) ascending
  int D;
  int groups;                 // ceil(D / kMaskDiags)
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
  double* z;                  // (N,) workspace: z of the last phase 2
  double* p[2];               // (N,) workspace: p_k in p[k & 1]
  double* cs_a;               // (chunks,) chunk sums of p.Ap
  double* cs_b;               // (chunks,) chunk sums of r.z
  double* cs_c;               // (chunks,) chunk sums of b.b
  double* Ap;                 // (N,) workspace (streaming case only)
  uint32_t* masks;            // (3 * groups, N) workspace (streaming case only):
                              // edge, high, cvn words of group g at planes 3g..3g+2
  int* iterations;            // out: final k
  double* residual_sq;        // out: final r.z
  long long* iterations_total;  // running sum of k over every solve on this device
};

// The 8-run tree of step 2 over the run sums s[0..7].
__device__ __forceinline__ double runs_tree(const double* s) {
  return __dadd_rn(__dadd_rn(__dadd_rn(s[0], s[4]), __dadd_rn(s[2], s[6])),
                   __dadd_rn(__dadd_rn(s[1], s[5]), __dadd_rn(s[3], s[7])));
}

// Halving tree over the block's 256 values (step 2 above); every thread
// returns the sum. All threads of the block must call it.
__device__ __forceinline__ double block_tree_sum(double v, double* s_warp) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, s));
  __syncthreads();                       // s_warp may still be read from the last call
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  return runs_tree(s_warp);
}

// Step 2 for U chunks at once: v[u] is this thread's product in chunk
// c0 + u * stride; the chunk's sum goes to cs[c0 + u * stride] where that
// chunk exists. `runs` (U * kWarps doubles of shared memory) must not be the
// buffer of the previous call: callers alternate two. One __syncthreads. All
// threads of the block must call it.
template <int U>
__device__ __forceinline__ void publish_chunk_sums(const double (&v)[U], int64_t c0,
                                                   int64_t stride, int64_t chunks,
                                                   double* cs, double* runs) {
  double w[U];
#pragma unroll
  for (int u = 0; u < U; ++u) w[u] = v[u];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = __dadd_rn(w[u], __shfl_down_sync(0xffffffffu, w[u], s));
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) runs[u * kWarps + (threadIdx.x >> 5)] = w[u];
  }
  __syncthreads();
  if (threadIdx.x < U) {
    const int64_t c = c0 + threadIdx.x * stride;
    if (c < chunks) cs[c] = runs_tree(runs + threadIdx.x * kWarps);
  }
}

// Step 3 above: the same scalar in every thread of every block. The chunk
// sums were written by other blocks before a grid sync: read them from L2,
// kLoadBatch rows of them in flight before their ordered adds.
__device__ __forceinline__ double sum_chunks(const double* cs, int64_t chunks, double* s_warp) {
  const int t = threadIdx.x;
  const int64_t padded = (chunks + kChunk - 1) / kChunk * kChunk;
  double acc = t < chunks ? __ldcg(cs + t) : 0.0;
  for (int64_t m = kChunk; m < padded; m += kLoadBatch * kChunk) {
    double v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int64_t idx = m + u * kChunk + t;
      v[u] = idx < chunks ? __ldcg(cs + idx) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u)
      if (m + u * kChunk < padded) acc = __dadd_rn(acc, v[u]);
  }
  return block_tree_sum(acc, s_warp);
}

// Row i's mask words for the diagonals [32 g, 32 g + 32) of D: bit b stands
// for diagonal 32 g + b.
__device__ __forceinline__ void pack_group(const Params& a, const int64_t* s_off, int g,
                                           int64_t i, uint32_t& edge, uint32_t& high,
                                           uint32_t& cvn) {
  edge = high = cvn = 0u;
  const int d0 = g * kMaskDiags;
  const int dn = min(a.D - d0, kMaskDiags);
  for (int b0 = 0; b0 < dn; b0 += kPackBatch) {
    int8_t code[kPackBatch];
    uint8_t cv[kPackBatch];
#pragma unroll
    for (int u = 0; u < kPackBatch; ++u) {
      const int b = b0 + u;
      code[u] = 0;
      cv[u] = 0;
      if (b < dn) {
        const int64_t j = i + s_off[d0 + b];
        if (j >= 0 && j < a.N) {
          code[u] = a.diags[static_cast<int64_t>(d0 + b) * a.N + i];
          cv[u] = a.cvac[j];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPackBatch; ++u) {
      if (code[u] != 0) {
        const uint32_t bit = 1u << (b0 + u);
        edge |= bit;
        if (code[u] == 2) high |= bit;
        if (cv[u]) cvn |= bit;
      }
    }
  }
}

// Adds one group's terms to (W v)_i and (adj vv)_i: the set bits of `edge`
// in ascending order, kGather gathers issued before the ordered adds that use
// them; v_j = z[j] or, with `fold`, z[j] + beta * p[j] (phase 1's p_k from the
// published z and p_{k-1}). `s_off` points at the group's first offset.
template <int kGather>
__device__ __forceinline__ void gather_group(uint32_t edge, uint32_t high, uint32_t cvn,
                                             const int64_t* s_off, int64_t i, const double* z,
                                             const double* p, double beta, bool fold,
                                             double val_low, double val_high, double& mv,
                                             double& corr) {
  while (edge) {
    int d[kGather];
    double vz[kGather], vp[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      d[u] = edge ? __ffs(edge) - 1 : -1;
      edge &= edge - 1u;
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      vz[u] = vp[u] = 0.0;
      if (d[u] >= 0) {
        const int64_t j = i + s_off[d[u]];
        vz[u] = z[j];
        if (fold) vp[u] = p[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      if (d[u] >= 0) {
        const double v = fold ? __dadd_rn(vz[u], __dmul_rn(beta, vp[u])) : vz[u];
        mv = __dadd_rn(mv, __dmul_rn(((high >> d[u]) & 1u) ? val_high : val_low, v));
        if ((cvn >> d[u]) & 1u) corr = __dadd_rn(corr, v);
      }
    }
  }
}

// A(v)_i of an interior row from its two sums.
__device__ __forceinline__ double interior_row(double diag_i, double dgc, double v_i, double mv,
                                               double corr) {
  return __dsub_rn(__dsub_rn(__dmul_rn(diag_i, v_i), mv), __dmul_rn(dgc, corr));
}

__device__ __forceinline__ void load_offsets(const Params& a, int64_t* s_off) {
  for (int d = threadIdx.x; d < a.D; d += kChunk) s_off[d] = a.offsets[d];
  __syncthreads();
}

__device__ __forceinline__ void finish(const Params& a, int k, double rz) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.iterations = k;
    *a.residual_sq = rz;
    *a.iterations_total += k;
  }
}

// ---- resident case: one block per chunk, one row per thread, in registers
__global__ void __launch_bounds__(kChunk, kResidentBlocksPerSM) dia_cg_resident(const Params a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int64_t s_off[kMaskDiags];
  __shared__ double s_warp[kWarps];
  load_offsets(a, s_off);
  const int64_t c = blockIdx.x;
  const int64_t i = c * kChunk + threadIdx.x;
  const bool live = i < a.N;

  // start: r = b - A(x0), z = r*inv_diag, p = z; chunk sums of b.b and r.z
  bool interior = false;
  uint32_t edge = 0u, high = 0u, cvn = 0u;
  double diag_i = 0.0, dgc = 0.0, inv_diag = 0.0, x = 0.0, r = 0.0, z = 0.0, p = 0.0;
  double bb = 0.0, rz_i = 0.0;
  if (live) {
    interior = a.is_int[i] != 0;
    diag_i = a.diag_i[i];
    dgc = a.dgc[i];
    inv_diag = a.inv_diag[i];
    pack_group(a, s_off, 0, i, edge, high, cvn);
    const double b = a.rhs[i];
    x = a.x0[i];
    double ax = x;
    if (interior) {
      double mv = 0.0, corr = 0.0;
      gather_group<kGatherResident>(edge, high, cvn, s_off, i, a.x0, nullptr, 0.0, false,
                                    a.val_low, a.val_high, mv, corr);
      ax = interior_row(diag_i, dgc, x, mv, corr);
    }
    r = __dsub_rn(b, ax);
    z = __dmul_rn(r, inv_diag);
    p = z;
    bb = __dmul_rn(b, b);
    rz_i = __dmul_rn(r, z);
    a.z[i] = z;
  }
  {
    const double sum_bb = block_tree_sum(bb, s_warp);
    const double sum_rz = block_tree_sum(rz_i, s_warp);
    if (threadIdx.x == 0) {
      a.cs_c[c] = sum_bb;
      a.cs_b[c] = sum_rz;
    }
  }
  grid.sync();
  const double norm2_rhs = sum_chunks(a.cs_c, a.chunks, s_warp);
  double rz = sum_chunks(a.cs_b, a.chunks, s_warp);
  double beta = 0.0;

  int k = 1;
  while (k <= a.max_iterations && __ddiv_rn(rz, norm2_rhs) > a.tol2) {
    const bool fold = k > 1;
    double* const p_new = (k & 1) ? a.p[1] : a.p[0];
    const double* const p_old = (k & 1) ? a.p[0] : a.p[1];
    // ---- phase 1: p = z + beta p, published; Ap = A(p); chunk sums of p.Ap
    double Ap = 0.0, prod = 0.0;
    if (live) {
      if (fold) p = __dadd_rn(z, __dmul_rn(beta, p));
      p_new[i] = p;
      Ap = p;
      if (interior) {
        double mv = 0.0, corr = 0.0;
        gather_group<kGatherResident>(edge, high, cvn, s_off, i, a.z, p_old, beta, fold,
                                      a.val_low, a.val_high, mv, corr);
        Ap = interior_row(diag_i, dgc, p, mv, corr);
      }
      prod = __dmul_rn(p, Ap);
    }
    {
      const double sum = block_tree_sum(prod, s_warp);
      if (threadIdx.x == 0) a.cs_a[c] = sum;
    }
    grid.sync();
    const double alpha = __ddiv_rn(rz, sum_chunks(a.cs_a, a.chunks, s_warp));

    // ---- phase 2: x += alpha p, r -= alpha Ap, z = r*inv_diag, published; chunk sums of r.z
    prod = 0.0;
    if (live) {
      x = __dadd_rn(x, __dmul_rn(alpha, p));
      r = __dsub_rn(r, __dmul_rn(alpha, Ap));
      z = __dmul_rn(r, inv_diag);
      prod = __dmul_rn(r, z);
      a.z[i] = z;
    }
    {
      const double sum = block_tree_sum(prod, s_warp);
      if (threadIdx.x == 0) a.cs_b[c] = sum;
    }
    grid.sync();
    const double rz_new = sum_chunks(a.cs_b, a.chunks, s_warp);
    beta = __ddiv_rn(rz_new, rz);
    rz = rz_new;
    ++k;
  }
  if (live) {
    a.x[i] = x;
    a.r[i] = r;
  }
  finish(a, k, rz);
}

// ---- streaming case: each block walks its chunks, the state in device memory

// The chunks block blockIdx.x takes in every phase: begin, begin + stride,
// ... below end; a group of kRows chunks is c0, c0 + stride, ... and the
// next group starts at c0 + kRows * stride.
struct Walk {
  int64_t begin, end, stride;
};

__device__ __forceinline__ Walk block_walk(int64_t chunks) {
  const int64_t G = gridDim.x, b = blockIdx.x;
  if constexpr (kContiguousRuns) return {b * chunks / G, (b + 1) * chunks / G, 1};
  return {b, chunks, G};
}

// Phase 1's mask words of group 0 for two groups of rows, staged in shared
// memory by cp.async (kPrefetch): each thread copies and reads only its own
// rows, and a buffer is refilled one group after it was read.
template <bool kOn>
struct Stage {
  uint32_t m[2][kRows][3][kChunk];
};
template <>
struct Stage<false> {};

// Issues the copies of the group at c0 (rows that exist only) into buffer `buf`.
template <bool kOn>
__device__ __forceinline__ void stage_group(Stage<kOn>& st, int buf, const Params& a,
                                            const Walk& w, int64_t c0) {
  if constexpr (kOn) {
    const int t = threadIdx.x;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int64_t c = c0 + u * w.stride;
      const int64_t i = c * kChunk + t;
      if (c < w.end && i < a.N) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(&st.m[buf][u][q][t]));
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                       "l"(a.masks + q * a.N + i)
                       : "memory");
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

template <bool kPf>
__global__ void __launch_bounds__(kChunk, kStreamBlocksPerSM) dia_cg_stream(const Params a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int64_t s_off[kMaxDiags];
  __shared__ double s_warp[kWarps];
  __shared__ double s_runs[2][kRows * kWarps];
  __shared__ Stage<kPf> s_stage;
  load_offsets(a, s_off);
  const int t = threadIdx.x;
  const int64_t N = a.N;
  const Walk w = block_walk(a.chunks);
  const int64_t step = kRows * w.stride;
  int parity = 0;

  // start: masks packed; x = x0, r = b - A(x0), z = r*inv_diag; chunk sums
  // of b.b and r.z (p_1 = z is taken from z in iteration 1)
  for (int64_t c = w.begin; c < w.end; c += w.stride) {
    const int64_t i = c * kChunk + t;
    double bb[1] = {0.0}, rz_i[1] = {0.0};
    if (i < N) {
      const bool interior = a.is_int[i] != 0;
      const double x = a.x0[i];
      double mv = 0.0, corr = 0.0;
      for (int g = 0; g < a.groups; ++g) {
        uint32_t edge, high, cvn;
        pack_group(a, s_off, g, i, edge, high, cvn);
        uint32_t* m = a.masks + static_cast<int64_t>(3 * g) * N + i;
        m[0] = edge;
        m[N] = high;
        m[2 * N] = cvn;
        if (interior)
          gather_group<kGatherStream>(edge, high, cvn, s_off + g * kMaskDiags, i, a.x0,
                                      nullptr, 0.0, false, a.val_low, a.val_high, mv, corr);
      }
      const double b = a.rhs[i];
      const double r = __dsub_rn(b, interior ? interior_row(a.diag_i[i], a.dgc[i], x, mv, corr)
                                             : x);
      const double z = __dmul_rn(r, a.inv_diag[i]);
      a.x[i] = x;
      a.r[i] = r;
      a.z[i] = z;
      bb[0] = __dmul_rn(b, b);
      rz_i[0] = __dmul_rn(r, z);
    }
    publish_chunk_sums<1>(bb, c, w.stride, w.end, a.cs_c, s_runs[parity]);
    parity ^= 1;
    publish_chunk_sums<1>(rz_i, c, w.stride, w.end, a.cs_b, s_runs[parity]);
    parity ^= 1;
  }
  grid.sync();
  const double norm2_rhs = sum_chunks(a.cs_c, a.chunks, s_warp);
  double rz = sum_chunks(a.cs_b, a.chunks, s_warp);
  double beta = 0.0;

  int k = 1;
  while (k <= a.max_iterations && __ddiv_rn(rz, norm2_rhs) > a.tol2) {
    const bool fold = k > 1;
    double* const p_new = (k & 1) ? a.p[1] : a.p[0];
    const double* const p_old = (k & 1) ? a.p[0] : a.p[1];

    // ---- phase 1: p = z + beta p, published; Ap = A(p); chunk sums of p.Ap.
    // Every row gathers, interior or not, and nothing is stored before the
    // gathers: only the mask words stand between a group's start and its
    // gathers, and the own-row loads arrive while the gathers run.
    int buf = 0;
    stage_group<kPf>(s_stage, buf, a, w, w.begin);
    for (int64_t c0 = w.begin; c0 < w.end; c0 += step) {
      int64_t row[kRows];
      bool in[kRows], interior[kRows];
      double zv[kRows], pv[kRows], dg[kRows], dc[kRows], prod[kRows];
      uint32_t edge[kRows], high[kRows], cvn[kRows];
      if constexpr (kPf) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        row[u] = (c0 + u * w.stride) * kChunk + t;
        in[u] = c0 + u * w.stride < w.end && row[u] < N;
        interior[u] = false;
        zv[u] = pv[u] = dg[u] = dc[u] = prod[u] = 0.0;
        edge[u] = high[u] = cvn[u] = 0u;
        if (in[u]) {
          const int64_t i = row[u];
          if constexpr (kPf) {
            edge[u] = s_stage.m[buf][u][0][t];
            high[u] = s_stage.m[buf][u][1][t];
            cvn[u] = s_stage.m[buf][u][2][t];
          } else {
            edge[u] = a.masks[i];
            high[u] = a.masks[N + i];
            cvn[u] = a.masks[2 * N + i];
          }
          zv[u] = a.z[i];
          if (fold) pv[u] = p_old[i];
          interior[u] = a.is_int[i] != 0;
          dg[u] = a.diag_i[i];
          dc[u] = a.dgc[i];
        }
      }
      if (c0 + step < w.end) stage_group<kPf>(s_stage, buf ^ 1, a, w, c0 + step);
      buf ^= 1;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (in[u]) {
          const int64_t i = row[u];
          double mv = 0.0, corr = 0.0;
          gather_group<kGatherStream>(edge[u], high[u], cvn[u], s_off, i, a.z, p_old, beta, fold,
                                      a.val_low, a.val_high, mv, corr);
          for (int g = 1; g < a.groups; ++g) {
            const uint32_t* m = a.masks + static_cast<int64_t>(3 * g) * N + i;
            gather_group<kGatherStream>(m[0], m[N], m[2 * N], s_off + g * kMaskDiags, i, a.z,
                                        p_old, beta, fold, a.val_low, a.val_high, mv, corr);
          }
          const double p = fold ? __dadd_rn(zv[u], __dmul_rn(beta, pv[u])) : zv[u];
          const double ap = interior[u] ? interior_row(dg[u], dc[u], p, mv, corr) : p;
          p_new[i] = p;
          a.Ap[i] = ap;
          prod[u] = __dmul_rn(p, ap);
        }
      }
      publish_chunk_sums<kRows>(prod, c0, w.stride, w.end, a.cs_a, s_runs[parity]);
      parity ^= 1;
    }
    grid.sync();
    const double alpha = __ddiv_rn(rz, sum_chunks(a.cs_a, a.chunks, s_warp));

    // ---- phase 2: x += alpha p, r -= alpha Ap, z = r*inv_diag, published; chunk sums of r.z
    for (int64_t c0 = w.begin; c0 < w.end; c0 += step) {
      int64_t row[kRows];
      bool in[kRows];
      double pv[kRows], av[kRows], xv[kRows], rv[kRows], iv[kRows], prod[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        row[u] = (c0 + u * w.stride) * kChunk + t;
        in[u] = c0 + u * w.stride < w.end && row[u] < N;
        pv[u] = av[u] = xv[u] = rv[u] = iv[u] = prod[u] = 0.0;
        if (in[u]) {
          const int64_t i = row[u];
          pv[u] = p_new[i];
          av[u] = a.Ap[i];
          xv[u] = a.x[i];
          rv[u] = a.r[i];
          iv[u] = a.inv_diag[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (in[u]) {
          const int64_t i = row[u];
          const double x = __dadd_rn(xv[u], __dmul_rn(alpha, pv[u]));
          const double r = __dsub_rn(rv[u], __dmul_rn(alpha, av[u]));
          const double z = __dmul_rn(r, iv[u]);
          prod[u] = __dmul_rn(r, z);
          a.x[i] = x;
          a.r[i] = r;
          a.z[i] = z;
        }
      }
      publish_chunk_sums<kRows>(prod, c0, w.stride, w.end, a.cs_b, s_runs[parity]);
      parity ^= 1;
    }
    grid.sync();
    const double rz_new = sum_chunks(a.cs_b, a.chunks, s_warp);
    beta = __ddiv_rn(rz_new, rz);
    rz = rz_new;
    ++k;
  }
  finish(a, k, rz);
}

// Nothing but grid syncs, on the grid and block size of a solve: what the
// syncs of an iteration cost with no work between them.
__global__ void __launch_bounds__(kChunk) grid_sync_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < syncs; ++s) grid.sync();
}

// What the launcher learns once per device.
struct DeviceInfo {
  bool known = false;
  int cooperative = 0;
  int sms = 0;
  int blocks_per_sm_resident = 0;
  int blocks_per_sm_stream = 0;
};
constexpr int kMaxDevices = 64;
DeviceInfo g_info[kMaxDevices];

int64_t chunks_of(long long N) { return (N + kChunk - 1) / kChunk; }
int groups_of(int D) { return (D + kMaskDiags - 1) / kMaskDiags; }

}  // namespace

// Error codes of this file, beside cudaError_t values (> 0).
enum {
  kErrTooManyDiags = -1,       // D > kMaxDiags
  kErrNoCooperativeLaunch = -2,
  kErrNotResident = -3,        // occupancy gives no resident block
  kErrBadArgument = -4,        // N or D not positive, or a device index beyond the table
};

namespace {

// The grid of a solve of N rows and D diagonals on the current device:
// `blocks` and whether the register-resident case runs. Returns 0, a
// cudaError_t, or one of the negative codes above.
int plan(int D, long long N, long long& blocks, bool& regs) {
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
             &di.blocks_per_sm_resident, dia_cg_resident, kChunk, 0)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &di.blocks_per_sm_stream, dia_cg_stream<kPrefetch>, kChunk, 0)) != cudaSuccess)
      return static_cast<int>(err);
    di.known = true;
  }
  if (!di.cooperative) return kErrNoCooperativeLaunch;
  const long long chunks = chunks_of(N);
  const long long resident_blocks = static_cast<long long>(di.blocks_per_sm_resident) * di.sms;
  regs = D <= kMaskDiags && chunks <= resident_blocks;
  const long long resident =
      regs ? resident_blocks : static_cast<long long>(di.blocks_per_sm_stream) * di.sms;
  if (resident <= 0) return kErrNotResident;
  blocks = chunks < resident ? chunks : resident;
  return 0;
}

}  // namespace

extern "C" int dia_cg_chunk() { return kChunk; }
extern "C" int dia_cg_max_diags() { return kMaxDiags; }
extern "C" int dia_cg_syncs_per_iteration() { return kSyncsPerIteration; }

// Doubles of workspace a solve of N rows and D diagonals takes on the
// current device: z, two p buffers and three arrays of chunk sums; in the
// streaming case also Ap and the mask words. A negative value is an error
// code of dia_cg_solve_launch.
extern "C" long long dia_cg_workspace_doubles(int D, long long N) {
  long long blocks = 0;
  bool regs = false;
  const int err = plan(D, N, blocks, regs);
  if (err != 0) return err < 0 ? err : -1000 - err;
  const long long base = 3 * N + 3 * chunks_of(N);
  return regs ? base : base + N + (3LL * groups_of(D) * N + 1) / 2;
}

// One cooperative launch on `stream`. `work` holds dia_cg_workspace_doubles(D,
// N) doubles. `info` receives {blocks, 1 if the register-resident case ran
// else 0}. Returns 0, a cudaError_t, or one of the negative codes above.
// Allocates nothing and does not synchronise.
extern "C" int dia_cg_solve_launch(
    const void* diags, const void* offsets, int D, long long N,
    double val_low, double val_high, const void* cvac, const void* is_int,
    const void* diag_i, const void* dgc, const void* inv_diag, const void* rhs,
    const void* x0, double tol2, int max_iterations, void* x, void* r,
    void* work, void* iterations, void* residual_sq, void* iterations_total,
    void* stream, int* info) {
  long long blocks = 0;
  bool regs = false;
  const int planned = plan(D, N, blocks, regs);
  if (planned != 0) return planned;

  Params a;
  a.diags = static_cast<const int8_t*>(diags);
  a.offsets = static_cast<const int64_t*>(offsets);
  a.D = D;
  a.groups = groups_of(D);
  a.N = N;
  a.chunks = chunks_of(N);
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
  a.z = w;
  a.p[0] = w + N;
  a.p[1] = w + 2 * N;
  a.cs_a = w + 3 * N;
  a.cs_b = a.cs_a + a.chunks;
  a.cs_c = a.cs_b + a.chunks;
  a.Ap = regs ? nullptr : a.cs_c + a.chunks;
  a.masks = regs ? nullptr : reinterpret_cast<uint32_t*>(a.Ap + N);
  a.iterations = static_cast<int*>(iterations);
  a.residual_sq = static_cast<double*>(residual_sq);
  a.iterations_total = static_cast<long long*>(iterations_total);
  info[0] = static_cast<int>(blocks);
  info[1] = regs ? 1 : 0;

  void* args[] = {&a};
  const void* fn = regs ? reinterpret_cast<const void*>(dia_cg_resident)
                        : reinterpret_cast<const void*>(dia_cg_stream<kPrefetch>);
  // cudaLaunchKernelEx with the cooperative attribute rather than
  // cudaLaunchCooperativeKernel: the same launch, and one that a stream
  // capture records as a cooperative kernel node (a superstep's CUDA graph,
  // models/step_program.py, launches the solve from inside the graph)
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kChunk);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The grid syncs of `iterations` iterations and nothing else on `blocks`
// blocks of a solve's size: the floor under an iteration, measured beside the
// solve. Returns 0 or a cudaError_t (a grid too large to be resident is
// refused by the runtime).
extern "C" int dia_cg_sync_floor_launch(int blocks, int iterations, void* stream) {
  int syncs = kSyncsPerIteration * iterations;
  void* args[] = {&syncs};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(grid_sync_kernel), dim3(static_cast<unsigned>(blocks)),
      dim3(kChunk), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
