// The tiled pairwise potential on the card in one launch: per tile, the
// charged sites within reach, in the order of the charged list, and the
// screened-Coulomb sum of every site of the tile over them, all kept on the
// chip. It computes what ops/pairwise.py::pairwise_potential_tiled_plain
// computes, bit for bit:
//
//     pot[i] = sum over the first cand_cap charged-list entries q within the
//              tile's reach (list order), of
//              (d2 < cut2 and i != site(q)) ? q_val * erfc(d * inv_sig) * kq / d : 0
//     d2 = (dx*dx + dy*dy) + dz*dz,  d = ang * sqrt(d2)
//
// in the plane's type P (float, or double for the f64 plane), each site's
// terms added one after the other in candidate order in a P accumulator,
// which is converted to double at the end. The tile filter is the twin's f32
// test on the tile center: d2c = (dx*dx + dy*dy) + dz*dz < reach (the padded
// squared reach, computed by the wrapper as the twin computes it).
//
// Replaces no Pallas kernel: akmc_tpu leaves the tiled plane to XLA, which
// fuses it. Written because PyTorch does not: it put every intermediate of
// the (T, S, C) plane and of the (T, Q) filter through device memory, about
// 150 bytes a plane entry, and sorted the filter's (T, Q) mask.
//
// Bound on this card. What the function needs is the pairs inside the
// cutoff (108 M at the 40 nm crossbar's initial state), each about 29 issued
// instructions, 3 of them MUFU (a reciprocal square root that serves both
// the square root and the division, an ex2 and a reciprocal in erfc), so
// f32 issue bounds it: at 132 SMs x 128 lanes x 1.98 GHz about 0.09 ms
// (chip_smoke.py's pair_tiled_bound). This kernel issues far more: it tests
// every pair of a tile with its candidates, those beyond the cutoff too
// (315 M in all there), and its IEEE division and library erfc give the
// twin's bits rather than the fewest instructions; its SASS spends 27
// instructions a pair tested and 78 more a pair inside the cutoff, about
// 0.5 ms of issue. The filter: testing every list entry against every tile
// center would read the list from L2 once a tile (T x Q x 12 bytes,
// terabytes at the 40 nm crossbar's size), far above the pairs. So the
// wrapper sorts the list's valid entries into a hash of coarse cells, and
// gives each tile the buckets of the cells its reach meets, at most three a
// side (ops/pairwise.py::_buckets): a tile tests only their entries, about
// 30 times fewer tests.
//
// Design. One block per tile, one thread per slot (a loop over slots past
// the block's width). The block walks its row of the cell table, tests each
// entry there and sets the entry's bit, at its list position, in a bitmap in
// shared memory (a bucket met twice through a hash collision sets the same
// bits). A prefix count over the bitmap's words ranks the entries in list
// order: that is the twin's candidate order without a sort. Entries ranked
// below cand_cap go, a ring of kRing at a time, into shared memory (position
// and value in P, site id), and every thread adds its site's terms over the
// ring in rank order. The tile's whole count sets the candidate overflow
// flag; entries past cand_cap are counted and not summed, as the twin
// truncates. A list longer than the bitmap (kWindow positions) is taken in
// windows of list positions, in order. Each slot's sum is written to
// pot[site]: every site lies in one tile slot, so no two blocks write one
// place, and sites outside the given tiles keep the zeros the wrapper put
// there (a rank's share). The block allocates nothing and reads nothing back.
//
// Rounding: every operation of the pair term is spelled with an _rn
// intrinsic, so none is contracted; erfcf / erfc are the CUDA math library's,
// as PyTorch's erfc kernel calls them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct PairArgs {
  const long long* tile_sites;   // (T, S) site ids, -1 pad
  const double* pos_tiles;       // (T, S, 3) site positions
  const double* tile_center;     // (T, 3)
  const double* q_pos;           // (Q, 3) positions of the charged list
  const double* q_val;           // (Q,) charges
  const long long* q_idx;        // (Q,) site ids
  const float* reach;            // 0-d: the filter's squared reach
  const long long* order;        // (Q,) list positions of the valid entries, by bucket
  const long long* start;        // (H + 1,) each bucket's first place in `order`
  const long long* cells;        // (T, kCells) the buckets a tile tests, -1 none
  double* pot;                   // (N,) zeros on entry
  unsigned char* cand_overflow;  // 0-d bool, false on entry
  long long T, S, Q, cand_cap;
  double cut2, inv_sig, kq, ang;
  int plane_f32;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 1024;                  // bitmap words: a window of list positions
constexpr int kWindow = kWords * 32;
constexpr int kWordsPerThread = kWords / kThreads;
constexpr int kRing = 512;                    // candidates summed per pass over the slots
constexpr int kCells = 27;                    // cells a tile tests: three a side

template <typename P> struct Ar;

template <> struct Ar<float> {
  static __device__ __forceinline__ float cvt(double x) { return __double2float_rn(x); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float erfc(float a) { return erfcf(a); }
};

template <> struct Ar<double> {
  static __device__ __forceinline__ double cvt(double x) { return x; }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double erfc(double a) { return ::erfc(a); }
};

// dynamic shared memory: the cells' first places (long long), the ring and the
// accumulators (P), then the bitmap, its word ranks, the ring's site ids and
// the scans' scratch (int)
__host__ __device__ inline size_t smem_bytes(long long S, size_t p) {
  return kCells * sizeof(long long) + (4 * kRing + S) * p
       + sizeof(int) * (2 * kWords + kRing + kCells + 1 + kWarps);
}

// exclusive prefix sum of v over the block; *total gets the sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) wsum[lane] = w;
  }
  __syncthreads();
  const int before = (warp ? wsum[warp - 1] : 0) + x - v;
  *total = wsum[kWarps - 1];
  __syncthreads();
  return before;
}

template <typename P>
__global__ void __launch_bounds__(kThreads) pair_tiled(const PairArgs a) {
  using A = Ar<P>;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* cell_first = reinterpret_cast<long long*>(smem);
  P* rx = reinterpret_cast<P*>(cell_first + kCells);
  P* ry = rx + kRing;
  P* rz = ry + kRing;
  P* rq = rz + kRing;
  P* acc = rq + kRing;
  unsigned* bits = reinterpret_cast<unsigned*>(acc + a.S);
  int* word_rank = reinterpret_cast<int*>(bits + kWords);
  int* rs = word_rank + kWords;
  int* cell_rank = rs + kRing;
  int* wsum = cell_rank + kCells + 1;

  const long long t = blockIdx.x;
  const int tid = threadIdx.x;
  const long long S = a.S;
  const P cut2 = A::cvt(a.cut2), inv_sig = A::cvt(a.inv_sig), kq = A::cvt(a.kq),
          ang = A::cvt(a.ang);
  const double* c = a.tile_center + 3 * t;
  const float cx = __double2float_rn(c[0]), cy = __double2float_rn(c[1]),
              cz = __double2float_rn(c[2]);
  const float reach = *a.reach;

  // the tile's cells: each one's first place in `order`, and the ranks of
  // their entries, one after the other
  int len = 0;
  if (tid < kCells) {
    const long long b = a.cells[t * kCells + tid];
    if (b >= 0) {
      cell_first[tid] = a.start[b];
      len = static_cast<int>(a.start[b + 1] - a.start[b]);
    }
  }
  int total;
  const int before = block_exclusive_scan(len, wsum, &total);
  if (tid < kCells) cell_rank[tid] = before;
  if (tid == 0) cell_rank[kCells] = total;
  for (long long s = tid; s < S; s += kThreads) acc[s] = P(0);
  long long taken = 0;     // in-reach entries of the earlier windows
  for (long long w0 = 0; w0 < a.Q; w0 += kWindow) {
    for (int i = tid; i < kWords; i += kThreads) bits[i] = 0u;
    __syncthreads();
    // 1. the bits of this window's in-reach entries
    for (int k = tid; k < total; k += kThreads) {
      int l = 0, h = kCells;   // the last cell j with cell_rank[j] <= k
      while (h - l > 1) {
        const int m = (l + h) >> 1;
        if (cell_rank[m] <= k) l = m; else h = m;
      }
      const long long q = a.order[cell_first[l] + (k - cell_rank[l])];
      if (q < w0 || q >= w0 + kWindow) continue;
      const double* p = a.q_pos + 3 * q;
      const float dx = __fsub_rn(cx, __double2float_rn(p[0]));
      const float dy = __fsub_rn(cy, __double2float_rn(p[1]));
      const float dz = __fsub_rn(cz, __double2float_rn(p[2]));
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < reach) {
        const long long o = q - w0;
        atomicOr(&bits[o >> 5], 1u << (o & 31));
      }
    }
    __syncthreads();

    // 2. each word's rank: the in-reach entries before it in the window
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j) cnt += __popc(bits[tid * kWordsPerThread + j]);
    int in_window;
    int r = block_exclusive_scan(cnt, wsum, &in_window);
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j) {
      word_rank[tid * kWordsPerThread + j] = r;
      r += __popc(bits[tid * kWordsPerThread + j]);
    }
    __syncthreads();

    // 3. the candidates ranked below cand_cap, a ring at a time, in rank order
    const long long end = taken + in_window < a.cand_cap ? taken + in_window : a.cand_cap;
    for (long long r0 = taken; r0 < end; r0 += kRing) {
      const long long r1 = r0 + kRing < end ? r0 + kRing : end;
#pragma unroll
      for (int j = 0; j < kWordsPerThread; ++j) {
        const int w = tid * kWordsPerThread + j;
        unsigned m = bits[w];
        long long rank = taken + word_rank[w];
        if (rank >= r1 || rank + __popc(m) <= r0) continue;
        while (m) {
          const int bit = __ffs(m) - 1;
          m &= m - 1;
          if (rank >= r0 && rank < r1) {
            const long long q = w0 + 32LL * w + bit;
            const int slot = static_cast<int>(rank - r0);
            rx[slot] = A::cvt(a.q_pos[3 * q]);
            ry[slot] = A::cvt(a.q_pos[3 * q + 1]);
            rz[slot] = A::cvt(a.q_pos[3 * q + 2]);
            rq[slot] = A::cvt(a.q_val[q]);
            rs[slot] = static_cast<int>(a.q_idx[q]);
          }
          ++rank;
        }
      }
      __syncthreads();
      const int nr = static_cast<int>(r1 - r0);
      for (long long s = tid; s < S; s += kThreads) {
        const long long site = a.tile_sites[t * S + s];
        if (site < 0) continue;
        const double* sp = a.pos_tiles + 3 * (t * S + s);
        const P sx = A::cvt(sp[0]), sy = A::cvt(sp[1]), sz = A::cvt(sp[2]);
        const int self = static_cast<int>(site);
        P v = acc[s];
        for (int j = 0; j < nr; ++j) {
          const P dx = A::sub(sx, rx[j]), dy = A::sub(sy, ry[j]), dz = A::sub(sz, rz[j]);
          const P d2 = A::add(A::add(A::mul(dx, dx), A::mul(dy, dy)), A::mul(dz, dz));
          P term = P(0);
          if (d2 < cut2 && rs[j] != self) {
            const P d = A::mul(ang, A::sqrt(d2));
            term = A::div(A::mul(A::mul(rq[j], A::erfc(A::mul(d, inv_sig))), kq), d);
          }
          v = A::add(v, term);
        }
        acc[s] = v;
      }
      __syncthreads();
    }
    taken += in_window;
    __syncthreads();
  }

  if (tid == 0 && taken > a.cand_cap) *a.cand_overflow = 1;
  for (long long s = tid; s < S; s += kThreads) {
    const long long site = a.tile_sites[t * S + s];
    if (site >= 0) a.pot[site] = static_cast<double>(acc[s]);
  }
}

}  // namespace

extern "C" int pair_tiled_launch(const PairArgs* a, void* stream) {
  const size_t bytes = smem_bytes(a->S, a->plane_f32 ? sizeof(float) : sizeof(double));
  const void* kernel = a->plane_f32 ? reinterpret_cast<const void*>(&pair_tiled<float>)
                                    : reinterpret_cast<const void*>(&pair_tiled<double>);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a->T > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (a->plane_f32)
      pair_tiled<float><<<static_cast<unsigned>(a->T), kThreads, bytes, st>>>(*a);
    else
      pair_tiled<double><<<static_cast<unsigned>(a->T), kThreads, bytes, st>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}
