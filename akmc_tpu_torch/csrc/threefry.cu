// One step of akmc_tpu's threefry stream on the card: a loop step's split
// and uniforms in one elementwise pass, drawn from a key held in device
// memory. The counterpart of what akmc_tpu's event loops do per batch or
// event inside their lax.while_loop (akmc_tpu/ops/events.py:589, :834):
//
//     key, k_a, k_b = jax.random.split(key, 3)
//     u = jax.random.uniform(k_a, (n,), dtype)      # the clocks: f64 or f32
//     v = jax.random.uniform(k_b, (B,), f64)        # the slots
//
// and, with n = B = 0, the superstep's `key, sub = jax.random.split(key)`
// (rows 0 and 1 of split(key, 3) are those of split(key, 2)).
//
// Replaces no Pallas kernel: akmc_tpu leaves threefry to XLA. It is written
// here because a CUDA graph replays fixed launches: a host generator's
// draws, or a seed baked into a launch at capture, would repeat every pass
// of a while node. This kernel reads the key and the loop's `live` flag
// from device memory when it runs, so a graph that replays it draws anew.
//
// State (int64 words, each holding a 32-bit word): [0, 2) the key, [2, 8)
// the three subkeys of the last live step, [8] the count of blocks that have
// read the key. A dead step (`*live` false) returns at once: it writes
// nothing and leaves the key where it is. Three threads of each block
// compute the split (one block function each) into shared memory; the last
// block to finish, known by an atomic count taken after its threads have
// read the key, writes the new key and the subkeys and resets the count, so
// no block reads a key that another has moved on. Blocks are few (two an
// SM, grid-stride over the values), so that the count is short.
//
// Bound: bytes, as counted: a step writes n * 8 (f64) or n * 4 (f32) bytes
// of clocks and B * 8 of slot draws. The integer work (one block function,
// about 90 32-bit operations, a value) is not counted in that bound. The
// float conversion is one exact subtraction, so the result equals the plain
// twin (ops/threefry.py::draw_step_plain) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 2;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 with 20 rounds, as jax.random computes it
__device__ __forceinline__ void block_fn(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                                         uint32_t* y0, uint32_t* y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

__device__ __forceinline__ double uniform_f64(uint32_t b0, uint32_t b1) {
  const uint64_t bits = (static_cast<uint64_t>(b0) << 20) | (b1 >> 12) | 0x3FF0000000000000ull;
  return __dsub_rn(__longlong_as_double(static_cast<long long>(bits)), 1.0);
}

__device__ __forceinline__ float uniform_f32(uint32_t b0, uint32_t b1) {
  const uint32_t bits = ((b0 ^ b1) >> 9) | 0x3F800000u;
  return __fsub_rn(__uint_as_float(bits), 1.0f);
}

__global__ void __launch_bounds__(kThreads)
threefry_step(long long* state, const unsigned char* live, void* u, int u_f32, long long n,
              double* v, long long B) {
  if (live != nullptr && *live == 0) return;
  __shared__ uint32_t s[3][2];
  if (threadIdx.x < 3) {
    block_fn(static_cast<uint32_t>(state[0]), static_cast<uint32_t>(state[1]), 0u,
             threadIdx.x, &s[threadIdx.x][0], &s[threadIdx.x][1]);
  }
  __syncthreads();

  const long long m = n > B ? n : B;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += stride) {
    const uint32_t hi = static_cast<uint32_t>(static_cast<uint64_t>(i) >> 32);
    const uint32_t lo = static_cast<uint32_t>(i);
    uint32_t b0, b1;
    if (i < n) {
      block_fn(s[1][0], s[1][1], hi, lo, &b0, &b1);
      if (u_f32) {
        static_cast<float*>(u)[i] = uniform_f32(b0, b1);
      } else {
        static_cast<double*>(u)[i] = uniform_f64(b0, b1);
      }
    }
    if (i < B) {
      block_fn(s[2][0], s[2][1], hi, lo, &b0, &b1);
      v[i] = uniform_f64(b0, b1);
    }
  }

  // every thread of this block has read the key: count the block in; the
  // last one moves the key on
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned long long* count = reinterpret_cast<unsigned long long*>(state + 8);
    if (atomicAdd(count, 1ull) == static_cast<unsigned long long>(gridDim.x) - 1ull) {
      for (int r = 0; r < 3; ++r) {
        state[2 + 2 * r] = s[r][0];
        state[3 + 2 * r] = s[r][1];
      }
      state[0] = s[0][0];
      state[1] = s[0][1];
      *count = 0ull;
      __threadfence();
    }
  }
}

}  // namespace

// One step on `stream`. `live` may be null (always live); `u` (n values,
// f32 if u_f32 else f64) and `v` (B f64 values) may be null when n or B is
// 0. Returns cudaGetLastError() after the launch.
extern "C" int threefry_step_launch(void* state, const void* live, void* u, int u_f32,
                                    long long n, void* v, long long B, void* stream) {
  const long long m = n > B ? n : B;
  long long blocks = (m + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  threefry_step<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(state), static_cast<const unsigned char*>(live), u, u_f32, n,
      static_cast<double*>(v), B);
  return static_cast<int>(cudaGetLastError());
}
