// CUDA conditional WHILE nodes for a stream capture under way: the graph
// form of `while (live) body();`, the counterpart of `lax.while_loop` inside
// one of akmc_tpu's executables. PyTorch (2.13) builds conditional IF nodes
// (CUDAGraph::begin_capture_to_if_node) but no WHILE node; this file builds
// one in the same way.
//
// graph_while_begin, on a stream that is capturing a graph G:
//   1. cudaStreamGetCaptureInfo: G and the capture's current dependencies;
//   2. cudaGraphConditionalHandleCreate on G (reset to 0 at every launch);
//   3. one launch of set_condition, which sets the handle from the device
//      flag `live` (so a loop that is dead at entry runs no pass);
//   4. cudaGraphAddNode of a conditional node of type While after it;
//   5. cudaStreamUpdateCaptureDependencies: later work waits for the node;
//   6. cudaStreamBeginCaptureToGraph of the node's body graph on the body
//      stream, where the caller then issues the body.
// graph_while_end issues set_condition once more as the body's last node
// (the body recomputes `live` before it) and ends the body's capture. The
// node then runs its body again for as long as the body leaves `live` true.
//
// span_stamp_launch issues one stamp of a span table (runtime/profiling.py):
// a one-thread kernel that reads the device's %globaltimer (nanoseconds)
// where it stands in the stream or graph. A table row is five int64 words,
// [sum, count, first start, last end, open start]:
//   kOpen   writes the open start (and the first start while count is 0);
//   kClose  adds now - open start to sum, 1 to count, and sets last end;
//   kAnchor writes now into word 0 of a one-word row, as its own kernel
//           span_anchor (launched eagerly before a replay, it is the kernel
//           by which a trace finds the dispatch);
// inside a while body a row adds up the node's passes. globaltimer_samples
// reads the timer n times back to back in one thread, for its resolution.
//
// Replaces no TPU kernel: it is graph plumbing and tracing. It computes
// nothing, and every kernel in it runs one thread. Needs CUDA >= 12.3
// (conditional nodes).

#include <cuda_runtime.h>

#if CUDART_VERSION >= 13000
#define CAPTURE_INFO(s, st, g, d, n) cudaStreamGetCaptureInfo(s, st, nullptr, g, d, nullptr, n)
#define ADD_NODE(node, g, d, n, p) cudaGraphAddNode(node, g, d, nullptr, n, p)
#define SET_DEPENDENCIES(s, d, n) \
  cudaStreamUpdateCaptureDependencies(s, d, nullptr, n, cudaStreamSetCaptureDependencies)
#else
#define CAPTURE_INFO(s, st, g, d, n) cudaStreamGetCaptureInfo(s, st, nullptr, g, d, n)
#define ADD_NODE(node, g, d, n, p) cudaGraphAddNode(node, g, d, n, p)
#define SET_DEPENDENCIES(s, d, n) \
  cudaStreamUpdateCaptureDependencies(s, d, n, cudaStreamSetCaptureDependencies)
#endif

namespace {

constexpr int kErrNotCapturing = -1;

__global__ void set_condition(cudaGraphConditionalHandle handle, const unsigned char* live) {
  cudaGraphSetConditional(handle, *live != 0 ? 1u : 0u);
}

enum StampOp { kOpen = 0, kClose = 1, kAnchor = 2 };

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void span_stamp(long long* row, int op) {
  const long long now = global_ns();
  if (op == kOpen) {
    row[4] = now;
    if (row[1] == 0) row[2] = now;
  } else {
    row[0] += now - row[4];
    row[1] += 1;
    row[3] = now;
  }
}

__global__ void span_anchor(long long* row) { row[0] = global_ns(); }

__global__ void globaltimer_samples(long long* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = global_ns();
}

}  // namespace

extern "C" int graph_while_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err == cudaSuccess) err = cudaDriverGetVersion(driver);
  return static_cast<int>(err);
}

// Opens a while node on `stream`, which must be capturing, and starts the
// capture of its body on `body_stream`. `live` is a one-byte device flag
// (a 0-d bool tensor). Returns 0, a cudaError_t or kErrNotCapturing.
extern "C" int graph_while_begin(void* stream, void* body_stream, const void* live,
                                 unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = CAPTURE_INFO(s, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return kErrNotCapturing;

  cudaGraphConditionalHandle handle = 0;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const unsigned char*>(live));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  err = CAPTURE_INFO(s, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node = nullptr;
  if ((err = ADD_NODE(&node, graph, deps, n_deps, &params)) != cudaSuccess)
    return static_cast<int>(err);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  if ((err = SET_DEPENDENCIES(s, &node, 1)) != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), body, nullptr,
                                      nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

// Closes the body opened by graph_while_begin: sets the handle from `live`
// as the body's last node and ends the capture on `body_stream`.
extern "C" int graph_while_end(void* body_stream, unsigned long long handle, const void* live) {
  cudaStream_t b = static_cast<cudaStream_t>(body_stream);
  set_condition<<<1, 1, 0, b>>>(static_cast<cudaGraphConditionalHandle>(handle),
                                static_cast<const unsigned char*>(live));
  cudaError_t err = cudaGetLastError();
  cudaGraph_t captured = nullptr;
  const cudaError_t end = cudaStreamEndCapture(b, &captured);
  return static_cast<int>(err != cudaSuccess ? err : end);
}

// One stamp of `op` on the table row `row` (five int64 words), on `stream`
// (captured into the graph when the stream is capturing). kAnchor launches
// its own kernel, span_anchor, so that a trace tells anchors from the
// stamps inside a graph by name. Returns a cudaError_t.
extern "C" int span_stamp_launch(void* stream, long long* row, int op) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == kAnchor) {
    span_anchor<<<1, 1, 0, s>>>(row);
  } else {
    span_stamp<<<1, 1, 0, s>>>(row, op);
  }
  return static_cast<int>(cudaGetLastError());
}

// `n` reads of %globaltimer back to back into `out` (n int64), on `stream`.
extern "C" int globaltimer_samples_launch(void* stream, long long* out, int n) {
  globaltimer_samples<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, n);
  return static_cast<int>(cudaGetLastError());
}
