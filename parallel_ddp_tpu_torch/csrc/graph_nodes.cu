// Conditional WHILE nodes for a CUDA graph under stream capture: what the
// port's `graphs.while_loop` captures a `lax.while_loop` into.
//
// pddp_while_begin, called while `parent` is capturing:
//   1. creates a conditional handle in the graph `parent` captures into;
//   2. captures a one-thread kernel that sets the handle from a bool on the
//      device (the loop's first test);
//   3. adds a WHILE node behind it and makes it the stream's dependency;
//   4. starts capturing `body` (a stream that is not capturing) into the
//      node's body graph.
// The caller enqueues the loop body on `body`, then pddp_while_end captures
// the kernel that sets the handle from the body's last test and ends the
// body's capture.  A replay runs the body while the handle is nonzero; the
// host reads nothing.
//
// Needs the CUDA runtime 12.4 or later (conditional nodes, capture to a
// graph); an older one returns cudaErrorNotSupported.

#include <cuda_runtime.h>

#if CUDART_VERSION >= 12040

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const unsigned char* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

static cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                                cudaGraph_t* graph, const cudaGraphNode_t** deps,
                                size_t* ndeps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr, ndeps);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, ndeps);
#endif
}

extern "C" int pddp_while_begin(void* parent_stream, const void* flag, void* body_stream,
                                int capture_mode, unsigned long long* handle_out,
                                void** body_graph_out) {
  cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_info(parent, &status, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorStreamCaptureUnmatched);

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition_kernel<<<1, 1, 0, parent>>>(handle, static_cast<const unsigned char*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = capture_info(parent, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(parent, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), body, nullptr,
                                      nullptr, 0, static_cast<cudaStreamCaptureMode>(capture_mode));
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = handle;
  *body_graph_out = body;
  return 0;
}

extern "C" int pddp_while_end(void* body_stream, unsigned long long handle, const void* flag) {
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  set_condition_kernel<<<1, 1, 0, body>>>(handle, static_cast<const unsigned char*>(flag));
  cudaError_t err = cudaGetLastError();
  cudaGraph_t graph;
  cudaError_t end = cudaStreamEndCapture(body, &graph);
  return static_cast<int>(err != cudaSuccess ? err : end);
}

#else

extern "C" int pddp_while_begin(void*, const void*, void*, int, unsigned long long*, void**) {
  return static_cast<int>(cudaErrorNotSupported);
}

extern "C" int pddp_while_end(void*, unsigned long long, const void*) {
  return static_cast<int>(cudaErrorNotSupported);
}

#endif

// The nodes of one graph, not counting those inside its conditional nodes'
// bodies (the caller counts each body graph it made).
extern "C" int pddp_graph_nodes(void* graph, unsigned long long* count) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *count = n;
  return static_cast<int>(err);
}
