// CUDA-graph conditional IF and WHILE nodes for stream capture, and the device
// clock's stamps, with a plain C interface.
//
// A host-side helper of core/graph.py, not a port of a TPU kernel: the JAX
// package's device loop branches with lax.cond inside one XLA program
// (skeres_tpu/core/device_loop.py); the port captures one LM step as a CUDA
// graph and branches with conditional nodes (CUDA 12.4+). The torch build this
// runs with has no Python binding for them, so this file adds the steps:
//
//   skeres_if_node_begin    on a capturing stream: create a conditional handle
//                           in the graph being captured, launch a one-thread
//                           kernel that sets it from a device bool, add an IF
//                           node after that kernel, and make the node the
//                           stream's only dependency; returns the node's body
//                           graph;
//   skeres_while_node_begin the same with a WHILE node (lax.while_loop's
//                           counterpart: the PCG of the iterative solvers);
//                           also returns the handle, which the body sets again
//                           as its last work;
//   skeres_set_conditional  on the stream capturing a WHILE body: launch the
//                           one-thread kernel that sets the handle from a
//                           device bool;
//   skeres_capture_to_graph begin capturing another stream into a body;
//   skeres_capture_end      end that capture;
//   skeres_stamp            launch a one-thread kernel that writes the device's
//                           %globaltimer (nanoseconds) into dst[*index], or
//                           dst[0] with no index: the device loop's stamps of
//                           each step's phases, captured into the step like
//                           any kernel.
//
// Work captured into an IF body runs on a replay only when the bool was true
// at that point of the replay; a WHILE body runs again and again for as long
// as the handle, set before the node and at the end of each turn, is not 0.
// Each function returns the cudaError_t it met.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The conditional node of either type, after a kernel that sets its handle
// from *pred.
int cond_node_begin(void* stream, const void* pred, cudaGraphConditionalNodeType type,
                    void** body_out, cudaGraphConditionalHandle* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorIllegalState);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_conditional_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dependencies now end in the kernel just captured
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  *body_out = params.conditional.phGraph_out[0];
  *handle_out = handle;
  return 0;
}

__global__ void stamp_kernel(long long* dst, const long long* index, int n) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long k = index ? *index : 0;
  if (k >= 0 && k < n) dst[k] = static_cast<long long>(t);
}

}  // namespace

extern "C" int skeres_if_node_begin(void* stream, const void* pred, void** body_out) {
  cudaGraphConditionalHandle handle = 0;
  return cond_node_begin(stream, pred, cudaGraphCondTypeIf, body_out, &handle);
}

extern "C" int skeres_while_node_begin(void* stream, const void* pred, void** body_out,
                                       unsigned long long* handle_out) {
  cudaGraphConditionalHandle handle = 0;
  int err = cond_node_begin(stream, pred, cudaGraphCondTypeWhile, body_out, &handle);
  *handle_out = static_cast<unsigned long long>(handle);
  return err;
}

extern "C" int skeres_set_conditional(void* stream, unsigned long long handle, const void* pred) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle), static_cast<const bool*>(pred));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int skeres_capture_to_graph(void* stream, void* graph) {
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(graph), nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
}

extern "C" int skeres_capture_end(void* stream) {
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph));
}

extern "C" int skeres_stamp(void* stream, void* dst, const void* index, int n) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(dst), static_cast<const long long*>(index), n);
  return static_cast<int>(cudaGetLastError());
}
