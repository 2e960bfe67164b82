// CUDA-graph conditional IF nodes for stream capture, with a plain C interface.
//
// A host-side helper of core/graph.py, not a port of a TPU kernel: the JAX
// package's device loop branches with lax.cond inside one XLA program
// (skeres_tpu/core/device_loop.py); the port captures one LM step as a CUDA
// graph and branches with conditional nodes (CUDA 12.4+). The torch build this
// runs with has no Python binding for them, so this file adds the three steps:
//
//   skeres_if_node_begin    on a capturing stream: create a conditional handle
//                           in the graph being captured, launch a one-thread
//                           kernel that sets it from a device bool, add an IF
//                           node after that kernel, and make the node the
//                           stream's only dependency; returns the node's body
//                           graph;
//   skeres_capture_to_graph begin capturing another stream into that body;
//   skeres_capture_end      end that capture.
//
// Work captured into the body runs on a replay only when the bool was true at
// that point of the replay. Each function returns the cudaError_t it met.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int skeres_if_node_begin(void* stream, const void* pred, void** body_out) {
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
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  *body_out = params.conditional.phGraph_out[0];
  return 0;
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
