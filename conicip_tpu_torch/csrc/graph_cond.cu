// A conditional IF node inside a CUDA graph that PyTorch is capturing.
//
// solver/graph.py keeps the interior-point loop as a captured CUDA graph.
// The reference stops iterative refinement on the device (a
// lax.while_loop on ref_cond, conicip_tpu/solver/ipm.py); a CUDA graph
// does the same with one conditional IF node per refinement trip, whose
// body is the trip and whose condition is a bool on the device (some
// instance still goes on). PyTorch's CUDAGraph exposes no conditional
// node, so this file adds one to the graph under capture:
//
//   conicip_if_begin(stream, child, pred, mode)
//     - creates a conditional handle in the graph `stream` is capturing,
//     - launches set_condition (one thread: the handle <- *pred) on it,
//     - adds an IF node after the capture's current dependencies and makes
//       it the capture's only dependency,
//     - starts capturing `child` into the node's body graph;
//   conicip_if_end(child)
//     - ends the body's capture.
//
// Between the two, whatever is issued on `child` becomes the body: it runs
// on a replay only when *pred was true when set_condition ran. The caller
// routes the body's allocations to the graph's memory pool. Needs CUDA
// 12.4 or later (conditional nodes, capture to an existing graph). Each
// function returns a cudaError_t, 0 on success.
//
// This is graph plumbing, not a port of a TPU kernel: set_condition
// computes nothing, and its CPU counterpart is the eager loop's early exit
// (a host read of the same bool).

#include <cuda_runtime.h>

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int conicip_if_begin(void* stream_ptr, void* child_ptr,
                                const void* pred, int mode) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaStream_t child = static_cast<cudaStream_t>(child_ptr);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err =
      cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureUnmatched;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the dependencies after set_condition: the node follows it
  err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      child, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      static_cast<cudaStreamCaptureMode>(mode));
}

extern "C" int conicip_if_end(void* child_ptr) {
  cudaGraph_t body = nullptr;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child_ptr), &body);
}
