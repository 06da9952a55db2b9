// Conditional IF and WHILE nodes inside a CUDA graph that PyTorch is
// capturing.
//
// solver/graph.py keeps the interior-point loop as a captured CUDA graph.
// The reference runs the whole solve as one lax.while_loop and stops
// iterative refinement on the device (a lax.while_loop on ref_cond,
// conicip_tpu/solver/ipm.py); a CUDA graph does the same with one
// conditional WHILE node whose body is a unit of the loop, and one
// conditional IF node per refinement trip, whose body is the trip; each
// node's condition is a bool on the device (some instance still goes
// on). PyTorch's CUDAGraph exposes no conditional node, so this file adds
// them to the graph under capture:
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
//   conicip_while_begin(stream, child, pred, mode, &handle)
//     - the same with a WHILE node, and the handle returned;
//   conicip_while_end(child, handle, pred)
//     - launches set_condition(handle, pred) on `child`, the body's last
//       node, so that the body runs again while *pred holds after it,
//     - ends the body's capture.
//
// Between begin and end, whatever is issued on `child` becomes the body:
// an IF body runs on a replay only when *pred was true when set_condition
// ran; a WHILE body runs while it is, *pred read before the first run and
// after each (the body writes it). The caller routes the body's
// allocations to the graph's memory pool. Needs CUDA 12.4 or later
// (conditional nodes, capture to an existing graph). Each function
// returns a cudaError_t, 0 on success.
//
// This is graph plumbing, not a port of a TPU kernel: set_condition
// computes nothing, and its CPU counterpart is the host loop's read of the
// same bool (ipm.run_chunks, the eager loop's early exits).
//
// Phase clocks (telemetry.DeviceClock), captured into the loop's graphs
// while telemetry is on:
//
//   conicip_stamp(stream, buf, slot, phases)
//     - launches phase_stamp (one thread) on `stream`: it reads the card's
//       %globaltimer (ns), adds the time since the previous stamp,
//       buf[phases], to buf[slot] (slot >= 0, a phase), or zeroes
//       buf[0..phases) (slot -1, a reset), or counts nothing (slot -2, a
//       mark), and keeps the time in buf[phases].
//
// Like set_condition, it computes nothing of the solve and replaces no
// TPU kernel; the CPU's phases are read on the host's clock
// (ipm.run_chunks).

#include <cuda_runtime.h>

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

namespace {

int begin_node(void* stream_ptr, void* child_ptr, const void* pred,
               int mode, cudaGraphConditionalNodeType type,
               cudaGraphConditionalHandle* handle_out) {
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
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  if (handle_out != nullptr) *handle_out = handle;
  return cudaStreamBeginCaptureToGraph(
      child, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      static_cast<cudaStreamCaptureMode>(mode));
}

}  // namespace

extern "C" int conicip_if_begin(void* stream_ptr, void* child_ptr,
                                const void* pred, int mode) {
  return begin_node(stream_ptr, child_ptr, pred, mode, cudaGraphCondTypeIf,
                    nullptr);
}

extern "C" int conicip_if_end(void* child_ptr) {
  cudaGraph_t body = nullptr;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child_ptr), &body);
}

extern "C" int conicip_while_begin(void* stream_ptr, void* child_ptr,
                                   const void* pred, int mode,
                                   unsigned long long* handle_out) {
  cudaGraphConditionalHandle handle = 0;
  int err = begin_node(stream_ptr, child_ptr, pred, mode,
                       cudaGraphCondTypeWhile, &handle);
  *handle_out = handle;
  return err;
}

extern "C" int conicip_while_end(void* child_ptr, unsigned long long handle,
                                 const void* pred) {
  cudaStream_t child = static_cast<cudaStream_t>(child_ptr);
  set_condition<<<1, 1, 0, child>>>(handle, static_cast<const bool*>(pred));
  cudaError_t launched = cudaGetLastError();
  // the capture ends either way, so that the stream is usable again
  cudaGraph_t body = nullptr;
  cudaError_t ended = cudaStreamEndCapture(child, &body);
  return launched != cudaSuccess ? launched : ended;
}

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void phase_stamp(long long* buf, int slot, int phases) {
  const long long now = global_ns();
  if (slot >= 0) {
    buf[slot] += now - buf[phases];
  } else if (slot == -1) {
    for (int i = 0; i < phases; ++i) buf[i] = 0;
  }
  buf[phases] = now;
}

}  // namespace

extern "C" int conicip_stamp(void* stream_ptr, void* buf, int slot,
                             int phases) {
  phase_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<long long*>(buf), slot, phases);
  return cudaGetLastError();
}
