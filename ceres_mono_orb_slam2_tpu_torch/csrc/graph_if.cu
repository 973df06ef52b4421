// CUDA-graph IF nodes opened inside a stream capture: the device half of
// `utils/graphs.run_if`, the port's counterpart of one trip of a JAX
// `lax.while_loop` (the pose solve's exit at convergence).
//
// Not a port of a Pallas kernel: the JAX package's while_loop is XLA control
// flow. torch 2.11 binds no conditional node, so this file makes one with
// the CUDA runtime (12.4 or later) on the stream that PyTorch is capturing:
//
//   graph_if_begin(parent, pred, body):
//     * a conditional handle in the graph that `parent` captures into;
//     * a one-thread kernel on `parent` that sets the handle to *pred (a
//       device bool written by the ops before it), so every replay reads
//       the value that point of the replay computed;
//     * an IF node after that kernel, and `parent`'s capture continues
//       after the node;
//     * `body` (a stream not capturing) starts capturing into the node's
//       body graph: the caller issues the body's work on it.
//   graph_if_end(body): ends the body's capture.
//
// A replay then runs the body only where *pred is true. The body's work
// depends on everything `parent` captured before the node, and what
// `parent` captures after the node depends on the body.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int graph_if_begin(void* parent_, const void* pred, void* body_) {
  cudaStream_t parent = static_cast<cudaStream_t>(parent_);
  cudaStream_t body = static_cast<cudaStream_t>(body_);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorIllegalState);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_if_kernel<<<1, 1, 0, parent>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the node depends on the setter: what the stream captured last
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr,
                                                        nullptr, 0, cudaStreamCaptureModeRelaxed));
}

extern "C" int graph_if_end(void* body_) {
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_), &graph));
}

extern "C" const char* graph_if_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
