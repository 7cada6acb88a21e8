// IF conditional nodes for the compiled path's CUDA graphs: the device-side
// control flow that stands where the JAX package has jax.lax.while_loop (the
// Gauss-Newton early exit, icet_tpu/solver.py) and lax.cond (the sharded
// prepare's clustering branch, icet_tpu/ops/clustering.py).  No TPU kernel
// is replaced: this is the graph's own branching, not a kernel of the math.
//
// icet_graph_add_if is called while a stream is being captured into a
// graph.  At the capture's current position it adds
//   1. a one-thread kernel node that reads a device bool and sets the
//      conditional handle with cudaGraphSetConditional, and after it
//   2. an IF conditional node on that handle, whose body is a child graph
//      node cloned from `body` (a graph captured beforehand),
// and makes the IF node the capture's dependency, so work captured next
// runs after it.  The body runs exactly when the bool is true at the time
// the set kernel runs, once per launch of the graph.  A body may hold
// kernel, memcpy, memset, child-graph and conditional nodes (cooperative
// launches included, MPS off); event-record and host nodes are refused
// when the graph is built or instantiated.
//
// Bound: one byte read, one handle set; the node costs what a launch does.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

extern "C" {

int icet_graph_add_if(cudaStream_t stream, const bool* flag, cudaGraph_t body) {
  cudaGetLastError();  // no earlier call's error is this one's
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional<<<1, 1, 0, stream>>>(handle, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0], nullptr, 0, body);
  if (err != cudaSuccess) return err;
  return cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                             cudaStreamSetCaptureDependencies);
}

const char* icet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
