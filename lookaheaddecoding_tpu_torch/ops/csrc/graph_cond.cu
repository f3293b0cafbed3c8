// CUDA-graph IF nodes for a step captured by PyTorch: the counterpart of
// the JAX step's lax.cond (lookaheaddecoding_tpu/core/pool.py:144-148).
//
// graph_cond_launch(0, stream, pred, body_stream), on a stream that is
// capturing a graph:
//   1. creates a conditional handle in the capturing graph;
//   2. captures set_if_kernel, which reads the one-byte predicate and sets
//      the handle's value with cudaGraphSetConditional each replay;
//   3. adds an IF node after it and makes the stream's later work depend
//      on the node;
//   4. starts capturing body_stream into the node's child graph.
// The caller then enqueues the body on body_stream, and
// graph_cond_launch(1, 0, 0, body_stream) ends that capture.
// graph_cond_launch(2, out, 0, 0) creates the stream the bodies capture
// on and writes it to *out: a stream of its own, never one of PyTorch's
// pooled streams, one of which may be the stream being captured. Each
// returns a cudaError_t (0 on success; cudaErrorIllegalState when
// `stream` is not capturing). Conditional nodes need CUDA 12.4 or later.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "graph_cond.cu needs CUDA 12.4 or later (conditional graph nodes)"
#endif

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

static int begin_if(cudaStream_t stream, const unsigned char* pred,
                    cudaStream_t body_stream) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph,
                                             &deps, nullptr, &n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph,
                                             &deps, &n_deps);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, stream>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the IF node depends on what the stream captured last: set_if_kernel
#if CUDART_VERSION >= 13000
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps,
                                 nullptr, &n_deps);
#else
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps,
                                 &n_deps);
#endif
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body_stream,
                                       params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

extern "C" int graph_cond_launch(int op, void* stream, const void* pred,
                                 void* body_stream) {
  if (op == 2)
    return cudaStreamCreateWithFlags(static_cast<cudaStream_t*>(stream),
                                     cudaStreamNonBlocking);
  if (op == 0)
    return begin_if(static_cast<cudaStream_t>(stream),
                    static_cast<const unsigned char*>(pred),
                    static_cast<cudaStream_t>(body_stream));
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}
