// CUDA-graph conditional nodes for steps captured by PyTorch: the IF node,
// the counterpart of the JAX step's lax.cond
// (lookaheaddecoding_tpu/core/pool.py:144-148), and the WHILE node, the
// counterpart of the JAX decode loop's lax.while_loop on ~finished
// (lookaheaddecoding_tpu/core/step.py:520-529 and :568-575).
//
// graph_cond_launch(op, stream, pred, n, iters, cap, body_stream, handle,
// info); every op returns a cudaError_t (0 on success;
// cudaErrorIllegalState when `stream` is not capturing):
//   op 0, begin an IF node, on a stream that is capturing a graph:
//     1. creates a conditional handle in the capturing graph;
//     2. captures set_if_kernel, which reads the one-byte predicate `pred`
//        and sets the handle's value with cudaGraphSetConditional each
//        replay;
//     3. adds an IF node after it and makes the stream's later work depend
//        on the node;
//     4. starts capturing body_stream into the node's body graph.
//   op 1 ends that body's capture (the caller has enqueued the body on
//     body_stream) and checks its nodes (below).
//   op 2 creates a stream for the bodies to capture on and writes it to
//     *stream: a stream of its own, never one of PyTorch's pooled streams,
//     one of which may be the stream being captured.
//   op 3, begin a WHILE node, the same way as op 0, with the loop's state:
//     `pred` points at n one-byte `finished` flags, `iters` at an int32
//     iteration counter and `cap` at an int32 bound on the iterations.
//     Upstream of the node, set_while_kernel (reset) zeroes the counter and
//     gives the handle its first value, any flag clear && 0 < cap, so a
//     loop whose lanes all finished before it runs no iteration. The
//     handle is written to *handle for op 4.
//   op 4 ends a WHILE body: it captures set_while_kernel at the body's end
//     (the counter plus one, then the condition any flag clear && iters <
//     cap for the next iteration), ends the capture and checks the body's
//     nodes.
// A conditional body may hold only kernel, empty, child-graph, memset,
// device-to-device memcpy and conditional nodes. Ops 1 and 4 walk the body
// (child graphs too) and return kForbiddenNode with the offending
// cudaGraphNodeType in *info. Conditional nodes need CUDA 12.4 or later.
//
// The two condition kernels run one thread: they replace no TPU kernel
// (XLA evaluates lax.cond's predicate and the while_loop's condition on
// the TPU itself). Their cost is their launch, and the WHILE node's: both
// read a few bytes and write four.

#include <cuda_runtime.h>

#include <algorithm>
#include <vector>

#if CUDART_VERSION < 12040
#error "graph_cond.cu needs CUDA 12.4 or later (conditional graph nodes)"
#endif

static const int kForbiddenNode = 100000;

// For each conditional body this thread is capturing, innermost last, the
// conditional nodes made in it. cudaGraphNodeGetType fails (CUDA 12.8,
// cudaErrorUnknown) on a conditional node nested in a conditional body, so
// the body check knows those by this list, which goes when the body's
// capture ends.
static thread_local std::vector<std::vector<cudaGraphNode_t>> t_bodies;

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void set_while_kernel(cudaGraphConditionalHandle handle,
                                 const unsigned char* finished, int n,
                                 int* iters, const int* cap, int reset) {
  const int i = reset ? 0 : *iters + 1;
  *iters = i;
  bool live = false;
  for (int k = 0; k < n; ++k) live |= finished[k] == 0;
  cudaGraphSetConditional(handle, live && i < *cap ? 1u : 0u);
}

static cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                                const cudaGraphNode_t** deps,
                                size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorIllegalState;
}

// Adds a conditional node of `type` on `handle` after what `stream`
// captured last, makes the stream's later work depend on it, and starts
// capturing body_stream into its body graph.
static cudaError_t add_conditional(cudaStream_t stream,
                                   cudaGraphConditionalHandle handle,
                                   cudaGraphConditionalNodeType type,
                                   cudaStream_t body_stream) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
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
  if (!t_bodies.empty()) t_bodies.back().push_back(node);
  err = cudaStreamBeginCaptureToGraph(body_stream,
                                      params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) t_bodies.emplace_back();
  return err;
}

static cudaError_t begin_if(cudaStream_t stream, const unsigned char* pred,
                            cudaStream_t body_stream) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, stream>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return add_conditional(stream, handle, cudaGraphCondTypeIf, body_stream);
}

static cudaError_t begin_while(cudaStream_t stream,
                               const unsigned char* finished, int n,
                               int* iters, const int* cap,
                               cudaStream_t body_stream,
                               unsigned long long* handle_out) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_while_kernel<<<1, 1, 0, stream>>>(handle, finished, n, iters, cap, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  return add_conditional(stream, handle, cudaGraphCondTypeWhile, body_stream);
}

static bool device_memory(const void* ptr) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, ptr) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return attr.type == cudaMemoryTypeDevice;
}

// The first node of `graph` (child graphs included) that a conditional
// body may not hold: its type in *info and kForbiddenNode, else 0.
// `nested` are the conditional nodes made in the body.
static int check_body(cudaGraph_t graph,
                      const std::vector<cudaGraphNode_t>& nested, int* info) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  int out = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; out == 0 && i < n; ++i) {
    if (std::find(nested.begin(), nested.end(), nodes[i]) != nested.end())
      continue;
    cudaGraphNodeType type;
    out = cudaGraphNodeGetType(nodes[i], &type);
    if (out != 0) break;
    bool ok = type == cudaGraphNodeTypeKernel ||
              type == cudaGraphNodeTypeEmpty ||
              type == cudaGraphNodeTypeMemset ||
              type == cudaGraphNodeTypeConditional;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      out = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (out == 0) out = check_body(child, nested, info);
      continue;
    }
    if (type == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p;
      out = cudaGraphMemcpyNodeGetParams(nodes[i], &p);
      if (out != 0) break;
      ok = p.kind == cudaMemcpyDeviceToDevice ||
           (p.kind == cudaMemcpyDefault && p.srcArray == nullptr &&
            p.dstArray == nullptr && device_memory(p.srcPtr.ptr) &&
            device_memory(p.dstPtr.ptr));
    }
    if (!ok) {
      *info = static_cast<int>(type);
      out = kForbiddenNode;
    }
  }
  delete[] nodes;
  return out;
}

static int end_body(cudaStream_t body_stream, int* info) {
  if (t_bodies.empty()) return cudaErrorIllegalState;
  const std::vector<cudaGraphNode_t> nested = std::move(t_bodies.back());
  t_bodies.pop_back();
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(body_stream, &body);
  if (err != cudaSuccess) return err;
  return check_body(body, nested, info);
}

extern "C" int graph_cond_launch(int op, void* stream, const void* pred,
                                 int n, void* iters, const void* cap,
                                 void* body_stream, void* handle, void* info) {
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  switch (op) {
    case 0:
      return begin_if(static_cast<cudaStream_t>(stream),
                      static_cast<const unsigned char*>(pred), body);
    case 1:
      return end_body(body, static_cast<int*>(info));
    case 2:
      return cudaStreamCreateWithFlags(static_cast<cudaStream_t*>(stream),
                                       cudaStreamNonBlocking);
    case 3:
      return begin_while(static_cast<cudaStream_t>(stream),
                         static_cast<const unsigned char*>(pred), n,
                         static_cast<int*>(iters),
                         static_cast<const int*>(cap), body,
                         static_cast<unsigned long long*>(handle));
    case 4: {
      // the condition for the next iteration, at the body's end
      set_while_kernel<<<1, 1, 0, body>>>(
          *static_cast<unsigned long long*>(handle),
          static_cast<const unsigned char*>(pred), n,
          static_cast<int*>(iters), static_cast<const int*>(cap), 0);
      cudaError_t err = cudaGetLastError();
      int ended = end_body(body, static_cast<int*>(info));
      return err != cudaSuccess ? err : ended;
    }
  }
  return cudaErrorInvalidValue;
}
