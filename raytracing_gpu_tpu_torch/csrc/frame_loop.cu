// A rendered frame as one CUDA graph with its loops on the device.
//
// The JAX package's frame is one device program (raytracing_gpu_tpu/
// render.py): `lax.map` over the chunk indices (:306-322) and, inside each
// chunk, a `lax.while_loop` whose condition is evaluated on the device (CPU
// pipeline :136-144, GPU pipeline :198-206). The port captures one chunk's
// rays, one bounce step and the fold into three CUDA graphs with PyTorch
// (utils/frame_graph.py) and assembles them here into one graph with two
// nested WHILE conditional nodes:
//
//   memsets: chunk_index = 0, counts[:] = 0  (outer condition: its default,
//                                             n_chunks > 0, at each launch)
//   WHILE chunks                              lax.map over chunk indices
//     child graph "rays"
//     loop_reset_kernel                       inner condition for a new chunk
//     WHILE bounces                           lax.while_loop of one chunk
//       child graph "step"                    writes more.any() into *flag
//       bounce_condition_kernel               steps[ci] += 1; the condition
//     child graph "fold"
//     chunk_advance_kernel                    chunk_index += 1; the condition
//
// That is utils/frame_graph.py's PROGRAM, the node list the CPU's
// interpreter walks. It arrives encoded (`encode_program`); the assembly
// builds this one program and refuses any other.
//
// The three kernels have no TPU counterpart: they are the port's
// `lax.while_loop` condition and `lax.map` counter, each one thread that
// reads and writes a few bytes, counts its own launch in `counts` and sets a
// conditional handle with the device-side cudaGraphSetConditional. `counts`
// holds each kernel's launches, then the bounce steps of each chunk; the
// frame reads it back once, after its last chunk. What bounds the kernels is
// not their bytes (under 30) but the cost of one iteration of a conditional
// node; their plain twins are `loop_reset` / `bounce_condition` /
// `chunk_advance` in utils/frame_graph.py.
//
// Why the condition kernels exist at all: cudaGraphCondAssignDefault sets a
// condition only at each launch of the whole graph, so the bounce loop's
// condition is set by loop_reset_kernel before each chunk. A conditional
// body may hold only kernel, memset, device-to-device memcpy, empty,
// child-graph and conditional nodes: `rgt_frame_graph_build` walks each
// piece and refuses any other node (host memcpys, host nodes, events,
// allocations) before it assembles anything.
//
// `stamp_kernel`, beside them, is the program recorder's device clock
// (utils/profiling.py): one thread that writes (tag, %globaltimer) into the
// next entry of a preallocated buffer. A span's two stamps are launched on
// the stream of the work they enclose, so a stamp captured with a piece
// replays inside the WHILE bodies, where no profiler sees. An entry past the
// buffer's capacity is dropped (the cursor still counts it), never wrapped.
//
// C interface (loaded with ctypes): each function returns a cudaError_t as
// an int; the assembly also writes a message naming the step that failed.

#include <cuda_runtime.h>

#include <cstdio>
#include <cstring>

namespace {

// the encoding of utils/frame_graph.py (OPCODES, PIECES, KERNELS, CONDITIONS)
enum Op { OP_END = 0, OP_RESET = 1, OP_PIECE = 2, OP_KERNEL = 3, OP_WHILE = 4 };
enum Piece { P_RAYS = 0, P_STEP = 1, P_FOLD = 2, N_PIECES = 3 };
enum Kernel { K_LOOP_RESET = 0, K_BOUNCE_CONDITION = 1, K_CHUNK_ADVANCE = 2, N_KERNELS = 3 };
enum Handle { H_CHUNKS = 0, H_BOUNCES = 1 };
constexpr int N_NODE_TYPES = 14;  // cudaGraphNodeType up to Conditional

// The one program this file assembles (`encode_program(PROGRAM)`).
constexpr int kProgram[] = {
    OP_RESET,
    OP_WHILE, H_CHUNKS,
      OP_PIECE, P_RAYS,
      OP_KERNEL, K_LOOP_RESET,
      OP_WHILE, H_BOUNCES,
        OP_PIECE, P_STEP,
        OP_KERNEL, K_BOUNCE_CONDITION,
      OP_END,
      OP_PIECE, P_FOLD,
      OP_KERNEL, K_CHUNK_ADVANCE,
    OP_END};
constexpr int kProgramLen = sizeof(kProgram) / sizeof(kProgram[0]);

// ---- the three kernels -----------------------------------------------------

// Before a chunk's first bounce step: the bounce loop is entered when the
// eager loop's first test passes (`first_step`) and the depth cap is not 0.
__global__ void loop_reset_kernel(cudaGraphConditionalHandle bounces, int* counts,
                                  int first_step, int n_bounces) {
  counts[K_LOOP_RESET] += 1;
  cudaGraphSetConditional(bounces, (first_step && n_bounces > 0) ? 1u : 0u);
}

// After each bounce step: count it for the current chunk and go on while a
// ray is alive for the next step (`*flag`, written by the step) and the
// depth cap is not reached.
__global__ void bounce_condition_kernel(cudaGraphConditionalHandle bounces,
                                        const long long* chunk_index, int* counts,
                                        const unsigned char* flag, int n_bounces) {
  counts[K_BOUNCE_CONDITION] += 1;
  int* steps = counts + N_KERNELS;
  const long long ci = *chunk_index;
  const int n = steps[ci] + 1;
  steps[ci] = n;
  cudaGraphSetConditional(bounces, (*flag != 0 && n < n_bounces) ? 1u : 0u);
}

// After a chunk's fold: the next chunk, while there is one.
__global__ void chunk_advance_kernel(cudaGraphConditionalHandle chunks,
                                     long long* chunk_index, int* counts, int n_chunks) {
  counts[K_CHUNK_ADVANCE] += 1;
  const long long ci = *chunk_index + 1;
  *chunk_index = ci;
  cudaGraphSetConditional(chunks, ci < n_chunks ? 1u : 0u);
}

// The recorder's stamp: entry i = atomicAdd(cursor, 1) of `buf` (capacity
// entries of two int64: the tag, then %globaltimer in ns) when i < capacity.
// The cursor keeps counting past the capacity: the excess is the dropped
// count. No TPU counterpart: the JAX package has no device clock in a span.
// Bound: one launch (a few µs as a graph node), 16 bytes written.
__global__ void stamp_kernel(long long* buf, unsigned long long* cursor,
                             unsigned long long capacity, long long tag) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long i = atomicAdd(cursor, 1ull);
  if (i < capacity) {
    buf[2 * i] = tag;
    buf[2 * i + 1] = (long long)now;
  }
}

// ---- the pieces' nodes -------------------------------------------------------

const char* node_type_name(int t) {
  static const char* names[N_NODE_TYPES] = {
      "kernel", "memcpy", "memset", "host", "child graph", "empty", "event wait",
      "event record", "semaphore signal", "semaphore wait", "memory allocation",
      "memory free", "batch memory op", "conditional"};
  return (t >= 0 && t < N_NODE_TYPES) ? names[t] : "unknown";
}

bool on_device(const void* p) {
  cudaPointerAttributes a;
  if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return a.type == cudaMemoryTypeDevice || a.type == cudaMemoryTypeManaged;
}

// Count the node types of `graph` (child graphs' nodes too) into counts[14];
// the first node a conditional body may not hold is described in `bad`.
cudaError_t walk(cudaGraph_t graph, int* counts, char* bad, int bad_len) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(graph, nullptr, &n);
  if (e != cudaSuccess || n == 0) return e;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) break;
    const int ti = (int)t;
    if (ti >= 0 && ti < N_NODE_TYPES) counts[ti] += 1;
    bool ok = t == cudaGraphNodeTypeKernel || t == cudaGraphNodeTypeMemset ||
              t == cudaGraphNodeTypeEmpty || t == cudaGraphNodeTypeGraph ||
              t == cudaGraphNodeTypeConditional || t == cudaGraphNodeTypeMemcpy;
    if (t == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p;
      e = cudaGraphMemcpyNodeGetParams(nodes[i], &p);
      if (e != cudaSuccess) break;
      ok = p.srcArray == nullptr && p.dstArray == nullptr &&
           (p.kind == cudaMemcpyDeviceToDevice || p.kind == cudaMemcpyDefault) &&
           on_device(p.srcPtr.ptr) && on_device(p.dstPtr.ptr);
      if (!ok && bad[0] == 0)
        snprintf(bad, bad_len, "a memcpy node that is not device to device");
    } else if (!ok && bad[0] == 0) {
      snprintf(bad, bad_len, "a %s node", node_type_name(ti));
    }
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e == cudaSuccess) e = walk(child, counts, bad, bad_len);
    }
  }
  delete[] nodes;
  return e;
}

// ---- the assembly ------------------------------------------------------------

// The nodes of one graph, each added after the one before it.
struct Chain {
  cudaGraph_t g;
  cudaGraphNode_t last = nullptr;

  cudaError_t added(cudaError_t e, cudaGraphNode_t node) {
    if (e == cudaSuccess) last = node;
    return e;
  }
  const cudaGraphNode_t* deps() const { return last ? &last : nullptr; }
  size_t n_deps() const { return last ? 1 : 0; }

  cudaError_t zeros(void* dst, size_t words) {
    cudaMemsetParams p = {};
    p.dst = dst;
    p.elementSize = 4;
    p.width = words;
    p.height = 1;
    cudaGraphNode_t node;
    const cudaError_t e = cudaGraphAddMemsetNode(&node, g, deps(), n_deps(), &p);
    return added(e, node);
  }
  cudaError_t child(cudaGraph_t piece) {
    cudaGraphNode_t node;
    const cudaError_t e = cudaGraphAddChildGraphNode(&node, g, deps(), n_deps(), piece);
    return added(e, node);
  }
  cudaError_t kernel(void* func, void** args) {
    cudaKernelNodeParams p = {};
    p.func = func;
    p.gridDim = dim3(1);
    p.blockDim = dim3(1);
    p.kernelParams = args;
    cudaGraphNode_t node;
    const cudaError_t e = cudaGraphAddKernelNode(&node, g, deps(), n_deps(), &p);
    return added(e, node);
  }
  // A WHILE node on `handle`; its body graph goes to *body.
  cudaError_t loop(cudaGraphConditionalHandle handle, cudaGraph_t* body) {
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = handle;
    p.conditional.type = cudaGraphCondTypeWhile;
    p.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    cudaError_t e = cudaGraphAddNode(&node, g, deps(), nullptr, n_deps(), &p);
#else
    cudaError_t e = cudaGraphAddNode(&node, g, deps(), n_deps(), &p);
#endif
    if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
    return added(e, node);
  }
};

// What the frame graph's nodes read and write.
struct Frame {
  cudaGraph_t pieces[N_PIECES];
  long long* chunk_index;
  int* counts;  // launches of each kernel, then the steps of each chunk
  const unsigned char* flag;
  int n_chunks, n_bounces, first_step;
};

// kProgram's nodes into `top`; on failure `err` names the node.
cudaError_t assemble(Frame& f, cudaGraph_t top, char* err, int err_len) {
  auto fail = [&](cudaError_t e, const char* node) {
    snprintf(err, err_len, "%s: %s", node, cudaGetErrorString(e));
    return e;
  };
  cudaError_t e;
  Chain frame{top};
  // ("reset",)
  if ((e = frame.zeros(f.chunk_index, 2)) ||
      (e = frame.zeros(f.counts, (size_t)(N_KERNELS + f.n_chunks))))
    return fail(e, "the reset's memset nodes");
  // ("while", "chunks", ...): its condition's default, assigned at each launch
  cudaGraphConditionalHandle chunks, bounces;
  if ((e = cudaGraphConditionalHandleCreate(&chunks, top, f.n_chunks > 0 ? 1u : 0u,
                                            cudaGraphCondAssignDefault)))
    return fail(e, "the chunk loop's condition handle");
  Chain chunk{nullptr};
  if ((e = frame.loop(chunks, &chunk.g))) return fail(e, "the chunk loop's WHILE node");
  if ((e = cudaGraphConditionalHandleCreate(&bounces, chunk.g, 0u, 0u)))
    return fail(e, "the bounce loop's condition handle");
  void* reset_args[] = {&bounces, &f.counts, &f.first_step, &f.n_bounces};
  void* condition_args[] = {&bounces, &f.chunk_index, &f.counts, &f.flag, &f.n_bounces};
  void* advance_args[] = {&chunks, &f.chunk_index, &f.counts, &f.n_chunks};
  //   ("piece", "rays"), ("kernel", "loop_reset")
  if ((e = chunk.child(f.pieces[P_RAYS]))) return fail(e, "the rays piece's node");
  if ((e = chunk.kernel((void*)loop_reset_kernel, reset_args)))
    return fail(e, "the loop_reset kernel node");
  //   ("while", "bounces", (("piece", "step"), ("kernel", "bounce_condition")))
  Chain bounce{nullptr};
  if ((e = chunk.loop(bounces, &bounce.g))) return fail(e, "the bounce loop's WHILE node");
  if ((e = bounce.child(f.pieces[P_STEP]))) return fail(e, "the step piece's node");
  if ((e = bounce.kernel((void*)bounce_condition_kernel, condition_args)))
    return fail(e, "the bounce_condition kernel node");
  //   ("piece", "fold"), ("kernel", "chunk_advance")
  if ((e = chunk.child(f.pieces[P_FOLD]))) return fail(e, "the fold piece's node");
  if ((e = chunk.kernel((void*)chunk_advance_kernel, advance_args)))
    return fail(e, "the chunk_advance kernel node");
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The CUDA version the system supports and this library's runtime version
// (e.g. 12080 for 12.8).
int rgt_cuda_versions(int* system, int* runtime) {
  cudaError_t e = cudaDriverGetVersion(system);
  if (e == cudaSuccess) e = cudaRuntimeGetVersion(runtime);
  return (int)e;
}

// Assemble and instantiate the frame graph of the encoded `program`, which
// must be kProgram, over the three pieces' graphs (each cloned into a
// child-graph node) and the device state: chunk_index (int64 scalar), counts
// (int32, N_KERNELS + n_chunks), flag (bool, 1). `first_step`: whether the
// eager loop's test before a chunk's first bounce step passes. Each piece's
// node types, counted while its nodes are checked, go to
// piece_nodes[piece * 14 + type]. On success *exec_out holds the executable
// graph; on failure `err` names the step.
int rgt_frame_graph_build(const int* program, int n_program, void* const* pieces,
                          long long* chunk_index, int* counts, const unsigned char* flag,
                          int n_chunks, int n_bounces, int first_step, int* piece_nodes,
                          void** exec_out, char* err, int err_len) {
  err[0] = 0;
  *exec_out = nullptr;
  if (n_program != kProgramLen || memcmp(program, kProgram, sizeof kProgram) != 0) {
    snprintf(err, err_len, "the program: not the frame program this assembler builds");
    return (int)cudaErrorInvalidValue;
  }
  static const char* piece_names[N_PIECES] = {"rays", "step", "fold"};
  cudaError_t e;
  Frame f = {{}, chunk_index, counts, flag, n_chunks, n_bounces, first_step};
  memset(piece_nodes, 0, N_PIECES * N_NODE_TYPES * sizeof(int));
  for (int i = 0; i < N_PIECES; ++i) {
    f.pieces[i] = (cudaGraph_t)pieces[i];
    char bad[96] = {0};
    e = f.pieces[i] == nullptr
            ? cudaErrorInvalidValue
            : walk(f.pieces[i], piece_nodes + i * N_NODE_TYPES, bad, sizeof bad);
    if (e != cudaSuccess) {
      snprintf(err, err_len, "walking the %s piece's nodes: %s", piece_names[i],
               cudaGetErrorString(e));
      return (int)e;
    }
    if (bad[0]) {
      snprintf(err, err_len, "the %s piece holds %s, which a conditional body "
               "may not hold", piece_names[i], bad);
      return (int)cudaErrorNotSupported;
    }
  }
  cudaGraph_t graph;
  e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) {
    snprintf(err, err_len, "cudaGraphCreate: %s", cudaGetErrorString(e));
    return (int)e;
  }
  e = assemble(f, graph, err, err_len);
  if (e == cudaSuccess) {
    cudaGraphExec_t exec;
    cudaGraphInstantiateParams ip = {};
    e = cudaGraphInstantiateWithParams(&exec, graph, &ip);
    if (e != cudaSuccess) {
      snprintf(err, err_len, "cudaGraphInstantiateWithParams: %s (result %d)",
               cudaGetErrorString(e), (int)ip.result_out);
    } else {
      *exec_out = exec;
    }
  }
  cudaGraphDestroy(graph);  // the executable graph keeps what it needs
  cudaGetLastError();
  return (int)e;
}

// One launch of an executable frame graph on `stream`.
int rgt_frame_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

int rgt_frame_graph_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}

// One stamp (tag, %globaltimer) into `buf` (int64, capacity x 2) at the
// entry `cursor` (uint64) hands out, launched on `stream` (captured with it
// when the stream is capturing); does not sync.
int rgt_stamp(long long* buf, unsigned long long* cursor, long long capacity,
              long long tag, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      buf, cursor, (unsigned long long)capacity, tag);
  return (int)cudaGetLastError();
}

}  // extern "C"
