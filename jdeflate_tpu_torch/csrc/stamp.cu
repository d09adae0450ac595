// The card's own clock inside a captured program, and the size of a
// captured graph, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package times its stages from the host.
// Added because an event pair around two replayed programs on one stream
// times whatever lies between them too: the first program's output clones,
// the second's input copies and every microsecond the card waited for the
// host to launch it. A stamp is a node of the graph itself.
//
// stamp_kernel: one thread writes %globaltimer, the card's global
// nanosecond timer, into one int64 slot. On a stream, and so in a graph
// captured from one, a kernel starts when every node before it has
// finished: the stamp reads the clock at the end of the work before it.
// The timer is one clock for the whole card; stamps of one card subtract.
//
// jd_graph_nodes: cudaGraphGetNodes of a captured cudaGraph_t (the handle
// torch.cuda.CUDAGraph.raw_cuda_graph() gives), the node count of every
// replay of it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = (long long)t;
}

}  // namespace

extern "C" int jd_stamp(void* slot, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)slot);
  return (int)cudaGetLastError();
}

extern "C" int jd_graph_nodes(void* graph, unsigned long long* n) {
  size_t count = 0;
  const cudaError_t rc = cudaGraphGetNodes((cudaGraph_t)graph, nullptr,
                                           &count);
  *n = count;
  return (int)rc;
}
