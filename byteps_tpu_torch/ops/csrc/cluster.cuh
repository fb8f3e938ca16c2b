// Thread-block cluster pieces shared by the kernels that fold partials
// across the blocks of a cluster through distributed shared memory
// (flash_fwd.cu's split path, flash_decode.cu, segmented_lora.cu,
// topk.cu).
//
// The protocol they share: every thread arrives (relaxed) at kernel start
// and waits before its first remote store, so no block writes into a
// block that has not started; remote stores, then arrive (release) and
// wait (acquire), after which each block reads its own shared memory and
// no block writes into another again, so a block may leave.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bps {

// the cluster barrier: a thread's arrival releases its shared-memory
// stores before it (the relaxed one orders nothing), the wait acquires
// every arrived thread's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// this block's rank in its cluster, and its cluster's index in the grid
// (x), in a launch with clusters
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_id() {
  unsigned r;
  asm("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}

// p's place in the shared memory of cluster block `rank`
__device__ __forceinline__ uint32_t map_cluster(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  return a;
}

__device__ __forceinline__ void st_cluster(uint32_t a, float x) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(x)
               : "memory");
}

// a 16-byte store; a must be 16-byte aligned
__device__ __forceinline__ void st_cluster(uint32_t a, float4 x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
               : "memory");
}

// store x at p's place in the shared memory of cluster block `rank`
__device__ __forceinline__ void st_cluster(float* p, int rank, float x) {
  st_cluster(map_cluster(p, rank), x);
}

}  // namespace bps
