// Thread-block-cluster helpers shared by local_best.cu and state_digest.cu
// (sm_90a): the blocks of a cluster merge their partial results in rank 0's
// shared memory (distributed shared memory) instead of global scratch.
//
// A block may write into another block's shared memory only once that block
// is running, and the cluster's blocks are placed together but need not all
// have started when the first one runs. So every thread announces its start
// with a relaxed cluster-barrier arrive as the kernel begins, and waits on
// that phase just before its first remote write: by then the wait is
// normally already satisfied, where a `cluster.sync()` at the start would
// hold every block until the last one came. The merge itself then takes
// one `cluster.sync()` (release / acquire): after it, rank 0 reads what the
// others wrote, and the others may exit, since nobody reads their memory.

#pragma once

namespace cluster_merge {

// Phase 1 of the cluster barrier: this thread has started.
__device__ __forceinline__ void arrive_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Every thread of every block of the cluster has started.
__device__ __forceinline__ void wait_started() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

}  // namespace cluster_merge
