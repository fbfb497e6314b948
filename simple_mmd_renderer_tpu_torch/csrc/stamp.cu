// The stage clock of the compiled step (`utils/profiling.StepClock`).
//
// No TPU kernel's port: the reference's step is one XLA program whose
// stages a profiler splits by name; the port's step is one CUDA-graph
// replay, which carries no host code to time it, so the graph times itself.
// At each stage boundary one launch of `stamp_kernel` writes the card's
// nanosecond clock (`%globaltimer`) into the replay's row of a ring of
// int64 rows, ring[(count - 1) % rows][col]; the row is picked on the
// device by `count`, which the replay's first stamp advances (`advance`),
// so the graph needs no host input from one replay to the next and replay
// k writes row k % rows. At the stage end after a posing pass the same
// launch also counts the pass's CCD loop: `active` holds, for every
// iteration of every chain, whether the chain was still active (bool, one
// byte each); the row gets the chain-iterations run (n_active) in column
// ccd_col and the active ones in ccd_col + 1.
//
// One block: thread 0 reads the clock first (the stage's end is the
// launch's start), the block counts the flags (tens to a few thousand),
// thread 0 advances the counter if asked and writes the row (nothing
// while the counter is still 0). The stream orders the stamps with the
// stage kernels around them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void stamp_kernel(long long* ring, long long* count, int rows,
                             int cols, int col, const unsigned char* active,
                             int n_active, int ccd_col, int advance) {
  __shared__ int warp_sums[kThreads / 32];
  unsigned long long now = 0;
  if (threadIdx.x == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  }
  int useful = 0;
  if (ccd_col >= 0) {
    int mine = 0;
    for (int i = threadIdx.x; i < n_active; i += blockDim.x) {
      mine += active[i] != 0;
    }
    for (int off = 16; off > 0; off >>= 1) {
      mine += __shfl_down_sync(0xffffffffu, mine, off);
    }
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = mine;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) useful += warp_sums[w];
    }
  }
  if (threadIdx.x == 0) {
    long long c = count[0] + (advance ? 1 : 0);
    if (advance) count[0] = c;
    if (c > 0) {
      long long* row = ring + ((c - 1) % rows) * cols;
      row[col] = static_cast<long long>(now);
      if (ccd_col >= 0) {
        row[ccd_col] = n_active;
        row[ccd_col + 1] = useful;
      }
    }
  }
}

}  // namespace

extern "C" int smr_stamp(void* ring, void* count, int rows, int cols,
                         int col, const void* active, int n_active,
                         int ccd_col, int advance, void* stream) {
  if (rows <= 0 || col < 0 || col >= cols || n_active < 0 ||
      ccd_col + 1 >= cols || (ccd_col >= 0 && n_active > 0 && !active))
    return static_cast<int>(cudaErrorInvalidValue);
  stamp_kernel<<<1, ccd_col >= 0 ? kThreads : 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(count), rows,
      cols, col, static_cast<const unsigned char*>(active), n_active,
      ccd_col, advance);
  return static_cast<int>(cudaGetLastError());
}
