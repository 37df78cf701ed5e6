// 64-bin tricode histogram for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tricode_histogram_kernel (body _kernel)
// of src/repro/kernels/tricode_hist.py: a histogram of pre-masked
// tricodes, where values outside [0, 64) are dropped.
//
// What bounds it on this card: one coalesced 4-byte read per item from
// HBM and a shared-memory atomic per counted item.  The TPU kernel folds
// each block through a one-hot compare-and-sum into an output block
// revisited across a sequential grid; here blocks run in any order, so
// each block counts its BLOCK_ITEMS-item tile into a block-private
// __shared__ int[64] and adds each non-zero bin to the zeroed global
// output once.  Integer atomics make the sums exact in any order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockItems = 8192;  // kernels.tricode_hist.BLOCK_ITEMS
constexpr int kBins = 64;

__global__ void __launch_bounds__(kThreads)
tricode_hist(const int* __restrict__ tri, int num_items,
             int* __restrict__ out) {
  __shared__ int s_hist[kBins];
  for (int t = threadIdx.x; t < kBins; t += blockDim.x) s_hist[t] = 0;
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * kBlockItems;
  const int end = static_cast<int>(
      min(static_cast<long long>(num_items), first + kBlockItems));
  for (int t = static_cast<int>(first) + threadIdx.x; t < end;
       t += kThreads) {
    const unsigned code = static_cast<unsigned>(__ldg(tri + t));
    if (code < kBins) atomicAdd(&s_hist[code], 1);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kBins; t += blockDim.x) {
    const int val = s_hist[t];
    if (val) atomicAdd(out + t, val);
  }
}

}  // namespace

extern "C" {

// out: zeroed int32[64].  Returns cudaGetLastError() after the launch.
int tricode_hist_launch(const int* tri, int num_items, int* out,
                        void* stream) {
  const long long blocks =
      (static_cast<long long>(num_items) + kBlockItems - 1) / kBlockItems;
  tricode_hist<<<blocks > 0 ? static_cast<int>(blocks) : 1, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(tri, num_items, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
