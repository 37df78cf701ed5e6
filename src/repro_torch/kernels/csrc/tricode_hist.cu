// 64-bin tricode histogram for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tricode_histogram_kernel (body _kernel)
// of src/repro/kernels/tricode_hist.py: a histogram of the tricodes whose
// mask is set, where codes outside [0, 64) are dropped.  The TPU kernel
// takes pre-masked codes; here the mask is applied in the kernel, so the
// wrapper makes no masking pass of its own.
//
// What bounds it on this card: HBM bytes, 5 per item (an int32 code and
// the bool mask's byte, each read once).  What stood in the way of that
// bound, and what the design does about it:
// 1. Passes.  The first port masked in torch (torch.where: 5 B read, 4 B
//    written per item), zeroed the output with a fill kernel, then read
//    the masked copy again: 13 B per item in three launches.  Now the
//    launch entry queues a 256-byte memset of the output and one kernel
//    that reads each code and mask byte once.
// 2. Contention.  Census codes are skewed (on a patents-like window a
//    handful of bins take most counted items), so a shared atomicAdd per
//    item serialises a warp on a few addresses.  Each lane counts into
//    private shared counters laid out s[warp][bin * 32 + lane]: the bank
//    is the lane, so the plain load-add-store of every lane is free of
//    conflicts and needs no atomic.  Each block sums its counters once
//    at the end (reading them with a per-bin skew, again one bank per
//    lane) and adds its non-zero bins to the output.
// 3. Many flushes.  A persistent grid -- SMs x resident blocks, queried
//    once per device -- walks the input with a grid stride, so the
//    global atomics number blocks x 64, not one set per 8K items.
// 4. Narrow loads.  The body loads 4 codes as one int4 and their 4 mask
//    bytes as one 32-bit word (or, when the two views are not equally
//    aligned, as 4 byte loads); a scalar head aligns the codes to 16
//    bytes, a scalar tail takes the ragged end.
// Integer sums make the result exact in any order.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md,
// section 6), at the patents-size graph's first window (16.8M items):
// 0.045 ms with the L2 flushed, 55 % of the 5-byte-per-item bound, where
// the first port's call took 0.117 ms.  Per-warp copies with
// __match_any_sync aggregation measured 7 % slower than the private
// counters, and a plain shared atomicAdd per item (step 2 undone) 3 %
// faster: on these codes the lanes' shared atomics do not bound the
// kernel, the bytes do.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 64;
constexpr int kUnroll = 4;  // int4 loads in flight per thread
constexpr int kMaxDevices = 64;
constexpr size_t kSharedBytes = sizeof(int) * kWarps * kBins * 32;

// Count one item into the lane's private counters.
__device__ __forceinline__ void count(int* mine, int code, unsigned m) {
  if (m != 0u && static_cast<unsigned>(code) < kBins) mine[code * 32] += 1;
}

// Count 4 codes with their 4 mask bytes (byte k of mbytes for code k).
__device__ __forceinline__ void count4(int* mine, int4 c, unsigned mbytes) {
  count(mine, c.x, mbytes & 0xffu);
  count(mine, c.y, (mbytes >> 8) & 0xffu);
  count(mine, c.z, (mbytes >> 16) & 0xffu);
  count(mine, c.w, mbytes >> 24);
}

// Counts the items [0, n) of tri where mask is set.  head: the items
// before tri + head, which is 16-byte aligned; nvec: int4 groups from
// there; mask_words: mask + head is 4-byte aligned.
__global__ void __launch_bounds__(kThreads)
tricode_hist(const int* __restrict__ tri,
             const unsigned char* __restrict__ mask, int n, int head,
             int nvec, bool mask_words, int* __restrict__ out) {
  extern __shared__ int s_cnt[];  // [warp][bin * 32 + lane]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* mine = s_cnt + warp * kBins * 32 + lane;
#pragma unroll
  for (int b = 0; b < kBins; ++b) mine[b * 32] = 0;  // the lane's own

  // scalar head and tail, by the first block
  if (blockIdx.x == 0) {
    const int tail = head + 4 * nvec;
    const int t = threadIdx.x;
    if (t < head) count(mine, __ldg(tri + t), __ldg(mask + t));
    if (tail + t < n) {
      count(mine, __ldg(tri + tail + t), __ldg(mask + tail + t));
    }
  }

  const int4* tri4 = reinterpret_cast<const int4*>(tri + head);
  const unsigned* mask4 = reinterpret_cast<const unsigned*>(mask + head);
  const unsigned char* maskb = mask + head;
  const int stride = gridDim.x * kThreads;
  int v = blockIdx.x * kThreads + threadIdx.x;
  // kUnroll groups per thread per round, their loads issued together
  for (; v + (kUnroll - 1) * stride < nvec; v += kUnroll * stride) {
    int4 c[kUnroll];
    unsigned m[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int g = v + k * stride;
      c[k] = __ldg(tri4 + g);
      if (mask_words) {
        m[k] = __ldg(mask4 + g);
      } else {
        const unsigned char* p = maskb + 4 * g;
        m[k] = static_cast<unsigned>(__ldg(p)) |
               static_cast<unsigned>(__ldg(p + 1)) << 8 |
               static_cast<unsigned>(__ldg(p + 2)) << 16 |
               static_cast<unsigned>(__ldg(p + 3)) << 24;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) count4(mine, c[k], m[k]);
  }
  for (; v < nvec; v += stride) {
    unsigned m;
    if (mask_words) {
      m = __ldg(mask4 + v);
    } else {
      const unsigned char* p = maskb + 4 * v;
      m = static_cast<unsigned>(__ldg(p)) |
          static_cast<unsigned>(__ldg(p + 1)) << 8 |
          static_cast<unsigned>(__ldg(p + 2)) << 16 |
          static_cast<unsigned>(__ldg(p + 3)) << 24;
    }
    count4(mine, __ldg(tri4 + v), m);
  }
  __syncthreads();

  // block sum: thread t sums bin t % 64 over a quarter of the block's
  // (warp, lane) counters, lane (j + bin) % 32 in step j so that the 32
  // threads of a warp read 32 banks
  __shared__ int s_part[kThreads];
  const int bin = threadIdx.x & (kBins - 1);
  const int quarter = threadIdx.x >> 6;
  int sum = 0;
  for (int w = quarter * (kWarps / 4); w < (quarter + 1) * (kWarps / 4); ++w) {
    const int* row = s_cnt + w * kBins * 32 + bin * 32;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) sum += row[(j + bin) & 31];
  }
  s_part[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x < kBins) {
    const int val = s_part[bin] + s_part[kBins + bin] +
                    s_part[2 * kBins + bin] + s_part[3 * kBins + bin];
    if (val) atomicAdd(out + bin, val);
  }
}

static_assert(kWarps % 4 == 0 && kThreads == 4 * kBins,
              "the block sum splits each bin over 4 threads");

// Resident blocks per SM x SMs of the current device, queried once per
// device into *blocks.
cudaError_t persistent_blocks(int* blocks) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0;
  int per_sm = 0;
  err = cudaFuncSetAttribute(tricode_hist,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSharedBytes));
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tricode_hist, kThreads, kSharedBytes);
  }
  if (err != cudaSuccess) return err;
  *blocks = std::max(sms, 1) * std::max(per_sm, 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// tri: int32[n]; mask: n bytes (a torch.bool's storage), an item counts
// where its byte is non-zero and 0 <= tri < 64; out: int32[64], zeroed
// here on the stream.  Returns the first CUDA error of the calls, or
// cudaGetLastError() after the launch.
int tricode_hist_launch(const int* tri, const unsigned char* mask, int n,
                        int* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int most = 0;
  cudaError_t err = persistent_blocks(&most);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(out, 0, kBins * sizeof(int), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // head: items before the first 16-byte boundary of tri
  const int misalign = static_cast<int>(
      (reinterpret_cast<uintptr_t>(tri) & 15u) / sizeof(int));
  const int head = misalign ? std::min(4 - misalign, n) : 0;
  const int nvec = (n - head) / 4;
  const bool mask_words =
      (reinterpret_cast<uintptr_t>(mask + head) & 3u) == 0;
  const int wanted = (nvec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int blocks = std::max(1, std::min(most, wanted));
  tricode_hist<<<blocks, kThreads, kSharedBytes, s>>>(tri, mask, n, head,
                                                      nvec, mask_words, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
