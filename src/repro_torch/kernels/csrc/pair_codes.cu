// Matched-key codes for (B, 128) tiles, for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel pair_codes_kernel (body _kernel) of
// src/repro/kernels/pair_codes.py: for each row b and query lane i,
//   out[b, i] = sum over j of (q[b, i] == k[b, j]) ? kc[b, j] : 0,
// summed in 32 bits that wrap as jnp's int32 sum does.  The sum runs over
// every equal key: rows are not assumed sorted or unique (padded rows are
// not sorted, and the JAX wrapper pads with repeated keys), so the full
// compare, not a binary search, is the same function on every input.
//
// What bounds it on this card: each input word is read once and each
// output word written once (16 bytes per lane), against 128 compares per
// lane; at 3.35 TB/s and 67 T int32 ops/s the bytes bound first.  The TPU
// kernel broadcasts a (tile, 128, 128) compare through the vector unit.
// Here a block holds kRowsPerBlock rows: each thread stages one key and
// its code of its row in __shared__ with a coalesced load, then compares
// its own query against all 128 staged entries, read as shared-memory
// broadcasts (every thread of a warp reads the same entry), accumulating
// in an unsigned register (wrapping, with no signed overflow), and writes
// its result coalesced.  Nothing but the output reaches device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;        // kernels.pair_codes.LANES
constexpr int kRowsPerBlock = 4;   // kernels.pair_codes.ROWS_PER_BLOCK
constexpr int kThreads = kLanes * kRowsPerBlock;

__global__ void __launch_bounds__(kThreads)
pair_codes(const int* __restrict__ q, const int* __restrict__ k,
           const int* __restrict__ kc, int num_rows, int* __restrict__ out) {
  __shared__ int2 s_entry[kRowsPerBlock][kLanes];  // (key, code)
  const int r = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + r;
  const bool live = row < num_rows;  // uniform over the row's 128 threads
  const long long at = row * kLanes + lane;
  int query = 0;
  if (live) {
    s_entry[r][lane] = make_int2(__ldg(k + at), __ldg(kc + at));
    query = __ldg(q + at);
  }
  __syncthreads();
  if (!live) return;
  unsigned acc = 0;
#pragma unroll 16
  for (int j = 0; j < kLanes; ++j) {
    const int2 e = s_entry[r][j];
    acc += (query == e.x) ? static_cast<unsigned>(e.y) : 0u;
  }
  out[at] = static_cast<int>(acc);
}

}  // namespace

extern "C" {

// q, k, kc, out: row-major int32 (num_rows, 128).  Returns
// cudaGetLastError() after the launch (cudaSuccess, launching nothing,
// when num_rows is 0).
int pair_codes_launch(const int* q, const int* k, const int* kc,
                      int num_rows, int* out, void* stream) {
  if (num_rows <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (num_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  pair_codes<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, kc, num_rows, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
