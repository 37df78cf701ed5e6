// Fused triad-census kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/census_fused.py:
//   census_fused_desc_kernel (body _desc_kernel) -> census_fused_desc
//     device emission: flat item index -> (pair, slot, side) by an
//     anchored lower-bound search over the window's descriptor table,
//     then classify and fold; the main path, one launch per window.
//   census_fused_kernel (body _kernel)           -> census_fused_items
//     host emission: the same classify-and-fold fed packed item words
//     item_sp = slot << 1 | side, item_pv = pair << 1 | valid.
// Both share classify_fold(), the per-item gather, row search, tricode
// classification and histogram fold.
//
// What bounds it on this card: random 4-byte gathers into L2 / HBM, one
// dependent chain per item -- about 5 descriptor-search reads (window
// arrays), about log2(deg + 1) row-search reads into the packed CSR, and
// about 8 fixed gathers (anchor, descriptor, pair_u/v/code, indptr x3,
// witness entry).  The graph arrays are read from HBM through the
// read-only path (__ldg) and never staged: unlike the Pallas kernel they
// need not fit in on-chip memory, and a graph past the 50 MB L2 pays HBM
// latency per gather.  The design hides that latency with occupancy (many
// independent item chains per SM) and keeps all other traffic off the
// memory system: the per-item tricode lives in registers, the histogram
// in a block-private shared array, and each block adds its 67 counters
// to the output once.
//
// The TPU kernel folds into one output block revisited across a
// sequential grid.  Here blocks run in any order: each block folds its
// BLOCK_ITEMS-item tile into __shared__ counters with shared atomics and
// flushes them with one global atomicAdd per non-zero counter into an
// int32[67] output the wrapper zeroes.  Integer atomics make the sums
// exact in any order.
//
// Every search runs to convergence with explicit [lo, hi) bounds, so no
// read leaves its array and no padding sentinel is needed; the converged
// lower bound is what the JAX package's fixed-depth, clamped search
// reaches.  Padding lanes (index >= num_valid, or a zero valid bit) are
// skipped before any address arithmetic: all three masks of the
// reference require a valid item, so they contribute exact zeros, and no
// IDX_PAD sum is ever formed (signed overflow is undefined in CUDA).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockItems = 8192;   // kernels.census_fused.BLOCK_ITEMS
constexpr int kAnchorStride = 16;   // planner.DESC_ANCHOR_STRIDE
constexpr int kOutWords = 67;       // hist64 + three counter lanes

// keep_mode: which plan-time pruning predicate lane 2 counts
// (census.prune_keep_mask); kKeepNone for host-emitted items
constexpr int kKeepNone = 0;
constexpr int kKeepAll = 1;
constexpr int kKeepNotSelf = 2;
constexpr int kKeepDegree = 3;

struct GraphArrays {
  const int* indptr;     // (n+1,)
  const int* packed;     // (2P,) nbr << 2 | code, rows sorted
  const int* pair_u;     // (P,)
  const int* pair_v;     // (P,)
  const int* pair_code;  // (P,) code | inter_side << 2
};

struct Lanes {
  int inter_asym;
  int inter_mut;
  int kept;
};

// First position in packed[lo, hi) whose neighbour id is >= q (hi if none).
__device__ __forceinline__ int row_lower_bound(const int* __restrict__ packed,
                                               int lo, int hi, int q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((__ldg(packed + mid) >> 2) < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Classify one valid item of pair (u, v) and fold it: census.classify_items
// plus census.prune_keep_mask, for a single lane.
__device__ __forceinline__ void classify_fold(const GraphArrays& g, int u,
                                              int v, int pc, int slot,
                                              int side, int keep_mode,
                                              int* s_acc, Lanes& lanes) {
  const int wp = __ldg(g.packed + slot);
  const int w = wp >> 2;
  const int c_side = wp & 3;
  const int c_uv = pc & 3;
  const int inter_side = (pc >> 2) & 1;
  const bool not_self = (w != u) && (w != v);

  if (keep_mode == kKeepDegree) {
    const bool can_count = side == 0 ? w > v : w > u;
    lanes.kept += not_self && (side == inter_side || can_count);
  } else if (keep_mode == kKeepNotSelf) {
    lanes.kept += not_self;
  } else if (keep_mode == kKeepAll) {
    lanes.kept += 1;
  }
  if (!not_self) return;  // both census masks require w outside {u, v}

  const int other = side == 0 ? v : u;
  const int lo = __ldg(g.indptr + other);
  const int hi = __ldg(g.indptr + other + 1);
  const int pos = row_lower_bound(g.packed, lo, hi, w);
  bool found = false;
  int c_other = 0;
  if (pos < hi) {
    const int hit = __ldg(g.packed + pos);
    if ((hit >> 2) == w) {
      found = true;
      c_other = hit & 3;
    }
  }
  const int c_uw = side == 0 ? c_side : c_other;
  const int c_vw = side == 0 ? c_other : c_side;
  const bool dedup = !(found && side == 1);  // union duplicates count once
  const bool canonical = (v < w) || (u < w && w < v && c_uw == 0);
  if (dedup && canonical) atomicAdd(&s_acc[c_uv * 16 + c_uw * 4 + c_vw], 1);
  if (found && side == inter_side) {
    if (c_uv == 3) {
      ++lanes.inter_mut;
    } else {
      ++lanes.inter_asym;
    }
  }
}

__device__ __forceinline__ void zero_shared(int* s_acc) {
  for (int t = threadIdx.x; t < kOutWords; t += blockDim.x) s_acc[t] = 0;
  __syncthreads();
}

// Warp-reduce the per-thread lane counters into shared memory, then add
// the block's non-zero counters to the global output once.
__device__ __forceinline__ void flush(int* s_acc, Lanes lanes, int* out) {
  for (int off = 16; off > 0; off >>= 1) {
    lanes.inter_asym += __shfl_down_sync(0xffffffffu, lanes.inter_asym, off);
    lanes.inter_mut += __shfl_down_sync(0xffffffffu, lanes.inter_mut, off);
    lanes.kept += __shfl_down_sync(0xffffffffu, lanes.kept, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (lanes.inter_asym) atomicAdd(&s_acc[64], lanes.inter_asym);
    if (lanes.inter_mut) atomicAdd(&s_acc[65], lanes.inter_mut);
    if (lanes.kept) atomicAdd(&s_acc[66], lanes.kept);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kOutWords; t += blockDim.x) {
    const int val = s_acc[t];
    if (val) atomicAdd(out + t, val);
  }
}

__global__ void __launch_bounds__(kThreads)
census_fused_desc(GraphArrays g, const int* __restrict__ desc_pair,
                  const int* __restrict__ desc_cum,
                  const int* __restrict__ desc_within0,
                  const int* __restrict__ anchors,
                  const int* __restrict__ num_valid_ptr,
                  const int* __restrict__ idx, int num_items, int num_descs,
                  int num_anchors, int keep_mode, int* __restrict__ out) {
  __shared__ int s_acc[kOutWords];
  zero_shared(s_acc);
  const int num_valid = __ldg(num_valid_ptr);
  Lanes lanes{0, 0, 0};
  const long long first = static_cast<long long>(blockIdx.x) * kBlockItems;
  const int end = static_cast<int>(
      min(static_cast<long long>(num_items), first + kBlockItems));
  for (int t = static_cast<int>(first) + threadIdx.x; t < end;
       t += kThreads) {
    const int i = __ldg(idx + t);
    if (i < 0 || i >= num_valid) continue;  // padding lane: exact zero

    // census.expand_work_items for one valid lane
    const int a = min(i / kAnchorStride, num_anchors - 1);
    const int lo_d = __ldg(anchors + a);
    const int hi_d = min(lo_d + kAnchorStride + 1, num_descs);
    int lo = lo_d;
    int hi = hi_d;
    while (lo < hi) {  // first descriptor with desc_cum > i
      const int mid = (lo + hi) >> 1;
      if (__ldg(desc_cum + mid) <= i) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int d = min(max(lo - 1, 0), hi_d - 1);
    const int pair = __ldg(desc_pair + d);
    const int within = __ldg(desc_within0 + d) + (i - __ldg(desc_cum + d));
    const int u = __ldg(g.pair_u + pair);
    const int v = __ldg(g.pair_v + pair);
    const int row_u = __ldg(g.indptr + u);
    const int deg_u = __ldg(g.indptr + u + 1) - row_u;
    const int side = within >= deg_u ? 1 : 0;
    const int slot =
        side == 0 ? row_u + within : __ldg(g.indptr + v) + within - deg_u;
    classify_fold(g, u, v, __ldg(g.pair_code + pair), slot, side, keep_mode,
                  s_acc, lanes);
  }
  flush(s_acc, lanes, out);
}

__global__ void __launch_bounds__(kThreads)
census_fused_items(GraphArrays g, const int* __restrict__ item_sp,
                   const int* __restrict__ item_pv, int num_items,
                   int* __restrict__ out) {
  __shared__ int s_acc[kOutWords];
  zero_shared(s_acc);
  Lanes lanes{0, 0, 0};
  const long long first = static_cast<long long>(blockIdx.x) * kBlockItems;
  const int end = static_cast<int>(
      min(static_cast<long long>(num_items), first + kBlockItems));
  for (int t = static_cast<int>(first) + threadIdx.x; t < end;
       t += kThreads) {
    const int pv = __ldg(item_pv + t);
    if ((pv & 1) == 0) continue;  // padding word: exact zero
    const int sp = __ldg(item_sp + t);
    const int pair = pv >> 1;
    classify_fold(g, __ldg(g.pair_u + pair), __ldg(g.pair_v + pair),
                  __ldg(g.pair_code + pair), sp >> 1, sp & 1, kKeepNone,
                  s_acc, lanes);
  }
  flush(s_acc, lanes, out);
}

int num_blocks(int num_items) {
  const long long blocks =
      (static_cast<long long>(num_items) + kBlockItems - 1) / kBlockItems;
  return blocks > 0 ? static_cast<int>(blocks) : 1;
}

}  // namespace

extern "C" {

// out: zeroed int32[67] -- hist64, inter-asym, inter-mut, kept.
// Returns cudaGetLastError() after the launch.
int census_fused_desc_launch(const int* indptr, const int* packed,
                             const int* pair_u, const int* pair_v,
                             const int* pair_code, const int* desc_pair,
                             const int* desc_cum, const int* desc_within0,
                             const int* anchors, const int* num_valid,
                             const int* idx, int num_items, int num_descs,
                             int num_anchors, int keep_mode, int* out,
                             void* stream) {
  const GraphArrays g{indptr, packed, pair_u, pair_v, pair_code};
  census_fused_desc<<<num_blocks(num_items), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      g, desc_pair, desc_cum, desc_within0, anchors, num_valid, idx,
      num_items, num_descs, num_anchors, keep_mode, out);
  return static_cast<int>(cudaGetLastError());
}

// out: zeroed int32[67] -- hist64, inter-asym, inter-mut (lane 66 stays 0).
int census_fused_items_launch(const int* indptr, const int* packed,
                              const int* pair_u, const int* pair_v,
                              const int* pair_code, const int* item_sp,
                              const int* item_pv, int num_items, int* out,
                              void* stream) {
  const GraphArrays g{indptr, packed, pair_u, pair_v, pair_code};
  census_fused_items<<<num_blocks(num_items), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      g, item_sp, item_pv, num_items, out);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_torch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
