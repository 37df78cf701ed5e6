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
// Both share classify_fold(): the witness gather, the row search, the
// tricode classification and the histogram fold.
//
// What bounds the desc kernel: not HBM bandwidth.  It runs about 5.5x
// its byte bound, no faster on a graph that fits in L2 than on one that
// does not, and within 2 % warm of its time with the L2 flushed.  Each
// lane walks a chain of dependent loads: in the first design some 20
// gathers (anchor, ~5 descriptor probes, descriptor, pair u/v/code,
// indptr reads, witness, ~log2(deg + 1) row probes, hit), although the
// lanes of a 4,096-lane tile share at most a few hundred descriptors.
// Staging what the lanes share, keeping two chains in flight and looking
// descriptors up in a table took it from 0.216 to 0.192 ms on the
// patents-size graph's first window.  Variants that each undo one step
// are 0-19 % slower, and none removes most of what is left: the lanes'
// own work -- resolution, witness, row search, fold -- beside the stage
// (PERF.md, section 6).
//
// 1. The stage.  Tile k holds lanes [4096 k, 4096 (k + 1)); an in-order
//    idx (the main path's) puts indices of anchors [a0, a1] there.  The
//    block reads those anchors, stages the descriptors they reach --
//    desc_cum, and per descriptor within0, u, v, pair code and both
//    endpoints' row bounds -- and, where the window is well formed there
//    (desc_cum rising, each anchor the last descriptor starting at or
//    before its index), writes for every index of the tile the staged
//    descriptor it falls in: marks at each descriptor's first index,
//    then a running max.  A lane whose index lies in that table reads
//    its pair, slot and row bounds from shared memory; what is left in
//    global memory is its witness packed[slot] and its row probes.  Any
//    other lane (a scattered idx, a window of tiny pairs past the
//    capacity, a malformed window) resolves from global memory by the
//    anchored search: same kernel, same function.
//    kernels/census_fused.py tile_desc_ranges is this rule in torch;
//    census_fused_desc_probe_launch runs this kernel and reports which
//    branch each tile and lane took, to hold the two to each other.
// 2. The row search keeps the value at its upper bound, so the hit needs
//    no load of its own.
// 3. Each thread walks two items in lockstep, issuing their loads
//    together; each lane's index is read one round ahead.
// The fold stays one shared atomicAdd per counted lane: counting a warp's
// lanes per bin first (__match_any_sync) measured 1 % slower.
//
// The TPU kernel folds into one output block revisited across a
// sequential grid.  Here blocks run in any order: each folds its tile
// into __shared__ counters and flushes them with one global atomicAdd
// per non-zero counter into an int32[67] output the wrapper zeroes.
// Integer atomics make the sums exact in any order.
//
// Every search runs to convergence with explicit [lo, hi) bounds, so no
// read leaves its array and no padding sentinel is needed; the converged
// lower bound is what the JAX package's fixed-depth, clamped search
// reaches.  Padding lanes (index outside [0, num_valid), or a zero valid
// bit) are dropped before any address arithmetic: all three masks of the
// reference require a valid item, so they contribute exact zeros, and no
// IDX_PAD sum is ever formed (signed overflow is undefined in CUDA).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockItems = 4096;   // kernels.census_fused.BLOCK_ITEMS
constexpr int kChains = 2;          // items in flight per thread
constexpr int kStageDescs = 512;    // kernels.census_fused.STAGE_DESCS
constexpr int kAnchorStride = 16;   // planner.DESC_ANCHOR_STRIDE
constexpr int kStageAnchors = kBlockItems / kAnchorStride + 2;
constexpr int kTable = kStageAnchors * kAnchorStride;  // indices a tile spans
constexpr int kWarps = kThreads / 32;
static_assert(kStageDescs <= 32767, "lane table entries are 16-bit");
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

// One work item, resolved: its pair, the witness slot, and the row of
// the endpoint the witness is searched in.
struct Item {
  bool valid;
  int u, v, pc;    // pair endpoints and pair_code
  int slot, side;  // witness entry packed[slot], in u's row if side == 0
  int olo, ohi;    // the other endpoint's row [olo, ohi)
};

// A staged descriptor (two 16-byte shared words).
struct alignas(16) StagedDesc {
  int within0, u, v, pc;
  int row_u, end_u, row_v, end_v;
};

// Classify kChains items of pairs (u, v) and fold them:
// census.classify_items plus census.prune_keep_mask, lane by lane.
__device__ __forceinline__ void classify_fold(const int* __restrict__ packed,
                                              const Item (&it)[kChains],
                                              int keep_mode, int* s_acc,
                                              Lanes& lanes) {
  int wp[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    wp[c] = it[c].valid ? __ldg(packed + it[c].slot) : 0;
  }
  int w[kChains], lo[kChains], hi[kChains], hv[kChains];
  bool counted[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const Item& x = it[c];
    w[c] = wp[c] >> 2;
    const bool not_self = (w[c] != x.u) && (w[c] != x.v);
    if (x.valid) {
      if (keep_mode == kKeepDegree) {
        const int inter_side = (x.pc >> 2) & 1;
        const bool can_count = x.side == 0 ? w[c] > x.v : w[c] > x.u;
        lanes.kept += not_self && (x.side == inter_side || can_count);
      } else if (keep_mode == kKeepNotSelf) {
        lanes.kept += not_self;
      } else if (keep_mode == kKeepAll) {
        lanes.kept += 1;
      }
    }
    // both census masks require w outside {u, v}
    counted[c] = x.valid && not_self;
    lo[c] = counted[c] ? x.olo : 0;
    hi[c] = counted[c] ? x.ohi : 0;
    hv[c] = 0;
  }
  // lower bound of w in each other row, all chains in lockstep; hv keeps
  // packed[hi] once a probe has lowered hi, which is the hit when found
  for (;;) {
    bool any = false;
    int mid[kChains], probe[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      mid[c] = (lo[c] + hi[c]) >> 1;
      probe[c] = lo[c] < hi[c] ? __ldg(packed + mid[c]) : 0;
      any |= lo[c] < hi[c];
    }
    if (!any) break;
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (lo[c] < hi[c]) {
        if ((probe[c] >> 2) < w[c]) {
          lo[c] = mid[c] + 1;
        } else {
          hi[c] = mid[c];
          hv[c] = probe[c];
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const Item& x = it[c];
    const bool found = counted[c] && lo[c] < x.ohi && (hv[c] >> 2) == w[c];
    const int c_other = found ? hv[c] & 3 : 0;
    const int c_side = wp[c] & 3;
    const int c_uv = x.pc & 3;
    const int c_uw = x.side == 0 ? c_side : c_other;
    const int c_vw = x.side == 0 ? c_other : c_side;
    const bool dedup = !(found && x.side == 1);  // union duplicates once
    const bool canonical =
        (x.v < w[c]) || (x.u < w[c] && w[c] < x.v && c_uw == 0);
    const int bin = counted[c] && dedup && canonical
                        ? c_uv * 16 + c_uw * 4 + c_vw
                        : -1;
    if (found && x.side == ((x.pc >> 2) & 1)) {
      if (c_uv == 3) {
        ++lanes.inter_mut;
      } else {
        ++lanes.inter_asym;
      }
    }
    if (bin >= 0) atomicAdd(&s_acc[bin], 1);
  }
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

// Block-wide min and max of (lo, hi) through s_red; every thread gets
// the result.  Ends with a barrier, so s_red may be reused after it.
__device__ __forceinline__ void block_min_max(int& lo, int& hi, int* s_red) {
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_red[warp] = lo;
    s_red[kWarps + warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    lo = min(lo, s_red[k]);
    hi = max(hi, s_red[kWarps + k]);
  }
  __syncthreads();
}

struct DescWindow {
  const int* desc_pair;
  const int* desc_cum;
  const int* desc_within0;
  const int* anchors;
  int num_descs;
  int num_anchors;
};

// census.expand_work_items for one valid lane, from global memory: the
// first descriptor with desc_cum > i among the <= 17 the anchor allows,
// less one (census.lane_descriptors), then its pair and slot.
__device__ __forceinline__ Item resolve_global(const GraphArrays& g,
                                               const DescWindow& win, int i) {
  const int lo_d = __ldg(win.anchors + min(i / kAnchorStride,
                                           win.num_anchors - 1));
  const int hi_d = min(lo_d + kAnchorStride + 1, win.num_descs);
  int lo = lo_d;
  int hi = hi_d;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(win.desc_cum + mid) <= i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int d = min(max(lo - 1, 0), hi_d - 1);
  const int pair = __ldg(win.desc_pair + d);
  const int within =
      __ldg(win.desc_within0 + d) + (i - __ldg(win.desc_cum + d));
  Item x;
  x.valid = true;
  x.u = __ldg(g.pair_u + pair);
  x.v = __ldg(g.pair_v + pair);
  x.pc = __ldg(g.pair_code + pair);
  const int row_u = __ldg(g.indptr + x.u);
  const int end_u = __ldg(g.indptr + x.u + 1);
  const int row_v = __ldg(g.indptr + x.v);
  const int deg_u = end_u - row_u;
  x.side = within >= deg_u ? 1 : 0;
  x.slot = x.side == 0 ? row_u + within : row_v + within - deg_u;
  x.olo = x.side == 0 ? row_v : row_u;
  x.ohi = x.side == 0 ? __ldg(g.indptr + x.v + 1) : end_u;
  return x;
}

// Stage tile [a0, a1]'s descriptors [d0, d0 + nst) and, where the
// window is well formed there, its lane table: s_tab[i - 16 a0] is the
// staged descriptor index i falls in (less d0).  For such a window the
// anchored search of lane i lands on the last descriptor with
// desc_cum <= i, which the table holds.  Returns whether the table was
// built; block-uniform, ends with a barrier.
__device__ __forceinline__ bool stage_tile(const GraphArrays& g,
                                           const DescWindow& win,
                                           const int* s_anchor, int* s_cum,
                                           StagedDesc* s_desc, short* s_tab,
                                           int* s_red, int a0, int a1, int d0,
                                           int nst) {
  for (int k = threadIdx.x; k < nst; k += kThreads) {
    const int d = d0 + k;
    const int pair = __ldg(win.desc_pair + d);
    StagedDesc e;
    e.within0 = __ldg(win.desc_within0 + d);
    e.u = __ldg(g.pair_u + pair);
    e.v = __ldg(g.pair_v + pair);
    e.pc = __ldg(g.pair_code + pair);
    e.row_u = __ldg(g.indptr + e.u);
    e.end_u = __ldg(g.indptr + e.u + 1);
    e.row_v = __ldg(g.indptr + e.v);
    e.end_v = __ldg(g.indptr + e.v + 1);
    s_cum[k] = __ldg(win.desc_cum + d);
    s_desc[k] = e;
  }
  __syncthreads();
  // well formed: desc_cum never falls, rises strictly below the table's
  // end (padding descriptors repeat DESC_CUM_PAD past it), and each anchor
  // is the last descriptor starting at or before its index
  const int end = (a1 + 1) * kAnchorStride;
  bool ok = true;
  for (int k = threadIdx.x; k + 1 < nst; k += kThreads) {
    ok = ok && (s_cum[k] < s_cum[k + 1] ||
                (s_cum[k] == s_cum[k + 1] && s_cum[k] >= end));
  }
  for (int k = threadIdx.x; k <= a1 - a0; k += kThreads) {
    const int at = s_anchor[k] - d0;
    const int index = (a0 + k) * kAnchorStride;
    ok = ok && s_cum[at] <= index &&
         (at + d0 + 1 == win.num_descs || s_cum[at + 1] > index);
  }
  if (!__syncthreads_and(ok)) return false;
  // marks at each descriptor's first index (index 16 a0 falls in its
  // anchor's descriptor), then a running max: per thread over a chunk,
  // then across the chunks' maxima
  const int base = a0 * kAnchorStride;
  const int len = end - base;
  for (int k = threadIdx.x; k < len; k += kThreads) {
    s_tab[k] = static_cast<short>(k == 0 ? s_anchor[0] - d0 : -1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nst; k += kThreads) {
    const int at = s_cum[k] - base;
    if (at >= 0 && at < len) s_tab[at] = static_cast<short>(k);
  }
  __syncthreads();
  constexpr int kChunk = (kTable + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * kChunk;
  const int hi = min(lo + kChunk, len);
  int run = -1;
  for (int k = lo; k < hi; ++k) run = max(run, static_cast<int>(s_tab[k]));
  const int lane = threadIdx.x & 31;
  int incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = max(incl, up);
  }
  if (lane == 31) s_red[threadIdx.x >> 5] = incl;
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = -1;
  for (int w = 0; w < (threadIdx.x >> 5); ++w) before = max(before, s_red[w]);
  for (int k = lo; k < hi; ++k) {
    before = max(before, static_cast<int>(s_tab[k]));
    s_tab[k] = static_cast<short>(before);
  }
  __syncthreads();
  return true;
}

// A lane of a staged tile: its descriptor from the lane table (index i,
// table base 16 a0), the rest from the staged descriptor.
__device__ __forceinline__ Item resolve_staged(const short* s_tab,
                                               const int* s_cum,
                                               const StagedDesc* s_desc,
                                               int base, int i) {
  const int k = s_tab[i - base];
  const StagedDesc e = s_desc[k];
  const int within = e.within0 + (i - s_cum[k]);
  const int deg_u = e.end_u - e.row_u;
  Item x;
  x.valid = true;
  x.u = e.u;
  x.v = e.v;
  x.pc = e.pc;
  x.side = within >= deg_u ? 1 : 0;
  x.slot = x.side == 0 ? e.row_u + within : e.row_v + within - deg_u;
  x.olo = x.side == 0 ? e.row_v : e.row_u;
  x.ohi = x.side == 0 ? e.end_v : e.end_u;
  return x;
}

// kProbe also records which branch ran: tile_staged[tile] whether the
// tile staged its lane table, lane_staged[position] whether that lane
// resolved from it (census_fused_desc_probe_launch; the main path runs
// the kProbe = false instance, which writes neither).
template <bool kProbe>
__global__ void __launch_bounds__(kThreads)
census_fused_desc(GraphArrays g, DescWindow win,
                  const int* __restrict__ num_valid_ptr,
                  const int* __restrict__ idx, int num_items, int keep_mode,
                  int* __restrict__ out, int* __restrict__ tile_staged,
                  int* __restrict__ lane_staged) {
  __shared__ int s_cum[kStageDescs];
  __shared__ StagedDesc s_desc[kStageDescs];
  __shared__ int s_anchor[kStageAnchors];
  __shared__ short s_tab[kTable];
  __shared__ int s_acc[kOutWords];
  __shared__ int s_red[2 * kWarps];

  const int first = blockIdx.x * kBlockItems;
  const int count = min(num_items - first, kBlockItems);
  for (int t = threadIdx.x; t < kOutWords; t += kThreads) s_acc[t] = 0;

  // the anchors of the tile's lane positions, then the descriptors they
  // reach: [max(min - 1, 0), min(max + 17, num_descs))
  const int a0 = min(first / kAnchorStride, win.num_anchors - 1);
  const int a1 = min((first + max(count, 1) - 1) / kAnchorStride,
                     win.num_anchors - 1);
  int amin = INT_MAX;
  int amax = INT_MIN;
  for (int k = threadIdx.x; k <= a1 - a0; k += kThreads) {
    const int anchor = __ldg(win.anchors + a0 + k);
    s_anchor[k] = anchor;
    amin = min(amin, anchor);
    amax = max(amax, anchor);
  }
  block_min_max(amin, amax, s_red);
  const int nd = win.num_descs;
  const int d0 = max(amin - 1, 0);
  const int d1 = nd - amax > kAnchorStride + 1 ? amax + kAnchorStride + 1 : nd;
  const bool staged = amin >= 0 && amax < nd && d1 - d0 <= kStageDescs &&
                      stage_tile(g, win, s_anchor, s_cum, s_desc, s_tab, s_red,
                                 a0, a1, d0, d1 - d0);
  const int tab_lo = a0 * kAnchorStride;
  const int tab_hi = staged ? (a1 + 1) * kAnchorStride : tab_lo;
  if (kProbe && threadIdx.x == 0) tile_staged[blockIdx.x] = staged;

  // each lane's index, read one round ahead
  const int num_valid = __ldg(num_valid_ptr);
  int next[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const int t = c * kThreads + threadIdx.x;
    next[c] = t < count ? __ldg(idx + first + t) : -1;
  }
  Lanes lanes{0, 0, 0};
  for (int base = 0; base < count; base += kThreads * kChains) {
    int cur[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      cur[c] = next[c];
      const int t = base + (kChains + c) * kThreads + threadIdx.x;
      next[c] = t < count ? __ldg(idx + first + t) : -1;
    }
    Item it[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int i = cur[c];
      const bool valid = i >= 0 && i < num_valid;  // else padding: zero
      const bool from_stage = valid && i >= tab_lo && i < tab_hi;
      it[c] = Item{};
      if (valid) {
        it[c] = from_stage ? resolve_staged(s_tab, s_cum, s_desc, tab_lo, i)
                           : resolve_global(g, win, i);
      }
      if (kProbe) {
        const int t = base + c * kThreads + threadIdx.x;
        if (t < count) lane_staged[first + t] = from_stage;
      }
    }
    classify_fold(g.packed, it, keep_mode, s_acc, lanes);
  }
  flush(s_acc, lanes, out);
}

__global__ void __launch_bounds__(kThreads)
census_fused_items(GraphArrays g, const int* __restrict__ item_sp,
                   const int* __restrict__ item_pv, int num_items,
                   int* __restrict__ out) {
  __shared__ int s_acc[kOutWords];
  for (int t = threadIdx.x; t < kOutWords; t += kThreads) s_acc[t] = 0;
  __syncthreads();
  Lanes lanes{0, 0, 0};
  const int first = blockIdx.x * kBlockItems;
  const int count = min(num_items - first, kBlockItems);
  for (int base = 0; base < count; base += kThreads * kChains) {
    Item it[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int t = first + base + c * kThreads + threadIdx.x;
      const int pv = t < first + count ? __ldg(item_pv + t) : 0;
      Item& x = it[c];
      x = Item{};
      x.valid = (pv & 1) != 0;  // a zero valid bit is padding: exact zero
      if (x.valid) {
        const int sp = __ldg(item_sp + t);
        const int pair = pv >> 1;
        x.u = __ldg(g.pair_u + pair);
        x.v = __ldg(g.pair_v + pair);
        x.pc = __ldg(g.pair_code + pair);
        x.slot = sp >> 1;
        x.side = sp & 1;
        const int other = x.side == 0 ? x.v : x.u;
        x.olo = __ldg(g.indptr + other);
        x.ohi = __ldg(g.indptr + other + 1);
      }
    }
    classify_fold(g.packed, it, kKeepNone, s_acc, lanes);
  }
  flush(s_acc, lanes, out);
}

int num_blocks(int num_items) {
  const long long blocks =
      (static_cast<long long>(num_items) + kBlockItems - 1) / kBlockItems;
  return blocks > 0 ? static_cast<int>(blocks) : 1;
}

template <bool kProbe>
int launch_desc(const int* indptr, const int* packed, const int* pair_u,
                const int* pair_v, const int* pair_code, const int* desc_pair,
                const int* desc_cum, const int* desc_within0,
                const int* anchors, const int* num_valid, const int* idx,
                int num_items, int num_descs, int num_anchors, int keep_mode,
                int* out, int* tile_staged, int* lane_staged, void* stream) {
  const GraphArrays g{indptr, packed, pair_u, pair_v, pair_code};
  const DescWindow win{desc_pair, desc_cum,  desc_within0,
                       anchors,   num_descs, num_anchors};
  census_fused_desc<kProbe><<<num_blocks(num_items), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      g, win, num_valid, idx, num_items, keep_mode, out, tile_staged,
      lane_staged);
  return static_cast<int>(cudaGetLastError());
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
  return launch_desc<false>(indptr, packed, pair_u, pair_v, pair_code,
                            desc_pair, desc_cum, desc_within0, anchors,
                            num_valid, idx, num_items, num_descs, num_anchors,
                            keep_mode, out, nullptr, nullptr, stream);
}

// The same launch, from the same kernel body, that also reports which
// branch ran: tile_staged int32[ceil(num_items / 4096)] (at least 1) and
// lane_staged int32[num_items], both written in full.  A diagnostic: the
// main path never calls it.
int census_fused_desc_probe_launch(
    const int* indptr, const int* packed, const int* pair_u,
    const int* pair_v, const int* pair_code, const int* desc_pair,
    const int* desc_cum, const int* desc_within0, const int* anchors,
    const int* num_valid, const int* idx, int num_items, int num_descs,
    int num_anchors, int keep_mode, int* out, int* tile_staged,
    int* lane_staged, void* stream) {
  return launch_desc<true>(indptr, packed, pair_u, pair_v, pair_code,
                           desc_pair, desc_cum, desc_within0, anchors,
                           num_valid, idx, num_items, num_descs, num_anchors,
                           keep_mode, out, tile_staged, lane_staged, stream);
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
