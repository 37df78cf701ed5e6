// Fused triad-census kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/census_fused.py:
//   census_fused_desc_kernel (body _desc_kernel) -> census_fused_desc
//     device emission: flat item index -> (pair, slot, side) by an
//     anchored lower-bound search over the window's descriptor table,
//     then classify and fold; the main path, one launch per window.
//   the same kernel under lax.scan over a (K, words) window batch
//   (src/repro/core/census.py census_partials_desc_batch, the async
//   partitioned megastep)                        -> census_fused_desc_batch
//     one launch of grid (tiles, real rows) runs the same body,
//     desc_tile(), on every real row, skipping tiles past a row's valid
//     count; the single-window kernel is that body at grid (tiles).
//   census_fused_kernel (body _kernel)           -> census_fused_items
//     host emission: the same classify-and-fold fed packed item words
//     item_sp = slot << 1 | side, item_pv = pair << 1 | valid.
// and one kernel that replaces no TPU kernel:
//   desc_anchors: a descriptor window's anchor table from its desc_cum,
//     which the JAX package builds with numpy on the host and ships with
//     every window (see the note above desc_anchors below).
// The desc kernel resolves and classifies through classify_fold() (the
// witness gather, the row search, the tricode classification and the
// histogram fold); the items kernel through classify_fold_lanes(), the
// same classification with the witness and the row search taken from
// shared memory where its tile staged them.
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
// patents-size graph's first window (NVIDIA H100 80GB HBM3, 700 W).
// Variants that each undo one step are 0-19 % slower, and none removes
// most of what is left: the lanes'
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
// What bounds the items kernel: the same per-lane work, and occupancy.
// Host items come grouped by pair, so the 4,096 lanes of a tile touch a
// few hundred pairs, and the first port fetched each lane's pair words,
// indptr words and rows from global memory at the end of its chain.
// The redesign stages them once per tile:
// 4. Runs.  Thread t reads the item_pv words of lanes [16 t, 16 t + 16)
//    (16-byte loads where aligned); a run starts at each valid lane whose
//    pair differs from the previous valid lane's, and two block scans
//    (last valid pair before each thread, heads before each thread) give
//    every lane its run.
// 5. The stage.  A tile of at most kStageRuns runs records each run's
//    pair (u, v, code, both row bounds); in run order, a run whose rows
//    fit the row buffer alone is placed at the running sum of such
//    rows, and staged when it ends within the buffer.  The staged rows
//    are copied coalesced: word w of the buffer belongs to the staged
//    run whose start bit is the last at or before w.
// 6. Staged lanes.  A lane of a staged run reads its witness and
//    searches the other row in shared memory: after its item_sp word it
//    makes no global load (nor after its item_pv word, read in step 4).
//    Any other lane -- a run past the buffer, a hub pair whose rows
//    exceed it, a tile of more than kStageRuns runs (shuffled or strided
//    items) -- resolves from global memory in the same launch.
//    kernels/census_fused.py tile_item_stage is this rule in torch;
//    census_fused_items_probe_launch runs this kernel and reports which
//    branch each tile and lane took, and each tile's clock per phase.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md,
// section 6), the redesign is slower than the first port's per-lane
// kernel: 0.205 against 0.140 ms at the patents-size graph's first
// window.  Undoing the row stage alone makes it up to 3 % faster, the
// records too 3-9 %: the first port's per-lane path is fast at 8 blocks
// per SM, and the stage's 43 KB of shared memory and 64 registers allow
// 4.  A tile spends about half its clock on the lanes'
// own work (classification and row search) and half on the runs, the
// records and the row copy, which the lanes wait for.  A 5,120-word
// buffer stages more runs and is 1-4 % slower; capping registers for 5
// or 6 blocks per SM spills and is no faster.
// The stage is sized to stay within 48 KB of static shared memory: a
// dynamic (extern) array in this file would change the desc kernel's
// shared-memory size as ptxas reports it.
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
#include <cstdint>

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
constexpr int kStageRuns = 512;     // kernels.census_fused.STAGE_RUNS
constexpr int kStageWords = 4096;   // kernels.census_fused.STAGE_WORDS
constexpr int kLanesPerThread = kBlockItems / kThreads;
constexpr int kRunsPerThread = kStageRuns / kThreads;
constexpr int kStartWords = kStageWords / 32;  // start bits per 32 words
constexpr int kCopyBatch = 8;       // row words in flight per thread
static_assert(kStageRuns % kThreads == 0 && kStartWords <= kThreads,
              "run records and start-bit words are spread over threads");
static_assert(kStageWords < 65536 && kStageRuns < 32768,
              "packed scans and 16-bit run indices");
// s.lane state of a padding lane (zero valid bit); else its run
constexpr short kLanePadding = -1;

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

// The body of both desc kernels: tile blockIdx.x of one descriptor
// window, folded into out.  (The tile is read from blockIdx.x here, not
// passed in: with a tile parameter ptxas gave census_fused_desc 40
// registers instead of 48.)  kProbe also records which branch ran:
// tile_staged[tile] whether the tile staged its lane table,
// lane_staged[position] whether that lane resolved from it
// (census_fused_desc_probe_launch; the main path runs the kProbe = false
// instance, which writes neither).
template <bool kProbe>
__device__ __forceinline__ void desc_tile(const GraphArrays& g,
                                          const DescWindow& win,
                                          const int* __restrict__ num_valid_ptr,
                                          const int* __restrict__ idx,
                                          int num_items, int keep_mode,
                                          int* __restrict__ out,
                                          int* __restrict__ tile_staged,
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

// One descriptor window: block x runs tile x.
template <bool kProbe>
__global__ void __launch_bounds__(kThreads)
census_fused_desc(GraphArrays g, DescWindow win,
                  const int* __restrict__ num_valid_ptr,
                  const int* __restrict__ idx, int num_items, int keep_mode,
                  int* __restrict__ out, int* __restrict__ tile_staged,
                  int* __restrict__ lane_staged) {
  desc_tile<kProbe>(g, win, num_valid_ptr, idx, num_items, keep_mode, out,
                    tile_staged, lane_staged);
}

// The K-window megastep: row y of the (K, row_stride) int32 batch is one
// DescriptorWindow.device_words() row -- num_preprune, then num_descs
// desc_pair, desc_cum and desc_within0 words, then num_anchors anchors
// -- and block (x, y) runs tile x of it into out[y] (int32[67] each)
// through desc_tile, the single-window kernel's body.  The launch covers
// the batch's real rows only.  A padding row (word 0 == 0) returns at
// once.  A block whose tile reaches past its row's valid count (the tail
// of a shard's last window) first reads the tile's indices and returns
// when none is a valid lane; a full tile reads nothing more.  Both exits
// are block-uniform and come before the first barrier: the output row
// stays zero, as the reference's lax.cond leaves a padding row's.
//
// A tile-major design -- one block per tile walking every row, reading
// the tile's indices once, computing in-order indices instead of loading
// them, fetching the next row's anchors by cp.async during a row's fold
// -- measured 10-12 % slower at every full batch (PERF.md, section 6):
// its loop over rows keeps block state live across the fold, so it
// spills at 40 registers or fits 5 blocks per SM at 48, where this body
// fits 6 at 40.
__global__ void __launch_bounds__(kThreads)
census_fused_desc_batch(GraphArrays g, const int* __restrict__ words,
                        int row_stride, int num_descs, int num_anchors,
                        const int* __restrict__ idx, int num_items,
                        int keep_mode, int* __restrict__ out) {
  const int* row = words + static_cast<long long>(blockIdx.y) * row_stride;
  const int num_valid = __ldg(row);
  if (num_valid == 0) return;
  const int first = blockIdx.x * kBlockItems;
  const int count = min(num_items - first, kBlockItems);
  if (num_valid < first + count) {
    bool live = false;
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const int i = __ldg(idx + first + t);
      live = live || (i >= 0 && i < num_valid);
    }
    if (!__syncthreads_or(live)) return;
  }
  const DescWindow win{row + 1,
                       row + 1 + num_descs,
                       row + 1 + 2 * num_descs,
                       row + 1 + 3 * num_descs,
                       num_descs,
                       num_anchors};
  desc_tile<false>(g, win, row, idx, num_items, keep_mode,
                   out + blockIdx.y * kOutWords, nullptr, nullptr);
}

// ---- host-emission kernel: runs of one pair staged per tile ----

// Exclusive prefix sum of x over the block's threads in thread order;
// total gets the block's sum.  Ends with a barrier.
__device__ __forceinline__ int block_exclusive_sum(int x, int* s_scan,
                                                   int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  int before = incl - x;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int part = s_scan[w];
    if (w < warp) before += part;
    total += part;
  }
  __syncthreads();
  return before;
}

// The last x >= 0 of the threads before this one, in thread order, or -1.
// Ends with a barrier.
__device__ __forceinline__ int block_last_before(int x, int* s_scan) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off && incl < 0) incl = up;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  int before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = -1;
  for (int w = warp - 1; w >= 0 && before < 0; --w) before = s_scan[w];
  __syncthreads();
  return before;
}

// A run of lanes of one pair, recorded by its tile: the copy fields
// first (one 16-byte word), then the rest.
struct alignas(16) StagedRun {
  int off;  // row buffer word of u's row (v's follows it); -1: not staged
  int row_u, deg_u, row_v;
  int u, v, pc, deg_v;
};

// The items kernel's shared memory: within the 48 KB of static shared
// memory, so that four blocks fit an SM.
struct ItemStage {
  int buf[kStageWords];         // staged rows, run after run
  StagedRun run[kStageRuns];    // per run of the tile
  short lane[kBlockItems];      // per lane: its run, or kLanePadding
  short order[kStageRuns];      // the staged runs, in buffer order
  unsigned starts[kStartWords];  // bit w % 32 of word w / 32: a run starts
  int rank[kStartWords];        // staged runs starting before word 32 k
  int acc[kOutWords];
  int scan[kWarps];
};

// One host item, resolved: its pair, its witness entry, and where the
// other endpoint's row lies: in the row buffer, or in packed.
struct ItemLane {
  bool valid;
  bool staged;      // the other row is [olo, ohi) of the row buffer
  int u, v, pc, side;
  int wp;           // the witness entry packed[slot]
  int olo, ohi;     // else [olo, ohi) of packed
};

// classify_fold for resolved host items: the same classification and
// fold, with the witness already loaded and each chain's row search in
// the row buffer (shared) or in packed (global, read-only path).
__device__ __forceinline__ void classify_fold_lanes(
    const int* __restrict__ packed, const int* s_buf,
    const ItemLane (&it)[kChains], int* s_acc, Lanes& lanes) {
  int w[kChains], lo[kChains], hi[kChains], hv[kChains];
  bool counted[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const ItemLane& x = it[c];
    w[c] = x.wp >> 2;
    counted[c] = x.valid && (w[c] != x.u) && (w[c] != x.v);
    lo[c] = counted[c] ? x.olo : 0;
    hi[c] = counted[c] ? x.ohi : 0;
    hv[c] = 0;
  }
  for (;;) {
    bool any = false;
    int mid[kChains], probe[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      mid[c] = (lo[c] + hi[c]) >> 1;
      probe[c] = lo[c] >= hi[c]  ? 0
                 : it[c].staged ? s_buf[mid[c]]
                                : __ldg(packed + mid[c]);
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
    const ItemLane& x = it[c];
    const bool found = counted[c] && lo[c] < x.ohi && (hv[c] >> 2) == w[c];
    const int c_other = found ? hv[c] & 3 : 0;
    const int c_side = x.wp & 3;
    const int c_uv = x.pc & 3;
    const int c_uw = x.side == 0 ? c_side : c_other;
    const int c_vw = x.side == 0 ? c_other : c_side;
    const bool dedup = !(found && x.side == 1);
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

// Runs, records and the row stage of the tile [first, first + count):
// fills s.lane, s.run, s.order and s.buf.  Returns whether the tile's
// runs were recorded (at most kStageRuns); block-uniform, ends with a
// barrier.  kProbe: clk[0] gets the clock when the records are done
// (before the rows are copied).
template <bool kProbe>
__device__ __forceinline__ bool stage_items(const GraphArrays& g,
                                            const int* __restrict__ pv_tile,
                                            int count, ItemStage& s,
                                            long long* clk) {
  // 1. runs: thread t reads the item_pv words of lanes [16 t, 16 t + 16)
  const int lo = threadIdx.x * kLanesPerThread;
  int pv[kLanesPerThread];
  if (lo + kLanesPerThread <= count &&
      (reinterpret_cast<uintptr_t>(pv_tile) & 15u) == 0) {
    const int4* p4 = reinterpret_cast<const int4*>(pv_tile + lo);
#pragma unroll
    for (int q = 0; q < kLanesPerThread / 4; ++q) {
      const int4 x = __ldg(p4 + q);
      pv[4 * q] = x.x;
      pv[4 * q + 1] = x.y;
      pv[4 * q + 2] = x.z;
      pv[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kLanesPerThread; ++i) {
      pv[i] = lo + i < count ? __ldg(pv_tile + lo + i) : 0;
    }
  }
  if (threadIdx.x < kStartWords) s.starts[threadIdx.x] = 0u;
  int last = -1;
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    if (pv[i] & 1) last = pv[i] >> 1;
  }
  // a run head: a valid lane whose pair differs from the previous valid
  // lane's in the tile
  int prev = block_last_before(last, s.scan);
  unsigned heads = 0u;
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    if (pv[i] & 1) {
      if ((pv[i] >> 1) != prev) heads |= 1u << i;
      prev = pv[i] >> 1;
    }
  }
  int num_runs = 0;
  int run = block_exclusive_sum(__popc(heads), s.scan, num_runs) - 1;
  const bool recorded = num_runs <= kStageRuns;
#pragma unroll
  for (int i = 0; i < kLanesPerThread; ++i) {
    short state = kLanePadding;
    if (pv[i] & 1) {
      if ((heads >> i) & 1u) {
        ++run;
        if (recorded) s.run[run].u = pv[i] >> 1;  // the pair, for now
      }
      state = static_cast<short>(run);
    }
    s.lane[lo + i] = state;
  }
  __syncthreads();
  if (!recorded) {
    if (kProbe && threadIdx.x == 0) clk[0] = clock64();
    return false;
  }

  // 2. records: thread t takes runs 2 t and 2 t + 1; both rows of a run
  // take len words, placed at the running sum of the lengths of the
  // runs before it that fit the buffer alone; a run is staged when it
  // fits alone (0 < len <= kStageWords) and ends within the buffer
  StagedRun e[kRunsPerThread];
  int len[kRunsPerThread];
  bool fits[kRunsPerThread];
#pragma unroll
  for (int j = 0; j < kRunsPerThread; ++j) {
    const int k = threadIdx.x * kRunsPerThread + j;
    len[j] = 0;
    if (k < num_runs) {
      const int pair = s.run[k].u;
      e[j].u = __ldg(g.pair_u + pair);
      e[j].v = __ldg(g.pair_v + pair);
      e[j].pc = __ldg(g.pair_code + pair);
    }
  }
#pragma unroll
  for (int j = 0; j < kRunsPerThread; ++j) {
    const int k = threadIdx.x * kRunsPerThread + j;
    if (k < num_runs) {
      e[j].row_u = __ldg(g.indptr + e[j].u);
      e[j].deg_u = __ldg(g.indptr + e[j].u + 1) - e[j].row_u;
      e[j].row_v = __ldg(g.indptr + e[j].v);
      e[j].deg_v = __ldg(g.indptr + e[j].v + 1) - e[j].row_v;
      len[j] = e[j].deg_u + e[j].deg_v;
    }
    fits[j] = len[j] > 0 && len[j] <= kStageWords;
  }
  int fit_words = 0;
#pragma unroll
  for (int j = 0; j < kRunsPerThread; ++j) fit_words += fits[j] ? len[j] : 0;
  int unused = 0;
  int off = block_exclusive_sum(fit_words, s.scan, unused);
  int staged_words = 0;
  int staged_runs = 0;
#pragma unroll
  for (int j = 0; j < kRunsPerThread; ++j) {
    const bool staged = fits[j] && off + len[j] <= kStageWords;
    e[j].off = staged ? off : -1;
    off += fits[j] ? len[j] : 0;
    staged_words += staged ? len[j] : 0;
    staged_runs += staged;
  }
  int totals = 0;
  int order =
      block_exclusive_sum(staged_words << 16 | staged_runs, s.scan, totals) &
      0xffff;
  const int words = totals >> 16;
#pragma unroll
  for (int j = 0; j < kRunsPerThread; ++j) {
    const int k = threadIdx.x * kRunsPerThread + j;
    if (k < num_runs) {
      s.run[k] = e[j];
      if (e[j].off >= 0) {
        s.order[order++] = static_cast<short>(k);
        atomicOr(&s.starts[e[j].off >> 5], 1u << (e[j].off & 31));
      }
    }
  }
  __syncthreads();
  const int bits = threadIdx.x < kStartWords ? __popc(s.starts[threadIdx.x])
                                             : 0;
  const int rank = block_exclusive_sum(bits, s.scan, unused);
  if (threadIdx.x < kStartWords) s.rank[threadIdx.x] = rank;
  __syncthreads();
  if (kProbe && threadIdx.x == 0) clk[0] = clock64();

  // 3. the rows: word w of the buffer belongs to the staged run whose
  // start is the last at or before w (its rank among the start bits)
  for (int w0 = threadIdx.x; w0 < words; w0 += kThreads * kCopyBatch) {
    int val[kCopyBatch];
#pragma unroll
    for (int q = 0; q < kCopyBatch; ++q) {
      const int w = w0 + q * kThreads;
      if (w < words) {
        const int grp = w >> 5;
        const int c = s.rank[grp] +
                      __popc(s.starts[grp] & ((2u << (w & 31)) - 1u)) - 1;
        const int4 f = *reinterpret_cast<const int4*>(&s.run[s.order[c]]);
        const int j = w - f.x;  // off, row_u, deg_u, row_v
        val[q] = __ldg(g.packed + (j < f.z ? f.y + j : f.w + (j - f.z)));
      }
    }
#pragma unroll
    for (int q = 0; q < kCopyBatch; ++q) {
      const int w = w0 + q * kThreads;
      if (w < words) s.buf[w] = val[q];
    }
  }
  __syncthreads();
  return true;
}

// A lane of a tile that recorded its runs, with item_sp word sp and
// lane state st (its run, or kLanePadding): straight-line, so that the
// chains of a thread interleave.  Its pair from the run's record; its
// witness and the other row from the row buffer when the run's rows are
// staged (the witness from packed should its slot lie outside its
// side's row), else from packed.
__device__ __forceinline__ ItemLane resolve_run(const int* __restrict__ packed,
                                                const ItemStage& s, int sp,
                                                int st) {
  const StagedRun r = s.run[max(st, 0)];
  ItemLane x;
  x.valid = st >= 0;  // a zero valid bit is padding: exact zero
  x.staged = x.valid && r.off >= 0;
  x.u = r.u;
  x.v = r.v;
  x.pc = r.pc;
  x.side = sp & 1;
  const int slot = sp >> 1;
  const bool side0 = x.side == 0;
  const int j = slot - (side0 ? r.row_u : r.row_v);
  const bool in_row = x.staged && static_cast<unsigned>(j) <
                                      static_cast<unsigned>(side0 ? r.deg_u
                                                                  : r.deg_v);
  x.wp = in_row    ? s.buf[(side0 ? r.off : r.off + r.deg_u) + j]
         : x.valid ? __ldg(packed + slot)
                   : 0;
  x.olo = x.staged ? (side0 ? r.off + r.deg_u : r.off)
                   : (side0 ? r.row_v : r.row_u);
  x.ohi = x.olo + (side0 ? r.deg_v : r.deg_u);
  return x;
}

// A lane of a tile past kStageRuns runs, from its item words alone, in
// global memory.
__device__ __forceinline__ ItemLane resolve_pv(const GraphArrays& g, int pv,
                                               int sp) {
  ItemLane x;
  x.valid = (pv & 1) != 0;  // a zero valid bit is padding: exact zero
  x.staged = false;
  x.u = x.v = x.pc = x.wp = x.olo = x.ohi = 0;
  x.side = sp & 1;
  if (x.valid) {
    const int pair = pv >> 1;
    x.u = __ldg(g.pair_u + pair);
    x.v = __ldg(g.pair_v + pair);
    x.pc = __ldg(g.pair_code + pair);
    x.wp = __ldg(g.packed + (sp >> 1));
    const int other = x.side == 0 ? x.v : x.u;
    x.olo = __ldg(g.indptr + other);
    x.ohi = __ldg(g.indptr + other + 1);
  }
  return x;
}

// kProbe also records which branch ran: tile_staged[tile] whether the
// tile recorded its runs (at most kStageRuns), lane_staged[position]
// whether that lane resolved from staged rows; and, per tile, the
// SM clock at 4 points: start, records done, rows staged, lanes done
// (tile_clocks[4 tile + k]).  census_fused_items_probe_launch; the main
// path runs the kProbe = false instance, which writes none of them.
template <bool kProbe>
__global__ void __launch_bounds__(kThreads)
census_fused_items(GraphArrays g, const int* __restrict__ item_sp,
                   const int* __restrict__ item_pv, int num_items,
                   int* __restrict__ out, int* __restrict__ tile_staged,
                   int* __restrict__ lane_staged,
                   long long* __restrict__ tile_clocks) {
  __shared__ ItemStage s;
  long long* clk = kProbe ? tile_clocks + 4 * blockIdx.x : nullptr;
  if (kProbe && threadIdx.x == 0) clk[0] = clock64();
  const int first = blockIdx.x * kBlockItems;
  const int count = min(num_items - first, kBlockItems);
  const int* pv_tile = item_pv + first;
  const int* sp_tile = item_sp + first;
  for (int t = threadIdx.x; t < kOutWords; t += kThreads) s.acc[t] = 0;
  // each lane's item_sp word, read one round ahead
  int next[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const int t = c * kThreads + threadIdx.x;
    next[c] = t < count ? __ldg(sp_tile + t) : 0;
  }
  const bool recorded = stage_items<kProbe>(g, pv_tile, count, s, clk + 1);
  if (kProbe && threadIdx.x == 0) {
    tile_staged[blockIdx.x] = recorded;
    clk[2] = clock64();
  }

  Lanes lanes{0, 0, 0};
  for (int base = 0; base < count; base += kThreads * kChains) {
    int sp[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      sp[c] = next[c];
      const int t = base + (kChains + c) * kThreads + threadIdx.x;
      next[c] = t < count ? __ldg(sp_tile + t) : 0;
    }
    ItemLane it[kChains];
    if (recorded) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const int t = base + c * kThreads + threadIdx.x;
        it[c] = resolve_run(g.packed, s, sp[c],
                            t < count ? s.lane[t] : kLanePadding);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const int t = base + c * kThreads + threadIdx.x;
        it[c] = resolve_pv(g, t < count ? __ldg(pv_tile + t) : 0, sp[c]);
      }
    }
    if (kProbe) {
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        const int t = base + c * kThreads + threadIdx.x;
        if (t < count) lane_staged[first + t] = it[c].staged;
      }
    }
    classify_fold_lanes(g.packed, s.buf, it, s.acc, lanes);
  }
  if (kProbe && threadIdx.x == 0) clk[3] = clock64();
  flush(s.acc, lanes, out);
}

// desc_anchors: anchors[a] = max(upper_bound(desc_cum, 16 a) - 1, 0), the
// last descriptor starting at or before item 16 a, over the window's
// padded desc_cum (live entries rising, then 2^31 - 1, above every grid
// point, so the search never counts padding and an empty window gives
// zeros).  It replaces no TPU kernel: the JAX package, and the port
// before it, built this table on the host (one np.searchsorted over the
// whole grid, 1,048,578 entries at 2^24 lanes) and shipped it with each
// window, 4.19 MB of a 4.33 MB upload.
// What bounds it: the table's writes, 4 B an anchor (4.19 MB, 1.25 us at
// 3.35 TB/s at 2^24 lanes); desc_cum, at most a few hundred KB, stays in
// L2, and the lanes of a block search a few neighbouring descriptors.
// Design: each thread takes kRunAnchors consecutive anchors.  It
// binary-searches the first and, since the anchors rise, gallops forward
// from there for the next ones (a step costs about two probes, and a run
// of equal desc_cum entries, from pairs with no items, costs a log of its
// length, not its length); it stores the run as one 16-byte word, so a
// warp's stores are one contiguous 512-byte span.
constexpr int kAnchorThreads = 256;
constexpr int kRunAnchors = 4;
static_assert(kRunAnchors == 4, "a run is stored as one int4");

// First index in [lo, n) whose desc_cum exceeds v, given that every index
// below lo holds at most v: probes lo, lo + 1, lo + 3, lo + 7, ... until
// one exceeds v, then bisects the last step.
__device__ int upper_bound_from(const int* __restrict__ cum, int n, int lo,
                                long long v) {
  int hi = n;
  for (int step = 1; lo < n; step <<= 1) {
    const int probe = lo + step - 1;
    if (probe >= n) break;
    if (__ldg(cum + probe) > v) {
      hi = probe;
      break;
    }
    lo = probe + 1;
  }
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(cum + mid) > v) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kAnchorThreads)
desc_anchors(const int* __restrict__ desc_cum, int num_descs,
             int* __restrict__ anchors, int num_anchors) {
  const long long a0 =
      (static_cast<long long>(blockIdx.x) * kAnchorThreads + threadIdx.x) *
      kRunAnchors;
  if (a0 >= num_anchors) return;
  long long v = a0 * kAnchorStride;
  int lo = 0;
  int hi = num_descs;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(desc_cum + mid) > v) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int run[kRunAnchors];
  run[0] = max(lo - 1, 0);
#pragma unroll
  for (int r = 1; r < kRunAnchors; ++r) {
    v += kAnchorStride;
    lo = upper_bound_from(desc_cum, num_descs, lo, v);
    run[r] = max(lo - 1, 0);
  }
  int* dst = anchors + a0;
  if (a0 + kRunAnchors <= num_anchors &&
      (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<int4*>(dst) = make_int4(run[0], run[1], run[2], run[3]);
  } else {
#pragma unroll
    for (int r = 0; r < kRunAnchors; ++r) {
      if (a0 + r < num_anchors) dst[r] = run[r];
    }
  }
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

template <bool kProbe>
int launch_items(const int* indptr, const int* packed, const int* pair_u,
                 const int* pair_v, const int* pair_code, const int* item_sp,
                 const int* item_pv, int num_items, int* out,
                 int* tile_staged, int* lane_staged, long long* tile_clocks,
                 void* stream) {
  const GraphArrays g{indptr, packed, pair_u, pair_v, pair_code};
  census_fused_items<kProbe><<<num_blocks(num_items), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      g, item_sp, item_pv, num_items, out, tile_staged, lane_staged,
      tile_clocks);
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

// The K-window megastep: words holds (at least num_rows) rows of
// row_stride int32 words, descriptor windows of one geometry (num_descs
// descriptors, num_anchors anchors; row_stride = 1 + 3 num_descs +
// num_anchors), idx the num_items-lane flat-index array every row
// expands.  Only the first num_rows rows are read: the batch's real
// windows.  out: int32[num_rows][67], zeroed here (one memset on the
// stream) and then accumulated, row y from batch row y; rows whose word 0
// is 0 stay zero.  Returns the first CUDA error of the calls, else
// cudaGetLastError() after the launch.
int census_fused_desc_batch_launch(const int* indptr, const int* packed,
                                   const int* pair_u, const int* pair_v,
                                   const int* pair_code, const int* words,
                                   const int* idx, int num_rows,
                                   int row_stride, int num_descs,
                                   int num_anchors, int num_items,
                                   int keep_mode, int* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int) * kOutWords * static_cast<size_t>(num_rows), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GraphArrays g{indptr, packed, pair_u, pair_v, pair_code};
  const dim3 grid(num_blocks(num_items), num_rows);
  census_fused_desc_batch<<<grid, kThreads, 0, st>>>(
      g, words, row_stride, num_descs, num_anchors, idx, num_items,
      keep_mode, out);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, then the resident blocks per SM of
// census_fused_desc and of the megastep (the occupancy calculator's
// answer for their registers and shared memory): out is int[3] in host
// memory.  Returns the first CUDA error of the queries.
int census_fused_desc_occupancy(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 1, census_fused_desc<false>, kThreads, 0);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out + 2, census_fused_desc_batch, kThreads, 0);
  }
  return static_cast<int>(err);
}

// out: zeroed int32[67] -- hist64, inter-asym, inter-mut (lane 66 stays 0).
int census_fused_items_launch(const int* indptr, const int* packed,
                              const int* pair_u, const int* pair_v,
                              const int* pair_code, const int* item_sp,
                              const int* item_pv, int num_items, int* out,
                              void* stream) {
  return launch_items<false>(indptr, packed, pair_u, pair_v, pair_code,
                             item_sp, item_pv, num_items, out, nullptr,
                             nullptr, nullptr, stream);
}

// The same launch, from the same kernel body, that also reports which
// branch ran and when: tile_staged int32[tiles] and lane_staged
// int32[num_items] (tiles = ceil(num_items / 4096), at least 1), and
// tile_clocks int64[4 tiles], all written in full.  A diagnostic: the
// main path never calls it.
int census_fused_items_probe_launch(const int* indptr, const int* packed,
                                    const int* pair_u, const int* pair_v,
                                    const int* pair_code,
                                    const int* item_sp, const int* item_pv,
                                    int num_items, int* out,
                                    int* tile_staged, int* lane_staged,
                                    long long* tile_clocks, void* stream) {
  return launch_items<true>(indptr, packed, pair_u, pair_v, pair_code,
                            item_sp, item_pv, num_items, out, tile_staged,
                            lane_staged, tile_clocks, stream);
}

// anchors: int32[num_anchors], written in full from desc_cum
// int32[num_descs] (a descriptor window's padded table).  Returns
// cudaGetLastError() after the launch.
int desc_anchors_launch(const int* desc_cum, int num_descs, int* anchors,
                        int num_anchors, void* stream) {
  if (num_anchors <= 0) return static_cast<int>(cudaSuccess);
  const long long threads =
      (static_cast<long long>(num_anchors) + kRunAnchors - 1) / kRunAnchors;
  const int blocks =
      static_cast<int>((threads + kAnchorThreads - 1) / kAnchorThreads);
  desc_anchors<<<blocks, kAnchorThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(desc_cum, num_descs,
                                                      anchors, num_anchors);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_torch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
