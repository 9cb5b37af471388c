// Per-level GBDT gradient histogram for Hopper (sm_90a):
//   out[n, f, b, :] = sum of gh[r, :] over rows r with rel[r] == n and bins[r, f] == b.
//
// Replaces the Pallas TPU kernel `_hist_kernel` (dmlc_core_tpu/ops/pallas_segment.py,
// launched from `_histogram_gh_pallas`), which computes the same histogram as a
// one-hot contraction on the MXU over an int32 [F, rows] copy of the codes.
// Contract kept from it:
//   * f32 (grad, hess) inputs and f32 results, no TF32 or bf16 anywhere;
//   * any num_bins >= 1 and any n_nodes >= 1; rows need not be a multiple of
//     anything; rows whose node id or bin code is out of range add nothing;
//   * bitwise the same result from launch to launch: no float atomics.
//
// Numerics (hist_fixed.cuh).  Each (grad, hess) value is rounded once to a
// 64-bit fixed-point integer with one scale per lane and launch, and every
// sum is an int64 add, exact and so the same in any order: integer atomics
// keep the determinism contract.  With n = rows, a bin of m rows ends at
// most m * n * amax * 2^-62 from its exact sum (amax = max |value| of the
// lane) before its one rounding to f32: 2.6e-5 if all 11M Higgs rows with
// |g| = 1 fell in one bin, against a tolerance of 1e-5 of the largest bin.
// A NaN or Inf in a lane makes that lane NaN everywhere.
//
// Layout.  The codes are read where they lie, as uint8 (or int32) [rows, F]
// row-major; gh as float2 [rows], rel as int32 [rows].  A fit scans its codes
// once (ops/histogram.py, dense_hist_layout) for the codes each feature's
// rows hold, its "used" bins: `slot` [F * B] numbers them 0..used-1 (-1 for
// a code the scan never saw), and the shared histogram keeps a feature's
// used bins only.  A caller with no scan gives every feature all num_bins
// (identity slots).
//
// What bounds it.  The function must read rows * F code bytes plus 12 bytes
// a row (rel, gh) and write 8 * n * F * B bytes: 0.131 ms at 3.35 TB/s for
// Higgs (11M rows x 28 features, 256 bins).  The work is one shared-memory
// add of two int64 (four 32-bit atomics) per (row, feature), 3.1e8 at
// Higgs, and it is bound by that atomic rate and by the rows each node tile
// and feature group reads again, not by bytes: 8-20x the byte bound on an
// H100 80GB HBM3 (chip_smoke's per-level lines).  On a column of few used
// bins every row of a node lands on one of a few words (Covertype's 44
// one-hot columns: two), and those atomics serialise.  So a level below
// the root is built by sibling subtraction (XGBoost hist's): only the
// child of each node pair with fewer rows adds its rows, and the other is
// the parent's accumulator less the built child's.  The sums are exact
// int64 at the same scale at every level of a tree (the scale depends on
// gh and the row count only), so the difference is the sibling's own sum
// bit for bit.  The JAX package builds every level in full: on the TPU a
// level is one fused, bandwidth-bound contraction.
//
// Design.  One call is two launches, the prologue of hist_fixed.cuh and
// the accumulate, which also dequantizes.  A cooperative launch (one
// launch, grid barriers, as segment_sum.cu) costs ~9 us however small the
// work; these calls run at 50,000 rows too, and two plain launches cost
// less.  The prologue zeroes the int64 accumulator, its marks and tickets
// and the outputs, and writes each of its blocks' max |g|, |h|; every
// accumulate block reduces those maxima to the scale itself, in double, as
// ops/fixed_point.py does, so the scale is fixed_point_scale(amax, rows)
// bit for bit and nothing else is queued.
//
// A subtracted level (Sub: given the previous level's scratch) runs the
// same launch over the n / 2 node pairs, building the child of each pair
// with fewer rows (the left on a tie; its prologue counts each node's rows
// into the parent's scratch, which the parent's prologue zeroed):
// the geometry and its node tiles count pairs, a row whose node is not its
// pair's built child is skipped before its codes and gh are read, and a
// built row adds under its pair.  Each warp first gathers the rows that
// add into a queue in shared memory and adds them 32 at a time, so that
// its lanes add together (about a third of the rows add at a Higgs level;
// left in place, nearly every warp would run the adds for a few lanes).
// The accumulator and the outputs stay full-level.  The ticket block of
// each item (below) also writes each pair's sibling, into the accumulator
// (parent - built, in int64) and, rounded once, into the outputs, over the
// item's slots, or over every bin of its features where this launch or an
// earlier level added a code the layout does not hold.  The launch's last
// block adds the rows the level added to a caller's counter and zeroes
// the counts again.
//
// The accumulate block (chunk, item) takes `chunk` rows and one item: a
// feature group and a node tile (n0, n1).  It holds ONE shared histogram of
// (n1 - n0) nodes x the group's used slots, which all its warps add into.
// Groups follow the rule tuned at Higgs width (ops/histogram.py,
// launch_geometry): 14 (node, feature) pairs a block while that leaves
// more than 3 features a node (depths 0-1), else 3 features and as many
// nodes as the widest group's slots leave room for (16 at 256 bins: depth
// 5's 32 nodes would take two tiles, its 16 pairs take one); a group of few-bin features (at most 8 used
// bins each: Covertype's one-hot columns, two slots each) takes every node
// its own slots leave room for, one tile at depth 5.  A block takes at
// least as many rows as the slots it zeroes and flushes.
//   * A group of consecutive features that use every bin is "plain" and
//     runs the loop tuned at Higgs width: each row adds straight into
//     shared memory.  A
//     launch of plain groups only (Higgs, MSLR, the sharded shares) is
//     the Plain instantiation, which computes its items and reads no
//     table before the rows.
//   * Other groups read a member table (in shared memory) and load the
//     codes of 4 features of a row at once, then add them; a code maps to
//     its slot by identity, by the few-bin feature's list of codes, or by
//     the layout's slot table.  Where a few-bin feature has at most
//     reduce_keys = 2 (node, slot) keys in the block (a one-hot column at
//     the root), each warp first sums the lanes of equal key
//     (__match_any_sync, then three 32-bit warp reductions of each int64,
//     hist_fixed::add_reduced), so a key gets one shared add a warp and
//     not one a row.  With more keys the match costs more than it saves
//     (chip_smoke.py --geometry-sweep: 0.57 ms against 0.26 at Covertype
//     depth 2 with 8 keys), and a warp pre-reduction measured slower
//     on many-bin features, where keys rarely repeat.
// Launches whose shared histogram leaves room for two blocks an SM use
// 32 registers a thread (MinBlocks 2); deeper ones keep their registers.
// A thread takes one row at a time, rounds its (g, h) once, and adds it to
// each feature of the group.  Blocks of one row
// chunk are adjacent in launch order, so a chunk's rows come from device
// memory once and from L2 for its other items.  The block adds its nonzero
// slots into the int64 [n, F, B, 2] buffer with global 64-bit integer
// atomics (a code with no slot adds there directly and marks its item).
// The last block of an item's chunks (a ticket) rounds the item's slots to
// f32 (the whole item when it holds an unslotted code or a lane is NaN);
// the last block of the launch makes a lane NaN everywhere if a value
// reached the value limit (or a subtracted level's parent carries that
// lane's mark).  The sharded route's accumulate entry runs the same body
// with the caller's scale and stops before the rounding.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_fixed.cuh"

namespace {

constexpr int kFew = 1;         // member flag: a few-bin feature (code list)
constexpr int kIdentity = 2;    // member flag: slot == code (every bin used)
constexpr int kMaxMembers = 16; // features a group holds at most
constexpr int kBatch = 4;       // features whose codes a thread loads at once
constexpr int kTwoBlocksSmem = 100 * 1024;  // dynamic bytes two blocks fit
constexpr int kQueue = 64;      // rows a warp's queue holds (Sub)
// An item (int4): group, n0, n1, and 1 when the group is plain (consecutive
// features, every bin used, none few-bin): the many-bin loop tuned at
// Higgs width,
// with no member table or slot lookups in it.

struct Dense {
  const void* bins;        // uint8 or int32 [rows, F]
  const int* rel;          // [rows]
  const float2* gh;        // [rows]
  hist_fixed::Scale sc;
  long long qmax;
  unsigned long long* acc; // [n_out] sums, then each lane's overflow mark
  int64_t n_out;
  unsigned* tickets;       // [1] launch, [1] spill flag, [n_items] tickets,
                           // [n_items] marks (after the children's counts)
  float* out;              // [n_out], or null: accumulate only
  int64_t rows;
  int64_t chunk;
  int F, B;
  int n_items;
  int n_groups, feat_group, node_tile, n_nodes;  // a Plain launch's geometry
                                                 // (n_nodes: pairs if Sub)
  int reduce_keys;         // pre-reduce a few-bin feature of at most this
                           // many (node, slot) keys in the block
  const int4* items;       // group, n0, n1, plain
  const int4* groups;      // first member, members, slots a node, first key
  const int4* members;     // feature, slot offset, flags, used
  const int4* lists;       // a few-bin member's used codes, 8 x int16 (-1 pad)
  const short* slot;       // [F * B] slot of a code in its feature, or -1
  const int* slot_key;     // f * B + code of each group slot
  // Sub: the previous level's scratch (its n_out / 2 sums, its marks, this
  // level's row counts, its launch ticket and spill flag), the counts
  // within it (pair p: rows of node 2p, of 2p + 1), and where to add the
  // rows the level adds, or null
  const unsigned long long* parent;
  int2* counts;
  unsigned long long* built;
};

// the slot of `code` among a few-bin feature's used codes (8 x int16), or -1
__device__ __forceinline__ int list_slot(int4 l, int code) {
  const int w[4] = {l.x, l.y, l.z, l.w};
  int s = -1;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (static_cast<short>(w[k >> 1] >> (16 * (k & 1))) == code) s = k;
  return s;
}

// MinBlocks 2: two blocks of 1024 an SM, so 32 registers a thread, for a
// launch whose shared histogram leaves room for two (kTwoBlocksSmem); 1
// for the deep levels, where one block fills the SM's shared memory and
// the plain loop keeps its registers
//
// Plain: every group of the launch is plain and every group has the same
// node tiles (Higgs, MSLR, the sharded shares): the item is group item %
// n_groups and tile item / n_groups, computed, with no table read before
// the rows and no code but that loop in the kernel.
//
// Sub: a subtracted level (see the header): node ids n0..n1 of the items
// and the shared histogram count pairs; pair c's built node is 2c + 1
// where that child has fewer rows than 2c, else 2c.
template <typename Code, int MinBlocks, bool Plain, bool Sub>
__global__ void __launch_bounds__(1024, MinBlocks)
hist_dense(const Dense a) {
  extern __shared__ unsigned s_hist[];
  __shared__ float s_scale[2];
  __shared__ unsigned s_tmp[2];
  __shared__ int s_flag[2];
  __shared__ int4 s_mem[kMaxMembers];
  __shared__ int4 s_list[kMaxMembers];
  __shared__ int s_queue[Sub ? 32 * kQueue : 1];  // each warp's row offsets
  const int item = static_cast<int>(blockIdx.x % a.n_items);
  const int64_t c = blockIdx.x / a.n_items;
  int4 it, gp;  // (group, n0, n1, plain), (first member, members, S, key0)
  if constexpr (Plain) {
    const int g = item % a.n_groups, f0 = g * a.feat_group;
    const int nf = a.feat_group < a.F - f0 ? a.feat_group : a.F - f0;
    const int t0 = (item / a.n_groups) * a.node_tile;
    it = make_int4(g, t0, t0 + a.node_tile < a.n_nodes ? t0 + a.node_tile
                                                        : a.n_nodes, 1);
    gp = make_int4(f0, nf, nf * a.B, 0);  // .x: the first feature
  } else {
    it = a.items[item];
    gp = a.groups[it.x];
  }
  const int n0 = it.y, n1 = it.z, S = gp.z, nm = gp.y;
  const int size = (n1 - n0) * S;
  if (!Plain && threadIdx.x < nm) {
    s_mem[threadIdx.x] = a.members[gp.x + threadIdx.x];
    s_list[threadIdx.x] = a.lists[gp.x + threadIdx.x];
  }
  hist_fixed::block_scale(a.sc, s_scale, s_tmp, [&] {  // ends with a barrier
    for (int i = threadIdx.x; i < 4 * size; i += blockDim.x) s_hist[i] = 0u;
  });
  const float sg = s_scale[0], sh = s_scale[1];
  unsigned long long* over = a.acc + a.n_out;
  const unsigned* p_spill = nullptr;  // Sub: the parent's spill flag
  if constexpr (Sub) {  // the parent's marks and spill flag are this level's
    const unsigned long long* p_over = a.parent + a.n_out / 2;
    p_spill = reinterpret_cast<const unsigned*>(p_over + 2 + a.n_nodes) + 1;
    if (blockIdx.x == 0 && threadIdx.x < 2) {
      if (__ldg(p_over + threadIdx.x)) over[threadIdx.x] = 1ull;
      if (threadIdx.x == 0 && __ldg(p_spill)) atomicOr(a.tickets + 1, 1u);
    }
  }
  const int lane = threadIdx.x & 31;
  // Sub: the built child (0 left, 1 right) of pair p; an item of at most
  // 32 pairs keeps its pairs' as bits in a register
  auto side_of = [&](int p) -> int {
    const int2 n = __ldg(a.counts + p);
    return n.y < n.x;
  };
  const bool few_pairs = n1 - n0 <= 32;
  unsigned sides = 0u;
  if (Sub && few_pairs)
    sides = __ballot_sync(0xffffffffu, lane < n1 - n0 && side_of(n0 + lane));
  // Sub: whether a row of node nd adds (its pair's built child, in the item)
  auto adds = [&](int nd) -> bool {
    const int p = nd >> 1;
    if (p < n0 || p >= n1) return false;
    return (nd & 1) == (few_pairs ? static_cast<int>(sides >> (p - n0)) & 1
                                  : side_of(p));
  };
  // the full-level node of pair (or node) nd
  auto node_of = [&](int nd) -> int64_t {
    return Sub ? 2 * static_cast<int64_t>(nd) + side_of(nd) : nd;
  };
  const int64_t r0 = c * a.chunk;
  const int64_t r1 = r0 + a.chunk < a.rows ? r0 + a.chunk : a.rows;
  bool spill = false;

  // Sub: body(r, node) for every row r of the chunk that adds in this item
  // (node: its pair less n0), 32 a call, the warp's lanes together; the
  // last call passes r = -1 to the lanes it has no row for
  int* const queue = s_queue + (threadIdx.x >> 5) * kQueue;
  auto built_rows = [&](auto&& body) {
    int count = 0;  // the same in the whole warp
    for (int64_t base = r0 + (threadIdx.x & ~31); base < r1;
         base += blockDim.x) {
      const int64_t r = base + lane;
      const bool add = r < r1 && adds(__ldg(a.rel + r));
      const unsigned m = __ballot_sync(0xffffffffu, add);
      if (add) queue[count + __popc(m & ((1u << lane) - 1u))] =
          static_cast<int>(r - r0);
      count += __popc(m);
      if (count >= 32) {
        __syncwarp();
        const int64_t q = r0 + queue[lane];
        body(q, (__ldg(a.rel + q) >> 1) - n0);
        __syncwarp();
        if (lane < count - 32) queue[lane] = queue[32 + lane];
        __syncwarp();
        count -= 32;
      }
    }
    __syncwarp();
    const int64_t q = lane < count ? r0 + queue[lane] : -1;
    body(q, q >= 0 ? (__ldg(a.rel + q) >> 1) - n0 : -1);
  };

  if (it.w) {  // plain: consecutive features, every bin used, none few
    const int f0 = Plain ? gp.x : s_mem[0].x;
    auto add_row = [&](int64_t r, int node) {
      const float2 v = __ldg(a.gh + r);
      const long long qg = hist_fixed::quantize(v.x, sg, a.qmax, over);
      const long long qh = hist_fixed::quantize(v.y, sh, a.qmax, over + 1);
      const Code* __restrict__ row =
          static_cast<const Code*>(a.bins) + r * a.F + f0;
      const int base = node * S;
      for (int j = 0; j < nm; ++j) {
        const int code = static_cast<int>(__ldg(row + j));
        if (code >= 0 && code < a.B)
          hist_fixed::add(s_hist, size, base + j * a.B + code, qg, qh);
      }
    };
    if constexpr (Sub) {
      built_rows([&](int64_t r, int node) {
        if (r >= 0) add_row(r, node);
      });
    } else {
      for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
        const int nd = __ldg(a.rel + r);
        if (nd >= n0 && nd < n1) add_row(r, nd - n0);
      }
    }
  }
  // a warp's lanes take consecutive rows and stay together (add_reduced):
  // node -1 for a lane with nothing to add
  auto add_rows = [&](int64_t r, int node) {
    long long qg = 0, qh = 0;
    if (node >= 0) {
      const float2 v = __ldg(a.gh + r);
      qg = hist_fixed::quantize(v.x, sg, a.qmax, over);
      qh = hist_fixed::quantize(v.y, sh, a.qmax, over + 1);
    }
    const Code* __restrict__ row = static_cast<const Code*>(a.bins) +
                                   (node >= 0 ? r * a.F : 0);
    for (int j0 = 0; j0 < nm; j0 += kBatch) {
      int code[kBatch];  // a batch's codes loaded together, then added
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        code[k] = node >= 0 && j0 + k < nm
                      ? static_cast<int>(__ldg(row + s_mem[j0 + k].x))
                      : -1;
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (j0 + k >= nm) break;  // the same for the whole block
        const int4 m = s_mem[j0 + k];
        int key = -1;
        if (code[k] >= 0 && code[k] < a.B) {
          const int s = (m.z & kIdentity) ? code[k]
                        : (m.z & kFew) ? list_slot(s_list[j0 + k], code[k])
                                       : a.slot[m.x * a.B + code[k]];
          if (s >= 0) {
            key = node * S + m.y + s;
          } else {  // a code the layout does not hold: straight to global
            const int64_t o = (node_of(node + n0) * a.F + m.x) * a.B +
                              code[k];
            atomicAdd(a.acc + 2 * o, static_cast<unsigned long long>(qg));
            atomicAdd(a.acc + 2 * o + 1, static_cast<unsigned long long>(qh));
            spill = true;
          }
        }
        if ((m.z & kFew) && m.w * (n1 - n0) <= a.reduce_keys)
          hist_fixed::add_reduced(s_hist, size, key, qg, qh);
        else if (key >= 0)
          hist_fixed::add(s_hist, size, key, qg, qh);
      }
    }
  };
  if (!Plain && !it.w) {
    if constexpr (Sub) {
      built_rows([&](int64_t r, int node) { add_rows(r, r >= 0 ? node : -1); });
    } else {
      for (int64_t base = r0 + (threadIdx.x & ~31); base < r1;
           base += blockDim.x) {
        const int64_t r = base + lane;
        const int nd = r < r1 ? __ldg(a.rel + r) : -1;
        add_rows(r, nd >= n0 && nd < n1 ? nd - n0 : -1);
      }
    }
  }
  const bool spilled = __syncthreads_or(spill);

  // a slot's column: in a plain group slot s is code s % B of feature
  // f0 + s / B, so f0 * B + s; else its key
  const int64_t node_stride = static_cast<int64_t>(a.F) * a.B;
  const int64_t plain_base =
      it.w ? static_cast<int64_t>(Plain ? gp.x : s_mem[0].x) * a.B : -1;
  auto column = [&](int i) -> int64_t {
    return plain_base >= 0 ? plain_base + i % S : a.slot_key[gp.w + i % S];
  };
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const long long g = hist_fixed::plane_value(s_hist, size, i);
    const long long h = hist_fixed::plane_value(s_hist + 2 * size, size, i);
    if (!(g | h)) continue;
    const int64_t o = node_of(n0 + i / S) * node_stride + column(i);
    if (g) atomicAdd(a.acc + 2 * o, static_cast<unsigned long long>(g));
    if (h) atomicAdd(a.acc + 2 * o + 1, static_cast<unsigned long long>(h));
  }
  if (a.out == nullptr) return;  // the same for every block

  if (spilled && threadIdx.x == 0) {
    atomicOr(a.tickets + 2 + a.n_items + item, 1u);
    atomicOr(a.tickets + 1, 1u);
  }
  const unsigned chunks = gridDim.x / a.n_items;
  if (hist_fixed::last_of(a.tickets + 2 + item, chunks, s_flag)) {
    // node (or pair) nd's column col: the built node's output, and under
    // Sub its sibling's sums and output from the parent's, in int64
    // modulo 2^64, which is the sibling's own sum (its adds wrap alike)
    auto finish = [&](int nd, int64_t col) {
      const int64_t built = node_of(nd);
      const int64_t o = built * node_stride + col;
      const long long g = hist_fixed::acc_at(a.acc, 2 * o);
      const long long h = hist_fixed::acc_at(a.acc, 2 * o + 1);
      a.out[2 * o] = hist_fixed::dequantize_one(g, sg);
      a.out[2 * o + 1] = hist_fixed::dequantize_one(h, sh);
      if constexpr (Sub) {
        const int64_t q = nd * node_stride + col;
        const int64_t os = (built ^ 1) * node_stride + col;
        const unsigned long long gs =
            __ldg(a.parent + 2 * q) - static_cast<unsigned long long>(g);
        const unsigned long long hs =
            __ldg(a.parent + 2 * q + 1) - static_cast<unsigned long long>(h);
        a.acc[2 * os] = gs;
        a.acc[2 * os + 1] = hs;
        a.out[2 * os] =
            hist_fixed::dequantize_one(static_cast<long long>(gs), sg);
        a.out[2 * os + 1] =
            hist_fixed::dequantize_one(static_cast<long long>(hs), sh);
      }
    };
    const bool whole = __ldcg(a.tickets + 2 + a.n_items + item) != 0u ||
                       !hist_fixed::lane_ok(sg) || !hist_fixed::lane_ok(sh) ||
                       (Sub && __ldg(p_spill) != 0u);
    if (whole) {  // every output of the item, slotted or not
      const int64_t n = static_cast<int64_t>(n1 - n0) * nm * a.B;
      for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
        const int b = static_cast<int>(i % a.B);
        const int j = static_cast<int>((i / a.B) % nm);
        const int nd = n0 + static_cast<int>(i / (static_cast<int64_t>(a.B) * nm));
        finish(nd, static_cast<int64_t>(Plain ? gp.x + j : s_mem[j].x) * a.B +
                       b);
      }
    } else {  // the slots; the prologue zeroed every other output
      for (int i = threadIdx.x; i < size; i += blockDim.x)
        finish(n0 + i / S, column(i));
    }
  }
  if (hist_fixed::last_of(a.tickets, gridDim.x, s_flag + 1)) {
    hist_fixed::poison_marked(over, nullptr, false, a.out, a.n_out);
    if constexpr (Sub) {  // the rows this level added; counts zeroed again
      unsigned long long n = 0;
      for (int p = threadIdx.x; p < a.n_nodes; p += blockDim.x) {
        const int2 k = __ldcg(a.counts + p);
        n += static_cast<unsigned long long>(k.y < k.x ? k.y : k.x);
        a.counts[p] = make_int2(0, 0);
      }
      if (n && a.built != nullptr) atomicAdd(a.built, n);
    }
  }
}

struct Launch {
  int code_bytes;
  int64_t n_chunks;
  int threads;
  int smem;
  int n_partial;  // prologue blocks (each writes its maxima with out)
  bool plain;     // every item plain, tiles uniform: hist_dense<..., true, .>
  bool sub;       // a subtracted level: hist_dense<..., true>
};

using Kernel = void (*)(const Dense);

template <typename Code, bool Plain, bool Sub>
Kernel pick(bool two) {
  return two ? hist_dense<Code, 2, Plain, Sub> : hist_dense<Code, 1, Plain, Sub>;
}

template <typename Code>
Kernel pick(bool two, bool plain, bool sub) {
  return plain ? (sub ? pick<Code, true, true>(two)
                      : pick<Code, true, false>(two))
               : (sub ? pick<Code, false, true>(two)
                      : pick<Code, false, false>(two));
}

cudaError_t run(Dense& a, const Launch& l, unsigned* partial,
                cudaStream_t s) {
  if ((l.code_bytes != 1 && l.code_bytes != 4) || a.n_items < 1 ||
      a.chunk < 1 || l.n_chunks < 0 || a.rows < 0 || a.qmax < 1 ||
      l.threads < 32 || l.threads > 1024 || l.threads % 32 || l.smem < 0 ||
      l.n_chunks * a.n_items > 0x7fffffff ||
      (a.out != nullptr) == (a.sc.scale != nullptr) ||
      (l.sub && (a.out == nullptr || a.parent == nullptr)))
    return cudaErrorInvalidValue;
  const int64_t n_tickets = a.out ? (2 * a.n_items + 2) / 2 : 0;
  // the sums, marks, the children's counts and the tickets
  const int64_t n_zero = a.tickets ? reinterpret_cast<unsigned long long*>(
                                         a.tickets) - a.acc + n_tickets
                                   : a.n_out + 2;
  cudaError_t err = hist_fixed::launch_prologue(
      a.out ? a.gh : nullptr, a.rows, partial, l.n_partial, a.acc, n_zero,
      a.out, a.out ? a.n_out : 0, s, l.sub ? a.rel : nullptr,
      reinterpret_cast<int*>(a.counts), 2 * a.n_nodes);
  // no rows: every sum is 0, a subtracted level's parent's too
  if (err != cudaSuccess || a.rows == 0 || a.n_out == 0) return err;
  const bool two = l.smem <= kTwoBlocksSmem;
  const Kernel kernel = l.code_bytes == 1
                            ? pick<uint8_t>(two, l.plain, l.sub)
                            : pick<int32_t>(two, l.plain, l.sub);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             l.smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(l.n_chunks * a.n_items), l.threads, l.smem,
           s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One histogram call (out != null) or the accumulate half of a sharded one
// (out == null).  bins: uint8 (code_bytes == 1) or int32 (== 4) [rows, F]
// row-major; rel: int32 [rows]; gh: f32 [rows, 2], 8-byte aligned.  The
// geometry (ops/histogram.py): items int4 [n_items] (group, n0, n1, 1 for a
// plain group: consecutive features, every bin used, none few-bin),
// groups int4 (first member, at most 16 members, slots a node, first slot
// key), members int4 (feature, slot offset, flags: 1 few-bin, 2 identity
// slots; used bins), lists int4 a member (a few-bin member's used codes as
// 8 int16, -1 past them), slot int16 [F * B], slot_key int32 (f * B + code
// of each group slot); a few-bin member of at most reduce_keys (node,
// slot) keys in its item pre-reduces; plain_groups > 0: every item is
// plain, group item % plain_groups of feat_group features from feature
// group * feat_group, node tile item / plain_groups of node_tile nodes
// (the tables are then not read); n_chunks row chunks of `chunk` rows,
// `threads` a block, `smem` bytes of shared memory (16 * the largest
// item's nodes x slots).  n_partial: the prologue's blocks.  scratch:
// int64 [n_out + 2 (+ (2 * n_items + 2) / 2 + n_partial with out)], n_out
// = n_nodes * F * B * 2: the sums, each lane's overflow mark, then the
// tickets (with out: the launch's ticket, its spill flag, the items'
// tickets and marks as uint32) and the prologue's maxima; the launch
// zeroes what it needs.  With out: the scale is fixed_point_scale(max
// |gh|, rows), found inside the launch and written to scale_out (f32
// [2]), and out (f32 [n_out]) is written whole.  Without: the caller's
// f32 [2] scale and value limit qmax, and scratch[0, n_out + 2) is left
// undequantized, so that the accumulators of several processes can be
// summed before one dmlc_histogram_gh_dequantize.  With out, scratch
// also holds, after the marks, n_nodes words the next level counts its
// nodes' rows in (zeroed here), and the tickets follow them.  parent
// (with out only; else null): a subtracted level, n_nodes even; parent
// the scratch of the previous level's one-process call on the same gh,
// rows and layout (n_nodes / 2 nodes, where each row's node was rel / 2):
// the prologue counts each node's rows in it, the child of each pair with
// fewer rows is built (the left on a tie), the other child's rows add
// nothing and its sums are the parent's less the built child's; the
// geometry (items, node tiles) is then over the n_nodes / 2 pairs, the
// block holds 8 KB more static shared memory (each warp's row queue),
// and scratch ends as the full level's; built (uint64 [1], or null)
// gains the rows the level added.  Two launches on `stream` (the prologue
// of hist_fixed.cuh, then the histogram), no synchronisation; returns the
// first CUDA error (0 on success).
int dmlc_histogram_gh_run(const void* bins, int code_bytes, const void* rel,
                          const void* gh, long long rows, int num_features,
                          int num_bins, int n_nodes, const void* items,
                          int n_items, const void* groups,
                          const void* members, const void* lists,
                          const void* slot, const void* slot_key,
                          int reduce_keys, int plain_groups, int feat_group,
                          int node_tile, long long chunk,
                          long long n_chunks, int threads, int smem,
                          int n_partial, const void* scale, void* scale_out,
                          long long qmax, void* scratch, void* out,
                          const void* parent, void* built,
                          void* stream) {
  Dense a;
  a.bins = bins;
  a.rel = static_cast<const int*>(rel);
  a.gh = static_cast<const float2*>(gh);
  a.qmax = qmax;
  a.acc = static_cast<unsigned long long*>(scratch);
  a.n_out = static_cast<int64_t>(n_nodes) * num_features * num_bins * 2;
  a.out = static_cast<float*>(out);
  const int64_t n_tickets = out ? (2 * static_cast<int64_t>(n_items) + 2) / 2
                                : 0;
  a.tickets = out ? reinterpret_cast<unsigned*>(a.acc + a.n_out + 2 + n_nodes)
                  : nullptr;
  unsigned* partial = reinterpret_cast<unsigned*>(
      a.acc + a.n_out + 2 + (out ? n_nodes + n_tickets : 0));
  a.sc.scale = static_cast<const float*>(scale);
  a.sc.amax = nullptr;
  a.sc.partial = partial;
  a.sc.n_partial = out ? n_partial : 0;
  a.sc.n = rows;
  a.sc.scale_out = static_cast<float*>(scale_out);
  a.rows = rows;
  a.chunk = chunk;
  a.F = num_features;
  a.B = num_bins;
  a.n_items = n_items;
  a.items = static_cast<const int4*>(items);
  a.groups = static_cast<const int4*>(groups);
  a.members = static_cast<const int4*>(members);
  a.lists = static_cast<const int4*>(lists);
  a.reduce_keys = reduce_keys;
  a.n_groups = plain_groups;
  a.feat_group = feat_group;
  a.node_tile = node_tile;
  const bool sub = parent != nullptr;
  a.n_nodes = sub ? n_nodes / 2 : n_nodes;  // the nodes the items tile
  a.slot = static_cast<const short*>(slot);
  a.slot_key = static_cast<const int*>(slot_key);
  a.parent = static_cast<const unsigned long long*>(parent);
  // this level's row counts in the parent's scratch, after its sums and
  // marks (its n_out is this level's / 2)
  a.counts = sub ? reinterpret_cast<int2*>(const_cast<unsigned long long*>(
                       a.parent + a.n_out / 2 + 2))
                 : nullptr;
  a.built = static_cast<unsigned long long*>(built);
  if ((plain_groups > 0 &&
       (feat_group < 1 || node_tile < 1 ||
        plain_groups * ((a.n_nodes + node_tile - 1) / node_tile) != n_items))
      || (sub && n_nodes % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l{code_bytes, n_chunks, threads, smem, n_partial,
           plain_groups > 0, sub};
  return static_cast<int>(run(a, l, partial, static_cast<cudaStream_t>(stream)));
}

// The dequantize half: out: f32 [n_out] (n_nodes * F * num_bins * 2 for a
// histogram), out[i] = f32(acc[i] / scale[i % lanes]), NaN for a lane whose
// scale is unusable or whose mark acc[n_out + lane] is nonzero.
int dmlc_histogram_gh_dequantize(const void* acc, const void* scale,
                                 void* out, long long n_out, int lanes,
                                 void* stream) {
  return static_cast<int>(hist_fixed::launch_dequantize(
      acc, scale, out, n_out, lanes, static_cast<cudaStream_t>(stream)));
}

const char* dmlc_histogram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
