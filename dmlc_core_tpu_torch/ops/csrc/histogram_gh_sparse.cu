// Sparse (COO) GBDT gradient histogram for Hopper (sm_90a):
//   out[n, f, b, :] = sum of gh_e[k, :] over feature-sorted entries k with
//                     rel_e[k] == n and gkey[k] == f * nb + b.
//
// Replaces the Pallas TPU kernel `_sparse_hist_kernel`
// (dmlc_core_tpu/ops/pallas_segment.py, launched from
// `_histogram_gh_sparse_pallas`), which computes the same histogram as a
// one-hot contraction on the MXU, key tile by key tile, over the entry blocks
// a scalar-prefetched span table names.  Contract kept from it:
//   * f32 (grad, hess) inputs and f32 results, no TF32 or bf16;
//   * any num_bins >= 1 and n_nodes >= 1; entries whose node id or bin lies
//     out of range add nothing; a bin no entry names (bin 0 of missing-aware
//     codes) stays exactly 0;
//   * bitwise the same result from launch to launch: no float atomics.
//
// Numerics (hist_fixed.cuh).  Each (grad, hess) value is rounded once to a
// 64-bit fixed-point integer with one scale per lane and launch, and every
// sum is an int64 add, exact and so the same in any order.  With n = the
// most entries of one feature (no bin receives more), a bin of m entries
// ends at most m * n * amax * 2^-62 from its exact sum (amax bounds |value|
// of the lane) before its one rounding to f32.  A NaN or Inf in a lane
// makes that lane NaN everywhere, and so does a value past the caller's
// amax where it could carry a bin past int64 (hist_fixed.cuh's qmax).
//
// Layout.  The entries arrive sorted by feature (stable, so within a feature
// in input order): gkey int32 [nnz] = f * nb + bin, rel_e int32 [nnz] (each
// entry's node at this level), gh_e float2 [nnz].  The wrapper cuts every
// feature's entries into spans (a feature with no entries gets one empty
// span) and passes a table: span begin / end / feature / spans of that
// feature; and the layout's once-a-fit count of each feature's used bins,
// from which a block decides to pre-reduce equal keys (few keys).
//
// What bounds it.  The function must read 16 bytes an entry (gkey, rel_e,
// gh_e) and write 8 * n * F * B bytes: about 1.05 ms at 3.35 TB/s for Bosch
// width (2.2e8 entries).  Device memory bounds it there: 1.2-1.4x that
// bound at every depth on an H100 80GB HBM3 (chip_smoke's per-level lines),
// its one shared-memory add of two int64 (four 32-bit atomics) per entry
// close behind.  At the small shapes of the examples (114,280 entries) the
// bound is under a microsecond and the cost is fixed: launches, zeroing,
// the scale.
//
// Design.  One call is at most two launches, the prologue of hist_fixed.cuh
// and the accumulate, which also dequantizes (a cooperative launch costs
// ~9 us however small the work, more than the small shapes' whole
// budget).  The prologue zeroes the int64 accumulator, its marks and
// tickets (a memset when that is all), and, when the caller gives no bound
// on |gh|, writes each of its blocks' max |g|, |h| of the entries; every
// accumulate block reduces those (or the caller's bound) to the scale
// itself, in double, as ops/fixed_point.py does, so the scale is
// fixed_point_scale(amax, n_max) bit for bit.  A call with the caller's
// bound and one span a feature (the examples' 114,280 entries) is one
// launch: no block adds into global memory, and the marks and the
// launch's ticket live in a small workspace kept zeroed on the stream.
// A block owns one span (so one feature) and ONE shared histogram of
// node_tile nodes x num_bins bins, which all its warps add into with
// integer atomics; the wrapper makes the node tile every node of the level
// while it fits (56 nodes at 256 bins, so every depth of a depth-6 tree
// takes one pass over the entries).  A span holds at least 4,096 entries
// and no fewer than the bins its block zeroes and flushes (the sweep of
// chip_smoke.py --geometry-sweep: at the examples' 114,280 entries one
// span a feature, 32 blocks, beats 264 spans of 433), else about two
// blocks an SM where the entries allow; Bosch width keeps the 1,024 spans
// of at least 16,384 it was tuned at; a block's threads follow its span
// (128 to 1024).  Each warp loads four entries a lane with 16-byte loads
// where the span allows.  Where a feature has at most 2 (node, bin) keys
// in the block the lanes of equal key are summed first
// (hist_fixed::add_reduced, compiled in only when some feature can) and
// add once; with more keys the match costs more than it saves (4x at 63
// keys, the sweep), as a warp pre-reduction measured on many-bin
// features before.  The
// block adds its nonzero bins into one int64 [n, F, B, 2] buffer with
// global 64-bit integer atomics; the last block of a feature's spans (a
// ticket) rounds that feature's bins of its node tile to f32 (a feature of
// one span is rounded by its block from shared memory, with no global
// adds: the small launches of the examples), and the last
// block of the launch makes a lane NaN everywhere if a value reached the
// value limit.  The sharded route's accumulate entry runs the same body with
// the caller's scale and stops before the rounding.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_fixed.cuh"

namespace {

struct Sparse {
  const int* gkey;
  const int* rel_e;
  const float2* gh_e;
  int64_t nnz;
  int vec;                    // 1: all three arrays 16-byte aligned
  hist_fixed::Scale sc;
  long long qmax;
  const long long* table;     // [4 * n_spans]: begin, end, feature, spans of it
  int64_t n_spans;
  const int* used;            // [F] each feature's used bins, or null
  int reduce_keys;            // pre-reduce a feature of at most this many
                              // (node, bin) keys in the block
  unsigned long long* acc;    // [n_out] sums (null when every span is alone)
  int64_t n_out;
  unsigned long long* over;   // [2] each lane's overflow mark
  unsigned* tickets;          // [F * tiles] each region's tickets
  unsigned* launch_ticket;    // the launch's ticket
  int reset;                  // 1: zero the marks and launch ticket at the
                              // end (a kept workspace, no prologue)
  float* out;                 // [n_out], or null: accumulate only
  int F, B, nb, n_nodes, node_tile;
};

template <bool Reduce>
__device__ __forceinline__ void add_entry(unsigned* s, int size, int gkey,
                                          int node, float2 v, int key0,
                                          int n0, int n1, int num_bins,
                                          float sg, float sh, long long qmax,
                                          unsigned long long* over,
                                          bool reduce) {
  const int bin = gkey - key0;
  int key = -1;
  long long qg = 0, qh = 0;
  if (node >= n0 && node < n1 && bin >= 0 && bin < num_bins) {
    key = (node - n0) * num_bins + bin;
    qg = hist_fixed::quantize(v.x, sg, qmax, over);
    qh = hist_fixed::quantize(v.y, sh, qmax, over + 1);
  }
  if (Reduce && reduce)
    hist_fixed::add_reduced(s, size, key, qg, qh);
  else if (key >= 0)
    hist_fixed::add(s, size, key, qg, qh);
}

// Reduce: some feature of the launch may pre-reduce (the used-bin counts
// are given); without, no warp-wide instruction is in the loop
template <bool Reduce>
__global__ void __launch_bounds__(1024)
hist_sparse(const Sparse a) {
  extern __shared__ unsigned s_hist[];
  __shared__ float s_scale[2];
  __shared__ unsigned s_tmp[2];
  __shared__ int s_flag[2];
  const int size = a.node_tile * a.B;
  const int64_t e0 = a.table[blockIdx.x];
  const int64_t e1 = a.table[a.n_spans + blockIdx.x];
  const int f = static_cast<int>(a.table[2 * a.n_spans + blockIdx.x]);
  // spans of this feature (its region's tickets); read with the span
  const unsigned count =
      a.out != nullptr
          ? static_cast<unsigned>(a.table[3 * a.n_spans + blockIdx.x])
          : 0u;
  const int key0 = f * a.nb;
  const int n0 = blockIdx.y * a.node_tile;
  const int n1 = n0 + a.node_tile < a.n_nodes ? n0 + a.node_tile : a.n_nodes;
  const bool reduce = Reduce && a.used[f] * (n1 - n0) <= a.reduce_keys;
  hist_fixed::block_scale(a.sc, s_scale, s_tmp, [&] {  // ends with a barrier
    for (int i = threadIdx.x; i < 4 * size; i += blockDim.x) s_hist[i] = 0u;
  });
  const float sg = s_scale[0], sh = s_scale[1];
  unsigned long long* over = a.over;
  const int lane = threadIdx.x & 31;

  // quads of entries at 4-aligned indices wholly inside the array, read
  // with 16-byte loads; entries of the first and last quad outside [e0,
  // e1) are masked.  The rest (all of it without `vec`) one entry a lane.
  // A warp's lanes stay together (add_reduced).
  int64_t t0 = e0;
  if (a.vec) {
    const int64_t q0 = e0 >> 2;
    const int64_t q_end = (e1 + 3) >> 2;
    const int64_t q1 = q_end < (a.nnz >> 2) ? q_end : (a.nnz >> 2);
    t0 = 4 * q1 > e0 ? 4 * q1 : e0;
    const int4* g4 = reinterpret_cast<const int4*>(a.gkey);
    const int4* r4 = reinterpret_cast<const int4*>(a.rel_e);
    const float4* v4 = reinterpret_cast<const float4*>(a.gh_e);
    for (int64_t qb = q0 + (threadIdx.x & ~31); qb < q1; qb += blockDim.x) {
      const int64_t q = qb + lane;
      int4 g = make_int4(-1, -1, -1, -1), r = g;
      float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
      if (q < q1) {
        g = __ldg(g4 + q);
        r = __ldg(r4 + q);
        va = __ldg(v4 + 2 * q);
        vb = __ldg(v4 + 2 * q + 1);
        const int64_t e = 4 * q;
        if (e < e0 || e >= e1) r.x = -1;
        if (e + 1 < e0 || e + 1 >= e1) r.y = -1;
        if (e + 2 < e0 || e + 2 >= e1) r.z = -1;
        if (e + 3 < e0 || e + 3 >= e1) r.w = -1;
      }
      add_entry<Reduce>(s_hist, size, g.x, r.x, make_float2(va.x, va.y), key0, n0,
                n1, a.B, sg, sh, a.qmax, over, reduce);
      add_entry<Reduce>(s_hist, size, g.y, r.y, make_float2(va.z, va.w), key0, n0,
                n1, a.B, sg, sh, a.qmax, over, reduce);
      add_entry<Reduce>(s_hist, size, g.z, r.z, make_float2(vb.x, vb.y), key0, n0,
                n1, a.B, sg, sh, a.qmax, over, reduce);
      add_entry<Reduce>(s_hist, size, g.w, r.w, make_float2(vb.z, vb.w), key0, n0,
                n1, a.B, sg, sh, a.qmax, over, reduce);
    }
  }
  for (int64_t eb = t0 + (threadIdx.x & ~31); eb < e1; eb += blockDim.x) {
    const int64_t e = eb + lane;
    const bool ok = e < e1;
    add_entry<Reduce>(s_hist, size, ok ? __ldg(a.gkey + e) : -1,
              ok ? __ldg(a.rel_e + e) : -1,
              ok ? __ldg(a.gh_e + e) : make_float2(0.f, 0.f), key0, n0, n1,
              a.B, sg, sh, a.qmax, over, reduce);
  }
  __syncthreads();

  const int n = (n1 - n0) * a.B;
  if (count == 1) {
    // the feature's only span: round its bins straight from shared memory
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int64_t o = (static_cast<int64_t>(n0 + i / a.B) * a.F + f) * a.B +
                        i % a.B;
      a.out[2 * o] = hist_fixed::dequantize_one(
          hist_fixed::plane_value(s_hist, size, i), sg);
      a.out[2 * o + 1] = hist_fixed::dequantize_one(
          hist_fixed::plane_value(s_hist + 2 * size, size, i), sh);
    }
  } else {
    hist_fixed::flush(s_hist, size, a.acc, [=](int i) -> int64_t {
      const int node = n0 + i / a.B;
      if (node >= n1) return -1;
      return (static_cast<int64_t>(node) * a.F + f) * a.B + i % a.B;
    });
    if (a.out == nullptr) return;  // the same for every block
    const unsigned region = f * gridDim.y + blockIdx.y;
    if (hist_fixed::last_of(a.tickets + region, count, s_flag)) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int64_t o =
            (static_cast<int64_t>(n0 + i / a.B) * a.F + f) * a.B + i % a.B;
        a.out[2 * o] = hist_fixed::dequantize_one(
            hist_fixed::acc_at(a.acc, 2 * o), sg);
        a.out[2 * o + 1] = hist_fixed::dequantize_one(
            hist_fixed::acc_at(a.acc, 2 * o + 1), sh);
      }
    }
  }
  if (hist_fixed::last_of(a.launch_ticket, gridDim.x * gridDim.y,
                          s_flag + 1))
    hist_fixed::poison_marked(over, a.launch_ticket, a.reset, a.out, a.n_out);
}

}  // namespace

extern "C" {

// One histogram call (out != null) or the accumulate half of a sharded one
// (out == null).  gkey, rel_e: int32 [nnz]; gh_e: f32 [nnz, 2], 8-byte
// aligned; vec != 0 when all three are 16-byte aligned (then 16-byte
// loads); table: int64 [4 * n_spans] = span begin, span end, span feature,
// spans of that feature (every feature at least one); used: int32 [F]
// (each feature's used bins) or null, and a feature of at most
// reduce_keys (node, bin) keys in a block pre-reduces; a block takes one span,
// `node_tile` nodes, `threads` threads and 16 * node_tile * num_bins bytes
// of shared memory; the prologue takes n_partial blocks.  workspace:
// int64 [4] kept zeroed between launches on `stream`, or null: with it, an
// out, an amax and one span a feature, the call is one launch (no
// prologue; scratch unused), its marks and ticket in the workspace, which
// its last block zeroes again.  scratch: int64
// [n_out + 2 (+ (F * tiles + 2) / 2 + n_partial with out)], n_out =
// n_nodes * F * num_bins * 2: the sums, each lane's overflow mark, then the
// tickets and the prologue's maxima; the launch zeroes what it needs.  With
// out: the scale is fixed_point_scale(amax, n_max), amax the caller's f32
// [2] bound when given, else max |gh_e| found inside the launch, written to
// scale_out (f32 [2]), and out (f32 [n_out]) is written whole.  Without:
// the caller's f32 [2] scale and value limit qmax, and scratch[0, n_out +
// 2) is left undequantized, so that the accumulators of several processes
// can be summed before one dmlc_histogram_gh_sparse_dequantize.  Two
// launches on `stream`, no synchronisation; returns the first CUDA error (0
// on success).
int dmlc_histogram_gh_sparse_run(
    const void* gkey, const void* rel_e, const void* gh_e, long long nnz,
    int vec, const void* table, long long n_spans, const void* used,
    int reduce_keys, int num_features, int num_bins, int nb, int n_nodes, int node_tile,
    int threads, int n_partial, long long n_max, const void* amax,
    const void* scale, void* scale_out, long long qmax, void* scratch,
    void* workspace, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_spans < 1 || n_spans > 0x7fffffff || node_tile < 1 ||
      nb < num_bins || qmax < 1 || threads < 32 || threads > 1024 ||
      threads % 32 || n_partial < 1 || (out != nullptr) == (scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Sparse a;
  a.gkey = static_cast<const int*>(gkey);
  a.rel_e = static_cast<const int*>(rel_e);
  a.gh_e = static_cast<const float2*>(gh_e);
  a.nnz = nnz;
  a.vec = vec;
  a.qmax = qmax;
  a.table = static_cast<const long long*>(table);
  a.n_spans = n_spans;
  a.used = static_cast<const int*>(used);
  a.reduce_keys = reduce_keys;
  a.acc = static_cast<unsigned long long*>(scratch);
  a.n_out = static_cast<int64_t>(n_nodes) * num_features * num_bins * 2;
  a.out = static_cast<float*>(out);
  a.F = num_features;
  a.B = num_bins;
  a.nb = nb;
  a.n_nodes = n_nodes;
  a.node_tile = node_tile;
  const int tiles = (n_nodes + node_tile - 1) / node_tile;
  const int64_t n_tickets =
      out ? (static_cast<int64_t>(num_features) * tiles + 2) / 2 : 0;
  // every span alone and the caller's bound on |gh|: one launch, its marks
  // and ticket in the kept workspace
  const bool alone = workspace != nullptr && out != nullptr &&
                     amax != nullptr && n_spans == num_features;
  unsigned* partial = nullptr;
  if (alone) {
    a.acc = nullptr;
    a.over = static_cast<unsigned long long*>(workspace);
    a.tickets = nullptr;
    a.launch_ticket = reinterpret_cast<unsigned*>(a.over + 2);
    a.reset = 1;
  } else {
    a.over = a.acc + a.n_out;
    a.tickets = reinterpret_cast<unsigned*>(a.acc + a.n_out + 2);
    a.launch_ticket = a.tickets + static_cast<int64_t>(num_features) * tiles;
    a.reset = 0;
    partial = reinterpret_cast<unsigned*>(a.acc + a.n_out + 2 + n_tickets);
  }
  const bool own = out != nullptr && amax == nullptr;
  a.sc.scale = static_cast<const float*>(scale);
  a.sc.amax = static_cast<const float*>(amax);
  a.sc.partial = partial;
  a.sc.n_partial = own ? n_partial : 0;
  a.sc.n = n_max;
  a.sc.scale_out = static_cast<float*>(scale_out);
  if (a.n_out == 0) return 0;
  cudaError_t err = alone ? cudaSuccess : hist_fixed::launch_prologue(
      own ? gh_e : nullptr, nnz, partial, n_partial, a.acc,
      a.n_out + 2 + n_tickets, nullptr, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 16 * static_cast<size_t>(node_tile) * num_bins;
  auto kernel = used != nullptr ? hist_sparse<true> : hist_sparse<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(n_spans), tiles), threads, smem, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// The dequantize half: out: f32 [n_out] (n_nodes * F * num_bins * 2 for a
// histogram), out[i] = f32(acc[i] / scale[i % lanes]), NaN for a lane whose
// scale is unusable or whose mark acc[n_out + lane] is nonzero.
int dmlc_histogram_gh_sparse_dequantize(const void* acc, const void* scale,
                                        void* out, long long n_out, int lanes,
                                        void* stream) {
  return static_cast<int>(hist_fixed::launch_dequantize(
      acc, scale, out, n_out, lanes, static_cast<cudaStream_t>(stream)));
}

const char* dmlc_histogram_sparse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
