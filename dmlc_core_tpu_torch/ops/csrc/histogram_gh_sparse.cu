// Sparse (COO) GBDT gradient histogram for Hopper (sm_90a):
//   out[n, f, b, :] = sum of gh_e[k, :] over feature-sorted entries k with
//                     rel_e[k] == n and gkey[k] == f * nb + b.
//
// Replaces the Pallas TPU kernel `_sparse_hist_kernel`
// (dmlc_core_tpu/ops/pallas_segment.py, launched from
// `_histogram_gh_sparse_pallas`), which computes the same histogram as a
// one-hot contraction on the MXU, key tile by key tile, over the entry blocks
// a scalar-prefetched span table names.  Contract kept from it:
//   * f32 (grad, hess) inputs and f32 results, no TF32; the sums are carried
//     in f64 inside a block (see "Accuracy");
//   * any num_bins >= 1 and n_nodes >= 1; entries whose node id or bin lies
//     out of range add nothing; a bin no entry names (bin 0 of missing-aware
//     codes) stays exactly 0;
//   * bitwise the same result from launch to launch: no float atomics.
//
// Layout.  The entries arrive sorted by feature (stable, so within a feature
// in input order): gkey int32 [nnz] = f * nb + bin, rel_e int32 [nnz] (each
// entry's node at this level), gh_e float2 [nnz].  The wrapper cuts every
// feature's entries into spans of at most `span` entries and passes a table:
// span begin / end / feature, and per feature the range of its spans.
//
// Design (simple first).  A warp owns one span (so one feature) and a private
// shared-memory histogram of `node_tile` nodes x num_bins bins x (g, h) in
// f64; a block holds `warps` such warps.  The node tile is as large as leaves
// at least three warps on an SM (16 nodes, 64 KB a warp, at 256 bins), so
// depths 0-4 take one pass over the entries and depth 5 two.  The warp walks
// its span 32 entries a step, four steps loaded ahead to hide memory latency.
// Lanes with equal (node, bin) keys are grouped with __match_any_sync and
// added rank by rank with a __syncwarp between ranks, so every bin sums its
// entries in entry order.  Each span writes its histogram to a partial
// [n_spans, n_nodes, B, 2]; a second kernel folds each feature's partials in
// span order into the output, in f64.
//
// Accuracy.  A span holds up to ~60k entries of one feature, and a bin's
// running sum in it adds hundreds to thousands of near-equal hessians, whose
// f32 rounding errors line up: with f32 sums the kernel sat at 1.0x the
// float64 check's tolerance (1e-5 of the largest bin) at Bosch width, and a
// value tied across many rows would go past it.  f64 sums rounded to f32
// once per span keep every bin within a few f32 ulps.
//
// What bounds it.  The function must read 16 bytes an entry (gkey, rel_e,
// gh_e) and write 8 * n * F * B bytes: about 1.0 ms at 3.35 TB/s for Bosch
// width (2.2e8 entries).  Each warp step costs a match, a reduction and as
// many shared-memory passes as its largest key group, and at 16 nodes only
// three warps fit on an SM, so it is bound by instruction issue and latency,
// not by device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 4;  // spans (warps) per block
constexpr int kAhead = 4;     // warp steps loaded before they are added

__global__ void __launch_bounds__(kMaxWarps * kWarp)
sparse_hist_partial(const int* __restrict__ gkey, const int* __restrict__ rel_e,
                    const float2* __restrict__ gh_e,
                    const long long* __restrict__ span_begin,
                    const long long* __restrict__ span_end,
                    const long long* __restrict__ span_feat,
                    float2* __restrict__ partials, long long n_spans,
                    int num_bins, int nb, int n_nodes, int node_tile) {
  extern __shared__ double2 s_hist[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long span =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  // no block-wide barrier follows, so a warp without a span leaves at once
  if (span >= n_spans) return;
  const int n0 = blockIdx.y * node_tile;
  const int keys = node_tile * num_bins;
  double2* h = s_hist + static_cast<int64_t>(warp) * keys;
  for (int k = lane; k < keys; k += kWarp) h[k] = make_double2(0.0, 0.0);
  __syncwarp();

  const int64_t e0 = span_begin[span];
  const int64_t e1 = span_end[span];
  const int key0 = static_cast<int>(span_feat[span]) * nb;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t base = e0; base < e1; base += kWarp * kAhead) {
    int key[kAhead];
    float2 v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t e = base + u * kWarp + lane;
      key[u] = -1;
      v[u] = make_float2(0.0f, 0.0f);
      if (e < e1) {
        const int node = rel_e[e] - n0;
        const int bin = gkey[e] - key0;
        v[u] = gh_e[e];
        if (node >= 0 && node < node_tile && bin >= 0 && bin < num_bins)
          key[u] = node * num_bins + bin;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (!__any_sync(0xffffffffu, key[u] >= 0)) continue;
      const unsigned same = __match_any_sync(0xffffffffu, key[u]);
      const int rank = key[u] >= 0 ? __popc(same & below) : 0;
      const int last = __reduce_max_sync(0xffffffffu, rank);
      for (int r = 0; r <= last; ++r) {
        if (key[u] >= 0 && rank == r) {
          double2 a = h[key[u]];
          a.x += v[u].x;
          a.y += v[u].y;
          h[key[u]] = a;
        }
        __syncwarp();
      }
    }
  }

  // this span's slice of the node tile; nodes of the last tile past n_nodes
  // are dropped
  float2* out = partials + span * n_nodes * num_bins;
  for (int k = lane; k < keys; k += kWarp) {
    const int node = n0 + k / num_bins;
    if (node >= n_nodes) break;
    out[static_cast<int64_t>(node) * num_bins + k % num_bins] = make_float2(
        static_cast<float>(h[k].x), static_cast<float>(h[k].y));
  }
}

// out[n, f, b, lane] = sum over feature f's spans, in span order, of
// partials[span, n, b, lane]; a feature without entries gets 0
__global__ void __launch_bounds__(256)
sparse_hist_fold(const float* __restrict__ partials,
                 const long long* __restrict__ feat_spans,
                 float* __restrict__ out, int num_features, int num_bins,
                 int n_nodes) {
  const int64_t n_out =
      static_cast<int64_t>(n_nodes) * num_features * num_bins * 2;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (o >= n_out) return;
  const int lane = static_cast<int>(o & 1);
  int64_t t = o >> 1;
  const int b = static_cast<int>(t % num_bins);
  t /= num_bins;
  const int f = static_cast<int>(t % num_features);
  const int64_t n = t / num_features;
  const int64_t per_span = static_cast<int64_t>(n_nodes) * num_bins * 2;
  const int64_t inner = (n * num_bins + b) * 2 + lane;
  double s = 0.0;
  for (long long sp = feat_spans[f]; sp < feat_spans[f + 1]; ++sp)
    s += partials[sp * per_span + inner];
  out[o] = static_cast<float>(s);
}

}  // namespace

extern "C" {

// gkey, rel_e: int32 [nnz]; gh_e: f32 [nnz, 2], 8-byte aligned; table: int64
// [3 * n_spans + num_features + 1] = span begin, span end, span feature (each
// n_spans long), then the prefix count of spans per feature; partials: f32
// [n_spans, n_nodes, num_bins, 2]; out: f32 [n_nodes, num_features, num_bins,
// 2].  `warps` spans share a block (1..4) and `node_tile` nodes a pass over
// the entries; a block takes warps * node_tile * num_bins * 16 bytes of
// shared memory.  Launches on `stream`, does not synchronise, and returns the
// first CUDA error (0 on success).
int dmlc_histogram_gh_sparse_f32(const void* gkey, const void* rel_e,
                                 const void* gh_e, const void* table,
                                 long long n_spans, int num_features,
                                 int num_bins, int nb, int n_nodes, int warps,
                                 int node_tile, void* partials, void* out,
                                 void* stream) {
  const int64_t n_out =
      static_cast<int64_t>(n_nodes) * num_features * num_bins * 2;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  if (n_spans < 1 || warps < 1 || warps > kMaxWarps || node_tile < 1 ||
      nb < num_bins)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* tab = static_cast<const long long*>(table);
  const size_t smem = sizeof(double2) * static_cast<size_t>(warps) *
                      node_tile * num_bins;
  cudaError_t err = cudaFuncSetAttribute(
      sparse_hist_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_blocks = (n_spans + warps - 1) / warps;
  const int n_tiles = (n_nodes + node_tile - 1) / node_tile;
  sparse_hist_partial<<<dim3(static_cast<unsigned>(n_blocks), n_tiles),
                        warps * kWarp, smem, s>>>(
      static_cast<const int*>(gkey), static_cast<const int*>(rel_e),
      static_cast<const float2*>(gh_e), tab, tab + n_spans,
      tab + 2 * n_spans, static_cast<float2*>(partials), n_spans, num_bins,
      nb, n_nodes, node_tile);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned gx = static_cast<unsigned>((n_out + 255) / 256);
  sparse_hist_fold<<<gx, 256, 0, s>>>(static_cast<const float*>(partials),
                                      tab + 3 * n_spans,
                                      static_cast<float*>(out), num_features,
                                      num_bins, n_nodes);
  return static_cast<int>(cudaGetLastError());
}

const char* dmlc_histogram_sparse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
