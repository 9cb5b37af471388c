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
// feature's entries into spans and passes a table: span begin / end /
// feature.
//
// What bounds it.  The function must read 16 bytes an entry (gkey, rel_e,
// gh_e) and write 8 * n * F * B bytes: about 1.05 ms at 3.35 TB/s for Bosch
// width (2.2e8 entries).  Device memory bounds it: it runs at 1.2-1.4x that
// bound at every depth on an H100 80GB HBM3 (chip_smoke's per-level lines),
// its one shared-memory add of two int64 (four 32-bit atomics) per entry
// close behind.  Many entries tied in one bin serialise those atomics; a
// warp pre-reduction of equal keys measured slower on the main path's
// shapes and was not kept (PERF.md).
//
// Design.  A block owns one span (so one feature) and ONE shared histogram
// of node_tile nodes x num_bins bins, which all its warps add into with
// integer atomics; the wrapper makes the node tile every node of the level
// while it fits (56 nodes at 256 bins, so every depth of a depth-6 tree
// takes one pass over the entries).  Each thread loads four entries at a
// time with 16-byte loads where the span allows.  The block then adds its
// nonzero bins into one zeroed int64 [n, F, B, 2] buffer with global 64-bit
// integer atomics, and a last pass rounds that buffer to f32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_fixed.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void add_entry(unsigned* s, int size, int gkey,
                                          int node, float2 v, int key0,
                                          int n0, int n1, int num_bins,
                                          float sg, float sh, long long qmax,
                                          unsigned long long* over) {
  const int bin = gkey - key0;
  if (node < n0 || node >= n1 || bin < 0 || bin >= num_bins) return;
  hist_fixed::add(s, size, (node - n0) * num_bins + bin,
                  hist_fixed::quantize(v.x, sg, qmax, over),
                  hist_fixed::quantize(v.y, sh, qmax, over + 1));
}

__global__ void __launch_bounds__(kThreads)
hist_sparse(const int* __restrict__ gkey, const int* __restrict__ rel_e,
            const float2* __restrict__ gh_e, const float* __restrict__ scale,
            long long qmax, const long long* __restrict__ span_begin,
            const long long* __restrict__ span_end,
            const long long* __restrict__ span_feat,
            unsigned long long* __restrict__ acc,
            unsigned long long* __restrict__ over, int64_t nnz,
            int num_features, int num_bins, int nb, int n_nodes,
            int node_tile, int vec) {
  extern __shared__ unsigned s_hist[];
  const int size = node_tile * num_bins;
  for (int i = threadIdx.x; i < 4 * size; i += blockDim.x) s_hist[i] = 0u;
  const int64_t e0 = span_begin[blockIdx.x];
  const int64_t e1 = span_end[blockIdx.x];
  const int f = static_cast<int>(span_feat[blockIdx.x]);
  const int key0 = f * nb;
  const int n0 = blockIdx.y * node_tile;
  const int n1 = n0 + node_tile < n_nodes ? n0 + node_tile : n_nodes;
  const float sg = scale[0], sh = scale[1];
  __syncthreads();

  // quads of entries at 4-aligned indices wholly inside the array, read
  // with 16-byte loads; entries of the first and last quad outside [e0,
  // e1) are masked.  The rest (all of it without `vec`) one entry a lane.
  int64_t t0 = e0;
  if (vec) {
    const int64_t q0 = e0 >> 2;
    const int64_t q_end = (e1 + 3) >> 2;
    const int64_t q1 = q_end < (nnz >> 2) ? q_end : (nnz >> 2);
    t0 = 4 * q1 > e0 ? 4 * q1 : e0;
    const int4* g4 = reinterpret_cast<const int4*>(gkey);
    const int4* r4 = reinterpret_cast<const int4*>(rel_e);
    const float4* v4 = reinterpret_cast<const float4*>(gh_e);
    for (int64_t q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
      const int4 g = g4[q];
      int4 r = r4[q];
      const float4 va = v4[2 * q], vb = v4[2 * q + 1];
      const int64_t e = 4 * q;
      if (e < e0 || e >= e1) r.x = -1;
      if (e + 1 < e0 || e + 1 >= e1) r.y = -1;
      if (e + 2 < e0 || e + 2 >= e1) r.z = -1;
      if (e + 3 < e0 || e + 3 >= e1) r.w = -1;
      add_entry(s_hist, size, g.x, r.x, make_float2(va.x, va.y), key0, n0,
                n1, num_bins, sg, sh, qmax, over);
      add_entry(s_hist, size, g.y, r.y, make_float2(va.z, va.w), key0, n0,
                n1, num_bins, sg, sh, qmax, over);
      add_entry(s_hist, size, g.z, r.z, make_float2(vb.x, vb.y), key0, n0,
                n1, num_bins, sg, sh, qmax, over);
      add_entry(s_hist, size, g.w, r.w, make_float2(vb.z, vb.w), key0, n0,
                n1, num_bins, sg, sh, qmax, over);
    }
  }
  for (int64_t e = t0 + threadIdx.x; e < e1; e += blockDim.x)
    add_entry(s_hist, size, gkey[e], rel_e[e], gh_e[e], key0, n0, n1,
              num_bins, sg, sh, qmax, over);
  __syncthreads();

  hist_fixed::flush(s_hist, size, acc, [=](int i) -> int64_t {
    const int node = n0 + i / num_bins;
    if (node >= n1) return -1;
    return (static_cast<int64_t>(node) * num_features + f) * num_bins +
           i % num_bins;
  });
}

// The accumulate half: adds every span's entries into the int64
// accumulator `acc` (the bins, then each lane's overflow mark), which the
// caller zeroed.
cudaError_t accumulate(const void* gkey, const void* rel_e, const void* gh_e,
                       long long nnz, int vec, const float* scale,
                       long long qmax, const void* table, long long n_spans,
                       int num_features, int num_bins, int nb, int n_nodes,
                       int node_tile, unsigned long long* acc,
                       int64_t n_out, cudaStream_t s) {
  if (n_spans < 0 || n_spans > 0x7fffffff || node_tile < 1 || nb < num_bins ||
      qmax < 1)
    return cudaErrorInvalidValue;
  if (n_spans == 0 || n_out == 0) return cudaSuccess;
  const long long* tab = static_cast<const long long*>(table);
  const size_t smem = 16 * static_cast<size_t>(node_tile) * num_bins;
  cudaError_t err = cudaFuncSetAttribute(
      hist_sparse, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_nodes + node_tile - 1) / node_tile;
  hist_sparse<<<dim3(static_cast<unsigned>(n_spans), n_tiles), kThreads,
                smem, s>>>(static_cast<const int*>(gkey),
                           static_cast<const int*>(rel_e),
                           static_cast<const float2*>(gh_e), scale, qmax, tab,
                           tab + n_spans, tab + 2 * n_spans, acc, acc + n_out,
                           nnz, num_features, num_bins, nb, n_nodes,
                           node_tile, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The accumulate half: gkey, rel_e: int32 [nnz]; gh_e: f32 [nnz, 2],
// 8-byte aligned; vec != 0 when all three are 16-byte aligned (then 16-byte
// loads); scale: f32 [2] on the card (2^k of each lane) and qmax its value
// limit (see hist_fixed.cuh), made from this launch's entries or from every
// process's; table: int64 [3 * n_spans] = span begin, span end, span
// feature; acc: int64 [n_nodes * num_features * num_bins * 2 + 2] (the
// bins, then each lane's overflow mark), zeroed by the caller and left
// undequantized, so that the accumulators of several processes can be
// summed before one dmlc_histogram_gh_sparse_dequantize.  A block takes one
// span and `node_tile` nodes, and 16 * node_tile * num_bins bytes of shared
// memory.  Launches on `stream`, does not synchronise, and returns the
// first CUDA error (0 on success).
int dmlc_histogram_gh_sparse_accumulate(
    const void* gkey, const void* rel_e, const void* gh_e, long long nnz,
    int vec, const void* scale, long long qmax, const void* table,
    long long n_spans, int num_features, int num_bins, int nb, int n_nodes,
    int node_tile, void* acc, void* stream) {
  const int64_t n_out =
      static_cast<int64_t>(n_nodes) * num_features * num_bins * 2;
  return static_cast<int>(accumulate(
      gkey, rel_e, gh_e, nnz, vec, static_cast<const float*>(scale), qmax,
      table, n_spans, num_features, num_bins, nb, n_nodes, node_tile,
      static_cast<unsigned long long*>(acc), n_out,
      static_cast<cudaStream_t>(stream)));
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
