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
// A NaN or Inf in a lane makes that lane NaN everywhere.  Many rows in one
// bin (the missing bin of densified data) serialise its atomics; a warp
// pre-reduction of equal keys measured slower on the main path's shapes
// and was not kept (PERF.md).
//
// Layout.  The codes are read where they lie, as uint8 (or int32) [rows, F]
// row-major; gh as float2 [rows], rel as int32 [rows].
//
// What bounds it.  The function must read rows * F code bytes plus 12 bytes
// a row (rel, gh) and write 8 * n * F * B bytes: 0.131 ms at 3.35 TB/s for
// Higgs (11M rows x 28 features, 256 bins).  The work is one shared-memory
// add of two int64 (four 32-bit atomics) per (row, feature), 3.1e8 at
// Higgs, and it is bound by that atomic rate and by the rows each node tile
// and feature group reads again, not by bytes: 8-20x the byte bound on an
// H100 80GB HBM3 (chip_smoke's per-level lines).
//
// Design.  Block (chunk, node tile, feature group) holds ONE shared histogram
// of node_tile x feature_group (node, feature) pairs x num_bins bins, which all
// its warps add into with integer atomics.  The wrapper gives a block every
// node of the level in 14 (node, feature) pairs while that leaves more than 3
// features (14 and 7 at depths 0-1), and 3 features with as many nodes as fit
// deeper (16 nodes at 256 bins, so depth 5 takes two node tiles): each node
// tile scans every row, and each feature group re-reads rel and gh, so the
// fastest split (`python3 chip_smoke.py --geometry-sweep`) sits between the
// two.  A thread takes one row at a time, rounds its (g, h) once, and adds it
// to each feature of the group, reading the row's codes from L1 lines its warp
// fetched whole.  Blocks of one row chunk are adjacent in launch order, so a
// chunk's rows come from device memory once and from L2 for its other groups
// and tiles.  The block then adds its nonzero bins into one zeroed int64 [n, F,
// B, 2] buffer with global 64-bit integer atomics, and a last pass rounds that
// buffer to f32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_fixed.cuh"

namespace {

constexpr int kThreads = 1024;

template <typename Code>
__global__ void __launch_bounds__(kThreads)
hist_dense(const Code* __restrict__ bins, const int* __restrict__ rel,
           const float2* __restrict__ gh, const float* __restrict__ scale,
           long long qmax, unsigned long long* __restrict__ acc,
           unsigned long long* __restrict__ over, int64_t rows,
           int num_features, int num_bins, int n_nodes, int node_tile,
           int feat_group, int n_groups, int n_tiles, int64_t chunk) {
  extern __shared__ unsigned s_hist[];
  const int size = node_tile * feat_group * num_bins;
  for (int i = threadIdx.x; i < 4 * size; i += blockDim.x) s_hist[i] = 0u;

  // group fastest, then node tile, then row chunk
  const int group = blockIdx.x % n_groups;
  const int tile = (blockIdx.x / n_groups) % n_tiles;
  const int64_t c = blockIdx.x / (n_groups * n_tiles);
  const int f0 = group * feat_group;
  const int nf = feat_group < num_features - f0 ? feat_group
                                                 : num_features - f0;
  const int n0 = tile * node_tile;
  const int n1 = n0 + node_tile < n_nodes ? n0 + node_tile : n_nodes;
  const float sg = scale[0], sh = scale[1];
  const int64_t r0 = c * chunk;
  const int64_t r1 = r0 + chunk < rows ? r0 + chunk : rows;
  __syncthreads();

  for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int nd = rel[r];
    if (nd < n0 || nd >= n1) continue;
    const int node = nd - n0;
    const float2 v = gh[r];
    const long long qg = hist_fixed::quantize(v.x, sg, qmax, over);
    const long long qh = hist_fixed::quantize(v.y, sh, qmax, over + 1);
    const Code* row = bins + r * num_features + f0;
    for (int j = 0; j < nf; ++j) {
      const int code = static_cast<int>(row[j]);
      if (code >= 0 && code < num_bins)
        hist_fixed::add(s_hist, size,
                        (node * feat_group + j) * num_bins + code, qg, qh);
    }
  }
  __syncthreads();

  hist_fixed::flush(s_hist, size, acc, [=](int i) -> int64_t {
    const int b = i % num_bins;
    const int p = i / num_bins;
    const int j = p % feat_group;
    const int node = n0 + p / feat_group;
    if (j >= nf || node >= n1) return -1;
    return (static_cast<int64_t>(node) * num_features + f0 + j) * num_bins + b;
  });
}

template <typename Code>
cudaError_t launch(const void* bins, const void* rel, const void* gh,
                   const float* scale, long long qmax,
                   unsigned long long* acc, unsigned long long* over,
                   int64_t rows, int num_features, int num_bins, int n_nodes,
                   int node_tile, int feat_group, int64_t chunk,
                   cudaStream_t s) {
  const int n_groups = (num_features + feat_group - 1) / feat_group;
  const int n_tiles = (n_nodes + node_tile - 1) / node_tile;
  const int64_t n_chunks = (rows + chunk - 1) / chunk;
  const int64_t n_blocks = n_chunks * n_groups * n_tiles;
  if (n_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = 16 * static_cast<size_t>(node_tile) * feat_group *
                      num_bins;
  auto kernel = hist_dense<Code>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_blocks), kThreads, smem, s>>>(
      static_cast<const Code*>(bins), static_cast<const int*>(rel),
      static_cast<const float2*>(gh), scale, qmax, acc, over, rows,
      num_features, num_bins, n_nodes, node_tile, feat_group, n_groups,
      n_tiles, chunk);
  return cudaGetLastError();
}

// The accumulate half: adds every row into the int64 accumulator `acc`
// (the bins, then each lane's overflow mark), which the caller zeroed.
cudaError_t accumulate(const void* bins, int code_bytes, const void* rel,
                       const void* gh, const float* scale, long long qmax,
                       unsigned long long* acc, int64_t n_out, int64_t rows,
                       int num_features, int num_bins, int n_nodes,
                       int node_tile, int feat_group, int64_t chunk,
                       cudaStream_t s) {
  if ((code_bytes != 1 && code_bytes != 4) || node_tile < 1 ||
      feat_group < 1 || chunk < 1 || rows < 0 || qmax < 1)
    return cudaErrorInvalidValue;
  if (rows == 0 || n_out == 0) return cudaSuccess;
  return code_bytes == 1
             ? launch<uint8_t>(bins, rel, gh, scale, qmax, acc, acc + n_out,
                               rows, num_features, num_bins, n_nodes,
                               node_tile, feat_group, chunk, s)
             : launch<int32_t>(bins, rel, gh, scale, qmax, acc, acc + n_out,
                               rows, num_features, num_bins, n_nodes,
                               node_tile, feat_group, chunk, s);
}

}  // namespace

extern "C" {

// The accumulate half: bins: uint8 (code_bytes == 1) or int32 (code_bytes
// == 4) [rows, F] row-major; rel: int32 [rows]; gh: f32 [rows, 2], 8-byte
// aligned; scale: f32 [2] on the card (2^k of each lane) and qmax its value
// limit (see hist_fixed.cuh), made from this launch's rows or from every
// process's; acc: int64 [n_nodes * F * num_bins * 2 + 2] (the bins, then
// each lane's overflow mark), zeroed by the caller and left undequantized,
// so that the accumulators of several processes can be summed before one
// dmlc_histogram_gh_dequantize.  A block takes `chunk` rows, `node_tile`
// nodes and `feat_group` features, and 16 * node_tile * feat_group *
// num_bins bytes of shared memory.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 on success).
int dmlc_histogram_gh_accumulate(const void* bins, int code_bytes,
                                 const void* rel, const void* gh,
                                 const void* scale, long long qmax, void* acc,
                                 long long rows, int num_features,
                                 int num_bins, int n_nodes, int node_tile,
                                 int feat_group, long long chunk,
                                 void* stream) {
  const int64_t n_out = static_cast<int64_t>(n_nodes) * num_features *
                        num_bins * 2;
  return static_cast<int>(accumulate(
      bins, code_bytes, rel, gh, static_cast<const float*>(scale), qmax,
      static_cast<unsigned long long*>(acc), n_out, rows, num_features,
      num_bins, n_nodes, node_tile, feat_group, chunk,
      static_cast<cudaStream_t>(stream)));
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
