// Per-level GBDT gradient histogram for Hopper (sm_90a):
//   out[n, f, b, :] = sum of gh[r, :] over rows r with rel[r] == n and bins[r, f] == b.
//
// Replaces the Pallas TPU kernel `_hist_kernel` (dmlc_core_tpu/ops/pallas_segment.py,
// launched from `_histogram_gh_pallas`), which computes the same histogram as a
// one-hot contraction on the MXU over an int32 [F, rows] copy of the codes.
// Contract kept from it:
//   * f32 (grad, hess) inputs and f32 results, no TF32 anywhere; the sums
//     are carried in f64 inside a block (see "Accuracy");
//   * any num_bins >= 1 and any n_nodes >= 1; rows need not be a multiple of
//     anything; rows whose node id or bin code is out of range add nothing;
//   * bitwise the same result from launch to launch: no float atomics.
//
// Layout.  The codes are read where they lie, as uint8 (or int32) [rows, F]
// row-major: no transposed or widened copy is made per level.  gh is read as
// float2 [rows], rel as int32 [rows].
//
// Design (simple first).  Block (x, y) is (feature group x node tile, row
// chunk).  Each warp of the block owns one feature of the group and a private
// shared-memory histogram of `node_tile` nodes x num_bins bins x (g, h) in
// f64.  The
// warp walks its chunk 32 rows a step, one row per lane.  Lanes whose
// (node, bin) keys are equal are grouped with __match_any_sync; each lane takes
// its rank in its group (the count of lower lanes with its key), and the warp
// adds rank 0 first, then rank 1, and so on, with a __syncwarp between ranks:
// lanes of one rank hold distinct keys, so the plain read-modify-write adds
// never race, and every bin is summed in row order.  The chunk's histogram is
// written to a partial [n_chunks, n, F, B, 2]; a second kernel folds the
// partials in chunk order.  With one chunk it is written to the output.
//
// Accuracy.  A bin's running sum in a chunk can take 1e5 adds (the missing
// bin of sparse data densified with NaN holds most rows), and f32 adds of
// near-equal values round the same way: an f32 chain that long drifted
// 2.8e-3 of the largest bin from float64 at Bosch width (1.18M x 968).  The
// shared-memory sums are f64 and rounded to f32 once; the fold adds the
// chunk partials in f64 too.
//
// What bounds it.  The function must move rows * F code bytes plus 12 bytes a
// row (rel, gh) and write 8 * n * F * B bytes: 0.131 ms at 3.35 TB/s for
// Higgs (11M rows x 28 features, 256 bins).  This kernel re-reads each row
// once per (feature, node tile), and each warp step costs a match, a
// reduction and as many shared-memory passes as its largest key group, so it
// is bound by instruction issue and the L1/L2 traffic of those re-reads, not
// by device memory.  A row partition by node (rows of one node contiguous)
// would remove the node-tile re-reads; that is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 4;  // features (warps) per block

template <typename Code>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
hist_partial(const Code* __restrict__ bins, const int* __restrict__ rel,
             const float2* __restrict__ gh, float2* __restrict__ dst,
             int64_t rows, int num_features, int num_bins, int n_nodes,
             int warps, int node_tile, int n_groups, int64_t chunk) {
  extern __shared__ double2 s_hist[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int group = blockIdx.x % n_groups;
  const int tile = blockIdx.x / n_groups;
  const int f = group * warps + warp;
  // no block-wide barrier follows, so a warp without a feature leaves at once
  if (f >= num_features) return;
  const int n0 = tile * node_tile;
  const int keys = node_tile * num_bins;
  double2* h = s_hist + static_cast<int64_t>(warp) * keys;
  for (int k = lane; k < keys; k += kWarp) h[k] = make_double2(0.0, 0.0);
  __syncwarp();

  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t r1 = r0 + chunk < rows ? r0 + chunk : rows;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t base = r0; base < r1; base += kWarp) {
    const int64_t r = base + lane;
    int key = -1;
    float2 v = make_float2(0.0f, 0.0f);
    if (r < r1) {
      const int node = rel[r] - n0;
      const int code = static_cast<int>(bins[r * num_features + f]);
      if (node >= 0 && node < node_tile && code >= 0 && code < num_bins) {
        key = node * num_bins + code;
        v = gh[r];
      }
    }
    if (!__any_sync(0xffffffffu, key >= 0)) continue;
    const unsigned same = __match_any_sync(0xffffffffu, key);
    const int rank = key >= 0 ? __popc(same & below) : 0;
    const int last = __reduce_max_sync(0xffffffffu, rank);
    for (int k = 0; k <= last; ++k) {
      if (key >= 0 && rank == k) {
        double2 a = h[key];
        a.x += v.x;
        a.y += v.y;
        h[key] = a;
      }
      __syncwarp();
    }
  }

  // this warp's (node tile, feature) slice of the chunk's histogram; the
  // nodes of the last tile past n_nodes (rows with such ids) are dropped
  float2* out = dst + static_cast<int64_t>(blockIdx.y) * n_nodes *
                          num_features * num_bins;
  for (int k = lane; k < keys; k += kWarp) {
    const int node = n0 + k / num_bins;
    if (node >= n_nodes) break;
    out[(static_cast<int64_t>(node) * num_features + f) * num_bins +
        k % num_bins] = make_float2(static_cast<float>(h[k].x),
                                    static_cast<float>(h[k].y));
  }
}

__global__ void __launch_bounds__(256)
hist_fold(const float* __restrict__ partials, float* __restrict__ out,
          int64_t n_out, int n_chunks) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (o >= n_out) return;
  double s = 0.0;
  for (int c = 0; c < n_chunks; ++c) s += partials[c * n_out + o];
  out[o] = static_cast<float>(s);
}

template <typename Code>
cudaError_t launch_partial(const void* bins, const void* rel, const void* gh,
                           float2* dst, int64_t rows, int num_features,
                           int num_bins, int n_nodes, int warps, int node_tile,
                           int n_chunks, int64_t chunk, cudaStream_t s) {
  const int n_groups = (num_features + warps - 1) / warps;
  const int n_tiles = (n_nodes + node_tile - 1) / node_tile;
  const size_t smem = sizeof(double2) * static_cast<size_t>(warps) *
                      node_tile * num_bins;
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial<Code>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  hist_partial<Code><<<dim3(n_groups * n_tiles, n_chunks), warps * kWarp,
                       smem, s>>>(
      static_cast<const Code*>(bins), static_cast<const int*>(rel),
      static_cast<const float2*>(gh), dst, rows, num_features, num_bins,
      n_nodes, warps, node_tile, n_groups, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bins: uint8 (code_bytes == 1) or int32 (code_bytes == 4) [rows, F]
// row-major; rel: int32 [rows]; gh: f32 [rows, 2], 8-byte aligned; out: f32
// [n_nodes, F, num_bins, 2]; partials: f32 [n_chunks, n_nodes * F * num_bins
// * 2], unused (may be null) when n_chunks == 1.  Rows [c * chunk, (c+1) *
// chunk) belong to chunk c.  `warps` features share a block (1..4) and
// `node_tile` nodes a pass over the rows; the block takes warps * node_tile *
// num_bins * 16 bytes of shared memory.  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 on success).
int dmlc_histogram_gh_f32(const void* bins, int code_bytes, const void* rel,
                          const void* gh, void* out, void* partials,
                          long long rows, int num_features, int num_bins,
                          int n_nodes, int warps, int node_tile, int n_chunks,
                          long long chunk, void* stream) {
  const int64_t n_out = static_cast<int64_t>(n_nodes) * num_features *
                        num_bins * 2;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  if ((code_bytes != 1 && code_bytes != 4) || warps < 1 || warps > kMaxWarps ||
      node_tile < 1 || n_chunks < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* dst = static_cast<float2*>(n_chunks == 1 ? out : partials);
  cudaError_t err =
      code_bytes == 1
          ? launch_partial<uint8_t>(bins, rel, gh, dst, rows, num_features,
                                    num_bins, n_nodes, warps, node_tile,
                                    n_chunks, chunk, s)
          : launch_partial<int32_t>(bins, rel, gh, dst, rows, num_features,
                                    num_bins, n_nodes, warps, node_tile,
                                    n_chunks, chunk, s);
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  const unsigned gx = static_cast<unsigned>((n_out + 255) / 256);
  hist_fold<<<gx, 256, 0, s>>>(static_cast<const float*>(partials),
                               static_cast<float*>(out), n_out, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* dmlc_histogram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
