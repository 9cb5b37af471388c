// Segment-sum for Hopper (sm_90a): out[r, l] = sum_k contrib[k, l] * [row_id[k] == r].
//
// Replaces the Pallas TPU kernel `_seg_kernel` (dmlc_core_tpu/ops/pallas_segment.py,
// launched from `_segment_sum_pallas`), which computes the same reduction as a
// tiled one-hot contraction on the MXU.  Contract kept from it:
//   * f32 inputs, f32 accumulation, no TF32 anywhere;
//   * row ids may be unsorted; ids outside [0, num_segments) are dropped;
//   * any lane count L >= 1;
//   * bitwise the same result from run to run: no float atomics.  Every
//     output is summed by one thread in entry order, and the per-chunk
//     partials are folded by a second kernel in chunk order.
//   * close to the exact sum however long a chunk is.  A chunk can hold
//     ~172k entries (a GBDT's leaf sums: 11M rows into 64 leaves), and one
//     running f32 sum that long drifted 1.6e-4 relative from the exact
//     one; the TPU kernel's blocked contraction does not.  So each stage
//     of 256 entries is summed apart, and the stage sums are added
//     compensated (Kahan): the low bits one add rounds off are carried
//     into the next.  The fold adds the chunk partials the same way.
//
// Design (simple first).  Block x owns 256 consecutive (row, lane) outputs of
// the flattened [R * L] result, one per thread; block y owns one contiguous
// chunk of the entries.  The block stages its chunk's row ids through shared
// memory (all threads read the same id: a broadcast), and a thread adds
// contrib[k, l] only when row_id[k] is its row, so each contrib element is
// read from device memory by exactly one thread of one block.  With more than
// one chunk, partials [n_chunks, R * L] go to scratch the caller allocates and
// `seg_fold` sums them in chunk order.
//
// What bounds it.  The compare work is R * L * nnz (every thread scans its
// whole chunk), so the kernel is bound by instruction issue, not by the
// bytes: at the served FM shape (R=256, nnz=16384, L=16) one call moves
// about 1.1 MB, 0.33 us at 3.35 TB/s, far below the launch overhead.  A
// segmented reduction over the sorted CSR rows that fuses the w[index] *
// value gather would remove the R factor and the separate gather; that is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// acc += x, compensated: comp holds what earlier adds rounded off.  The
// _rn intrinsics keep nvcc from contracting the compensation into FMAs.
// Once acc is Inf or NaN the compensation is dropped, so an Inf entry
// leaves its row Inf, as a plain sum does.
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float x) {
  const float y = __fsub_rn(x, comp);
  const float t = __fadd_rn(acc, y);
  comp = isfinite(t) ? __fsub_rn(__fsub_rn(t, acc), y) : 0.0f;
  acc = t;
}

constexpr int kThreads = 256;  // outputs per block, one per thread
constexpr int kStage = 256;    // row ids staged in shared memory per step

__global__ void __launch_bounds__(kThreads)
seg_partial(const float* __restrict__ contrib, const int* __restrict__ row_id,
            float* __restrict__ dst, int64_t nnz, int num_segments, int lanes,
            int64_t chunk) {
  __shared__ int s_rid[kStage];
  const int64_t n_out = static_cast<int64_t>(num_segments) * lanes;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = o < n_out;
  // a dead thread still walks the chunk (it joins every barrier) but takes
  // row -1 and never writes; contrib reads stay in bounds for any row match
  const int row = live ? static_cast<int>(o / lanes) : -1;
  const int lane = live ? static_cast<int>(o % lanes) : 0;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t k1 = k0 + chunk < nnz ? k0 + chunk : nnz;
  float acc = 0.0f, comp = 0.0f;
  for (int64_t base = k0; base < k1; base += kStage) {
    const int n = k1 - base < kStage ? static_cast<int>(k1 - base) : kStage;
    __syncthreads();  // the previous stage is fully consumed
    for (int i = threadIdx.x; i < n; i += kThreads) s_rid[i] = row_id[base + i];
    __syncthreads();
    float part = 0.0f;
    for (int i = 0; i < n; ++i) {
      if (s_rid[i] == row) part += contrib[(base + i) * lanes + lane];
    }
    kahan_add(acc, comp, part);
  }
  if (live) dst[static_cast<int64_t>(blockIdx.y) * n_out + o] = acc;
}

__global__ void __launch_bounds__(kThreads)
seg_fold(const float* __restrict__ partials, float* __restrict__ out,
         int64_t n_out, int n_chunks) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (o >= n_out) return;
  float s = 0.0f, comp = 0.0f;
  for (int c = 0; c < n_chunks; ++c)
    kahan_add(s, comp, partials[c * n_out + o]);
  out[o] = s;
}

}  // namespace

extern "C" {

// contrib: f32 [nnz, lanes] row-major; row_id: i32 [nnz]; out: f32
// [num_segments, lanes]; partials: f32 [n_chunks, num_segments * lanes],
// unused (may be null) when n_chunks == 1.  Entries [c * chunk, (c+1) *
// chunk) belong to chunk c.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
int dmlc_segment_sum_f32(const void* contrib, const void* row_id, void* out,
                         void* partials, long long nnz, int num_segments,
                         int lanes, int n_chunks, long long chunk,
                         void* stream) {
  const int64_t n_out = static_cast<int64_t>(num_segments) * lanes;
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned gx = static_cast<unsigned>((n_out + kThreads - 1) / kThreads);
  float* dst = static_cast<float*>(n_chunks == 1 ? out : partials);
  seg_partial<<<dim3(gx, n_chunks), kThreads, 0, s>>>(
      static_cast<const float*>(contrib), static_cast<const int*>(row_id), dst,
      nnz, num_segments, lanes, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  seg_fold<<<gx, kThreads, 0, s>>>(static_cast<const float*>(partials),
                                   static_cast<float*>(out), n_out, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* dmlc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
