// Segment sum for Hopper (sm_90a): out[r, l] = sum_k contrib[k, l] * [row_id[k] == r].
//
// Replaces the Pallas TPU kernel `_seg_kernel` (dmlc_core_tpu/ops/pallas_segment.py:67,
// launched from `_segment_sum_pallas`), which computes the same reduction as a
// tiled one-hot contraction on the MXU.  Contract kept from it:
//   * f32 inputs and f32 results, no TF32 anywhere;
//   * row ids may be unsorted; ids outside [0, num_segments) are dropped;
//   * any lane count L >= 1 (the wrapper takes lanes past kMaxLanes in column
//     chunks);
//   * bitwise the same result from run to run: no float atomics.
//
// Numerics (hist_fixed.cuh, the histogram kernels' fixed point).  Each f32
// value of lane l is rounded once to q = rint(v * 2^k_l), an int64, and every
// sum is an exact int64 add, so the result does not depend on the order the
// integer atomics run in.  k_l = 62 - ceil(log2(nnz * amax_l)), clamped at
// 126, is found on the card inside the launch, in double, as
// ops/fixed_point.py computes it, so the two agree bit for bit.  An output of
// m values ends at most m * 2^-(k+1) from its exact sum before its one
// rounding to f32.  A lane holding a NaN or Inf comes out NaN in every
// output; so does a lane with a quantised value at or past the value limit
// floor((2^63 - 1) / nnz) (impossible with the launch's own amax; kept as
// hist_fixed.cuh defines it).
//
// What bounds it.  The function must read each entry's id and L values once
// and write R * L outputs: 0.039 ms at 3.35 TB/s for a GBDT's leaf sums (11M
// rows x 2 lanes into 64 leaves), 0.34 us for a served FM micro-batch (16,384
// entries x 16 lanes into 256 rows), where launch latency dominates.  The
// previous kernel compared every entry with every output (R * L * nnz work);
// this one touches each (entry, lane) value once.
//
// Design.  One cooperative launch, its grid no larger than the blocks the
// card holds at once, in three phases split by grid-wide barriers:
//   A. zero the int64 accumulators and the overflow marks; each block takes
//      the max of |v| of every lane over its chunk of entries (integer max of
//      the bit pattern: a NaN ranks above Inf) and stores it;
//   B. every block reduces those partial maxima to each lane's scale, then
//      quantises its chunk once and adds it up.  A thread walks runs of 4
//      consecutive entries (ids and values loaded together, values as float4
//      or float2 where the lanes allow) and keeps one running int64 sum for
//      the id it is on, added out only when the id changes: sorted served
//      rows and the one-segment node total of a tree's root fold in
//      registers.  The adds go into one shared int64 copy of the outputs a
//      block (two 32-bit atomics with the carry, hist_fixed::shared_add) up
//      to 96 KB, and straight into the global int64 buffer with 64-bit
//      integer atomics past that; a block adds its shared copy into the
//      global buffer.  (A copy a warp, to spread same-word atomics at few
//      outputs, measured no faster at any main-path shape: PERF.md);
//   C. round every output once to f32.
// The scratch is one int64 buffer the wrapper allocates (accumulators,
// overflow marks, per-block maxima, each lane's scale), and nothing is
// zeroed outside the launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_fixed.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kRun = 4;  // consecutive entries a thread loads at once

struct Args {
  const float* contrib;          // [nnz, lanes]
  const int* row_id;             // [nnz]
  float* out;                    // [num_segments, lanes]
  unsigned long long* acc;       // [num_segments * lanes], then over [lanes]
  unsigned* partial;             // [gridDim.x * lanes] per-block max |v| bits
  float* scale;                  // [lanes] 2^k of each lane (written by block 0)
  const float* scale_in;         // [lanes] the caller's 2^k, or null: find it
  int finish;                    // 1: phase C; 0: leave the int64 sums
  int64_t nnz;
  int64_t n_out;                 // num_segments * lanes
  long long qmax;                // hist_fixed value limit for n = max(nnz, 1)
  int num_segments;
  int lanes;
  int groups;                    // lanes / V
  int tg;                        // threads that share one run: min(groups, kThreads)
  int streams;                   // runs a block walks side by side: kThreads / tg
  int shared;                    // 1: a shared copy of the outputs; 0: global adds
};

template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

// Every run of this thread over the block's entries [c0, c1), lane group by
// lane group: begin(grp), then body(k0, grp) for each run start k0, then
// done(grp).  The block's runs are side by side, so a warp reads one span.
template <typename Begin, typename Body, typename Done>
__device__ __forceinline__ void walk(const Args& a, int64_t c0, int64_t c1,
                                     Begin begin, Body body, Done done) {
  const int s = threadIdx.x / a.tg;
  if (s >= a.streams) return;
  const int64_t step = static_cast<int64_t>(a.streams) * kRun;
  for (int grp = threadIdx.x % a.tg; grp < a.groups; grp += a.tg) {
    begin(grp);
    for (int64_t k0 = c0 + static_cast<int64_t>(s) * kRun; k0 < c1; k0 += step)
      body(k0, grp);
    done(grp);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
seg_fixed(const Args a) {
  extern __shared__ unsigned smem[];
  unsigned* s_amax = smem;                                   // [lanes]
  float* s_scale = reinterpret_cast<float*>(smem + a.lanes);  // [lanes]
  unsigned* s_hist = smem + 2 * a.lanes;  // (lo, hi) x n_out words
  cg::grid_group grid = cg::this_grid();
  const int64_t gthreads = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t per_block = (a.nnz + gridDim.x - 1) / gridDim.x;
  const int64_t c0 = blockIdx.x * per_block;
  const int64_t c1 = c0 + per_block < a.nnz ? c0 + per_block : a.nnz;
  unsigned long long* over = a.acc + a.n_out;

  // ---- A: zero the accumulators; each block's max |v| of every lane
  for (int64_t i = gtid; i < a.n_out + a.lanes; i += gthreads) a.acc[i] = 0ull;
  for (int l = threadIdx.x; l < a.lanes; l += kThreads) s_amax[l] = 0u;
  __syncthreads();
  unsigned m[V];
  if (a.scale_in == nullptr) walk(a, c0, c1,
       [&](int) {
         for (int v = 0; v < V; ++v) m[v] = 0u;
       },
       [&](int64_t k0, int grp) {
         float x[kRun][V];
#pragma unroll
         for (int j = 0; j < kRun; ++j) {
           if (k0 + j < c1) {
             load<V>(a.contrib + (k0 + j) * a.lanes + grp * V, x[j]);
           } else {
             for (int v = 0; v < V; ++v) x[j][v] = 0.0f;
           }
         }
#pragma unroll
         for (int j = 0; j < kRun; ++j)
           for (int v = 0; v < V; ++v)
             m[v] = max(m[v], __float_as_uint(x[j][v]) & 0x7fffffffu);
       },
       [&](int grp) {
         for (int v = 0; v < V; ++v) atomicMax(s_amax + grp * V + v, m[v]);
       });
  __syncthreads();
  for (int l = threadIdx.x; l < a.lanes; l += kThreads)
    a.partial[static_cast<int64_t>(blockIdx.x) * a.lanes + l] = s_amax[l];
  grid.sync();

  // ---- B: each lane's scale, then quantise and add up
  for (int l = threadIdx.x; l < a.lanes; l += kThreads) s_amax[l] = 0u;
  const int n_hist = a.shared ? static_cast<int>(a.n_out) : 0;
  for (int i = threadIdx.x; i < 2 * n_hist; i += kThreads)
    s_hist[i] = 0u;
  __syncthreads();
  const int64_t n_partial = static_cast<int64_t>(gridDim.x) * a.lanes;
  for (int64_t i = threadIdx.x; i < n_partial; i += kThreads)
    atomicMax(s_amax + i % a.lanes, a.partial[i]);
  __syncthreads();
  for (int l = threadIdx.x; l < a.lanes; l += kThreads) {
    if (a.scale_in != nullptr) {
      s_scale[l] = a.scale_in[l];
      continue;
    }
    // fixed_point.fixed_point_scale, step for step: NaN stays NaN through
    // the clamp, amax 0 gives k = +inf and so the clamp
    const double n = static_cast<double>(a.nnz > 0 ? a.nnz : 1);
    double k = 62.0 - ceil(log2(
        static_cast<double>(__uint_as_float(s_amax[l])) * n));
    if (k > 126.0) k = 126.0;
    const float sc = isfinite(k) ? static_cast<float>(exp2(k))
                                 : __int_as_float(0x7fc00000);
    s_scale[l] = sc;
    if (blockIdx.x == 0) a.scale[l] = sc;
  }
  __syncthreads();

  int cur = -1;
  long long run[V];
  float sc[V];
  auto emit = [&](int grp) {
    if (cur < 0) return;
    const int64_t o = static_cast<int64_t>(cur) * a.lanes + grp * V;
    for (int v = 0; v < V; ++v) {
      if (run[v] == 0) continue;
      if (n_hist)
        hist_fixed::shared_add(s_hist + o + v, s_hist + n_hist + o + v,
                               run[v]);
      else
        atomicAdd(a.acc + o + v, static_cast<unsigned long long>(run[v]));
    }
  };
  walk(a, c0, c1,
       [&](int grp) {
         cur = -1;
         for (int v = 0; v < V; ++v) sc[v] = s_scale[grp * V + v];
       },
       [&](int64_t k0, int grp) {
         int id[kRun];
         float x[kRun][V];
#pragma unroll
         for (int j = 0; j < kRun; ++j) {
           id[j] = -1;
           if (k0 + j < c1) {
             id[j] = a.row_id[k0 + j];
             load<V>(a.contrib + (k0 + j) * a.lanes + grp * V, x[j]);
           }
         }
#pragma unroll
         for (int j = 0; j < kRun; ++j) {
           if (id[j] < 0 || id[j] >= a.num_segments) continue;
           long long q[V];
           for (int v = 0; v < V; ++v)
             q[v] = hist_fixed::quantize(x[j][v], sc[v], a.qmax,
                                         over + grp * V + v);
           if (id[j] == cur) {
             for (int v = 0; v < V; ++v) run[v] += q[v];
           } else {
             emit(grp);
             cur = id[j];
             for (int v = 0; v < V; ++v) run[v] = q[v];
           }
         }
       },
       [&](int grp) { emit(grp); });
  __syncthreads();
  for (int i = threadIdx.x; i < n_hist; i += kThreads) {
    const long long total = hist_fixed::plane_value(s_hist, n_hist, i);
    if (total) atomicAdd(a.acc + i, static_cast<unsigned long long>(total));
  }
  if (!a.finish) return;  // the same for every block
  grid.sync();

  // ---- C: the one rounding of each output
  for (int64_t i = gtid; i < a.n_out; i += gthreads) {
    const int lane = static_cast<int>(i % a.lanes);
    const float s = s_scale[lane];
    a.out[i] = hist_fixed::lane_ok(s) && over[lane] == 0ull
                   ? static_cast<float>(
                         static_cast<double>(static_cast<long long>(a.acc[i])) /
                         static_cast<double>(s))
                   : __int_as_float(0x7fc00000);
  }
}

template <int V>
cudaError_t launch(Args& a, int blocks, size_t smem, cudaStream_t s) {
  auto kernel = seg_fixed<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(grid), dim3(kThreads), params, smem,
                                    s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t run(const void* contrib, const void* row_id, void* out,
                void* scratch, void* scale, const void* scale_in,
                int finish, long long nnz, int num_segments, int lanes,
                int vec, int shared, int blocks, long long qmax,
                cudaStream_t s) {
  Args a;
  a.n_out = static_cast<int64_t>(num_segments) * lanes;
  if (a.n_out == 0) return cudaSuccess;
  if ((vec != 1 && vec != 2 && vec != 4) || lanes % vec || nnz < 0 ||
      blocks < 1 || qmax < 1 || (shared && a.n_out > 0x3fffffff))
    return cudaErrorInvalidValue;
  a.contrib = static_cast<const float*>(contrib);
  a.row_id = static_cast<const int*>(row_id);
  a.out = static_cast<float*>(out);
  a.acc = static_cast<unsigned long long*>(scratch);
  a.partial = reinterpret_cast<unsigned*>(a.acc + a.n_out + lanes);
  a.scale = static_cast<float*>(scale);
  a.scale_in = static_cast<const float*>(scale_in);
  a.finish = finish;
  a.nnz = nnz;
  a.qmax = qmax;
  a.num_segments = num_segments;
  a.lanes = lanes;
  a.groups = lanes / vec;
  a.tg = a.groups < kThreads ? a.groups : kThreads;
  a.streams = kThreads / a.tg;
  a.shared = shared ? 1 : 0;
  const size_t smem = 8 * static_cast<size_t>(lanes) +
                      (shared ? 8 * static_cast<size_t>(a.n_out) : 0);
  return vec == 4   ? launch<4>(a, blocks, smem, s)
         : vec == 2 ? launch<2>(a, blocks, smem, s)
                    : launch<1>(a, blocks, smem, s);
}

}  // namespace

extern "C" {

// contrib: f32 [nnz, lanes] row-major, 4 * vec-byte aligned; row_id: i32
// [nnz]; out: f32 [num_segments, lanes]; scratch: int64 [num_segments *
// lanes + lanes + ceil(blocks * lanes / 2)], any contents; scale: f32
// [lanes], written with each lane's 2^k.  vec (1, 2 or 4) divides lanes;
// shared is 1 when a block adds into a shared copy of the outputs (8 *
// lanes + 8 * num_segments * lanes bytes of shared memory), 0 when it adds
// straight into the global buffer (8 * lanes bytes); blocks is the most blocks the launch takes
// (fewer if the card holds fewer at once).  Launches on `stream`, does not
// synchronise, and returns the first CUDA error (0 on success).
int dmlc_segment_sum_fixed(const void* contrib, const void* row_id, void* out,
                           void* scratch, void* scale, long long nnz,
                           int num_segments, int lanes, int vec, int shared,
                           int blocks, long long qmax, void* stream) {
  return static_cast<int>(run(contrib, row_id, out, scratch, scale, nullptr,
                              1, nnz, num_segments, lanes, vec, shared,
                              blocks, qmax,
                              static_cast<cudaStream_t>(stream)));
}

// The accumulate half of dmlc_segment_sum_fixed, for a sum over several
// processes: the same launch with the caller's f32 [lanes] scale and value
// limit (made from every process's entries), ending with the int64 sums in
// scratch[0, num_segments * lanes) and each lane's overflow mark after
// them, undequantized; the caller sums those of every process and rounds
// them with dmlc_segment_sum_dequantize.  scratch as for
// dmlc_segment_sum_fixed.
int dmlc_segment_sum_accumulate(const void* contrib, const void* row_id,
                                void* scratch, const void* scale,
                                long long nnz, int num_segments, int lanes,
                                int vec, int shared, int blocks,
                                long long qmax, void* stream) {
  if (scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run(contrib, row_id, nullptr, scratch, nullptr,
                              scale, 0, nnz, num_segments, lanes, vec,
                              shared, blocks, qmax,
                              static_cast<cudaStream_t>(stream)));
}

// out[i] = f32(acc[i] / scale[i % lanes]) over n_out outputs, NaN for a
// lane whose scale is unusable or whose mark acc[n_out + lane] is nonzero.
int dmlc_segment_sum_dequantize(const void* acc, const void* scale, void* out,
                                long long n_out, int lanes, void* stream) {
  return static_cast<int>(hist_fixed::launch_dequantize(
      acc, scale, out, n_out, lanes, static_cast<cudaStream_t>(stream)));
}

const char* dmlc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
