// Fixed-point (grad, hess) accumulation shared by the histogram kernels
// (histogram_gh.cu, histogram_gh_sparse.cu) and, for any number of lanes,
// by the segment sum (segment_sum.cu, which finds its scale itself).
//
// Each f32 value v of lane l (0: grad, 1: hess) becomes one 64-bit integer
// q = rint(v * 2^k_l), with one scale 2^k_l per lane and launch, chosen by
// the wrapper (ops/fixed_point.py) as k = 62 - ceil(log2(n * amax_l)): n
// bounds the values one bin can receive and amax_l bounds |v|, so no bin
// sum passes 2^62 + n/2 < 2^63 and int64 never overflows.  All sums are
// int64 adds: exact, so bitwise the same in any order, and the kernels may
// use integer atomics (shared and global) and keep the determinism contract
// with no float atomics.  A bin of m values ends m * 2^-(k+1) <= m * n *
// amax * 2^-62 from its exact sum at most, before the one rounding to f32.
// A lane whose scale is not a finite positive number (the wrapper marks a
// NaN or Inf input that way) comes out NaN in every bin, and so does a lane
// with a value past the bound its scale was made from where that value
// could carry a bin past int64: |q| >= qmax = floor((2^63 - 1) / n), twice
// what a true bound allows, marks the lane (n values below qmax sum inside
// int64, so an unmarked lane is exact whatever bound the caller gave).
//
// Shared histograms keep each int64 as two 32-bit words in four planes (g
// low, g high, h low, h high; `size` words each), so that lanes with
// random bins spread over all 32 banks.  A 64-bit shared atomic add
// compiles to a compare-and-swap loop on this card; two native 32-bit
// atomics with the carry taken from the low word's old value add the same
// integer exactly (the scheme of XGBoost's GPU hist).  Lanes of a warp with
// equal keys can first sum their int64 values with three 32-bit warp
// reductions (add_reduced): the same integer, one shared add per key.
//
// A one-process histogram call is two launches: `prologue` (zero the
// accumulator, its marks and tickets; each block's max |g|, |h|; for a
// dense level built by subtraction, each node's rows), then the
// histogram, whose every block turns those maxima into the scale itself
// (block_scale, scale_of: fixed_point_scale step for step, in double);
// the last block of each output region rounds that region (last_of), and
// the last block of the launch poisons a lane a value marked over.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hist_fixed {

__device__ __forceinline__ bool lane_ok(float scale) {
  return scale > 0.0f && scale <= 3.0e38f;  // false for NaN, Inf, 0
}

// q = rint(v * scale): scale is a power of two, so the product is exact;
// |q| >= qmax (see above; a saturated or NaN product included) sets *over
__device__ __forceinline__ long long quantize(float v, float scale,
                                              long long qmax,
                                              unsigned long long* over) {
  const long long q = __float2ll_rn(v * scale);
  if (q >= qmax || q <= -qmax) *over = 1ull;
  return q;
}

// *word (low), *(word + size) (high) += v, exactly and in any order
__device__ __forceinline__ void shared_add(unsigned* lo, unsigned* hi,
                                           long long v) {
  const unsigned long long u = static_cast<unsigned long long>(v);
  const unsigned vlo = static_cast<unsigned>(u);
  const unsigned vhi = static_cast<unsigned>(u >> 32);
  const unsigned old = atomicAdd(lo, vlo);
  const unsigned up = vhi + (old + vlo < old ? 1u : 0u);
  if (up) atomicAdd(hi, up);
}

// Add (qg, qh) into bin `key` of a four-plane shared histogram of `size`
// bins
__device__ __forceinline__ void add(unsigned* s, int size, int key,
                                    long long qg, long long qh) {
  shared_add(s + key, s + size + key, qg);
  shared_add(s + 2 * size + key, s + 3 * size + key, qh);
}

__device__ __forceinline__ long long plane_value(const unsigned* lo,
                                                 int size, int i) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(lo[size + i]) << 32) | lo[i]);
}

// acc[dst(i), lane] += the shared histogram's bin i, for every nonzero bin:
// one global 64-bit integer add (RED.ADD.64) each, in any order
template <typename Dst>
__device__ __forceinline__ void flush(const unsigned* s, int size,
                                      unsigned long long* acc, Dst dst) {
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    const int64_t o = dst(i);
    if (o < 0) continue;
    const long long g = plane_value(s, size, i);
    const long long h = plane_value(s + 2 * size, size, i);
    if (g) atomicAdd(acc + 2 * o, static_cast<unsigned long long>(g));
    if (h) atomicAdd(acc + 2 * o + 1, static_cast<unsigned long long>(h));
  }
}

// ---- equal keys of a warp summed before they touch shared memory ----------

// The int64 sum of v over the lanes of `peers` (this lane among them), in
// every one of them: the low 32 bits as two 16-bit halves (each sum below
// 2^21, exact) and the high word modulo 2^32, which is all its share of a
// sum modulo 2^64 needs; the true sum fits int64 (n values below qmax), so
// the modular sum is the sum.  Three native 32-bit warp reductions.
__device__ __forceinline__ long long warp_sum(unsigned peers, long long v) {
  const unsigned long long u = static_cast<unsigned long long>(v);
  const unsigned a = __reduce_add_sync(peers, static_cast<unsigned>(u) & 0xffffu);
  const unsigned b = __reduce_add_sync(peers, static_cast<unsigned>(u) >> 16);
  const unsigned c = __reduce_add_sync(peers, static_cast<unsigned>(u >> 32));
  return static_cast<long long>((static_cast<unsigned long long>(c) << 32) +
                                (static_cast<unsigned long long>(b) << 16) +
                                a);
}

// add(s, size, key, qg, qh) for every lane of the warp with key >= 0, the
// lanes of one key summed first and added once by the lowest of them.  All
// 32 lanes call it together (a lane with nothing to add passes key -1).
__device__ __forceinline__ void add_reduced(unsigned* s, int size, int key,
                                            long long qg, long long qh) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const long long g = warp_sum(peers, qg);
  const long long h = warp_sum(peers, qh);
  if (key >= 0 && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1)
    add(s, size, key, g, h);
}

// ---- the scale inside a launch (ops/fixed_point.py, step for step) --------

// |v| as ordered bits: integer max ranks NaN above Inf above every number
__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// fixed_point_scale(amax, n): k = 62 - ceil(log2(amax * n)) in double,
// clamped at 126 (NaN stays NaN, amax 0 gives +inf and so 126), 2^k as f32;
// NaN where k is not finite
__device__ __forceinline__ float scale_of(float amax, int64_t n) {
  double k = 62.0 - ceil(log2(static_cast<double>(amax) *
                              static_cast<double>(n > 0 ? n : 1)));
  if (k > 126.0) k = 126.0;
  return isfinite(k) ? static_cast<float>(exp2(k))
                     : __int_as_float(0x7fc00000);
}

// Where a launch takes each lane's scale from, first that is set: `scale`
// (the caller's 2^k: a sum over several processes), `amax` (the caller's
// bound on |v|, f32 [2]), else the max of the prologue's per-block maxima
// `partial` [2 * n_partial].  `n` is the scale's n_max.  Block (0, 0)
// writes the scale it used to `scale_out` when that is set.
struct Scale {
  const float* scale;
  const float* amax;
  const unsigned* partial;
  int n_partial;
  int64_t n;
  float* scale_out;
};

// The partial maxima one thread of block_scale loads (n_partial is at most
// kPartialLoads * blockDim)
constexpr int kPartialLoads = 4;

// s_scale[0..1] = each lane's scale, the same in every block; ends with a
// barrier.  s_tmp: two shared words.  The loads are issued first and
// zero() (the caller's zeroing of its shared histogram) runs while they
// are in flight.
template <typename Zero>
__device__ __forceinline__ void block_scale(const Scale& src, float* s_scale,
                                            unsigned* s_tmp, Zero zero) {
  const bool from_partial = src.scale == nullptr && src.amax == nullptr;
  unsigned pg[kPartialLoads], ph[kPartialLoads];
  float v = 0.0f;
  if (from_partial) {
#pragma unroll
    for (int k = 0; k < kPartialLoads; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      pg[k] = i < src.n_partial ? src.partial[2 * i] : 0u;
      ph[k] = i < src.n_partial ? src.partial[2 * i + 1] : 0u;
    }
  } else if (threadIdx.x < 2) {
    v = src.scale != nullptr ? src.scale[threadIdx.x] : src.amax[threadIdx.x];
  }
  if (threadIdx.x < 2) s_tmp[threadIdx.x] = 0u;
  zero();
  if (from_partial) {  // each lane's max over the blocks: a warp reduction,
                       // then one shared max a warp (blockDim a multiple of 32)
    unsigned mg = 0u, mh = 0u;
#pragma unroll
    for (int k = 0; k < kPartialLoads; ++k) {
      mg = max(mg, pg[k]);
      mh = max(mh, ph[k]);
    }
    mg = __reduce_max_sync(0xffffffffu, mg);
    mh = __reduce_max_sync(0xffffffffu, mh);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
      atomicMax(s_tmp, mg);
      atomicMax(s_tmp + 1, mh);
    }
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const int l = threadIdx.x;
    const float sc = src.scale != nullptr ? v
                     : src.amax != nullptr
                         ? scale_of(v, src.n)
                         : scale_of(__uint_as_float(s_tmp[l]), src.n);
    s_scale[l] = sc;
    if (src.scale_out != nullptr && blockIdx.x == 0 && blockIdx.y == 0)
      src.scale_out[l] = sc;
  }
  __syncthreads();
}

// ---- the end of a one-process launch ---------------------------------------

// The one rounding of an int64 sum: f32(a * 2^-k), NaN for an unusable scale
__device__ __forceinline__ float dequantize_one(long long a, float s) {
  return lane_ok(s) ? static_cast<float>(static_cast<double>(a) /
                                         static_cast<double>(s))
                    : __int_as_float(0x7fc00000);
}

// acc[i] as the other blocks' atomics left it (read past L1)
__device__ __forceinline__ long long acc_at(const unsigned long long* acc,
                                            int64_t i) {
  return __ldcg(reinterpret_cast<const long long*>(acc) + i);
}

// Called by every thread of a block after its adds: true in all of them
// when the block's ticket is the last of `count` on `*ticket`; every add
// of those blocks is then visible to this one.  *s_flag: a shared word.
__device__ __forceinline__ bool last_of(unsigned* ticket, unsigned count,
                                        int* s_flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_flag = atomicAdd(ticket, 1u) == count - 1u;
  __syncthreads();
  const bool last = *s_flag != 0;
  if (last) __threadfence();
  return last;
}

// The last block of a launch: a lane marked over (over[lane], set by
// quantize anywhere in the launch) is NaN in every output.  Only a bound
// that understates the values marks a lane (the launch's own amax never
// does), so the loop runs on error paths only.  With `reset` the marks
// and the launch's ticket are zeroed for the next launch on the stream.
__device__ __forceinline__ void poison_marked(unsigned long long* over,
                                              unsigned* ticket, bool reset,
                                              float* out, int64_t n_out) {
  const bool bad[2] = {__ldcg(reinterpret_cast<const long long*>(over)) != 0,
                       __ldcg(reinterpret_cast<const long long*>(over) + 1) !=
                           0};
  __syncthreads();
  if (reset && threadIdx.x < 2) over[threadIdx.x] = 0ull;
  if (reset && threadIdx.x == 0) *ticket = 0u;
  for (int l = 0; l < 2; ++l) {
    if (!bad[l]) continue;
    for (int64_t i = 2 * static_cast<int64_t>(threadIdx.x) + l; i < n_out;
         i += 2 * static_cast<int64_t>(blockDim.x))
      out[i] = __int_as_float(0x7fc00000);
  }
}

// nodes whose rows a prologue block counts in shared memory before it adds
// its counts to the caller's (more: straight to the caller's)
constexpr int kCountShared = 4096;

// The prologue of a launch: zero[0, n_zero) = 0 and fill[0, n_fill) = 0.0f
// (the accumulator, its marks and tickets; the outputs no slot writes;
// both 16-byte aligned), and, with gh, each block's max |gh| bits of both
// lanes over a grid-stride share of gh[0, n_gh) into partial[2 * block +
// lane]; with rel too, counts[n] += the rows i < n_gh with rel[i] == n, for
// n in [0, n_count) (each warp's rows of one node summed first, then each
// block's in shared memory; a dense histogram's subtracted level counts
// its nodes' rows so).  256 threads, 4 * min(n_count, kCountShared) bytes
// of dynamic shared memory with rel.
__global__ void __launch_bounds__(256)
prologue(const float2* __restrict__ gh, int64_t n_gh,
         unsigned* __restrict__ partial, unsigned long long* __restrict__ zero,
         int64_t n_zero, float* __restrict__ fill, int64_t n_fill,
         const int* __restrict__ rel, int* __restrict__ counts, int n_count) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * 256;
  // 16-byte stores (both arrays start 16-byte aligned), then the tails
  ulonglong2* z2 = reinterpret_cast<ulonglong2*>(zero);
  const int64_t n2 = n_zero / 2;
  int64_t i2 = tid;
  for (; i2 + 3 * step < n2; i2 += 4 * step) {  // four stores in flight
    z2[i2] = make_ulonglong2(0, 0);
    z2[i2 + step] = make_ulonglong2(0, 0);
    z2[i2 + 2 * step] = make_ulonglong2(0, 0);
    z2[i2 + 3 * step] = make_ulonglong2(0, 0);
  }
  for (; i2 < n2; i2 += step) z2[i2] = make_ulonglong2(0, 0);
  if (tid == 0 && (n_zero & 1)) zero[n_zero - 1] = 0ull;
  float4* f4 = reinterpret_cast<float4*>(fill);
  for (int64_t i = tid; i < n_fill / 4; i += step)
    f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < (n_fill & 3)) fill[n_fill - 1 - tid] = 0.0f;
  if (gh == nullptr) return;  // the same for every thread
  extern __shared__ int s_count[];
  const bool shared = n_count <= kCountShared;
  if (rel != nullptr && shared)
    for (int k = threadIdx.x; k < n_count; k += 256) s_count[k] = 0;
  __syncthreads();
  unsigned mg = 0u, mh = 0u;
  const int lane = threadIdx.x & 31;
  // a warp's lanes take consecutive rows and stay together (the match);
  // each lane loads kPrologueRows rows before it uses them
  constexpr int kPrologueRows = 4;
  for (int64_t base = tid - lane; base < n_gh;
       base += kPrologueRows * step) {
    float2 v[kPrologueRows];
    int nd[kPrologueRows];
#pragma unroll
    for (int k = 0; k < kPrologueRows; ++k) {
      const int64_t i = base + k * step + lane;
      v[k] = i < n_gh ? gh[i] : make_float2(0.f, 0.f);
      nd[k] = rel != nullptr && i < n_gh ? rel[i] : -1;
    }
#pragma unroll
    for (int k = 0; k < kPrologueRows; ++k) {
      mg = max(mg, abs_bits(v[k].x));
      mh = max(mh, abs_bits(v[k].y));
      if (rel == nullptr) continue;  // the same for every thread
      const unsigned peers = __match_any_sync(0xffffffffu, nd[k]);
      if (nd[k] >= 0 && nd[k] < n_count && lane == __ffs(peers) - 1)
        atomicAdd(shared ? s_count + nd[k] : counts + nd[k], __popc(peers));
    }
  }
  mg = __reduce_max_sync(0xffffffffu, mg);
  mh = __reduce_max_sync(0xffffffffu, mh);
  __shared__ unsigned s_max[2];
  if (threadIdx.x < 2) s_max[threadIdx.x] = 0u;
  __syncthreads();
  if (rel != nullptr && shared)
    for (int k = threadIdx.x; k < n_count; k += 256)
      if (s_count[k]) atomicAdd(counts + k, s_count[k]);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(s_max, mg);
    atomicMax(s_max + 1, mh);
  }
  __syncthreads();
  if (threadIdx.x < 2) partial[2 * blockIdx.x + threadIdx.x] = s_max[threadIdx.x];
}

// The prologue on stream s: with neither gh nor fill (nothing but zeroes
// to write) one cudaMemsetAsync, which zeroes faster than the kernel; rel,
// counts and n_count (with gh only) count each node's rows
inline cudaError_t launch_prologue(const void* gh, int64_t n_gh,
                                   unsigned* partial, int blocks,
                                   unsigned long long* zero, int64_t n_zero,
                                   float* fill, int64_t n_fill,
                                   cudaStream_t s, const int* rel = nullptr,
                                   int* counts = nullptr, int n_count = 0) {
  if (blocks < 1 || (rel != nullptr && (gh == nullptr || counts == nullptr)))
    return cudaErrorInvalidValue;
  if (gh == nullptr && (fill == nullptr || n_fill == 0))
    return cudaMemsetAsync(zero, 0, 8 * static_cast<size_t>(n_zero), s);
  const size_t smem = rel != nullptr && n_count <= kCountShared
                          ? 4 * static_cast<size_t>(n_count) : 0;
  prologue<<<blocks, 256, smem, s>>>(static_cast<const float2*>(gh), n_gh,
                                     partial, zero, n_zero, fill, n_fill, rel,
                                     counts, n_count);
  return cudaGetLastError();
}

// out[i] = f32(acc[i] * 2^-k_lane), lane = i % lanes: the one rounding of
// each output; NaN for a lane with no usable scale or marked in
// acc[n + lane] (quantize's over, summed over any number of accumulators)
__global__ void __launch_bounds__(256)
dequantize(const long long* __restrict__ acc, const float* __restrict__ scale,
           float* __restrict__ out, int64_t n, int lanes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  const int lane = static_cast<int>(i % lanes);
  const float s = scale[lane];
  out[i] = lane_ok(s) && acc[n + lane] == 0
               ? static_cast<float>(static_cast<double>(acc[i]) /
                                    static_cast<double>(s))
               : __int_as_float(0x7fc00000);
}

// The dequantize pass over n outputs of `lanes` lanes, on stream s
inline cudaError_t launch_dequantize(const void* acc, const void* scale,
                                     void* out, int64_t n, int lanes,
                                     cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  if (lanes < 1) return cudaErrorInvalidValue;
  const unsigned gx = static_cast<unsigned>((n + 255) / 256);
  dequantize<<<gx, 256, 0, s>>>(static_cast<const long long*>(acc),
                                static_cast<const float*>(scale),
                                static_cast<float*>(out), n, lanes);
  return cudaGetLastError();
}

}  // namespace hist_fixed
