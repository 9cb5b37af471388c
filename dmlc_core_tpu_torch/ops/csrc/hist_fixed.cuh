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
// integer exactly (the scheme of XGBoost's GPU hist).
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

// out[i] = f32(acc[i] * 2^-k_lane): the one rounding of each bin; NaN for
// a lane with no usable scale or marked in acc[n + lane] (quantize's over)
__global__ void __launch_bounds__(256)
dequantize(const long long* __restrict__ acc, const float* __restrict__ scale,
           float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  const float s = scale[i & 1];
  out[i] = lane_ok(s) && acc[n + (i & 1)] == 0
               ? static_cast<float>(static_cast<double>(acc[i]) /
                                    static_cast<double>(s))
               : __int_as_float(0x7fc00000);
}

}  // namespace hist_fixed
