// A sampled GBDT tree's row draw for Hopper (sm_90a): out[i] = w[i] * keep(c_i),
// keep(c) = jax.random.bernoulli(key, p) at element c of the stream, where
// c_i = i, or index[i] when an index is given (a sharded fit: each local row
// draws at its global row number).
//
// Replaces no Pallas kernel.  The JAX package draws the row mask with
// jax.random.bernoulli and XLA fuses the whole threefry hash into one pass;
// the port's plain route (random.bernoulli, random.bernoulli_at) runs the same
// hash as ~170 int64 torch ops over the rows, each a round trip through device
// memory.  This kernel is that function in one pass, bit for bit:
//   * the counter pair (c >> 32, c & 0xffffffff);
//   * threefry2x32 with 20 rounds under the key words (k0, k1) and the
//     schedule of random.threefry2x32 (jax._src.prng._threefry2x32_lowering),
//     rotations as funnel shifts;
//   * the element's word x0 ^ x1 (the partitionable stream);
//   * jax.random.uniform's map, f32 ((bits >> 9) | 0x3F800000) - 1, clamped
//     at 0, and the f32 compare u < p;
//   * w[i] * keep as an f32 multiply (not a select), so that a negative
//     weight that is dropped comes out -0.0, as the plain route's product.
//
// What bounds it.  It must read w and write out once (8 bytes a row: 88 MB
// at Higgs's 11M rows, 26 us at 3.35 TB/s; 16 bytes a row with an index) and
// hash every counter: 32 adds, 20 rotations and 21 xors a row, and the
// uniform's shift and or.  The shifts and logic ops run only on the integer
// ALU pipe (64 lanes an SM), the adds also on the FMA pipe (as IMAD); the
// compiled hash has 41.75 of them a row (85 LOP3 and 82 SHF for a thread's
// four rows, some xors merged into three-input LOP3s): 27 us at 11M rows at
// 1.98 GHz.  So the hash bounds it, barely, without an index; the bytes
// with one.
//
// Design.  Nothing but registers: the key words and p are kernel arguments
// (the key stays on the host, so a draw costs no copy and no sync), and a
// thread takes kPerThread rows a block-width apart, so a warp's loads and
// stores stay coalesced and the thread's independent hashes interleave.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // rows a thread takes, kThreads apart
constexpr uint32_t kParity = 0x1BD11BDAu;  // threefry's key-schedule constant

template <int R>
__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b) {
  a += b;
  b = __funnelshift_l(b, b, R) ^ a;
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& a, uint32_t& b) {
  mix<R0>(a, b);
  mix<R1>(a, b);
  mix<R2>(a, b);
  mix<R3>(a, b);
}

// x0 ^ x1 of threefry2x32((k0, k1), (c >> 32, c & 0xffffffff)); k2 is
// k0 ^ k1 ^ kParity.
__device__ __forceinline__ uint32_t stream_word(uint32_t k0, uint32_t k1,
                                                uint32_t k2, uint64_t c) {
  uint32_t a = static_cast<uint32_t>(c >> 32) + k0;
  uint32_t b = static_cast<uint32_t>(c) + k1;
  four_rounds<13, 15, 26, 6>(a, b);
  a += k1;
  b += k2 + 1u;
  four_rounds<17, 29, 16, 24>(a, b);
  a += k2;
  b += k0 + 2u;
  four_rounds<13, 15, 26, 6>(a, b);
  a += k0;
  b += k1 + 3u;
  four_rounds<17, 29, 16, 24>(a, b);
  a += k1;
  b += k2 + 4u;
  four_rounds<13, 15, 26, 6>(a, b);
  a += k2;
  b += k0 + 5u;
  return a ^ b;
}

__global__ void __launch_bounds__(kThreads)
    sample_weights(const float* __restrict__ w,
                   const int64_t* __restrict__ index, float* __restrict__ out,
                   int64_t n, uint32_t k0, uint32_t k1, float p) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * (kThreads * kPerThread) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = first + j * kThreads;
    if (i < n) {
      const uint64_t c = index ? static_cast<uint64_t>(index[i])
                               : static_cast<uint64_t>(i);
      const uint32_t bits = stream_word(k0, k1, k2, c);
      const float u =
          fmaxf(__uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f, 0.0f);
      out[i] = w[i] * (u < p ? 1.0f : 0.0f);
    }
  }
}

}  // namespace

extern "C" {

// w, out: f32 [n]; index: int64 [n] (each row's element of the stream), or
// null for element i at row i; (k0, k1): the key's two 32-bit words; p: the
// keep probability as f32.  Launches on `stream`, does not synchronise, and
// returns the first CUDA error (0 on success; nothing is launched for n = 0).
int dmlc_threefry_sample_weights(const void* w, const void* index, void* out,
                                 long long n, unsigned k0, unsigned k1,
                                 float p, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long per_block = kThreads * kPerThread;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sample_weights<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const int64_t*>(index),
      static_cast<float*>(out), n, k0, k1, p);
  return static_cast<int>(cudaGetLastError());
}

const char* dmlc_threefry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
