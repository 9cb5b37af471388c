// Dense GBDT routing for Hopper (sm_90a): each row's node, walked down one
// or more levels of a fixed-depth tree.  For each level walked a row reads its
// node's (feature f, threshold t, default direction d), then its one code
// b = bins[row, f], goes right when b > t (under missing_aware, when b == 0:
// right iff d == 1), and takes the child 2 node + right.  The result is each
// row's node in the level below the last one walked.
//
// Replaces no Pallas kernel.  The JAX package routes in jnp
// (dmlc_core_tpu/models/gbdt.py:1387-1404, and the same rule in its training
// loop), which XLA fuses into one pass over the rows.  The port's plain route
// (ops/route.py, route_dense_plain) is 9 torch ops a level, each a round trip
// through device memory: ~1.2 GB a level at Higgs's 11M rows x 28 uint8 codes.
//
// What bounds it.  A row's node is read (4 bytes; nothing when the walk starts
// at the root) and written (4 bytes) once, and each level reads the one
// 32-byte sector of the row's codes that holds its split feature's code, or
// the whole row where that is shorter: at 11M x 28 uint8 codes, one level,
// 11M x (4 + 4 + 28) B = 396 MB, 0.118 ms at 3.35 TB/s.  The compares are a
// few integer operations a row and level, far below the bytes.
//
// Design.  The split tables of the levels walked (heap order from the first
// level's first node: at most 63 entries for a depth-6 tree) sit in shared
// memory, loaded once a block, so a row's node costs no device-memory read.
// A thread takes kRows consecutive rows: their nodes are read and written as
// one 16-byte vector where both arrays are 16-byte aligned, and their code
// loads are independent, so each thread keeps kRows loads in flight at every
// level.  Row offsets are 64-bit.  A feature out of range is clamped into
// [0, F) and a node into its level (a negative one counts as past the end),
// so a malformed forest or node array never reads outside an array.  The
// launch allocates nothing and does not synchronise, so it can be captured in
// a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // consecutive rows a thread takes: one int4 of nodes
// table entries up to which the tables sit in shared memory (3 int32 arrays:
// 48 KiB, the most a block takes without opting in); deeper tables are read
// from device memory through the read-only cache
constexpr int kSharedEntries = 4096;

template <typename Code, bool kMissing, bool kShared>
__global__ void __launch_bounds__(kThreads)
    route_dense(const Code* __restrict__ bins, int64_t rows, int num_features,
                const int32_t* rel, int32_t* out,
                const int32_t* __restrict__ feature,
                const int32_t* __restrict__ threshold,
                const int32_t* __restrict__ default_right, int first,
                int levels, int entries, bool vec) {
  extern __shared__ int32_t table[];
  const int32_t* tf = feature;
  const int32_t* tt = threshold;
  const int32_t* td = default_right;
  if (kShared) {
    for (int i = threadIdx.x; i < entries; i += kThreads) {
      table[i] = feature[i];
      table[entries + i] = threshold[i];
      if (kMissing) table[2 * entries + i] = default_right[i];
    }
    __syncthreads();
    tf = table;
    tt = table + entries;
    td = table + 2 * entries;
  }
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kRows;
  if (r0 >= rows) return;
  const int n = rows - r0 < kRows ? static_cast<int>(rows - r0) : kRows;
  uint32_t node[kRows];
  if (rel == nullptr) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) node[j] = 0;
  } else if (vec && n == kRows) {
    const int4 v = *reinterpret_cast<const int4*>(rel + r0);
    node[0] = v.x;
    node[1] = v.y;
    node[2] = v.z;
    node[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j) node[j] = j < n ? rel[r0 + j] : 0;
  }
  const Code* row = bins + r0 * num_features;
  uint32_t width = 1u << first;  // nodes in the level being walked
  uint32_t base = 0;             // its first node's table entry
  for (int lv = 0; lv < levels; ++lv) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < n) {
        const uint32_t t = base + min(node[j], width - 1);
        const int f = min(max(tf[t], 0), num_features - 1);
        const int32_t b = static_cast<int32_t>(row[j * num_features + f]);
        bool right = b > tt[t];
        if (kMissing && b == 0) right = td[t] == 1;
        node[j] = 2 * node[j] + (right ? 1u : 0u);
      }
    }
    base += width;
    width <<= 1;
  }
  if (vec && n == kRows) {
    *reinterpret_cast<int4*>(out + r0) =
        make_int4(node[0], node[1], node[2], node[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (j < n) out[r0 + j] = node[j];
  }
}

struct Args {
  const void* bins;
  int64_t rows;
  int num_features;
  const void* rel;
  void* out;
  const void* feature;
  const void* threshold;
  const void* default_right;
  int first, levels, entries;
  bool vec;
};

template <typename Code, bool kMissing, bool kShared>
void launch(const Args& a, unsigned blocks, cudaStream_t stream) {
  const size_t smem =
      kShared ? static_cast<size_t>(kMissing ? 3 : 2) * a.entries * 4 : 0;
  route_dense<Code, kMissing, kShared><<<blocks, kThreads, smem, stream>>>(
      static_cast<const Code*>(a.bins), a.rows, a.num_features,
      static_cast<const int32_t*>(a.rel), static_cast<int32_t*>(a.out),
      static_cast<const int32_t*>(a.feature),
      static_cast<const int32_t*>(a.threshold),
      static_cast<const int32_t*>(a.default_right), a.first, a.levels,
      a.entries, a.vec);
}

template <typename Code>
void launch_code(bool missing, bool shared, const Args& a, unsigned blocks,
                 cudaStream_t stream) {
  if (missing) {
    if (shared)
      launch<Code, true, true>(a, blocks, stream);
    else
      launch<Code, true, false>(a, blocks, stream);
  } else if (shared) {
    launch<Code, false, true>(a, blocks, stream);
  } else {
    launch<Code, false, false>(a, blocks, stream);
  }
}

}  // namespace

extern "C" {

// bins: uint8 (code_bytes 1) or int32 (4) codes [rows, num_features],
// row-major; rel: int32 [rows], each row's node in level `first` (null: every
// row at node 0); out: int32 [rows], each row's node in level first + levels
// (may be rel itself); feature, threshold, default_right: int32 tables in heap
// order from level first's node 0, ((1 << levels) - 1) << first entries
// (default_right is read only under missing_aware).  Launches on `stream`,
// does not synchronise, and returns the first CUDA error (0 on success;
// nothing is launched for no rows).
int dmlc_route_dense(const void* bins, int code_bytes, long long rows,
                     int num_features, const void* rel, void* out,
                     const void* feature, const void* threshold,
                     const void* default_right, int first, int levels,
                     int missing_aware, void* stream) {
  if (rows < 0 || first < 0 || levels < 0 || first + levels > 30 ||
      (code_bytes != 1 && code_bytes != 4) ||
      (rows > 0 && num_features < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int entries = ((1 << levels) - 1) << first;
  const long long per_block = kThreads * kRows;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{bins, rows, num_features, rel, out, feature, threshold,
               default_right, first, levels, entries,
               ((reinterpret_cast<uintptr_t>(rel) |
                 reinterpret_cast<uintptr_t>(out)) & 15) == 0};
  const bool shared = entries <= kSharedEntries;
  const auto s = static_cast<cudaStream_t>(stream);
  if (code_bytes == 1)
    launch_code<uint8_t>(missing_aware != 0, shared, a,
                         static_cast<unsigned>(blocks), s);
  else
    launch_code<int32_t>(missing_aware != 0, shared, a,
                         static_cast<unsigned>(blocks), s);
  return static_cast<int>(cudaGetLastError());
}

const char* dmlc_route_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
