// The sparse (padded-ELL) worker step's two halves, for Hopper (sm_90a).
//
// No Pallas kernel lies on this path: the JAX package computes it in XLA,
// as a gather and row sum (asyncframework_tpu/ops/gradients.py:131,
// sparse_residual) and a SORTED scatter-add (:138, make_sparse_grad_sum: a
// stable argsort of the flat column ids, then .at[].add with
// indices_are_sorted).  A plain PyTorch port of the scatter would be
// index_add_ / scatter_add_, which sum with atomics on CUDA in an order that
// changes from launch to launch.  These kernels keep the reference's order
// and are bit-equal from launch to launch:
//
// ell_residual (one warp a row):
//   r_j = sum_k (vals[row_j, k] * valid_j) * w[cols[row_j, k]] - y[row_j] * valid_j
//   with row_j = idx[j] (or j), valid_j = valid[j] (or 1, and no product).
//   The sampled rows are read straight from the shard through idx, so the
//   compacted step never materialises the gathered rows.  Lane l sums
//   k = l, l + 32, ... in turn from 0, then a five-step shuffle tree adds
//   the lanes (lane l + off into lane l, off = 16, 8, 4, 2, 1);
//   ops/sparse_grad.py::ell_residual_plain repeats that order.  Optionally
//   it writes the segment sum's sort keys: keys[j*K + k] is the column of
//   an entry whose value (times valid_j) is nonzero, else d.
//
// segment_sum (two launches: bounds, a thread a column; sums, a warp a
// column):
//   g[c] = sum over the entries e with keys[i] == c, in the order of i, of
//   coeff[j] * (vals[row_j, k] * valid_j), e = perm[i] = j*K + k,
//   where keys / perm are a stable sort of the flat keys (torch.sort).
//   Each product is rounded before its add (__fmul_rn, __fadd_rn) and the
//   adds run in sorted order from 0.0f, which is the flat order within a
//   column: torch.zeros(d).index_add_(0, keys, contrib) on the CPU takes
//   the same order, and so does the reference's sorted scatter.  Entries
//   keyed d (padding: col 0, val 0; slots with valid 0; zero values) are
//   left out.  Each would add coeff * (+-0) = +-0 (for a finite coeff) to a
//   sum that starts at +0 and so is never -0: adding it changes no bit.
//   So the padding that ELL piles into column 0 costs nothing here.
//
// What bounds them: a task moves little (rcv1's compacted task: 4,752 rows x 80 of
// int32 + f32, 3 MB; the segment sum reads its 380,160 sorted keys and
// permutation, 4.6 MB), so both are bound by bytes and by the latency of
// their dependent loads (perm -> idx -> vals), not by operations.  A warp a
// column keeps every segment in one order while its 32 lanes load a round
// of up to 256 entries at once, all loads in flight before the round's
// adds; a long segment (a frequent column of real rcv1) then costs about
// one shuffle and one add an entry in its warp.  Each column finds its
// segment's end by a binary search of the sorted keys, so the cost does
// not depend on how the columns are spread (no live entry at all, or every
// entry in one column, included).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;      // ell_residual: rows (warps) a block
constexpr int kColWarps = 8;      // segment_sum: columns (warps) a block
constexpr int kRound = 8;         // segment_sum: entries a lane loads a round
constexpr int kBoundsThreads = 256;

__global__ void ell_residual_kernel(const int* __restrict__ cols,
                                    const float* __restrict__ vals,
                                    const float* __restrict__ y,
                                    const float* __restrict__ w,
                                    const long long* __restrict__ idx,
                                    const float* __restrict__ valid,
                                    long long m, int K, int d,
                                    float* __restrict__ r,
                                    int* __restrict__ keys) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long j =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (j >= m) return;  // whole warps leave together
  const long long row = idx != nullptr ? idx[j] : j;
  const float vj = valid != nullptr ? valid[j] : 1.0f;
  const int* crow = cols + row * K;
  const float* vrow = vals + row * K;
  int* krow = keys != nullptr ? keys + j * K : nullptr;
  float s = 0.0f;
  for (int k = lane; k < K; k += kWarp) {
    const int c = crow[k];
    float v = vrow[k];
    if (valid != nullptr) v = __fmul_rn(v, vj);
    s = __fadd_rn(s, __fmul_rn(v, __ldg(w + c)));
    if (krow != nullptr) krow[k] = v != 0.0f ? c : d;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
  }
  if (lane == 0) {
    const float yj = valid != nullptr ? __fmul_rn(y[row], vj) : y[row];
    r[j] = __fsub_rn(s, yj);
  }
}

// ends[c] = the number of sorted keys <= c, for c in [0, d): a binary
// search a column (neighbouring threads walk neighbouring paths, so their
// loads share lines).
__global__ void segment_bounds_kernel(const int* __restrict__ keys,
                                      long long n, int d,
                                      long long* __restrict__ ends) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  long long lo = 0, hi = n;  // the first key above c
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) <= c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  ends[c] = lo;
}

// The product of flat entry e = j*K + k; kNarrow: e < 2^31, so the split
// takes a 32-bit division.
template <bool kNarrow>
__device__ __forceinline__ float entry(long long e, int K,
                                       const float* __restrict__ vals,
                                       const long long* __restrict__ idx,
                                       const float* __restrict__ valid,
                                       const float* __restrict__ coeff) {
  long long j;
  int k;
  if (kNarrow) {
    const int j32 = static_cast<int>(e) / K;
    j = j32;
    k = static_cast<int>(e) - j32 * K;
  } else {
    j = e / K;
    k = static_cast<int>(e - j * K);
  }
  const long long row = idx != nullptr ? idx[j] : j;
  float v = vals[row * K + k];
  if (valid != nullptr) v = __fmul_rn(v, valid[j]);
  return __fmul_rn(coeff[j], v);
}

template <bool kNarrow>
__global__ void segment_sum_kernel(const long long* __restrict__ ends,
                                   const long long* __restrict__ perm,
                                   const float* __restrict__ vals,
                                   const long long* __restrict__ idx,
                                   const float* __restrict__ valid,
                                   const float* __restrict__ coeff,
                                   int K, int d, float* __restrict__ g) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int c = blockIdx.x * kColWarps + (threadIdx.x >> 5);
  if (c >= d) return;  // whole warps leave together
  const long long lo = c == 0 ? 0 : ends[c - 1];
  const long long hi = ends[c];
  float s = 0.0f;
  for (long long base = lo; base < hi; base += kWarp * kRound) {
    // lane l loads entries base + u*32 + l: all of the round's loads are in
    // flight before its first add
    float part[kRound];
    const long long left = hi - base;
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      part[u] = 0.0f;
      if (left > u * kWarp) {  // the same for the whole warp
        const long long i = base + u * kWarp + lane;
        if (i < hi) part[u] = entry<kNarrow>(perm[i], K, vals, idx, valid,
                                             coeff);
      }
    }
    // then every lane adds them alike, in order: entry base + u*32 + t is
    // lane t's part[u]
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      if (left >= (u + 1) * kWarp) {
#pragma unroll
        for (int t = 0; t < kWarp; ++t) {
          s = __fadd_rn(s, __shfl_sync(kFull, part[u], t));
        }
      } else if (left > u * kWarp) {
        const int count = static_cast<int>(left - u * kWarp);
        for (int t = 0; t < count; ++t) {
          s = __fadd_rn(s, __shfl_sync(kFull, part[u], t));
        }
      }
    }
  }
  if (lane == 0) g[c] = s;
}

}  // namespace

extern "C" {

// Enqueue ell_residual on `stream`; no synchronisation.
//   cols: (n, K) int32 in [0, d)   vals: (n, K) f32   y: (n,) f32
//   w: (d,) f32   idx: (m,) int64 in [0, n) or NULL (m == n)
//   valid: (m,) f32 or NULL   r: (m,) f32 out
//   keys: (m * K,) int32 out or NULL
// Returns the cudaError_t of the launch (0 on success).
int ell_residual_launch(const int* cols, const float* vals, const float* y,
                        const float* w, const long long* idx,
                        const float* valid, long long m, int K, int d,
                        float* r, int* keys, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return cudaSuccess;
  const long long blocks = (m + kRowWarps - 1) / kRowWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ell_residual_kernel<<<static_cast<unsigned>(blocks), kRowWarps * kWarp, 0,
                        s>>>(cols, vals, y, w, idx, valid, m, K, d, r, keys);
  return cudaGetLastError();
}

// Enqueue segment_sum (bounds, then sums) on `stream`; no synchronisation.
//   keys: (n,) int32, ascending, in [0, d]   perm: (n,) int64, entry ids
//   e = j*K + k of the sort   vals: (rows, K) f32   idx: (m,) int64 or NULL
//   valid: (m,) f32 or NULL   coeff: (m,) f32   ends: (d,) int64 scratch
//   g: (d,) f32 out
// Returns the cudaError_t of the launches (0 on success).
int segment_sum_launch(const int* keys, long long n, const long long* perm,
                       const float* vals, const long long* idx,
                       const float* valid, const float* coeff, int K, int d,
                       long long* ends, float* g, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 0) return cudaSuccess;
  const int bounds_blocks = (d + kBoundsThreads - 1) / kBoundsThreads;
  segment_bounds_kernel<<<bounds_blocks, kBoundsThreads, 0, s>>>(keys, n, d,
                                                                 ends);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int sum_blocks = (d + kColWarps - 1) / kColWarps;
  if (n <= 0x7fffffffLL) {
    segment_sum_kernel<true><<<sum_blocks, kColWarps * kWarp, 0, s>>>(
        ends, perm, vals, idx, valid, coeff, K, d, g);
  } else {
    segment_sum_kernel<false><<<sum_blocks, kColWarps * kWarp, 0, s>>>(
        ends, perm, vals, idx, valid, coeff, K, d, g);
  }
  return cudaGetLastError();
}

const char* sparse_grad_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
