// Masked least-squares / logistic gradient sum on Hopper:
//
//     g = X^T (mask * (f(X w) - y)),   f = identity or sigmoid
//
// over the full shard (row i of the sum is X[i]) or over a compacted index
// list (row i is X[idx[i]], with no gathered copy of X).  Two more forms
// serve ASAGA (asyncframework_tpu/ops/gradients.py:99-123, ops/steps.py:
// 165-182,218-237), full shard only:
//
//   saga:     diff_i = x_i w - y_i for every row (written out), and
//             g = X^T (mask * (diff - alpha))
//   xt_coeff: g = X^T c  (the history table delta, c given)
//
// Replaces the Pallas TPU kernel
// asyncframework_tpu/ops/pallas_kernels.py::_fused_masked_grad_padded
// (pallas_call at :58, body _grad_kernel :41-52), and is the ASGD worker
// step's whole contraction (asyncframework_tpu/ops/gradients.py:52-62).
//
// Bound on an H100 SXM (80 GB, 3.35 TB/s): 4 flops per element of X against
// 4 bytes (f32) or 2 bytes (bf16) read, i.e. 1-2 flop/byte, far below the
// card's ridge point, so the kernel is bound by HBM bytes: at least
// bytes(rows of X read) / 3.35 TB/s.  The design therefore reads each row
// of X from HBM once:
//
//   * Stage 1 (masked_grad_partial): a persistent grid of 2 blocks per SM.
//     A block walks row tiles of kTileRows rows (one row per warp).  Phase A:
//     each warp computes its row's dot product with f32 accumulation and
//     writes the row coefficient c_i = mask_i * (f(x_i w) - y_i) to shared
//     memory.  Phase B: the block's threads stride over the columns and add
//     sum_i c_i x_ij for the tile into the block's accumulator row.  The
//     tile was just read in phase A, and all tiles in flight over the card
//     (2 * 132 blocks * 16 rows) fit the 50 MB L2, so phase B's re-read is
//     served from L2, not HBM.  The accumulator row lives in shared memory
//     (global memory when d is too wide for it) and ends as the block's row
//     of a (blocks, d) scratch tensor.
//   * Stage 2 (reduce_partials): g_j = sum over blocks of the scratch rows,
//     in fixed block order.
//
// No atomics anywhere, so two launches on the same inputs are bit-equal.
//
// bf16 contract (asyncframework_tpu/ops/gradients.py:32-43 mm_f32): w is
// rounded to bf16 before the first product and c_i is rounded to bf16
// before the X^T product; both products accumulate in f32.  For f32 X both
// roundings are the identity.  The xt_coeff form is a plain X^T c in the
// JAX package (steps.py:232-235), where jnp promotes a bf16 X to f32: c is
// NOT rounded there, and not here.  Each form reads X from HBM once, so
// each is bound by X's bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = kWarps;  // one row per warp per tile
// widest accumulator row kept in shared memory; wider rows accumulate in
// the block's global scratch row instead
constexpr long long kMaxSmemAccBytes = 200 * 1024;
constexpr int kReduceCols = 32;
constexpr int kReduceRows = 16;

// what phase A makes of a row (the C interface's `mode`)
enum Mode : int {
  kLeastSquares = 0,  // c_i = mask_i * (x_i w - y_i)
  kLogistic = 1,      // c_i = mask_i * (sigmoid(x_i w) - y_i)
  kSaga = 2,          // diff_i = x_i w - y_i;  c_i = mask_i * (diff_i - alpha_i)
  kXtCoeff = 3,       // c_i = mask_i, with no product and no rounding
};

// V consecutive elements of a row, widened to f32.  V > 1 needs the address
// aligned to 16 bytes (checked by the host wrapper).
template <typename T, int V>
struct Loader;

template <>
struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[1]) {
    o[0] = *p;
  }
};

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

template <>
struct Loader<float, 8> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = a.z;
    o[3] = a.w;
    o[4] = b.x;
    o[5] = b.y;
    o[6] = b.z;
    o[7] = b.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[1]) {
    o[0] = __bfloat162float(*p);
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  }
};

// Round an f32 value to X's storage type and back (mm_f32's cast of the
// vector operand); the identity for f32 X.
template <typename T>
__device__ __forceinline__ float round_like(float v);

template <>
__device__ __forceinline__ float round_like<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    masked_grad_partial(const T* __restrict__ X, long long n, long long d,
                        const float* __restrict__ y,
                        const float* __restrict__ w,
                        const float* __restrict__ mask,
                        const long long* __restrict__ idx, long long m,
                        int mode, const float* __restrict__ alpha,
                        float* __restrict__ diff_out, int acc_in_smem,
                        float* __restrict__ partial) {
  extern __shared__ float smem_acc[];
  __shared__ float s_coef[kTileRows];
  __shared__ long long s_row[kTileRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* acc = acc_in_smem ? smem_acc : partial + (long long)blockIdx.x * d;
  for (long long j = tid; j < d; j += kThreads) acc[j] = 0.f;

  const long long dv = d / V;  // d % V == 0 whenever V > 1
  const long long tiles = (m + kTileRows - 1) / kTileRows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    // ---- phase A: row coefficients, one warp per row.  A slot past m or
    // an index outside the shard gets row -1 and contributes nothing.
    const long long i = t * kTileRows + warp;
    long long row = -1;
    if (i < m) {
      const long long r = idx != nullptr ? idx[i] : i;
      if (r >= 0 && r < n) row = r;
    }
    float coef = 0.f;
    if (row >= 0 && mode == kXtCoeff) {
      coef = mask[i];
    } else if (row >= 0) {
      const T* xr = X + row * d;
      float dot = 0.f;
      // unrolled so several 16-byte loads per lane are in flight at once
#pragma unroll 4
      for (long long c = lane; c < dv; c += 32) {
        float xv[V];
        float wv[V];
        Loader<T, V>::load(xr + c * V, xv);
        Loader<float, V>::load(w + c * V, wv);
#pragma unroll
        for (int k = 0; k < V; ++k) dot = fmaf(xv[k], round_like<T>(wv[k]), dot);
      }
      dot = warp_sum(dot);
      const float wt = mask != nullptr ? mask[i] : 1.f;
      if (mode == kSaga) {
        const float diff = dot - y[row];
        if (lane == 0) diff_out[row] = diff;
        coef = round_like<T>(wt * (diff - alpha[row]));
      } else {
        const float f = mode == kLogistic ? 1.f / (1.f + expf(-dot)) : dot;
        coef = round_like<T>(wt * (f - y[row]));
      }
    }
    if (lane == 0) {
      s_coef[warp] = coef;
      s_row[warp] = row;
    }
    __syncthreads();

    // ---- phase B: acc_j += sum over the tile's rows of c_i x_ij
    const long long left = m - t * kTileRows;
    const int rows = left < kTileRows ? (int)left : kTileRows;
    for (long long c = tid; c < dv; c += kThreads) {
      float a[V];
#pragma unroll
      for (int k = 0; k < V; ++k) a[k] = acc[c * V + k];
      for (int r = 0; r < rows; ++r) {
        const long long rr = s_row[r];
        if (rr < 0) continue;
        const float cf = s_coef[r];
        float xv[V];
        Loader<T, V>::load(X + rr * d + c * V, xv);
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = fmaf(cf, xv[k], a[k]);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) acc[c * V + k] = a[k];
    }
    __syncthreads();
  }
  if (acc_in_smem) {
    float* out = partial + (long long)blockIdx.x * d;
    for (long long j = tid; j < d; j += kThreads) out[j] = acc[j];
  }
}

// g_j = sum_b partial[b, j] in fixed order: thread (x, y) sums blocks
// y, y + kReduceRows, ... of column x; the kReduceRows sums are then added
// in y order.
__global__ void __launch_bounds__(kReduceCols* kReduceRows)
    reduce_partials(const float* __restrict__ partial, int nblocks,
                    long long d, float* __restrict__ g) {
  __shared__ float s[kReduceRows][kReduceCols];
  const long long j = (long long)blockIdx.x * kReduceCols + threadIdx.x;
  float v = 0.f;
  if (j < d) {
    for (int b = threadIdx.y; b < nblocks; b += kReduceRows) {
      v += partial[(long long)b * d + j];
    }
  }
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && j < d) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kReduceRows; ++r) total += s[r][threadIdx.x];
    g[j] = total;
  }
}

template <typename T, int V>
cudaError_t launch_partial(const void* X, long long n, long long d,
                           const float* y, const float* w, const float* mask,
                           const long long* idx, long long m, int mode,
                           const float* alpha, float* diff, float* partial,
                           int nblocks, cudaStream_t stream) {
  const long long acc_bytes = d * (long long)sizeof(float);
  const int in_smem = acc_bytes <= kMaxSmemAccBytes;
  const size_t smem = in_smem ? (size_t)acc_bytes : 0;
  auto kernel = masked_grad_partial<T, V>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<nblocks, kThreads, smem, stream>>>(
      static_cast<const T*>(X), n, d, y, w, mask, idx, m, mode, alpha, diff,
      in_smem, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of X one stage-1 tile covers (the host sizes the grid from it).
int masked_grad_tile_rows(void) { return kTileRows; }

// Enqueue one form of the contraction on `stream`; no synchronisation.
//   X: (n, d) row-major, f32 (x_is_bf16 = 0) or bf16 (1)
//   mode 0 / 1 (least squares / logistic): g = X^T (mask * (f(X w) - y))
//     y: (n,) f32   w: (d,) f32   mask: (m,) f32 or NULL (all ones)
//     idx: (m,) int64 or NULL (m == n, row i is X[i])
//   mode 2 (saga, idx NULL, m == n): also alpha (n,) f32 and diff (n,) f32,
//     diff_i = x_i w - y_i, g = X^T (mask * (diff - alpha))
//   mode 3 (xt_coeff, idx NULL, m == n): g = X^T mask (y, w unused)
//   vec: 1 when d and the X / w addresses allow 16-byte loads, else 0
//   partial: (nblocks, d) f32 scratch   g: (d,) f32 output
// Returns the cudaError_t of the launches (0 on success).
int masked_grad_launch(const void* X, int x_is_bf16, long long n, long long d,
                       const float* y, const float* w, const float* mask,
                       const long long* idx, long long m, int mode,
                       const float* alpha, float* diff, int vec,
                       float* partial, int nblocks, float* g, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode < kLeastSquares || mode > kXtCoeff) return cudaErrorInvalidValue;
  if (mode >= kSaga && (idx != nullptr || m != n)) return cudaErrorInvalidValue;
  if (d == 0) return cudaSuccess;
  if (m == 0) nblocks = 0;
  if (nblocks > 0) {
    cudaError_t e;
    if (x_is_bf16) {
      e = vec ? launch_partial<__nv_bfloat16, 8>(X, n, d, y, w, mask, idx, m,
                                                 mode, alpha, diff, partial,
                                                 nblocks, s)
              : launch_partial<__nv_bfloat16, 1>(X, n, d, y, w, mask, idx, m,
                                                 mode, alpha, diff, partial,
                                                 nblocks, s);
    } else {
      e = vec ? launch_partial<float, 4>(X, n, d, y, w, mask, idx, m, mode,
                                         alpha, diff, partial, nblocks, s)
              : launch_partial<float, 1>(X, n, d, y, w, mask, idx, m, mode,
                                         alpha, diff, partial, nblocks, s);
    }
    if (e != cudaSuccess) return e;
  }
  const dim3 block(kReduceCols, kReduceRows);
  const unsigned grid = (unsigned)((d + kReduceCols - 1) / kReduceCols);
  reduce_partials<<<grid, block, 0, s>>>(partial, nblocks, d, g);
  return cudaGetLastError();
}

const char* masked_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
