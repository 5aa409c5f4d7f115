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
// bytes(rows of X read) / 3.35 TB/s.  Both routes read each row of X from
// HBM once.  The host picks the route by shape and dtype
// (ops/masked_grad.py::launch_plan):
//
// Staged route (masked_grad_staged; rows of 16-byte multiples, d / V <= 512
// column lanes): one cooperative launch of one persistent block an SM.  A
// producer warp copies rows, one 1-D bulk copy a row keyed on idx, into a
// ring of `stages` x `rows` rows of shared memory, with cp.async copies of
// each row's scalars (y, alpha, weight); a stage completes on its "full"
// mbarrier and is handed back on its "empty" one.  Sixteen consumer warps
// take a stage's 16-byte pieces into registers (groups of whole warps hold
// whole rows, one piece a thread), then: phase A, the row dot products, a
// warp's rows summed together by a 9-shuffle exchange, then over the
// group's warps, forming c_i; the stage goes back to the producer; phase B
// folds c_i x_ij into register accumulators.  Shared memory is read once
// and X leaves HBM once.  The slots are cut into chunks of whole stages,
// shrinking round by round; each block runs chunk b, then claims chunks
// from a counter, so SMs that stream faster take more (on an H100 some SMs
// stream a third slower than others under full load), and each chunk's
// sum is a row of a scratch tensor.  After a grid barrier every block sums
// a slice of columns over the chunks, in chunk order, straight into g:
// the result does not depend on which block ran which chunk.
//
// Tiled route (masked_grad_partial + reduce_partials; every launch the
// staged route does not take: unaligned or wider rows, small inputs): two
// launches.
//   * Stage 1: a persistent grid of 2 blocks per SM.  A block walks row
//     tiles of kTileRows rows (one row per warp).  Phase A: each warp
//     computes its row's dot product with f32 accumulation and writes the
//     row coefficient c_i = mask_i * (f(x_i w) - y_i) to shared memory.
//     Phase B: the block's threads stride over the columns and add
//     sum_i c_i x_ij for the tile into the block's accumulator row.  The
//     tile was just read in phase A, and all tiles in flight over the card
//     (2 * 132 blocks * 16 rows) fit the 50 MB L2, so phase B's re-read is
//     served from L2, not HBM.  The accumulator row lives in shared memory
//     (global memory when d is too wide for it) and ends as the block's row
//     of a (blocks, d) scratch tensor.
//   * Stage 2 (reduce_partials): g_j = sum over blocks of the scratch rows,
//     in fixed block order.
//
// No atomics on values anywhere (the one atomic is the staged route's
// chunk counter), so two launches on the same inputs are bit-equal.
//
// bf16 contract (asyncframework_tpu/ops/gradients.py:32-43 mm_f32): w is
// rounded to bf16 before the first product and c_i is rounded to bf16
// before the X^T product; both products accumulate in f32.  For f32 X both
// roundings are the identity.  The xt_coeff form is a plain X^T c in the
// JAX package (steps.py:232-235), where jnp promotes a bf16 X to f32: c is
// NOT rounded there, and not here.  A slot whose index lies outside
// [0, n) contributes nothing; every other slot is read and multiplied, a
// weight of 0 included (0 * a non-finite row stays NaN, as in the plain
// version).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// The V elements of X in 16 bytes, widened to f32.
template <typename T, int V>
struct Unpack;

template <>
struct Unpack<float, 4> {
  static __device__ __forceinline__ void unpack(const uint4& r, float (&o)[4]) {
    o[0] = __uint_as_float(r.x);
    o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z);
    o[3] = __uint_as_float(r.w);
  }
};

template <>
struct Unpack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void unpack(const uint4& r, float (&o)[8]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[2 * k] = __uint_as_float(u[k] << 16);
      o[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
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

// ------------------------------------------------------------ staged route

constexpr int kConsumerWarps = 16;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kStagedThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxStageRows = 32;                 // one producer lane a row
constexpr int kMaxGroupRows = 8;                  // a group's rows a stage
constexpr int kSumFloats = kConsumers;            // g's sums: cols x parts
constexpr int kSumBatch = 16;                     // loads in flight a part
constexpr int kMaxRounds = 48;                    // rounds of chunks
constexpr int kConsumerBarrier = 1;                // named barrier id

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0u;
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts any copy by orders of magnitude is a fault: trap (the launch
// then fails with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long k = 0; !mbar_try(bar, parity); ++k) {
    if (k > (1ll << 28)) __trap();
  }
}

// One row of X (`bytes`, a multiple of 16) into shared memory, completing
// on `bar`'s transaction count.
__device__ __forceinline__ void bulk_row(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// 4 bytes from global to shared memory, asynchronously (cp.async).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// One arrival on `bar` once every earlier cp.async of this thread has
// landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBarrier), "n"(kConsumers)
               : "memory");
}

// Dynamic shared memory of the staged route, in this order: the ring
// (stages x rows rows of X), each ring slot's row number (int64, -1 for a
// slot that reads nothing), the full and empty mbarriers (one each a
// stage), four f32 a slot (its coefficient, y and alpha of its row, its
// weight), two int a stage (its chunk, -1 for the last stage a block runs,
// and its rows), and, with more than one row group, the groups' sums of a
// chunk (groups x d f32).  The host's plan
// (ops/masked_grad.py::staged_geometry) sizes it with the same sum.
__host__ __device__ inline long long staged_smem_bytes(long long d, int es,
                                                       int stages, int rows,
                                                       int groups) {
  const long long slots = (long long)stages * rows;
  return slots * d * es + 8 * slots + 16LL * stages + 16 * slots +
         8LL * stages + (groups > 1 ? 4LL * groups * d : 0);
}

// Sum each of kMaxGroupRows values over the warp: on return lane l holds
// the sum of value l / 4 in v[0].  Three halving exchanges (xor 16, 8, 4)
// leave each lane one value, two more sum it over its four lanes: 9
// shuffles where 8 separate sums would take 40.  The order is fixed.
__device__ __forceinline__ void warp_sum_rows(float (&v)[kMaxGroupRows],
                                              int lane) {
#pragma unroll
  for (int h = kMaxGroupRows / 2, bit = 16; h >= 1; h /= 2, bit /= 2) {
    const bool upper = (lane & bit) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// The slots are cut into chunks of whole ring stages, in rounds of up to
// one chunk a block that shrink: round r has take[r] chunks of size[r]
// stages (the host's plan, ops/masked_grad.py::chunk_rounds: each round's
// chunks hold half the stages still left, shared over the blocks, at least
// one), and the last chunk is cut at m.  Each chunk's sum sum_i c_i x_i is
// one row of `partial`, whichever block ran it, and g sums those rows in
// chunk order, so the result does not depend on which block took which
// chunk.  Block b runs chunk b, then claims the next from `counter` (zero
// at launch, set back to zero at the end): an SM that streams faster takes
// more chunks, and the small last rounds even out the finish.  The host
// keeps one counter a stream, so launches that share one never overlap.
struct Rounds {
  int n;
  int size[kMaxRounds];
  int take[kMaxRounds];
};

// Chunk c's slots [*lo, return value); c < the rounds' chunks.
__device__ __forceinline__ long long chunk_slots(const Rounds& rd, long long c,
                                                 int rows, long long m,
                                                 long long* lo) {
  long long start = 0;
  for (int r = 0; r < rd.n; ++r) {
    if (c < rd.take[r]) {
      start += c * rd.size[r];
      *lo = start * rows;
      const long long hi = (start + rd.size[r]) * rows;
      return hi < m ? hi : m;
    }
    start += (long long)rd.take[r] * rd.size[r];
    c -= rd.take[r];
  }
  *lo = 0;
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kStagedThreads, 1)
    masked_grad_staged(const T* __restrict__ X, long long n, long long d,
                       const float* __restrict__ y,
                       const float* __restrict__ w,
                       const float* __restrict__ mask,
                       const long long* __restrict__ idx, long long m,
                       int mode, const float* __restrict__ alpha,
                       float* __restrict__ diff_out, int stages, int rows,
                       int groups, const __grid_constant__ Rounds rounds,
                       int nchunks, int* __restrict__ counter,
                       float* __restrict__ partial,
                       float* __restrict__ g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_red[kSumFloats];
  constexpr int V = 16 / sizeof(T);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t row_bytes = (uint32_t)(d * (long long)sizeof(T));
  const int slots = stages * rows;
  unsigned char* ring = smem;
  long long* s_row =
      reinterpret_cast<long long*>(smem + (long long)slots * row_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_row + slots);
  uint64_t* empty = full + stages;
  float* s_coef = reinterpret_cast<float*>(empty + stages);
  float* s_y = s_coef + slots;
  float* s_alpha = s_y + slots;
  float* s_wt = s_alpha + slots;
  int* s_meta = reinterpret_cast<int*>(s_wt + slots);  // (chunk, rows) a stage
  float* s_groups = reinterpret_cast<float*>(s_meta + 2 * stages);

  const long long nb = gridDim.x;
  const long long b = blockIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // a stage is full after the producer's arrival with the bytes it
      // expects and each producer lane's cp.async arrival
      mbar_init(smem_u32(&full[s]), 1 + 32);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: each chunk's slots in order, `rows` a stage, lane r
    // for slot r of a stage: one bulk copy a row, keyed on idx, and
    // cp.async copies of the slot's scalars (its weight, y and alpha of its
    // row), which arrive on the stage's full barrier as they land.  A slot
    // past the chunk or outside [0, n) issues no copy and is not in the
    // stage's transaction count.  After the last chunk, one stage of chunk
    // -1 tells the consumers to stop.  The index is read 32 slots at a time
    // (lane j holds slot w0 + j of three windows), and the next chunk's
    // number and first windows are read while a chunk runs, so no load
    // waits in front of a copy.
    auto window = [&](long long w0, long long hi) -> long long {
      const long long slot = w0 + lane;
      if (slot >= hi) return -1;
      return idx != nullptr ? idx[slot] : slot;
    };
    auto bounds = [&](long long c, long long* lo) -> long long {
      *lo = 0;
      return c < nchunks ? chunk_slots(rounds, c, rows, m, lo) : 0;
    };
    long long cur = b, first, nfirst = 0;
    long long hi = bounds(b, &first), w0 = first;
    long long win0 = window(w0, hi), win1 = window(w0 + 32, hi),
              win2 = window(w0 + 64, hi);
    // the chunk after this one is claimed as its last stage but one goes
    // out, and read a stage later, with its first windows (at once for a
    // one-stage chunk)
    int claim = 0;
    bool claimed = false, have_next = false;
    long long nxt = 0, nhi = 0, pre0 = -1, pre1 = -1, pre2 = -1;
    for (long long k = 0;; ++k) {
      if (cur < nchunks && first >= hi) {  // on to the next chunk
        if (!have_next) {
          nxt = nb + __shfl_sync(0xffffffffu, claim, 0);
          nhi = bounds(nxt, &nfirst);
          pre0 = window(nfirst, nhi);
          pre1 = window(nfirst + 32, nhi);
          pre2 = window(nfirst + 64, nhi);
        }
        cur = nxt;
        first = w0 = nfirst;
        hi = nhi;
        win0 = pre0;
        win1 = pre1;
        win2 = pre2;
        claimed = have_next = false;
      }
      const bool done = cur >= nchunks;
      if (!done && first >= w0 + 32) {  // rows <= 32: one window a stage
        w0 += 32;
        win0 = win1;
        win1 = win2;
        win2 = window(w0 + 64, hi);
      }
      const int off = (int)(first - w0) + lane;  // < 64 for lane < rows
      const long long r0 = __shfl_sync(0xffffffffu, win0, off & 31);
      const long long r1 = __shfl_sync(0xffffffffu, win1, off & 31);
      const long long raw = off < 32 ? r0 : r1;
      const long long slot = first + lane;
      const long long row = !done && lane < rows && slot < hi && raw >= 0 &&
                                    raw < n
                                ? raw
                                : -1;
      const int s = (int)(k % stages);
      const uint32_t lap = (uint32_t)(k / stages);
      const int at = s * rows + lane;
      const uint32_t bar = smem_u32(&full[s]);
      mbar_wait(smem_u32(&empty[s]), (lap & 1u) ^ 1u);
      if (lane < rows) {
        s_row[at] = row;
        if (mask == nullptr) s_wt[at] = 1.f;
      }
      if (lane == 0) {
        s_meta[2 * s] = done ? -1 : (int)cur;
        s_meta[2 * s + 1] = done ? 0 : (int)(hi - first < rows ? hi - first : rows);
      }
      const unsigned valid = __ballot_sync(0xffffffffu, row >= 0);
      __syncwarp();
      if (lane == 0) mbar_expect_tx(bar, (uint32_t)__popc(valid) * row_bytes);
      __syncwarp();
      if (row >= 0) {
        bulk_row(smem_u32(ring + (long long)at * row_bytes),
                 reinterpret_cast<const unsigned char*>(X) +
                     row * (long long)row_bytes,
                 row_bytes, bar);
        if (mask != nullptr) cp_async4(smem_u32(&s_wt[at]), mask + slot);
        if (mode != kXtCoeff) cp_async4(smem_u32(&s_y[at]), y + row);
        if (mode == kSaga) cp_async4(smem_u32(&s_alpha[at]), alpha + row);
      }
      cp_async_arrive(bar);
      if (done) break;
      first += rows;
      if (claimed && !have_next) {
        // the chunk after this one, and its first windows
        nxt = nb + __shfl_sync(0xffffffffu, claim, 0);
        nhi = bounds(nxt, &nfirst);
        pre0 = window(nfirst, nhi);
        pre1 = window(nfirst + 32, nhi);
        pre2 = window(nfirst + 64, nhi);
        have_next = true;
      }
      if (!claimed && hi - first <= rows) {
        claim = lane == 0 ? atomicAdd(counter, 1) : 0;
        claimed = true;
      }
    }
  } else {
    // ---- consumers: thread (grp, col) holds columns [col V, col V + V) of
    // rows grp, grp + groups, ... of each stage; a group is `pad` threads,
    // a whole number of warps.  A stage: the rows' 16-byte pieces into
    // registers (the stage's only shared-memory read of X); phase A, each
    // thread's partial dot products, summed over the warp, then over the
    // group's warps by shuffles, and the coefficients formed; the stage goes
    // back to the producer; phase B folds c_i x_ij into registers.  At the
    // end of a chunk the groups' sums go, in group order, to its row of
    // `partial`.
    const long long lanes = d / V;
    const int pad = (int)((lanes + 31) / 32 * 32);
    const int wg = pad / 32;  // warps a group
    const int grp = tid / pad;
    const int col = tid - grp * pad;
    const int kg = rows / groups;  // a group's rows a stage
    const bool active = grp < groups && col < lanes;
    float wv[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      wv[q] = active && w != nullptr ? round_like<T>(w[col * V + q]) : 0.f;
    }
    float acc[V];
    float* s_part = s_red;  // (rows, wg) warp sums; free until the end
    long long cur = -1;
    for (long long k = 0;; ++k) {
      const int s = (int)(k % stages);
      const uint32_t lap = (uint32_t)(k / stages);
      mbar_wait(smem_u32(&full[s]), lap & 1u);
      const int chunk = s_meta[2 * s];
      const int here = s_meta[2 * s + 1];
      if (chunk != cur) {
        if (cur >= 0 && groups == 1) {
          if (active) {
            float4* o = reinterpret_cast<float4*>(partial + cur * d + col * V);
#pragma unroll
            for (int q = 0; q < V / 4; ++q) {
              o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                                 acc[4 * q + 3]);
            }
          }
        } else if (cur >= 0) {
          consumer_sync();
          if (active) {
#pragma unroll
            for (int q = 0; q < V; ++q) s_groups[grp * d + col * V + q] = acc[q];
          }
          consumer_sync();
          for (long long j = tid; j < d; j += kConsumers) {
            float p = 0.f;
            for (int q = 0; q < groups; ++q) p += s_groups[q * d + j];
            partial[cur * d + j] = p;
          }
        }
        cur = chunk;
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = 0.f;
      }
      if (chunk < 0) break;
      const unsigned char* st = ring + (long long)s * rows * row_bytes;
      uint4 xr[kMaxGroupRows];
      unsigned valid = 0;
#pragma unroll
      for (int i = 0; i < kMaxGroupRows; ++i) {
        const int r = grp + i * groups;
        xr[i] = make_uint4(0u, 0u, 0u, 0u);
        if (active && i < kg && r < here && s_row[s * rows + r] >= 0) {
          xr[i] = *reinterpret_cast<const uint4*>(
              st + (long long)r * row_bytes + (long long)col * 16);
          valid |= 1u << i;
        }
      }
      float cf[kMaxGroupRows];
      if (mode == kXtCoeff) {
#pragma unroll
        for (int i = 0; i < kMaxGroupRows; ++i) {
          cf[i] = (valid >> i & 1u) ? s_wt[s * rows + grp + i * groups] : 0.f;
        }
      } else {
        // phase A
        float part[kMaxGroupRows];
#pragma unroll
        for (int i = 0; i < kMaxGroupRows; ++i) {
          float xv[V];
          Unpack<T, V>::unpack(xr[i], xv);
          float p = 0.f;
#pragma unroll
          for (int q = 0; q < V; ++q) p = fmaf(xv[q], wv[q], p);
          part[i] = p;
        }
        warp_sum_rows(part, lane);
        const int i = lane >> 2;
        if ((lane & 3) == 0 && grp < groups && i < kg &&
            grp + i * groups < here) {
          s_part[(grp + i * groups) * wg + (col >> 5)] = part[0];
        }
        consumer_sync();
        // the coefficients: row r's wg warp sums on p2 lanes (wg rounded up
        // to a power of two), summed by shuffles in a fixed order
        const int p2 = wg <= 1 ? 1 : wg <= 2 ? 2 : wg <= 4 ? 4 : wg <= 8 ? 8 : 16;
        const int r = warp * (32 / p2) + lane / p2;
        const int q = lane % p2;
        if (warp * (32 / p2) < here) {
          float dot = r < here && q < wg ? s_part[r * wg + q] : 0.f;
          for (int off = p2 / 2; off > 0; off /= 2) {
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          }
          const int at = s * rows + r;
          const long long row = r < here && q == 0 ? s_row[at] : -1;
          if (row >= 0) {
            float coef;
            if (mode == kSaga) {
              const float diff = dot - s_y[at];
              diff_out[row] = diff;
              coef = round_like<T>(s_wt[at] * (diff - s_alpha[at]));
            } else {
              const float f =
                  mode == kLogistic ? 1.f / (1.f + expf(-dot)) : dot;
              coef = round_like<T>(s_wt[at] * (f - s_y[at]));
            }
            s_coef[at] = coef;
          }
        }
        consumer_sync();
#pragma unroll
        for (int i = 0; i < kMaxGroupRows; ++i) {
          cf[i] = (valid >> i & 1u) ? s_coef[s * rows + grp + i * groups] : 0.f;
        }
      }
      // everything this thread needs of the stage is in registers
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
      // phase B: fold this thread's rows, in row order
#pragma unroll
      for (int i = 0; i < kMaxGroupRows; ++i) {
        if (valid >> i & 1u) {
          float xv[V];
          Unpack<T, V>::unpack(xr[i], xv);
#pragma unroll
          for (int q = 0; q < V; ++q) acc[q] = fmaf(cf[i], xv[q], acc[q]);
        }
      }
    }
  }

  cooperative_groups::this_grid().sync();

  // g_j = sum over chunks of partial[., j]: a block takes `cols` columns
  // at a time (about d / nb), its threads `parts` = 512 / cols parts of
  // the chunks (part p: chunks p, p + parts, ...), then the parts are added
  // in order -- the same order whichever block takes the column
  const int cols = d <= 4 * nb ? 4 : d <= 8 * nb ? 8 : d <= 16 * nb ? 16 : 32;
  const int parts = kSumFloats / cols;
  const int sc = tid % cols;
  const int sp = tid / cols;
  for (long long c0 = b * cols; c0 < d; c0 += nb * cols) {
    const long long j = c0 + sc;
    if (sp < parts) {
      // kSumBatch loads in flight, then added in chunk order
      float v = 0.f;
      for (long long p0 = sp; j < d && p0 < nchunks;
           p0 += (long long)kSumBatch * parts) {
        float t[kSumBatch];
#pragma unroll
        for (int q = 0; q < kSumBatch; ++q) {
          const long long p = p0 + (long long)q * parts;
          t[q] = p < nchunks ? __ldcg(partial + p * d + j) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kSumBatch; ++q) v += t[q];
      }
      s_red[sp * cols + sc] = v;
    }
    __syncthreads();
    if (sp == 0 && j < d) {
      float total = 0.f;
      for (int q = 0; q < parts; ++q) total += s_red[q * cols + sc];
      g[j] = total;
    }
    __syncthreads();
  }
  if (b == 0 && tid == 0) *counter = 0;  // every claim came before the barrier
}

// Raises the staged kernel's dynamic shared-memory limit to the most a
// block may have (the device's opt-in limit less the static arrays), once
// a device: the limit never changes after that, so host threads that
// launch at different d need no lock, and a launch costs no driver call
// for it.  Setting it twice sets the same value.
template <typename T>
cudaError_t staged_attr() {
  static std::atomic<unsigned long long> done{0};  // one bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, masked_grad_staged<T>);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(masked_grad_staged<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - (int)attr.sharedSizeBytes);
  if (e != cudaSuccess) return e;
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

template <typename T>
cudaError_t staged_occupancy(long long smem, int* per_sm) {
  cudaError_t e = staged_attr<T>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, masked_grad_staged<T>, kStagedThreads, (size_t)smem);
}

template <typename T>
cudaError_t staged_launch(const void* X, long long n, long long d,
                          const float* y, const float* w, const float* mask,
                          const long long* idx, long long m, int mode,
                          const float* alpha, float* diff, int stages,
                          int rows, int groups, const Rounds& rounds,
                          int nchunks, int* counter, long long smem,
                          int blocks,
                          float* partial, float* g, cudaStream_t stream) {
  cudaError_t e = staged_attr<T>();
  if (e != cudaSuccess) return e;
  const T* Xt = static_cast<const T*>(X);
  void* args[] = {(void*)&Xt,      (void*)&n,       (void*)&d,
                  (void*)&y,       (void*)&w,       (void*)&mask,
                  (void*)&idx,     (void*)&m,       (void*)&mode,
                  (void*)&alpha,   (void*)&diff,    (void*)&stages,
                  (void*)&rows,    (void*)&groups,  (void*)&rounds,
                  (void*)&nchunks, (void*)&counter, (void*)&partial,
                  (void*)&g};
  e = cudaLaunchCooperativeKernel((const void*)masked_grad_staged<T>,
                                  dim3(blocks), dim3(kStagedThreads), args,
                                  (size_t)smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueue one form on the tiled route (two launches; kTileRows = 16 rows a
// tile, the host's plan sizes the grid from it) on `stream`; no
// synchronisation.
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

// Threads of a staged-route block (16 consumer warps and one producer).
int masked_grad_staged_threads(void) { return kStagedThreads; }

// Blocks of the staged route one SM holds at `smem` bytes of dynamic
// shared memory, into *per_sm.  Returns the cudaError_t (0 on success).
int masked_grad_staged_occupancy(int x_is_bf16, long long smem, int* per_sm) {
  return x_is_bf16 ? staged_occupancy<__nv_bfloat16>(smem, per_sm)
                   : staged_occupancy<float>(smem, per_sm);
}

// Enqueue one form on the staged route (one cooperative launch) on
// `stream`; no synchronisation.  Arguments as masked_grad_launch, and the
// plan's geometry: `stages` x `rows` ring rows, `groups` row groups, its
// chunks (`nrounds` rounds, round r of round_take[r] <= blocks chunks of
// round_size[r] stages, covering the ceil(m / rows) stages with the last
// chunk cut), `smem` bytes of dynamic shared memory, `blocks` persistent
// blocks (all resident: the launch is refused otherwise).  X must be
// 16-byte aligned with d * sizeof(element) a multiple of 16.
//   counter: one int, zero, used by no launch that may overlap this one
//     (the kernel leaves it zero; the host keeps one a stream)
//   partial: (max(nchunks, 1), d) f32 scratch   g: (d,) f32 output
// Returns the cudaError_t (0 on success).
int masked_grad_staged_launch(const void* X, int x_is_bf16, long long n,
                              long long d, const float* y, const float* w,
                              const float* mask, const long long* idx,
                              long long m, int mode, const float* alpha,
                              float* diff, int stages, int rows, int groups,
                              const int* round_size, const int* round_take,
                              int nrounds, int* counter,
                              long long smem, int blocks, float* partial,
                              float* g, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode < kLeastSquares || mode > kXtCoeff) return cudaErrorInvalidValue;
  if (mode >= kSaga && (idx != nullptr || m != n)) return cudaErrorInvalidValue;
  if (d == 0) return cudaSuccess;
  const int es = x_is_bf16 ? 2 : 4;
  const long long pad = (d / (16 / es) + 31) / 32 * 32;  // a group's threads
  Rounds rounds = {};
  long long nchunks = 0, covered = 0, last = 0;
  bool rounds_ok = nrounds >= 0 && nrounds <= kMaxRounds;
  for (int r = 0; rounds_ok && r < nrounds; ++r) {
    rounds_ok = round_size[r] >= 1 && round_take[r] >= 1 &&
                round_take[r] <= blocks;
    rounds.size[r] = round_size[r];
    rounds.take[r] = round_take[r];
    nchunks += round_take[r];
    covered += (long long)round_take[r] * round_size[r];
    last = round_size[r];
  }
  rounds.n = nrounds;
  const long long stages_needed = (m + rows - 1) / rows;
  rounds_ok = rounds_ok && covered >= stages_needed &&
              covered - last < stages_needed + (m == 0 ? 1 : 0) &&
              nchunks <= (1LL << 30);
  const bool ok = rounds_ok && d % (16 / es) == 0 && rows >= 1 &&
                  rows <= kMaxStageRows &&
                  groups >= 1 && rows % groups == 0 &&
                  rows / groups <= kMaxGroupRows && groups * pad <= kConsumers &&
                  stages >= 1 && blocks >= 1 && counter != nullptr &&
                  smem >= staged_smem_bytes(d, es, stages, rows, groups) &&
                  reinterpret_cast<uintptr_t>(X) % 16 == 0;
  if (!ok) return cudaErrorInvalidValue;
  return x_is_bf16
             ? staged_launch<__nv_bfloat16>(X, n, d, y, w, mask, idx, m, mode,
                                            alpha, diff, stages, rows, groups,
                                            rounds, (int)nchunks, counter,
                                            smem, blocks, partial, g, s)
             : staged_launch<float>(X, n, d, y, w, mask, idx, m, mode, alpha,
                                    diff, stages, rows, groups, rounds,
                                    (int)nchunks, counter, smem, blocks,
                                    partial, g, s);
}

const char* masked_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
