// Block attention with local softmax statistics on Hopper:
//
//     s = (q k^T) * scale        scale = f32(1 / sqrt(D)), multiplied in
//     s = -1e30 where mask == 0
//     m = rowmax s,  p = exp(s - m),  l = rowsum p,  o = p v (unnormalised)
//
// for every (batch, head), returning the f32 triple (o, m, l) that the ring
// and Ulysses merges fold.
//
// Replaces the Pallas TPU kernel
// asyncframework_tpu/ops/pallas_kernels.py::_chunk_attn_padded
// (pallas_call at :155, body _chunk_attn_kernel :127-147, public
// chunk_attention :178-227).
//
// Semantics kept from the TPU kernel, by both routes below:
//   * q, k, v are read in their (B, T, H, D) layout through strides (the
//     last stride is 1), with no transposed copy; both products are exact
//     products summed in f32, and p is the f32 value.
//   * The TPU kernel pads Tk to a multiple of 8 with masked columns.  A row
//     with no unmasked key therefore has m = -1e30, o = sum_k v_k and
//     l = Tk rounded up to 8.  Here the padded columns are not computed:
//     each adds exp(-1e30 - m) to l (1 for such a row, 0 for any row with a
//     real key), added once at the end.
//   * A key tile that masks out every column for rows that already hold a
//     real key is skipped: for such a row its exponentials are exactly 0
//     and its rescale exactly 1, so skipping changes no bit of (o, m, l).
//     (A row with no real key yet must see every tile: its p is 1 on each
//     masked column.)
//   * expf (not __expf), no fast-math, fixed reduction orders and no
//     atomics, so two launches are bit-equal.
//
// Bound on an H100 SXM: 4 * Tq * Tk * D operations per (batch, head),
// counting only the (query, key) pairs the mask attends (all Tk for a row
// that attends none), against (Tq + 2 Tk) * D * 2 bytes of bf16 input and
// the f32 outputs: hundreds of operations per byte at the long-context
// shapes, so the work is bound by arithmetic.
//
// The tensor-core route (namespace tc: bf16 q/k/v, D % 16 == 0, views TMA
// can read; the caller picks the route).  A bf16 x bf16 product is exact in
// f32, so q k^T on bf16 tensor cores with f32 accumulation is the same
// function up to summation order.  p is split exactly: every f32 p in
// [2^-100, 1] is p1 + p2 + p3 with p1 = bf16(p), p2 = bf16(p - p1),
// p3 = bf16(p - p1 - p2) (8 + 8 + 8 significant bits; each remainder is
// exact in f32), so p v is three bf16 passes with p unrounded.  The
// function's floor is its operations at the 989 TFLOP/s bf16 rate (1.11 ms
// at a ring block B=1, Tq=Tk=8192, H=32, D=128, unmasked); this design
// runs four passes where the function needs two, so its own floor is
// twice that.
//   * One block of 288 threads per (b, h, 128-row query tile): two consumer
//     warpgroups of 64 rows and one producer warp.  The Q tile stays in
//     shared memory; K and V tiles of 64 keys come through a ring of 3
//     stages (2 for D > 128), each filled by TMA (4-d tensor maps over the
//     (B, T, H, D) strides, 128-byte swizzle, boxes of 64 columns, zero
//     fill past Tq, Tk and D) and handed over with mbarriers.
//   * S = Q K^T: wgmma m64n64k16, bf16 -> f32, both operands in shared
//     memory (descriptors in the swizzle TMA wrote).  Then in registers:
//     scale, mask, online max, expf, an f32 row sum over the quad's fixed
//     shuffle tree.
//   * The mask (a template switch: without one, no code reads it) is read
//     one key tile ahead into registers and warmed in L2 two tiles ahead:
//     a mask as large as a ring block's (64 MB) does not stay in L2, and a
//     load issued in the tile that needs it left its latency on every
//     tile.  Each thread of a quad loads 16 bytes of each of its two rows
//     (where Tk % 16 == 0; single bytes otherwise), and the quad trades
//     the pieces with shuffles.  A consumer warpgroup skips a tile by a
//     vote over its 64 rows.  The producer still loads every K/V tile.
//   * O: the accumulator of S becomes the A fragments of p1, p2 and p3 in
//     registers (FlashAttention-3's reuse), and V is the transposed B
//     operand in shared memory.  Per 64 output columns the three passes
//     (12 wgmma steps, one fixed order) run in a fresh accumulator that an
//     f32 FMA folds into O: O = O exp(m_old - m_new) + part.  The tensor
//     cores' f32 accumulation truncates (on an H100 80GB HBM3 at 700 W, a
//     chain as long as Tk = 8192 drifted to 6.4e-4 relative against f32
//     sums), so the chain never outlives one tile.
//   * Registers: 288 threads are allocated as 12 warps (four at a time), so
//     168 a thread; ptxas spills a few words at D = 128 and more at D > 128.
//
// The f32 route (anonymous namespace): f32 inputs, and bf16 views the
// first route does not take, keep the CUDA-core design: a bf16 split would
// not make an f32 q or k exact, and TF32 would round them.
//   * One block of 256 threads per (b, h, 64-row query tile).  The query
//     tile sits in shared memory, transposed, for the whole block.
//   * A loop over Tk in 64-column tiles: K (transposed) and V are staged in
//     shared memory (16-byte loads where D and the strides allow, all of a
//     thread's in flight at once); each thread computes a 4 x 4 piece of
//     the 64 x 64 score tile with f32 FMAs, then the block runs an online
//     max and sum; the tile's p goes to shared memory (over the K tile's
//     buffer) for the p v product, where each thread owns 4 rows x (D / 16)
//     output columns in registers.  Bound: the 67 TFLOP/s f32 FMA rate.
//   * The tile's mask is read as one 32-bit word per row and thread (four
//     key columns) at the start of the tile, alongside the K/V loads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key columns per tile
constexpr int kLd = kBQ + 4;   // row pitch (floats) of the transposed tiles
constexpr float kNeg = -1e30f;
constexpr int kMaxD = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The 16 bytes of one vector load, widened to f32 (4 f32 or 8 bf16).
__device__ __forceinline__ void unpack(const uint4 raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(const uint4 raw, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

// Rows [t0, t0 + 64) of one (b, h) slice (row stride st, unit stride along
// D) into shared memory as f32, zero past Tn: transposed (dst[d * kLd + c])
// or row-major (dst[c * pitch + d]).  With `vec`, 16-byte loads, all of a
// thread's issued before any is stored, so their latencies overlap;
// otherwise one element at a time.
template <typename T, int kMaxVec, bool kTransposed>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           long long st, int t0, int Tn,
                                           int D, int vec, float* dst,
                                           int pitch) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int dv = D / V;
    const int n = kBK * dv;
    uint4 raw[kMaxVec];
#pragma unroll
    for (int u = 0; u < kMaxVec; ++u) {
      const int i = threadIdx.x + u * kThreads;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n) {
        const int c = i / dv;
        if (t0 + c < Tn) {
          raw[u] = __ldg(reinterpret_cast<const uint4*>(
              src + (long long)(t0 + c) * st + (i - c * dv) * V));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxVec; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < n) {
        const int c = i / dv;
        const int d0 = (i - c * dv) * V;
        float x[V];
        unpack(raw[u], x, T());
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (kTransposed) {
            dst[(d0 + e) * kLd + c] = x[e];
          } else {
            dst[c * pitch + d0 + e] = x[e];
          }
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int c = i / D;
      const int d = i - c * D;
      float x = 0.f;
      if (t0 + c < Tn) x = to_f32(src[(long long)(t0 + c) * st + d]);
      if (kTransposed) {
        dst[d * kLd + c] = x;
      } else {
        dst[c * pitch + d] = x;
      }
    }
  }
}

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// kDch: output columns in 64-wide chunks (D <= 64 * kDch).
template <typename T, int kDch>
__global__ void __launch_bounds__(kThreads, kDch <= 2 ? 2 : 1)
    chunk_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const uint8_t* __restrict__ mask, int H, int Tq, int Tk,
                      int D, long long qsb, long long qst, long long qsh,
                      long long ksb, long long kst, long long ksh,
                      long long vsb, long long vst, long long vsh, float scale,
                      int kpad, int mask_words, int vec, float* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int kDp = 64 * kDch;
  // most 16-byte vectors one thread stages per 64-row tile
  constexpr int kMaxVec = kBK * kDp * (int)sizeof(T) / 16 / kThreads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                               // [D][kLd]: Qt[d][r]
  float* Kt = Qt + D * kLd;                       // [max(D,64)][kLd]: Kt[d][c]
  float* Ps = Kt;                                 // [kBQ][kLd]: Ps[r][c]
  float* Vs = Kt + (D > kBQ ? D : kBQ) * kLd;     // [kBK][kDp]: Vs[c][d]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key columns tx*4.. / output columns tx*4..
  const int ty = tid >> 4;  // query rows ty*4..
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;

  stage_tile<T, kMaxVec, true>(qp, qst, q0, Tq, D, vec, Qt, 0);
  // V's columns past D stay zero (the tiles write only columns < D)
  for (int i = tid; i < kBK * (kDp - D); i += kThreads) {
    const int c = i / (kDp - D);
    Vs[c * kDp + D + (i - c * (kDp - D))] = 0.f;
  }

  float m_run[4], l_run[4], acc[4][4 * kDch];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * kDch; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    __syncthreads();  // the previous tile's p v product is done with Ps, Vs
    // ---- this thread's mask bits: row ty*4+i, columns tx*4+j -> bit 4i+j
    unsigned bits = 0xffffu;
    bool needed = true;
    if (mask != nullptr) {
      bits = 0u;
      needed = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r >= Tq) continue;
        const int c = k0 + tx * 4;
        const uint8_t* mr = mask + (long long)r * Tk + c;
        unsigned rb = 0u;
        if (mask_words && c + 3 < Tk) {
          const unsigned w = __ldg(reinterpret_cast<const unsigned*>(mr));
#pragma unroll
          for (int j = 0; j < 4; ++j) rb |= (((w >> (8 * j)) & 0xffu) != 0u) << j;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (c + j < Tk && mr[j] != 0) rb |= 1u << j;
          }
        }
        bits |= rb << (4 * i);
        // a row with no real key yet needs every tile
        needed = needed || rb != 0u || m_run[i] <= kNeg;
      }
    }
    stage_tile<T, kMaxVec, true>(kp, kst, k0, Tk, D, vec, Kt, 0);
    stage_tile<T, kMaxVec, false>(vp, vst, k0, Tk, D, vec, Vs, kDp);
    if (!__syncthreads_or(needed)) continue;  // a wholly masked tile

    // ---- s = q k^T for rows ty*4+i, columns tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kLd + ty * 4);
      const float4 bk = *reinterpret_cast<const float4*>(Kt + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
    }
    __syncthreads();  // every thread is done with Kt before Ps overwrites it

    // ---- scale, mask, online max / sum; p to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx * 4 + j;
        float x;
        if (c >= Tk) {
          x = -INFINITY;  // past the keys: no part in max, sum or product
        } else {
          x = s[i][j] * scale;
          if (((bits >> (4 * i + j)) & 1u) == 0u) x = kNeg;
        }
        s[i][j] = x;
      }
      const float mt = group16_max(
          fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m_run[i], mt);
      const float corr = expf(m_run[i] - m_new);
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = expf(s[i][j] - m_new);
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * kLd + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
      const float ps = group16_sum((p[0] + p[1]) + (p[2] + p[3]));
      l_run[i] = l_run[i] * corr + ps;
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * kDch; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    // ---- o += p v for rows ty*4+i, columns jj*64 + tx*4 + e
#pragma unroll 1
    for (int c0 = 0; c0 < kBK; c0 += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kLd + c0);
        pr[i][0] = p4.x;
        pr[i][1] = p4.y;
        pr[i][2] = p4.z;
        pr[i][3] = p4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < kDch; ++jj) {
          const float4 v4 = *reinterpret_cast<const float4*>(
              Vs + (c0 + cc) * kDp + jj * 64 + tx * 4);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][jj * 4 + e] = fmaf(pr[i][cc], vv[e], acc[i][jj * 4 + e]);
            }
          }
        }
      }
    }
  }

  // ---- epilogue: o (B, Tq, H, D), m and l (B, H, Tq)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
    float* orow = o + (((long long)b * Tq + r) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < kDch; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = jj * 64 + tx * 4 + e;
        if (d < D) orow[d] = acc[i][jj * 4 + e];
      }
    }
    if (tx == 0) {
      const long long at = ((long long)b * H + h) * Tq + r;
      m_out[at] = m_run[i];
      l_out[at] = l_run[i] + (float)kpad * expf(kNeg - m_run[i]);
    }
  }
}

template <typename T, int kDch>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const uint8_t* mask, int B, int H, int Tq, int Tk, int D,
                   const long long* st, float scale, int kpad, float* o,
                   float* m, float* l, cudaStream_t stream) {
  constexpr int kDp = 64 * kDch;
  // 32-bit mask loads need every row start 4-byte aligned
  const int mask_words =
      mask != nullptr && Tk % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  // 16-byte loads need D, every (b, t, h) stride and each base a whole
  // number of vectors
  constexpr long long V = 16 / sizeof(T);
  int vec = D % V == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % V == 0;
  vec = vec && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const size_t smem =
      sizeof(float) * ((size_t)D * kLd + (size_t)(D > kBQ ? D : kBQ) * kLd +
                       (size_t)kBK * kDp);
  auto kernel = chunk_attn_kernel<T, kDch>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((Tq + kBQ - 1) / kBQ), (unsigned)(B * H));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, H, Tq, Tk, D, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], scale, kpad, mask_words, vec,
      o, m, l);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const uint8_t* mask, int B, int H, int Tq, int Tk, int D,
                     const long long* st, float scale, int kpad, float* o,
                     float* m, float* l, cudaStream_t s) {
  if (D <= 64) return launch<T, 1>(q, k, v, mask, B, H, Tq, Tk, D, st, scale, kpad, o, m, l, s);
  if (D <= 128) return launch<T, 2>(q, k, v, mask, B, H, Tq, Tk, D, st, scale, kpad, o, m, l, s);
  if (D <= 192) return launch<T, 3>(q, k, v, mask, B, H, Tq, Tk, D, st, scale, kpad, o, m, l, s);
  return launch<T, 4>(q, k, v, mask, B, H, Tq, Tk, D, st, scale, kpad, o, m, l, s);
}

}  // namespace

// ======================================================================
// The tensor-core route (bf16 q/k/v, D a multiple of 16, D <= 256)
// ======================================================================
namespace tc {

constexpr int kBQ = 128;            // query rows per block: 2 consumer warpgroups
constexpr int kBK = 64;             // keys per K/V tile
constexpr int kThreads = 288;       // 2 consumer warpgroups + 1 producer warp
constexpr int kChunkBytes = 64 * 128;  // one 64-row x 64-column bf16 box
constexpr int kMaskAhead = 2;          // key tiles of mask warmed in L2 ahead
constexpr float kNeg = -1e30f;
// return codes beyond cudaError_t's range
constexpr int kEncoderMissing = 90000;   // no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = 100000;    // + the CUresult of the encode

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
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
// outlasts any load by orders of magnitude is a fault: trap (the launch
// then fails with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long n = 0; !mbar_try(bar, parity); ++n) {
    if (n > (1ll << 28)) __trap();
  }
}

// One box of a 4-d tensor map (d, h, t, b) into shared memory, completing
// on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int d, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(t),
      "r"(b)
      : "memory");
}

// True on every thread of a consumer warpgroup when it is true on any
// (named barrier `id`, 128 threads).
__device__ __forceinline__ bool warpgroup_any(bool v, int id) {
  uint32_t out;
  asm volatile(
      "{\n"
      ".reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n"
      "}\n"
      : "=r"(out)
      : "r"((uint32_t)v), "r"(id)
      : "memory");
  return out != 0u;
}

// wgmma shared-memory descriptor for a tile written by TMA with the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO); `lbo` is the
// stride between 64-column atoms of an MN-major operand (unused for
// K-major ones).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)(1024u >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define TC_D32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define TC_R32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B for a 64 x 64 x 16 bf16 step, f32 accumulation; A and B
// K-major in shared memory (S = Q K^T).
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_R32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : TC_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B for a 64 x 64 x 16 bf16 step, A from registers (four packed
// bf16 pairs per thread), B MN-major in shared memory (O += P V).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TC_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : TC_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Ask for the 128-byte line holding `p` to be brought into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Bit e of the result: byte e of `w` is nonzero (e < 4).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t b = __vcmpne4(w, 0u);  // 0xff per nonzero byte
  return ((b >> 7) & 1u) | ((b >> 14) & 2u) | ((b >> 21) & 4u) |
         ((b >> 28) & 8u);
}

// Bit e of the result: byte e of the 16 bytes `w` is nonzero.
__device__ __forceinline__ uint32_t nonzero_bytes16(uint4 w) {
  return nonzero_bytes(w.x) | nonzero_bytes(w.y) << 4 |
         nonzero_bytes(w.z) << 8 | nonzero_bytes(w.w) << 12;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int kDch>
__host__ __device__ constexpr int stages() {
  return kDch <= 2 ? 3 : 2;
}

template <int kDch>
__host__ __device__ constexpr size_t smem_bytes() {
  // alignment slack, Q (kDch chunks of 128 rows), the K and V rings, and
  // the full / empty / Q barriers
  return 1024 + (size_t)kDch * 2 * kChunkBytes +
         2 * (size_t)stages<kDch>() * kDch * kChunkBytes +
         8 * (2 * stages<kDch>() + 1);
}

// kDch: the head in 64-column chunks (D <= 64 * kDch); a chunk's columns
// past D are TMA's zero fill.  kMasked: a mask is given (without one, no
// register or instruction goes to it).
template <int kDch, bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
    chunk_attn_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const uint8_t* __restrict__ mask, int H, int Tq,
                         int Tk, int D, float scale, int kpad, int mask_vec,
                         float* __restrict__ o, float* __restrict__ m_out,
                         float* __restrict__ l_out) {
  constexpr int kStages = stages<kDch>();
  constexpr int kTile = kDch * kChunkBytes;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: every box starts on one
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + kDch * 2 * kChunkBytes;
  const uint32_t sV = sK + kStages * kTile;
  const uint32_t sBar = sV + kStages * kTile;
  const uint32_t qbar = sBar + 16u * kStages;
  // full[s] at sBar + 8 s, empty[s] at sBar + 8 (kStages + s)

  // the last query tiles first: under a causal mask they see the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int n_tiles = (Tk + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sBar + 8u * s, 1);                    // the producer's expect_tx
      mbar_init(sBar + 8u * (kStages + s), 256);      // every consumer thread
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warps 0-3 and 4-7 are the consumer warpgroups (a warpgroup starts at
  // a warp index divisible by 4), warp 8 the producer
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the K/V ring full through TMA
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, kDch * 2 * kChunkBytes);
      for (int c = 0; c < kDch; ++c) {
        tma_load(&q_map, sQ + c * 2 * kChunkBytes, qbar, 64 * c, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(sBar + 8u * (kStages + s), ((it / kStages) & 1) ^ 1);
        const uint32_t full = sBar + 8u * s;
        mbar_expect_tx(full, 2 * kTile);
        for (int c = 0; c < kDch; ++c) {
          tma_load(&k_map, sK + s * kTile + c * kChunkBytes, full, 64 * c, h,
                   it * kBK, b);
          tma_load(&v_map, sV + s * kTile + c * kChunkBytes, full, 64 * c, h,
                   it * kBK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    const int cw = wg;
    const int tid = threadIdx.x - 128 * wg;
    const int g = (tid & 31) >> 2;  // accumulator row (and row + 8)
    const int t = tid & 3;          // accumulator columns 8j + 2t, + 1
    const int r0 = q0 + cw * 64 + (tid >> 5) * 16 + g;
    const int rows[2] = {r0, r0 + 8};
    const uint32_t qa = sQ + cw * 64 * 128;  // this warpgroup's Q rows

    float acc[kDch][32];
#pragma unroll
    for (int c = 0; c < kDch; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    }
    float m_run[2] = {kNeg, kNeg};
    float l_run[2] = {0.f, 0.f};
    // the mask rows of key tile `tile` into L2 ahead of their loads (a
    // mask as large as 8192 x 8192 does not stay in L2)
    auto warm_mask = [&](int tile) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tile * kBK + 16 * t;
        if (rows[i] < Tq && c < Tk) prefetch_l2(mask + (long long)rows[i] * Tk + c);
      }
    };
    // this thread's 16 mask bytes of each of its rows, loaded one key tile
    // ahead of their use (where Tk % 16 == 0)
    uint4 mnext[2];
    auto load_mask = [&](int tile) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tile * kBK + 16 * t;
        mnext[i] = make_uint4(0u, 0u, 0u, 0u);
        if (rows[i] < Tq && c < Tk) {
          mnext[i] = __ldg(reinterpret_cast<const uint4*>(
              mask + (long long)rows[i] * Tk + c));
        }
      }
    };
    if (kMasked) {
      for (int ahead = 0; ahead < kMaskAhead && ahead < n_tiles; ++ahead) {
        warm_mask(ahead);
      }
      if (mask_vec) load_mask(0);
    }
    mbar_wait(qbar, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = it * kBK;
      if (kMasked && it + kMaskAhead < n_tiles) warm_mask(it + kMaskAhead);
      // ---- mask bits, read ahead of the tile's wait: bit 16 i + 2 j + e
      // is row rows[i], key k0 + 8 j + 2 t + e
      uint32_t bits = 0xffffffffu;
      bool needed = true;
      if (kMasked) {
        bits = 0u;
        needed = false;
        // keys 16 t .. 16 t + 15 of each row (loaded an iteration ago);
        // then the next tile's bytes are asked for
        uint32_t nz[2] = {0u, 0u};
        if (mask_vec) {
          nz[0] = nonzero_bytes16(mnext[0]);
          nz[1] = nonzero_bytes16(mnext[1]);
          if (it + 1 < n_tiles) load_mask(it + 1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = rows[i];
          uint32_t rb = 0u;
          if (mask_vec) {
            // the quad trades its four 16-key pieces of the row
            uint32_t piece[4];
#pragma unroll
            for (int src = 0; src < 4; ++src) {
              piece[src] = __shfl_sync(0xffffffffu, nz[i], (tid & ~3) | src);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              rb |= ((piece[j >> 1] >> (8 * (j & 1) + 2 * t)) & 3u) << (2 * j);
            }
          } else if (r < Tq) {
            const uint8_t* mr = mask + (long long)r * Tk;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int c = k0 + 8 * j + 2 * t;
              if (c < Tk && mr[c] != 0) rb |= 1u << (2 * j);
              if (c + 1 < Tk && mr[c + 1] != 0) rb |= 1u << (2 * j + 1);
            }
          }
          if (r >= Tq) continue;
          bits |= rb << (16 * i);
          // a row with no real key yet needs every tile
          needed = needed || rb != 0u || m_run[i] <= kNeg;
        }
      }
      mbar_wait(sBar + 8u * s, (it / kStages) & 1);
      if (warpgroup_any(needed, 1 + cw)) {
        const uint32_t kb = sK + s * kTile;
        const uint32_t vb = sV + s * kTile;
        // ---- S = Q K^T: bf16 products, exact in f32, f32 accumulation
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
        fence_regs(sc);
        wg_fence();
#pragma unroll
        for (int c = 0; c < kDch; ++c) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            mma_ss(sc, desc(qa + c * 2 * kChunkBytes + kk * 32, 0),
                   desc(kb + c * kChunkBytes + kk * 32, 0), (c | kk) != 0);
          }
        }
        wg_commit();
        wg_wait0();
        fence_regs(sc);

        // ---- scale, mask, online max and sum; p over the scores
        float corr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x_at = 4 * j + 2 * i + e;
              float x;
              if (k0 + 8 * j + 2 * t + e >= Tk) {
                x = -INFINITY;  // past the keys: no part in max, sum or product
              } else {
                x = sc[x_at] * scale;
                if (((bits >> (16 * i + 2 * j + e)) & 1u) == 0u) x = kNeg;
              }
              sc[x_at] = x;
              mt = fmaxf(mt, x);
            }
          }
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          const float m_new = fmaxf(m_run[i], mt);
          corr[i] = expf(m_run[i] - m_new);
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x_at = 4 * j + 2 * i + e;
              sc[x_at] = expf(sc[x_at] - m_new);
              ps += sc[x_at];
            }
          }
          ps += __shfl_xor_sync(0xffffffffu, ps, 1);
          ps += __shfl_xor_sync(0xffffffffu, ps, 2);
          l_run[i] = l_run[i] * corr[i] + ps;
          m_run[i] = m_new;
        }
        // ---- p = p1 + p2 + p3 exactly, each bf16, as wgmma A fragments:
        // keys 16 kk.. of the accumulator are the A operand of step kk
        uint32_t pa[3][4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float x0 = sc[8 * kk + 2 * u];
            const float x1 = sc[8 * kk + 2 * u + 1];
            const __nv_bfloat162 h1 = __floats2bfloat162_rn(x0, x1);
            const float2 f1 = __bfloat1622float2(h1);
            const float y0 = x0 - f1.x;  // exact
            const float y1 = x1 - f1.y;
            const __nv_bfloat162 h2 = __floats2bfloat162_rn(y0, y1);
            const float2 f2 = __bfloat1622float2(h2);
            const __nv_bfloat162 h3 =
                __floats2bfloat162_rn(y0 - f2.x, y1 - f2.y);  // exact
            pa[0][kk][u] = pack_bf16(h1);
            pa[1][kk][u] = pack_bf16(h2);
            pa[2][kk][u] = pack_bf16(h3);
          }
        }

        // ---- O = O exp(m_old - m_new) + (p1 V + p2 V + p3 V), per 64
        // output columns: the three passes run in a fresh wgmma accumulator
        // (12 steps, in one fixed order), folded into O by an f32 FMA.  The
        // tensor cores' f32 accumulation truncates, so a chain as long as Tk
        // would drift; 12 steps stay well inside f32's own rounding.
#pragma unroll
        for (int c = 0; c < kDch; ++c) {
          float part[32];
#pragma unroll
          for (int e = 0; e < 32; ++e) part[e] = 0.f;
          fence_regs(part);
          wg_fence();
#pragma unroll
          for (int sp = 0; sp < 3; ++sp) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              mma_rs(part, pa[sp][kk],
                     desc(vb + c * kChunkBytes + kk * 2048, kChunkBytes),
                     (sp | kk) != 0);
            }
          }
          wg_commit();
          wg_wait0();
          fence_regs(part);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[c][4 * j] = fmaf(acc[c][4 * j], corr[0], part[4 * j]);
            acc[c][4 * j + 1] = fmaf(acc[c][4 * j + 1], corr[0], part[4 * j + 1]);
            acc[c][4 * j + 2] = fmaf(acc[c][4 * j + 2], corr[1], part[4 * j + 2]);
            acc[c][4 * j + 3] = fmaf(acc[c][4 * j + 3], corr[1], part[4 * j + 3]);
          }
        }
#pragma unroll
        for (int sp = 0; sp < 3; ++sp) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(pa[sp][kk]);
        }
      }
      mbar_arrive(sBar + 8u * (kStages + s));  // the stage may be refilled
    }

    // ---- epilogue: o (B, Tq, H, D), m and l (B, H, Tq)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rows[i];
      if (r >= Tq) continue;
      float* orow = o + (((long long)b * Tq + r) * H + h) * D;
#pragma unroll
      for (int c = 0; c < kDch; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = 64 * c + 8 * j + 2 * t;
          if (d < D) {
            *reinterpret_cast<float2*>(orow + d) =
                make_float2(acc[c][4 * j + 2 * i], acc[c][4 * j + 2 * i + 1]);
          }
        }
      }
      if (t == 0) {
        const long long at = ((long long)b * H + h) * Tq + r;
        m_out[at] = m_run[i];
        l_out[at] = l_run[i] + (float)kpad * expf(kNeg - m_run[i]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: reach it through the runtime,
// so the library needs no link against libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-d map over a bf16 (B, T, H, D) view (element strides b, t, h in
// st[0..2]), boxes of 64 columns x 1 head x `rows` rows, 128-byte swizzle,
// zero fill outside the view.
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int T, int H,
                  int D, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int kDch>
int launch(const void* q, const void* k, const void* v, const uint8_t* mask,
           int B, int H, int Tq, int Tk, int D, const long long* st,
           float scale, int kpad, float* o, float* m, float* l,
           cudaStream_t stream) {
  if (encoder() == nullptr) return kEncoderMissing;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const CUresult r = make_map(&maps[i], ptrs[i], B, i ? Tk : Tq, H, D,
                                st + 3 * i, i ? kBK : kBQ);
    if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  }
  // 16-byte mask loads need every row start 16-byte aligned
  const int mask_vec = mask != nullptr && Tk % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  constexpr size_t smem = smem_bytes<kDch>();
  auto kernel = mask != nullptr ? chunk_attn_tc_kernel<kDch, true>
                                : chunk_attn_tc_kernel<kDch, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Tq + kBQ - 1) / kBQ), (unsigned)(B * H));
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], mask, H,
                                           Tq, Tk, D, scale, kpad, mask_vec,
                                           o, m, l);
  return (int)cudaGetLastError();
}

}  // namespace tc

extern "C" {

// Enqueue the block attention on `stream`; no synchronisation.
//   q: (B, Tq, H, D), k and v: (B, Tk, H, D), f32 (is_bf16 = 0) or bf16
//     (1), element strides for (b, t, h) in `strides` (q's three, then
//     k's, then v's); the stride of d is 1
//   mask: (Tq, Tk) contiguous bytes, nonzero = attend, or NULL
//   scale: f32(1 / sqrt(D));  kpad: Tk rounded up to 8, minus Tk
//   o: (B, Tq, H, D) f32;  m, l: (B, H, Tq) f32, contiguous
// Needs 1 <= D <= 256, Tq >= 1, Tk >= 1, B * H <= 65535.
// Returns the cudaError_t of the launch (0 on success).
int chunk_attention_launch(const void* q, const void* k, const void* v,
                           int is_bf16, const uint8_t* mask, int B, int H,
                           int Tq, int Tk, int D, const long long* strides,
                           float scale, int kpad, float* o, float* m,
                           float* l, void* stream) {
  if (D < 1 || D > kMaxD || Tq < 1 || Tk < 1 || B < 1 || H < 1 ||
      (long long)B * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, mask, B, H, Tq, Tk, D,
                                        strides, scale, kpad, o, m, l, s)
              : dispatch<float>(q, k, v, mask, B, H, Tq, Tk, D, strides,
                                scale, kpad, o, m, l, s);
  return (int)e;
}

// The tensor-core route: the same contract for bf16 q, k, v with
// D % 16 == 0, 16 <= D <= 256, every stride a multiple of 8 elements and
// every base 16-byte aligned (TMA's rules); the caller picks the route.
int chunk_attention_launch_tc(const void* q, const void* k, const void* v,
                              const uint8_t* mask, int B, int H, int Tq,
                              int Tk, int D, const long long* strides,
                              float scale, int kpad, float* o, float* m,
                              float* l, void* stream) {
  if (D < 16 || D > kMaxD || D % 16 != 0 || Tq < 1 || Tk < 1 || B < 1 ||
      H < 1 || (long long)B * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < 9; ++i) {
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  }
  for (const void* p : {q, k, v}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return tc::launch<1>(q, k, v, mask, B, H, Tq, Tk, D, strides, scale, kpad, o, m, l, s);
  if (D <= 128) return tc::launch<2>(q, k, v, mask, B, H, Tq, Tk, D, strides, scale, kpad, o, m, l, s);
  if (D <= 192) return tc::launch<3>(q, k, v, mask, B, H, Tq, Tk, D, strides, scale, kpad, o, m, l, s);
  return tc::launch<4>(q, k, v, mask, B, H, Tq, Tk, D, strides, scale, kpad, o, m, l, s);
}

const char* chunk_attention_error_string(int err) {
  if (err == tc::kEncoderMissing) {
    return "cuTensorMapEncodeTiled not found in the driver";
  }
  if (err >= tc::kEncodeFailed) {
    return "cuTensorMapEncodeTiled refused the view (CUresult = code - 100000)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
