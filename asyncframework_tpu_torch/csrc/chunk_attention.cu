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
// Semantics kept from the TPU kernel:
//   * q, k, v are read in their (B, T, H, D) layout through strides (the
//     last stride is 1), in f32 or bf16, and widened to f32 in registers;
//     both products accumulate in f32 and p stays f32.
//   * The TPU kernel pads Tk to a multiple of 8 with masked columns.  A row
//     with no unmasked key therefore has m = -1e30, o = sum_k v_k and
//     l = Tk rounded up to 8.  Here the padded columns are not computed:
//     each adds exp(-1e30 - m) to l (1 for such a row, 0 for any row with a
//     real key), added once at the end.
//
// Bound on an H100 SXM: 4 * Tq * Tk * D flops per (batch, head) against
// (Tq + 2 Tk) * D * 2 bytes of bf16 input, i.e. hundreds of flops per byte
// at the long-context shapes, so the kernel is bound by arithmetic: at
// least 4 B H Tq Tk D / 67 TFLOP/s (the f32 rate outside the tensor cores).
// At a ring block (B=1, Tq=Tk=8192, H=32, D=128) that is 16.4 ms, and the
// bytes take under 1% of it; at a Ulysses block (Tq=32768, Tk=512, H=8)
// 1.03 ms, and the bytes about 6%.  Tensor cores (TF32 or bf16) would
// compute a different function: the TPU kernel's p is f32.
//
// Design (simple first, right first):
//   * One block of 256 threads per (b, h, 64-row query tile).  The query
//     tile sits in shared memory, transposed, for the whole block.
//   * A loop over Tk in 64-column tiles: K (transposed) and V are staged in
//     shared memory (16-byte loads where D and the strides allow, all of a
//     thread's in flight at once); each thread computes a 4 x 4 piece of the 64 x 64
//     score tile with f32 FMAs, then the block runs an online max and sum,
//     so no Tq x Tk matrix reaches device memory; the tile's p goes to
//     shared memory (over the K tile's buffer) for the p v product, where
//     each thread owns 4 rows x (D / 16) output columns in registers.
//   * The tile's mask is read as one 32-bit word per row and thread (four
//     key columns) at the start of the tile, alongside the K/V loads.  A
//     tile that masks out every column for rows that already hold a real
//     key is skipped: for such a row its exponentials are exactly 0 and its
//     rescale exactly 1, so skipping changes no bit of (o, m, l).  (A row
//     with no real key yet must see every tile: its p is 1 on each masked
//     column.)  The bound then counts the (query, key) pairs the mask
//     attends, and all Tk columns for a row that attends none.
//   * expf (not __expf), no fast-math; row reductions are fixed shuffle
//     trees and there are no atomics, so two launches are bit-equal.

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

const char* chunk_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
