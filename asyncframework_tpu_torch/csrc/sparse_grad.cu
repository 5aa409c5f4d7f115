// The sparse (padded-ELL) worker step, kernel S1, for Hopper (sm_90a).
//
// No Pallas kernel lies on this path: the JAX package computes it in XLA,
// as a gather and row sum (asyncframework_tpu/ops/gradients.py:131,
// sparse_residual) and a SORTED scatter-add (:138, make_sparse_grad_sum: a
// stable argsort of the flat column ids, then .at[].add with
// indices_are_sorted).  A plain PyTorch port of the scatter would be
// index_add_ / scatter_add_, which sum with atomics on CUDA in an order that
// changes from launch to launch.  These kernels keep the reference's order
// and are bit-equal from launch to launch.
//
// sparse_task (the fused design; one cooperative launch a task, one block
// of 512 threads an SM, phases split by grid barriers):
//   r_j   = sum_k (vals[row_j, k] * valid_j) * w[cols[row_j, k]] - y[row_j] * valid_j
//   c_j   = r_j, or r_j - alpha[row_j] (ASAGA), or r_j - alpha[j] (the DCN
//           ASAGA worker's per-slot scalars), or a given coeff_j (no r)
//   g[c]  = sum over the entries keyed c, in flat order, of c_j * (vals * valid_j)
//   with row_j = idx[j] (or j), valid_j = valid[j] (or 1, and no product).
//   (a) A warp stages up to eight whole rows of its slots at once in shared
//       memory (16-byte loads where K % 4 == 0 and the rows are aligned),
//       so that all their loads, then all their w gathers, are in flight
//       together.  Lane l sums k = l, l + 32, ... from 0 and a five-step
//       shuffle tree adds the lanes (as ell_residual does: the two are
//       bit-equal).  Then every entry's key (its column, or d for a zero
//       value) and rounded product c_j * v are written in flat order, and
//       counted in two block histograms (256 bins): the key's first digit,
//       and the top digit of a live key.
//   Then the kernel picks a route from the top-digit totals, the same on
//   every block.
//   Local route (at most two digits, and no top-digit bucket of live
//   entries longer than 4,096 or L; rcv1's uniform tasks): (b) one stable
//   scatter by the top digit, which leaves each bucket (up to 256 columns)
//   in flat order, dead entries out; (c) a block, or half a block where no
//   bucket passes 2,048, ranks each bucket by its low digit in shared
//   memory, which puts it in column order, and one thread sums each column
//   there.  Three grid barriers.
//   Global route (the rest: long or skewed columns, one column, three
//   digits): (b) a stable LSD radix sort over the digits [0, d] needs (2
//   passes at d = 47,236); the products ride with the keys, the last pass
//   writes no keys and drops the entries keyed d.  (c) The live entries
//   are counted by column (a red a distinct column of a warp's 32 entries;
//   repeats through a small shared table first, so that a skewed column is
//   not one address hammered by every warp), the counts scanned in tiles
//   of 1,024 columns give every column's bounds, warps take groups of 32
//   columns (a thread a column of at most kShortMax entries), and a longer
//   column is an item for one warp, one longer than L (`chunk`) cut into
//   chunks of L, an item each, claimed from a counter; a warp's item is
//   added by its lane 0 from shared memory, and the chunk sums are added
//   in chunk order by the warp that finishes the column's last chunk (seen
//   through an integer counter after a fence).  Six barriers at two
//   digits, seven with the count.
//   A sort pass (either route) is a histogram of each block's tile (its
//   slots' entries, in order), a block-major scan of the block histograms
//   (a warp a digit) and a stable scatter: warps rank 32 entries at a time
//   with __match_any, then warps add up in order, so equal keys keep their
//   flat order; each sub-tile is put in digit order in shared memory
//   first, so the writes to each digit's run are coalesced.
//   Every sum runs serially from 0.0f in sorted (= flat) order, each
//   product rounded before its add (__fmul_rn, __fadd_rn): a column of at
//   most L entries gets exactly the bits of the reference's sorted scatter
//   on the CPU, on both routes.  Columns with no entry get +0.0.  No float
//   atomics; the scratch (histogram totals, column counts, chunk counters,
//   claim counters) is zeroed in the kernel by its last reader, so a
//   launch needs no memset and no sort launch.  Entries keyed d (padding:
//   col 0, val 0; slots with valid 0; zero values) are left out of the
//   sums: each would add c_j * (+-0) = +-0 (for a finite c_j) to a sum that
//   starts at +0 and so is never -0: adding it changes no bit.
//
// ell_residual (one warp a row; the evaluation's launch, and the first
// launch of the earlier three-launch chain) and segment_sum (bounds, a
// thread a column; sums, a warp a column, one serial chain a column, after
// a stable torch.sort of ell_residual's keys) are the earlier design, kept
// callable: chip_smoke.py times it in turns against sparse_task.
//
// What bounds them: a task moves little (rcv1's compacted task: 4,752 rows
// x 80 of int32 + f32 read, r and g written, ~3.5 MB, ~1 us at 3.35 TB/s),
// so the time goes to fixed costs and latency: the launch and the grid
// barriers (~1.1 us each on an H100), the dependent loads of the residual
// (idx -> row -> w), and the serial chains of the longest columns (a chunk
// of L = 4,096 entries is 4,096 dependent adds).
// tools/probe_sparse_grad.py times each phase.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

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

// ------------------------------------------------------------ sparse_task
namespace task {

constexpr int kThreads = 512;
constexpr int kBlockWarps = kThreads / kWarp;
constexpr int kStage = 512;       // entries a warp stages (a multiple of 32)
constexpr int kMaxRows = 8;       // rows a warp stages at once
constexpr int kRanks = 8;         // rounds of 32 entries a warp ranks
constexpr int kSubTile = kBlockWarps * kRanks * kWarp;  // 4,096 entries
constexpr int kDigits = 256;
constexpr int kColTile = 2 * kThreads;  // columns a tile: two a thread
constexpr int kMaxColTiles = 4096;
constexpr int kShortMax = 16;     // longest column one thread sums
constexpr int kHot = 256;         // the block's table of repeated columns,
constexpr int kProbes = 4;        // probed linearly, then straight to cnt
constexpr int kStamps = 32;       // phase boundaries a block may stamp
constexpr int kRouteStamp = 23;   // stamp 23: 1 for the local route, else 0
constexpr int kDetail = 24;       // stamps 24-27: warp 0's last row batch

// One launch.  Pos (unsigned or unsigned long long) holds entry positions
// and counts: 32 bits while m * K < 2^31.
template <typename Pos>
struct Task {
  const int* cols;
  const float* vals;
  const float* y;      // the residual form's labels and model
  const float* w;
  const long long* idx;
  const float* valid;
  const float* coeff;  // the coefficient form's c_j
  const float* alpha;  // NULL, or the residual form's c_j = r_j - alpha[.]
  int alpha_slots;     // 1: alpha is indexed by slot j, 0: by row_j
  long long m;
  int K, d, passes, chunk, vec;
  int residual;        // 1: the residual form, 0: the coefficient form
  int global_only;     // 1: the global route whatever the buckets' sizes
  float* r;
  float* g;
  unsigned long long* stamps;  // NULL, or [blocks][kStamps] phase times
  // scratch, written before it is read
  int* keys[2];
  float* prods[2];
  Pos* hist;       // [256][blocks], digit-major: a pass's block counts
  Pos* hist_top;   // [256][blocks]: the live keys' top digits (local route)
  Pos* offs;       // [256][blocks]: where each block's run of a digit starts
  Pos* col_incl;   // [d]: inclusive count within the column's tile
  Pos* tile_tot;   // [tiles]
  int2* items;     // (column, chunk) of the columns one thread does not sum
  float* partials; // one an item
  // scratch that is zero between launches (each part reset by its last
  // reader)
  Pos* tot[2];     // [256]: pass p's digit totals in tot[p & 1]
  Pos* tot_top;    // [256]: the live keys' top-digit totals (the buckets)
  Pos* cnt;        // [d]: live entries a column
  unsigned* done;  // [items]: chunks finished, at the column's first item
  unsigned* ctrl;  // [0] work claimed, [1] items, [2] blocks finished
};

template <typename Pos>
constexpr int smem_bytes() {
  return kBlockWarps * kStage * 8 + kBlockWarps * kDigits * 4 + kHot * 8 +
         4 * kDigits * (int)sizeof(Pos) + (kBlockWarps + 2) * (int)sizeof(Pos);
}
static_assert(kSubTile * 8 + kMaxColTiles * 8 <= kBlockWarps * kStage * 8,
              "a sub-tile's reordered entries and the tile bases reuse the "
              "row staging");

// %globaltimer (ns) at phase boundary i, by thread 0 of each block, when
// the launch asked for stamps (tools/probe_sparse_grad.py)
template <typename Pos>
__device__ __forceinline__ void stamp(const Task<Pos>& t, int i) {
  if (t.stamps == nullptr || threadIdx.x != 0 || i >= kStamps) return;
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  t.stamps[(size_t)blockIdx.x * kStamps + i] = ns;
}

template <typename T>
__device__ __forceinline__ T warp_incl_scan(T x) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const T y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(kFull, x, off);
  }
  return x;
}

// Exclusive scan of x over the block's threads in thread order; `total`
// gets the sum.  Every thread of the block calls it; sc: kBlockWarps + 1.
template <typename T>
__device__ T block_excl_scan(T x, T* sc, T& total) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  const T incl = warp_incl_scan(x);
  if (lane == kWarp - 1) sc[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T v = lane < kBlockWarps ? sc[lane] : T(0);
    const T vi = warp_incl_scan(v);
    if (lane < kBlockWarps) sc[lane] = vi - v;
    if (lane == kBlockWarps - 1) sc[kBlockWarps] = vi;
  }
  __syncthreads();
  const T out = sc[warp] + incl - x;
  total = sc[kBlockWarps];
  __syncthreads();
  return out;
}

// Load entries [p0, p0 + n) of a row into shared memory (no sync).
template <typename Pos>
__device__ __forceinline__ void stage_piece(const Task<Pos>& t, long long row,
                                            int p0, int n, int* sc,
                                            float* sv) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long base = row * t.K + p0;
  if (t.vec) {  // K % 4 == 0 and 16-byte aligned rows: n % 4 == 0
    const int4* c4 = reinterpret_cast<const int4*>(t.cols + base);
    const float4* v4 = reinterpret_cast<const float4*>(t.vals + base);
    for (int q = lane; q < n / 4; q += kWarp) {
      reinterpret_cast<int4*>(sc)[q] = __ldg(c4 + q);
      reinterpret_cast<float4*>(sv)[q] = __ldg(v4 + q);
    }
  } else {
    for (int k = lane; k < n; k += kWarp) {
      sc[k] = __ldg(t.cols + base + k);
      sv[k] = __ldg(t.vals + base + k);
    }
  }
}

// *p += v with no return value (red: the issuing warp does not wait).
__device__ __forceinline__ void red_add(unsigned* p, unsigned v) {
  asm volatile("red.relaxed.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void red_add(unsigned long long* p, unsigned v) {
  asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;" ::"l"(p),
               "l"((unsigned long long)v)
               : "memory");
}

// Columns that repeat within a warp's round of 32 entries (a skewed or a
// single column) are counted in a small shared-memory table first, and go
// to cnt once a block at the end of phase (a): kHot slots, probed kProbes
// times, else straight to cnt.
struct HotColumns {
  int* key;         // kHot, -1 empty
  unsigned* count;  // kHot
};

// The top digit of a live key: its bucket on the local route.
template <typename Pos>
__device__ __forceinline__ int top_digit(const Task<Pos>& t, int key) {
  return (key >> (8 * (t.passes - 1))) & (kDigits - 1);
}

// Count an entry's key in the block's histograms (shared atomics): its
// first digit, every entry (the global route's first pass), and the top
// digit of a live key (the local route's one pass; hist_top_s NULL where
// that route cannot be taken).
template <typename Pos>
__device__ __forceinline__ void count_digits(const Task<Pos>& t, int key,
                                             Pos* hist_s, Pos* hist_top_s) {
  atomicAdd(hist_s + (key & (kDigits - 1)), (Pos)1);
  if (hist_top_s != nullptr && key < t.d) {
    atomicAdd(hist_top_s + top_digit(t, key), (Pos)1);
  }
}

// Count a warp's live keys by column (the global route's column counts):
// one red a column the warp holds once, the hot table for one it holds
// more often.
template <typename Pos>
__device__ __forceinline__ void count_columns(const Task<Pos>& t, int key,
                                              bool act, HotColumns hot) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int col = act && key < t.d ? key : -1;
  const unsigned peers = __match_any_sync(kFull, col);
  if (col < 0 || lane != __ffs(peers) - 1) return;
  const unsigned n = __popc(peers);
  if (n > 1) {
    unsigned slot = ((unsigned)col * 2654435761u) >> 24;
    for (int probe = 0; probe < kProbes; ++probe) {
      const int k = atomicCAS(hot.key + slot, -1, col);
      if (k == -1 || k == col) {
        atomicAdd(hot.count + slot, n);
        return;
      }
      slot = (slot + 1) & (kHot - 1);
    }
  }
  red_add(t.cnt + col, n);
}

// The hot table into cnt, and back to empty (after a __syncthreads).
template <typename Pos>
__device__ __forceinline__ void flush_hot(const Task<Pos>& t,
                                          HotColumns hot) {
  if (threadIdx.x < kHot && hot.key[threadIdx.x] >= 0) {
    red_add(t.cnt + hot.key[threadIdx.x], hot.count[threadIdx.x]);
    hot.key[threadIdx.x] = -1;
    hot.count[threadIdx.x] = 0;
  }
}

// Keys and products of entries [p0, p0 + n) of slot j, in flat order.
template <typename Pos>
__device__ __forceinline__ void emit_piece(const Task<Pos>& t, long long j,
                                           int p0, int n, const int* sc,
                                           const float* sv, float vj,
                                           float coeff, Pos* hist_s,
                                           Pos* hist_top_s) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long e0 = j * t.K + p0;
  for (int k = lane; k < n; k += kWarp) {
    float v = sv[k];
    if (t.valid != nullptr) v = __fmul_rn(v, vj);
    const int key = v != 0.0f ? sc[k] : t.d;
    t.keys[0][e0 + k] = key;
    t.prods[0][e0 + k] = __fmul_rn(coeff, v);
    count_digits(t, key, hist_s, hist_top_s);
  }
}

// Row r's residual from its lanes' sums s (lane l: k = l, l + 32, ... in
// order): the five-step shuffle tree, then r_j; returns c_j to every lane.
template <typename Pos>
__device__ __forceinline__ float finish_row(const Task<Pos>& t, long long j,
                                            float s, float vj, float y0,
                                            float aj) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
  }
  const float yj = t.valid != nullptr ? __fmul_rn(y0, vj) : y0;
  const float rj = __shfl_sync(kFull, __fsub_rn(s, yj), 0);
  if (lane == 0) t.r[j] = rj;
  return t.alpha != nullptr ? __fsub_rn(rj, aj) : rj;
}

// nb (<= kMaxRows) whole rows of this warp, slots jb + (s0 + r) * 16: row r
// staged at r * Kp (Kp = K rounded up to 32), all rows' loads, then all
// their w gathers, in flight at once.  The lanes' per-slot values (row,
// valid, y, alpha or coeff) sit in lane s0 + r.
template <typename Pos>
__device__ __forceinline__ void residual_rows(
    const Task<Pos>& t, long long jb, int s0, int nb, int q, long long rowl,
    float vl, float yl, float al, int* sc, float* sv, Pos* hist_s,
    Pos* hist_top_s) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int K = t.K, Kp = q * kWarp;
  stamp(t, kDetail);
  for (int r = 0; r < nb; ++r) {
    stage_piece(t, __shfl_sync(kFull, rowl, s0 + r), 0, K, sc + r * Kp,
                sv + r * Kp);
  }
  __syncwarp();
  stamp(t, kDetail + 1);
  float mine = __shfl_sync(kFull, al, (s0 + lane) & (kWarp - 1));
  if (t.residual) {  // lane r ends with row r's coefficient
    const int items = nb * q;
    float p[kStage / kWarp];
#pragma unroll
    for (int i = 0; i < kStage / kWarp; ++i) {
      p[i] = 0.0f;
      if (i < items) {
        const int r = i / q;
        const float vj = __shfl_sync(kFull, vl, s0 + r);
        const int k = (i - r * q) * kWarp + lane;
        if (k < K) {
          float v = sv[i * kWarp + lane];
          if (t.valid != nullptr) v = __fmul_rn(v, vj);
          p[i] = __fmul_rn(v, __ldg(t.w + sc[i * kWarp + lane]));
        }
      }
    }
    float acc = 0.0f;
    int r = 0;
#pragma unroll
    for (int i = 0; i < kStage / kWarp; ++i) {
      if (i < items) {
        acc = __fadd_rn(acc, p[i]);
        if (i + 1 == (r + 1) * q) {
          const int src = s0 + r;
          const float c = finish_row(
              t, jb + (long long)src * kBlockWarps, acc,
              __shfl_sync(kFull, vl, src), __shfl_sync(kFull, yl, src),
              __shfl_sync(kFull, al, src));
          if (lane == r) mine = c;
          acc = 0.0f;
          ++r;
        }
      }
    }
    stamp(t, kDetail + 2);
    for (; r < nb; ++r) {  // K == 0: rows with no entry
      const int src = s0 + r;
      const float c = finish_row(
          t, jb + (long long)src * kBlockWarps, 0.0f,
          __shfl_sync(kFull, vl, src), __shfl_sync(kFull, yl, src),
          __shfl_sync(kFull, al, src));
      if (lane == r) mine = c;
    }
  }
  for (int r = 0; r < nb; ++r) {
    emit_piece(t, jb + (long long)(s0 + r) * kBlockWarps, 0, K, sc + r * Kp,
               sv + r * Kp, __shfl_sync(kFull, vl, s0 + r),
               __shfl_sync(kFull, mine, r), hist_s, hist_top_s);
  }
  stamp(t, kDetail + 3);
}

// One row longer than kStage, staged a piece at a time (read twice).
template <typename Pos>
__device__ void residual_long_row(const Task<Pos>& t, long long j,
                                  long long row, float vj, float y0,
                                  float aj, int* sc, float* sv,
                                  Pos* hist_s, Pos* hist_top_s) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int K = t.K;
  float coeff = aj;
  if (t.residual) {
    float s = 0.0f;
    for (int p0 = 0; p0 < K; p0 += kStage) {
      const int n = min(kStage, K - p0);
      __syncwarp();
      stage_piece(t, row, p0, n, sc, sv);
      __syncwarp();
      for (int k = lane; k < n; k += kWarp) {
        float v = sv[k];
        if (t.valid != nullptr) v = __fmul_rn(v, vj);
        s = __fadd_rn(s, __fmul_rn(v, __ldg(t.w + sc[k])));
      }
    }
    coeff = finish_row(t, j, s, vj, y0, aj);
  }
  for (int p0 = 0; p0 < K; p0 += kStage) {
    const int n = min(kStage, K - p0);
    __syncwarp();
    stage_piece(t, row, p0, n, sc, sv);
    __syncwarp();
    emit_piece(t, j, p0, n, sc, sv, vj, coeff, hist_s, hist_top_s);
  }
}

// Phase (a) over slots [j0, j1): warp w takes slots j0 + w, j0 + w + 16,
// ..., 32 at a time, whose idx, valid, y and alpha (or coeff) its lanes
// load together, then up to kMaxRows whole rows at a time.
template <typename Pos>
__device__ void residual_phase(const Task<Pos>& t, long long j0, long long j1,
                               int* stage, Pos* hist_s, Pos* hist_top_s) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  int* sc = stage + warp * kStage;
  float* sv = reinterpret_cast<float*>(stage + kBlockWarps * kStage) +
              warp * kStage;
  const int q = (t.K + kWarp - 1) / kWarp;  // a lane's entries of a row
  const int Kp = q * kWarp;
  const int per = Kp <= kStage ? min(kMaxRows, kStage / max(Kp, kWarp)) : 0;
  for (long long jb = j0 + warp; jb < j1;
       jb += (long long)kWarp * kBlockWarps) {
    const long long jl = jb + (long long)lane * kBlockWarps;
    long long rowl = jl;
    float vl = 1.0f, yl = 0.0f, al = 0.0f;
    if (jl < j1) {
      if (t.idx != nullptr) rowl = __ldg(t.idx + jl);
      if (t.valid != nullptr) vl = __ldg(t.valid + jl);
      if (t.residual) {
        yl = __ldg(t.y + rowl);
        if (t.alpha != nullptr) {
          al = __ldg(t.alpha + (t.alpha_slots ? jl : rowl));
        }
      } else {
        al = __ldg(t.coeff + jl);
      }
    }
    const long long left = (j1 - jb + kBlockWarps - 1) / kBlockWarps;
    const int count = left < kWarp ? (int)left : kWarp;
    if (per > 0) {
      for (int s0 = 0; s0 < count; s0 += per) {
        residual_rows(t, jb, s0, min(per, count - s0), q, rowl, vl, yl, al,
                      sc, sv, hist_s, hist_top_s);
        __syncwarp();
      }
    } else {
      for (int s_ = 0; s_ < count; ++s_) {
        residual_long_row(t, jb + (long long)s_ * kBlockWarps,
                          __shfl_sync(kFull, rowl, s_),
                          __shfl_sync(kFull, vl, s_),
                          __shfl_sync(kFull, yl, s_),
                          __shfl_sync(kFull, al, s_), sc, sv, hist_s,
                          hist_top_s);
      }
    }
  }
}

// A block's histogram into a digit-major table ([256][blocks]) and into
// its totals.
template <typename Pos>
__device__ __forceinline__ void publish_hist(const Pos* hist_s, Pos* table,
                                             Pos* tot, int b, int blocks) {
  if (threadIdx.x < kDigits) {
    const Pos h = hist_s[threadIdx.x];
    table[(size_t)threadIdx.x * blocks + b] = h;
    if (h != 0) atomicAdd(tot + threadIdx.x, h);
  }
}

// The global route's pass p's histogram of the block's tile [lo, hi).
template <typename Pos>
__device__ void hist_phase(const Task<Pos>& t, int p, Pos lo, Pos hi,
                           Pos* hist_s, int b, int blocks) {
  if (threadIdx.x < kDigits) hist_s[threadIdx.x] = 0;
  __syncthreads();
  const int* in = t.keys[p & 1];
  const int shift = 8 * p;
  for (Pos base = lo; base < hi; base += kThreads * kRanks) {
    int digit[kRanks];
#pragma unroll
    for (int u = 0; u < kRanks; ++u) {  // all loads first
      const Pos i = base + (Pos)(u * kThreads + threadIdx.x);
      digit[u] = i < hi ? (__ldcg(in + i) >> shift) & (kDigits - 1) : -1;
    }
#pragma unroll
    for (int u = 0; u < kRanks; ++u) {
      if (digit[u] >= 0) atomicAdd(hist_s + digit[u], (Pos)1);
    }
  }
  __syncthreads();
  publish_hist(hist_s, t.hist, t.tot[p & 1], b, blocks);
}

// The global route's column counts: the block's tile of first-pass keys
// [lo, hi) (flat order), counted by column into cnt.
template <typename Pos>
__device__ void count_phase(const Task<Pos>& t, Pos lo, Pos hi,
                            HotColumns hot) {
  if (threadIdx.x < kHot) {
    hot.key[threadIdx.x] = -1;
    hot.count[threadIdx.x] = 0;
  }
  __syncthreads();
  const int* in = t.keys[0];
  for (Pos base = lo; base < hi; base += kThreads * kRanks) {
    int key[kRanks];
#pragma unroll
    for (int u = 0; u < kRanks; ++u) {  // all loads first
      const Pos i = base + (Pos)(u * kThreads + threadIdx.x);
      key[u] = i < hi ? __ldcg(in + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kRanks; ++u) {
      if (base + (Pos)(u * kThreads) >= hi) break;  // the same for the block
      count_columns(t, key[u], key[u] >= 0, hot);
    }
  }
  __syncthreads();
  flush_hot(t, hot);
}

// The longest column one thread sums: kShortMax, or L where that is less.
template <typename Pos>
__device__ __forceinline__ Pos short_max(const Task<Pos>& t) {
  return (Pos)min(kShortMax, t.chunk);
}

template <typename Pos>
__device__ __forceinline__ void push_items(const Task<Pos>& t, int c, Pos n) {
  if (n <= short_max(t)) return;
  const unsigned chunks = (unsigned)((n + t.chunk - 1) / t.chunk);
  const unsigned q = atomicAdd(t.ctrl + 1, chunks);
  for (unsigned i = 0; i < chunks; ++i) {
    t.items[q + i] = make_int2(c, (int)i);
  }
}

// Column tiles b, b + blocks, ...: the counts' inclusive scan within the
// tile, the tile's total, the long columns' items; the counts go back to 0.
template <typename Pos>
__device__ void column_phase(const Task<Pos>& t, int b, int blocks, Pos* sc) {
  const int tiles = (t.d + kColTile - 1) / kColTile;
  for (int tile = b; tile < tiles; tile += blocks) {
    const int c = tile * kColTile + 2 * threadIdx.x;
    const Pos n0 = c < t.d ? __ldcg(t.cnt + c) : Pos(0);
    const Pos n1 = c + 1 < t.d ? __ldcg(t.cnt + c + 1) : Pos(0);
    Pos total;
    const Pos ex = block_excl_scan<Pos>(n0 + n1, sc, total);
    if (c < t.d) {
      t.col_incl[c] = ex + n0;
      t.cnt[c] = 0;
      push_items(t, c, n0);
    }
    if (c + 1 < t.d) {
      t.col_incl[c + 1] = ex + n0 + n1;
      t.cnt[c + 1] = 0;
      push_items(t, c + 1, n1);
    }
    if (threadIdx.x == 0) t.tile_tot[tile] = total;
  }
}

// offs[v][b] = (entries of digits below v) + (entries of digit v in blocks
// before b), from a digit-major table and its totals: a warp a digit,
// digits v = b, b + blocks, ...
template <typename Pos>
__device__ void scan_phase(const Task<Pos>& t, const Pos* hist,
                           const Pos* tot, int b, int blocks) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  constexpr int kLoads = 8;
  for (int v = b + warp * blocks; v < kDigits; v += kBlockWarps * blocks) {
    Pos base = 0;
#pragma unroll
    for (int u = 0; u < kDigits / kWarp; ++u) {
      const int x = u * kWarp + lane;
      if (x < v) base += __ldcg(tot + x);
    }
    base = warp_sum(base);
    for (int b0 = 0; b0 < blocks; b0 += kLoads * kWarp) {
      Pos h[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {  // all loads first
        const int bi = b0 + u * kWarp + lane;
        h[u] = bi < blocks ? __ldcg(hist + (size_t)v * blocks + bi) : Pos(0);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int bi = b0 + u * kWarp + lane;
        const Pos incl = warp_incl_scan(h[u]);
        if (bi < blocks) t.offs[(size_t)v * blocks + bi] = base + incl - h[u];
        base += __shfl_sync(kFull, incl, kWarp - 1);
      }
    }
  }
}

// A sub-tile of n entries (in_k, in_v already at its start) into
// registers: warp w of the team takes entries (w*R + u)*32 + lane, u < R =
// rounds.  key -1: no entry (past n, or keyed d where only live keys are
// wanted).
__device__ __forceinline__ void load_entries(const int* in_k,
                                             const float* in_v, int n,
                                             int rounds, int d, bool live_only,
                                             int warp, int (&key)[kRanks],
                                             float (&val)[kRanks]) {
  const int lane = threadIdx.x & (kWarp - 1);
#pragma unroll
  for (int u = 0; u < kRanks; ++u) {
    const int i = (warp * rounds + u) * kWarp + lane;
    const bool act = u < rounds && i < n;
    const int k = act ? __ldcg(in_k + i) : -1;
    key[u] = live_only && k >= d ? -1 : k;
    val[u] = act ? __ldcg(in_v + i) : 0.0f;
  }
}

// Each warp ranks its entries by digit (key >> shift) & 255, 32 at a time
// in order (__match_any): rank[u] counts the warp's earlier entries of the
// same digit, and my[] (the warp's row of wcnt) its counts.
__device__ __forceinline__ void rank_entries(const int (&key)[kRanks],
                                             int (&rank)[kRanks], int rounds,
                                             int shift, int* my) {
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kRanks; ++u) {
    if (u >= rounds) break;
    const int digit = key[u] >= 0 ? (key[u] >> shift) & (kDigits - 1) : -1;
    const unsigned peers = __match_any_sync(kFull, digit);
    rank[u] = digit >= 0 ? my[digit] + __popc(peers & below) : 0;
    __syncwarp();
    if (digit >= 0 && (peers & below) == 0) my[digit] += __popc(peers);
    __syncwarp();
  }
}

// Once every warp has ranked: each warp's count of a digit becomes the
// count of that digit in the warps before it (warp order keeps flat
// order), and thread v < 256 gets the digit's count in the sub-tile and
// returns its start in the sub-tile's digit order; `total`: the entries
// ranked.
__device__ __forceinline__ int digit_starts(int* wcnt, int* isc, int& count,
                                            int& total) {
  __syncthreads();
  count = 0;
  if (threadIdx.x < kDigits) {
    for (int w = 0; w < kBlockWarps; ++w) {
      const int c = wcnt[w * kDigits + threadIdx.x];
      wcnt[w * kDigits + threadIdx.x] = count;
      count += c;
    }
  }
  return block_excl_scan<int>(count, isc, total);
}

// A stable scatter of the block's tile [lo, hi) of (in_k, in_v) by digit
// (key >> shift) & 255 to (out_k, out_v) at offs, sub-tile by sub-tile:
// the warps rank their entries, the sub-tile is put in digit order in
// shared memory (skey, sval) and then written out a run of consecutive
// positions a digit, so that neighbouring threads write neighbouring
// addresses.  The global route's last pass (last) writes no keys and
// drops the entries keyed d; the local route's one pass (live_only)
// leaves them out altogether, as its histogram did.
template <typename Pos>
__device__ void scatter_phase(const Task<Pos>& t, const int* in_k,
                              const float* in_v, int* out_k, float* out_v,
                              int shift, bool last, bool live_only, Pos lo,
                              Pos hi, int b, int blocks, int* wcnt,
                              Pos* run_off, Pos* sub_base, int* loc,
                              int* skey, float* sval, Pos* sc) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  int* my = wcnt + warp * kDigits;
  if (threadIdx.x < kDigits) {
    run_off[threadIdx.x] = __ldcg(t.offs + (size_t)threadIdx.x * blocks + b);
  }
  for (int v = lane; v < kDigits; v += kWarp) my[v] = 0;
  __syncthreads();
  for (Pos sub = lo; sub < hi; sub += kSubTile) {
    const int n = hi - sub < (Pos)kSubTile ? (int)(hi - sub) : kSubTile;
    const int rounds = (n + kThreads - 1) / kThreads;  // a warp's, <= kRanks
    int key[kRanks];
    float val[kRanks];
    int rank[kRanks];
    load_entries(in_k + sub, in_v + sub, n, rounds, t.d, live_only, warp, key,
                 val);
    rank_entries(key, rank, rounds, shift, my);
    int count, total;
    const int start =
        digit_starts(wcnt, reinterpret_cast<int*>(sc), count, total);
    if (threadIdx.x < kDigits) {
      loc[threadIdx.x] = start;
      sub_base[threadIdx.x] = run_off[threadIdx.x];
      run_off[threadIdx.x] += (Pos)count;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kRanks; ++u) {
      if (key[u] < 0) continue;
      const int digit = (key[u] >> shift) & (kDigits - 1);
      const int at = loc[digit] + my[digit] + rank[u];
      skey[at] = key[u];
      sval[at] = val[u];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int k = skey[i];
      // the global route's last pass: no sum reads the entries keyed d
      if (last && k >= t.d) continue;
      const int digit = (k >> shift) & (kDigits - 1);
      const Pos pos = sub_base[digit] + (Pos)(i - loc[digit]);
      if (!last) out_k[pos] = k;
      out_v[pos] = sval[i];
    }
    for (int v = lane; v < kDigits; v += kWarp) my[v] = 0;
    __syncthreads();
  }
}

// a[0..n) added one at a time from 0.0f, in order (eight loads ahead).
__device__ __forceinline__ float serial_sum(const float* a, int n) {
  float s = 0.0f;
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = a[i + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) s = __fadd_rn(s, x[u]);
  }
  for (; i < n; ++i) s = __fadd_rn(s, a[i]);
  return s;
}

// A block's halves (8 warps each) work apart in the bucket phase, each
// with its own named barrier (ids 1 and 2; 0 is __syncthreads).
constexpr int kHalf = kThreads / 2;
constexpr int kHalfWarps = kBlockWarps / 2;

__device__ __forceinline__ void half_sync(int h) {
  asm volatile("bar.sync %0, %1;" ::"r"(h + 1), "n"(kHalf) : "memory");
}

// Exclusive scan of x over half h's threads in thread order (as
// block_excl_scan over a block); isc: kHalfWarps + 1 ints of the half's.
__device__ __forceinline__ int half_excl_scan(int x, int* isc, int h,
                                              int& total) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = (threadIdx.x >> 5) - h * kHalfWarps;
  const int incl = warp_incl_scan(x);
  if (lane == kWarp - 1) isc[w] = incl;
  half_sync(h);
  if (w == 0) {
    const int v = lane < kHalfWarps ? isc[lane] : 0;
    const int vi = warp_incl_scan(v);
    if (lane < kHalfWarps) isc[lane] = vi - v;
    if (lane == kHalfWarps - 1) isc[kHalfWarps] = vi;
  }
  half_sync(h);
  const int out = isc[w] + incl - x;
  total = isc[kHalfWarps];
  half_sync(h);
  return out;
}

// The bucket phase where no bucket holds more than kHalf * kRanks (2,048)
// entries: each half of a block takes buckets on its own (half h of block
// b: buckets b + blocks * h, b + blocks * (h + 2), ...), so 185 buckets
// take one round of 132 blocks.  Each half does what bucket_phase does
// for a whole block, with its own rows of wcnt, digit starts (loc_h),
// shared memory (sval_h) and scan scratch (isc_h).
template <typename Pos>
__device__ void bucket_halves(const Task<Pos>& t, int b, int blocks,
                              int buckets, int* wcnt, int* loc0, int* loc1,
                              float* svals, int* iscs) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  const int h = warp / kHalfWarps, hw = warp % kHalfWarps;
  const int ht = threadIdx.x % kHalf;  // the half's thread: its digit
  int* my = wcnt + warp * kDigits;
  int* loc = h ? loc1 : loc0;
  float* sval = svals + h * kHalf * kRanks;
  int* isc = iscs + h * (kHalfWarps + 1);
  const int shift = 8 * (t.passes - 1);
  for (int v = b + blocks * h; v < buckets; v += 2 * blocks) {
    // the bucket starts where block 0's run of its digit does
    const Pos s = __ldcg(t.offs + (size_t)v * blocks);
    const int n = (int)__ldcg(t.tot_top + v);
    const int rounds = (n + kHalf - 1) / kHalf;
    int key[kRanks];
    float val[kRanks];
    int rank[kRanks];
    load_entries(t.keys[1] + s, t.prods[1] + s, n, rounds, t.d, false, hw,
                 key, val);
    rank_entries(key, rank, rounds, 0, my);  // by the low digit
    half_sync(h);
    int count = 0;
    for (int w = h * kHalfWarps; w < (h + 1) * kHalfWarps; ++w) {
      const int c = wcnt[w * kDigits + ht];
      wcnt[w * kDigits + ht] = count;
      count += c;
    }
    int total;
    const int start = half_excl_scan(count, isc, h, total);
    loc[ht] = start;
    half_sync(h);
#pragma unroll
    for (int u = 0; u < kRanks; ++u) {
      if (key[u] < 0) continue;
      const int digit = key[u] & (kDigits - 1);
      sval[loc[digit] + my[digit] + rank[u]] = val[u];
    }
    half_sync(h);
    const int c = shift ? (v << shift) | ht : ht;
    if (c < t.d && (shift != 0 || c == v)) {
      t.g[c] = serial_sum(sval + start, count);
    }
    for (int u = lane; u < kDigits; u += kWarp) my[u] = 0;
    half_sync(h);
  }
}

// The local route's last phase.  Bucket v holds the live entries whose top
// digit is v, in flat order after the scatter, at most kSubTile of them
// (the route's condition).  The block ranks it by the low digit as a
// sub-tile is ranked, which puts it in column order in shared memory, and
// one thread sums each of its columns there, serially from 0.0f: every
// column of the bucket has at most L entries, so this is the order of the
// global route and of the plain version.  Buckets v = b, b + blocks, ...,
// or, where none holds more than 2,048 entries (halves), a bucket a half
// block (bucket_halves).
template <typename Pos>
__device__ void bucket_phase(const Task<Pos>& t, int b, int blocks,
                             bool halves, int* wcnt, int* loc, int* loc1,
                             float* sval, Pos* sc) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  int* my = wcnt + warp * kDigits;
  const int shift = 8 * (t.passes - 1);
  const int buckets = t.d > 0 ? ((t.d - 1) >> shift) + 1 : 0;
  for (int v = lane; v < kDigits; v += kWarp) my[v] = 0;
  __syncwarp();
  if (halves) {
    bucket_halves(t, b, blocks, buckets, wcnt, loc, loc1, sval,
                  reinterpret_cast<int*>(sc));
    return;
  }
  for (int v = b; v < buckets; v += blocks) {
    // the bucket starts where block 0's run of its digit does
    const Pos s = __ldcg(t.offs + (size_t)v * blocks);
    const int n = (int)__ldcg(t.tot_top + v);
    const int rounds = (n + kThreads - 1) / kThreads;
    int key[kRanks];
    float val[kRanks];
    int rank[kRanks];
    load_entries(t.keys[1] + s, t.prods[1] + s, n, rounds, t.d, false, warp,
                 key, val);
    rank_entries(key, rank, rounds, 0, my);  // by the low digit
    int count, total;
    const int start =
        digit_starts(wcnt, reinterpret_cast<int*>(sc), count, total);
    if (threadIdx.x < kDigits) loc[threadIdx.x] = start;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kRanks; ++u) {
      if (key[u] < 0) continue;
      const int digit = key[u] & (kDigits - 1);
      sval[loc[digit] + my[digit] + rank[u]] = val[u];
    }
    __syncthreads();
    if (threadIdx.x < kDigits) {
      // one digit: the bucket is column v; two: column v * 256 + digit
      const int c = shift ? (v << shift) | threadIdx.x : threadIdx.x;
      if (c < t.d && (shift != 0 || c == v)) {
        t.g[c] = serial_sum(sval + start, count);
      }
    }
    for (int u = lane; u < kDigits; u += kWarp) my[u] = 0;
    __syncthreads();
  }
}

// Sorted entries [lo, hi) of p added one at a time from 0.0f, in order,
// by lane 0: the warp loads a round of 256 entries (coalesced, the next
// round's loads in flight while lane 0 adds) into its 1 KB of shared
// memory `buf`, and lane 0 reads them back four at a time, so the chain
// costs about one dependent add an entry.  Every lane gets the sum.
template <typename Pos>
__device__ float warp_serial_sum(const float* __restrict__ p, Pos lo, Pos hi,
                                 float* buf) {
  const int lane = threadIdx.x & (kWarp - 1);
  constexpr int kRoundEntries = kWarp * kRound;
  float part[kRound];
#pragma unroll
  for (int u = 0; u < kRound; ++u) {
    const Pos i = lo + (Pos)(u * kWarp + lane);
    part[u] = i < hi ? __ldcg(p + i) : 0.0f;
  }
  float s = 0.0f;
  for (Pos base = lo; base < hi; base += kRoundEntries) {
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kRound; ++u) buf[u * kWarp + lane] = part[u];
    __syncwarp();
    const Pos next = base + kRoundEntries;
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const Pos i = next + (Pos)(u * kWarp + lane);
      part[u] = i < hi ? __ldcg(p + i) : 0.0f;
    }
    if (lane == 0) {
      const int count =
          hi - base < (Pos)kRoundEntries ? (int)(hi - base) : kRoundEntries;
      const float4* b4 = reinterpret_cast<const float4*>(buf);
      int i = 0;
      for (; i + 32 <= count; i += 32) {  // eight loads ahead of 32 adds
        float4 x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = b4[i / 4 + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          s = __fadd_rn(s, x[u].x);
          s = __fadd_rn(s, x[u].y);
          s = __fadd_rn(s, x[u].z);
          s = __fadd_rn(s, x[u].w);
        }
      }
      for (; i < count; ++i) s = __fadd_rn(s, buf[i]);
    }
  }
  return __shfl_sync(kFull, s, 0);
}

template <typename Pos>
__device__ __forceinline__ void bounds(const Task<Pos>& t, const Pos* tbase,
                                       int c, Pos& start, Pos& end) {
  const Pos base = tbase[c / kColTile];
  end = base + __ldcg(t.col_incl + c);
  start = c % kColTile ? base + __ldcg(t.col_incl + c - 1) : base;
}

// Phase (c): warps take groups of 32 columns in turn (warp k of the grid:
// groups k, k + warps, ...; a thread a column of at most kShortMax
// entries), then claim the longer columns' chunks from ctrl[0].
template <typename Pos>
__device__ void segment_phase(const Task<Pos>& t, int blocks, Pos* tbase,
                              float* bufs, Pos* sc) {
  const int lane = threadIdx.x & (kWarp - 1);
  float* buf = bufs + (threadIdx.x >> 5) * kWarp * kRound;
  const int d = t.d;
  // the column tiles' bases: an exclusive scan of their totals
  const int tiles = (d + kColTile - 1) / kColTile;
  Pos carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kThreads) {
    const int ti = t0 + threadIdx.x;
    const Pos x = ti < tiles ? __ldcg(t.tile_tot + ti) : Pos(0);
    Pos total;
    const Pos ex = block_excl_scan<Pos>(x, sc, total);
    if (ti < tiles) tbase[ti] = carry + ex;
    carry += total;
  }
  __syncthreads();
  const float* prods = t.prods[t.passes & 1];
  const unsigned nitems = __ldcg(t.ctrl + 1);
  const int warps = blocks * kBlockWarps;
  for (int c = (blockIdx.x * kBlockWarps + (threadIdx.x >> 5)) * kWarp + lane;
       c < d; c += warps * kWarp) {
    Pos start, end;
    bounds(t, tbase, c, start, end);
    const Pos n = end - start;
    if (n > short_max(t)) continue;  // an item's
    float v[kShortMax];
#pragma unroll
    for (int u = 0; u < kShortMax; ++u) {
      v[u] = (Pos)u < n ? __ldcg(prods + start + u) : 0.0f;
    }
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < kShortMax; ++u) {
      if ((Pos)u < n) s = __fadd_rn(s, v[u]);
    }
    t.g[c] = s;
  }
  for (;;) {
    unsigned q = 0;
    if (lane == 0 && nitems > 0) q = atomicAdd(t.ctrl, 1u);
    q = __shfl_sync(kFull, q, 0);
    if (q >= nitems) break;
    const int2 it = __ldcg(t.items + q);
    Pos start, end;
    bounds(t, tbase, it.x, start, end);
    const Pos lo = start + (Pos)it.y * (Pos)t.chunk;
    const Pos hi = min(lo + (Pos)t.chunk, end);
    const float s = warp_serial_sum(prods, lo, hi, buf);
    const unsigned chunks =
        (unsigned)((end - start + (Pos)t.chunk - 1) / (Pos)t.chunk);
    if (chunks == 1) {
      if (lane == 0) t.g[it.x] = s;
      continue;
    }
    const unsigned first = q - (unsigned)it.y;
    int last = 0;
    if (lane == 0) {
      t.partials[q] = s;
      __threadfence();
      last = atomicAdd(t.done + first, 1u) == chunks - 1;
    }
    if (__shfl_sync(kFull, last, 0)) {
      __threadfence();
      const float total = warp_serial_sum(t.partials, (Pos)first,
                                          (Pos)(first + chunks), buf);
      if (lane == 0) {
        t.g[it.x] = total;
        t.done[first] = 0;
      }
    }
  }
}

template <typename Pos>
__global__ void __launch_bounds__(kThreads, 1)
    sparse_task_kernel(const __grid_constant__ Task<Pos> t) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* stage = reinterpret_cast<int*>(smem);
  int* wcnt = stage + kBlockWarps * kStage * 2;
  const HotColumns hot{wcnt + kBlockWarps * kDigits,
                       reinterpret_cast<unsigned*>(wcnt + kBlockWarps * kDigits +
                                                   kHot)};
  Pos* hist_s = reinterpret_cast<Pos*>(hot.count + kHot);
  Pos* hist_top_s = hist_s + kDigits;
  Pos* run_off = hist_top_s + kDigits;
  Pos* sub_base = run_off + kDigits;
  Pos* sc = sub_base + kDigits;
  // the scatter's reorder and the tile bases reuse the staging, the
  // scatter's digit starts the histogram's room
  int* skey = stage;
  float* sval = reinterpret_cast<float*>(stage + kSubTile);
  Pos* tbase = reinterpret_cast<Pos*>(stage + 2 * kSubTile);
  int* loc = reinterpret_cast<int*>(hist_s);
  __shared__ int last_block;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int b = blockIdx.x, blocks = gridDim.x;
  const long long j0 = t.m * b / blocks, j1 = t.m * (b + 1) / blocks;
  const Pos lo = (Pos)(j0 * t.K), hi = (Pos)(j1 * t.K);
  // the local route sorts by the top digit, then each bucket in shared
  // memory: at most two digits, and every bucket within kSubTile and L
  const bool may_be_local = !t.global_only && t.passes <= 2;

  int si = 0;
  stamp(t, si++);
  if (threadIdx.x < kDigits) {
    hist_s[threadIdx.x] = 0;
    hist_top_s[threadIdx.x] = 0;
  }
  __syncthreads();
  residual_phase(t, j0, j1, stage, hist_s,
                 may_be_local ? hist_top_s : (Pos*)nullptr);
  __syncthreads();
  publish_hist(hist_s, t.hist, t.tot[0], b, blocks);
  if (may_be_local) publish_hist(hist_top_s, t.hist_top, t.tot_top, b, blocks);
  stamp(t, si++);
  grid.sync();
  stamp(t, si++);
  bool local = false, halves = false;
  if (may_be_local) {  // every block reads the same totals: one decision
    Pos top = threadIdx.x < kDigits ? __ldcg(t.tot_top + threadIdx.x) : 0;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      top = max(top, __shfl_xor_sync(kFull, top, off));
    }
    if ((threadIdx.x & (kWarp - 1)) == 0) sc[threadIdx.x >> 5] = top;
    __syncthreads();
    for (int w = 0; w < kBlockWarps; ++w) top = max(top, sc[w]);
    local = top <= (Pos)min(kSubTile, t.chunk);  // the largest bucket
    halves = top <= (Pos)(kHalf * kRanks);
    __syncthreads();
  }
  if (t.stamps != nullptr && threadIdx.x == 0) {
    t.stamps[(size_t)b * kStamps + kRouteStamp] = local;
  }
  if (local) {
    scan_phase(t, t.hist_top, t.tot_top, b, blocks);
    stamp(t, si++);
    grid.sync();
    stamp(t, si++);
    scatter_phase(t, t.keys[0], t.prods[0], t.keys[1], t.prods[1],
                  8 * (t.passes - 1), false, true, lo, hi, b, blocks, wcnt,
                  run_off, sub_base, loc, skey, sval, sc);
    stamp(t, si++);
    grid.sync();
    stamp(t, si++);
    bucket_phase(t, b, blocks, halves, wcnt, loc,
                 reinterpret_cast<int*>(sub_base), sval, sc);
  } else {
    for (int p = 0; p < t.passes; ++p) {
      if (p > 0) {
        hist_phase(t, p, lo, hi, hist_s, b, blocks);
        if (p == 1) column_phase(t, b, blocks, sc);
        stamp(t, si++);
        grid.sync();
        stamp(t, si++);
      }
      scan_phase(t, t.hist, t.tot[p & 1], b, blocks);
      if (p == 0) count_phase(t, lo, hi, hot);
      stamp(t, si++);
      grid.sync();
      stamp(t, si++);
      // every reader of this pass's totals came before the barrier
      if (b == 0 && threadIdx.x < kDigits) t.tot[p & 1][threadIdx.x] = 0;
      if (p == 0 && t.passes == 1) column_phase(t, b, blocks, sc);
      scatter_phase(t, t.keys[p & 1], t.prods[p & 1], t.keys[(p + 1) & 1],
                    t.prods[(p + 1) & 1], 8 * p, p == t.passes - 1, false,
                    lo, hi, b, blocks, wcnt, run_off, sub_base, loc, skey,
                    sval, sc);
      stamp(t, si++);
      grid.sync();
      stamp(t, si++);
    }
    segment_phase(t, blocks, tbase, sval, sc);
  }
  __syncthreads();
  stamp(t, si++);
  if (threadIdx.x == 0) {  // the last block out resets the scratch read late
    __threadfence();
    last_block = atomicAdd(t.ctrl + 2, 1u) == (unsigned)blocks - 1;
  }
  __syncthreads();
  if (last_block) {
    if (threadIdx.x < kDigits) {
      t.tot_top[threadIdx.x] = 0;
      t.tot[0][threadIdx.x] = 0;  // read on the global route's first pass
    }
    if (threadIdx.x == 0) {
      t.ctrl[0] = 0;
      t.ctrl[1] = 0;
      t.ctrl[2] = 0;
    }
  }
}

// The scratch's layout: offsets (16-byte aligned) into the plain and the
// zeroed buffers.
struct Layout {
  size_t keys[2], prods[2], hist, hist_top, offs, col_incl, tile_tot, items,
      partials, bytes;
  size_t tot[2], tot_top, cnt, done, ctrl, zbytes;
};

inline size_t take(size_t& at, size_t n) {
  const size_t o = (at + 15) & ~size_t(15);
  at = o + n;
  return o;
}

inline Layout layout(long long m, int K, int d, int blocks, size_t pos,
                     long long max_items) {
  Layout L{};
  const size_t n = (size_t)m * (size_t)K;
  const size_t tiles = ((size_t)d + kColTile - 1) / kColTile;
  size_t at = 0;
  for (int i = 0; i < 2; ++i) {
    L.keys[i] = take(at, 4 * n);
    L.prods[i] = take(at, 4 * n);
  }
  L.hist = take(at, pos * kDigits * blocks);
  L.hist_top = take(at, pos * kDigits * blocks);
  L.offs = take(at, pos * kDigits * blocks);
  L.col_incl = take(at, pos * d);
  L.tile_tot = take(at, pos * tiles);
  L.items = take(at, 8 * (size_t)max_items);
  L.partials = take(at, 4 * (size_t)max_items);
  L.bytes = at;
  at = 0;
  L.tot[0] = take(at, pos * kDigits);
  L.tot[1] = take(at, pos * kDigits);
  L.tot_top = take(at, pos * kDigits);
  L.cnt = take(at, pos * d);
  L.done = take(at, 4 * (size_t)max_items);
  L.ctrl = take(at, 16);
  L.zbytes = at;
  return L;
}

// Raises the kernel's dynamic shared-memory limit, once a device.
template <typename Pos>
cudaError_t task_attr() {
  static std::atomic<unsigned long long> done{0};  // one bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(sparse_task_kernel<Pos>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<Pos>());
  if (e != cudaSuccess) return e;
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

template <typename Pos>
cudaError_t task_launch(Task<Pos>& t, const Layout& L, unsigned char* ws,
                        unsigned char* zws, int blocks, cudaStream_t s) {
  cudaError_t e = task_attr<Pos>();
  if (e != cudaSuccess) return e;
  for (int i = 0; i < 2; ++i) {
    t.keys[i] = reinterpret_cast<int*>(ws + L.keys[i]);
    t.prods[i] = reinterpret_cast<float*>(ws + L.prods[i]);
  }
  t.hist = reinterpret_cast<Pos*>(ws + L.hist);
  t.hist_top = reinterpret_cast<Pos*>(ws + L.hist_top);
  t.offs = reinterpret_cast<Pos*>(ws + L.offs);
  t.col_incl = reinterpret_cast<Pos*>(ws + L.col_incl);
  t.tile_tot = reinterpret_cast<Pos*>(ws + L.tile_tot);
  t.items = reinterpret_cast<int2*>(ws + L.items);
  t.partials = reinterpret_cast<float*>(ws + L.partials);
  t.tot[0] = reinterpret_cast<Pos*>(zws + L.tot[0]);
  t.tot[1] = reinterpret_cast<Pos*>(zws + L.tot[1]);
  t.tot_top = reinterpret_cast<Pos*>(zws + L.tot_top);
  t.cnt = reinterpret_cast<Pos*>(zws + L.cnt);
  t.done = reinterpret_cast<unsigned*>(zws + L.done);
  t.ctrl = reinterpret_cast<unsigned*>(zws + L.ctrl);
  void* args[] = {(void*)&t};
  e = cudaLaunchCooperativeKernel((const void*)sparse_task_kernel<Pos>,
                                  dim3(blocks), dim3(kThreads), args,
                                  (size_t)smem_bytes<Pos>(), s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace task

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

// Bytes of the two scratch buffers of one sparse_task launch: `bytes`
// written before they are read, `zbytes` zero before the first launch
// (each launch leaves them zero).
int sparse_task_workspace(long long m, int K, int d, int blocks, int wide,
                          long long max_items, long long* bytes,
                          long long* zbytes) {
  const task::Layout L =
      task::layout(m, K, d, blocks, wide ? 8 : 4, max_items);
  *bytes = (long long)L.bytes;
  *zbytes = (long long)L.zbytes;
  return cudaSuccess;
}

// Enqueue one sparse_task launch on `stream`; no synchronisation.
//   cols: (n, K) int32 in [0, d)   vals: (n, K) f32
//   residual: 1 with y: (n,) f32 and w: (d,) f32 (the residual form), or
//   0 with coeff: (m,) f32 (the coefficient form)
//   idx: (m,) int64 in [0, n) or NULL (m == n)   valid: (m,) f32 or NULL
//   alpha: (n,) f32 or NULL (residual form: c_j = r_j - alpha[row_j]), or
//     with alpha_slots 1 (m,) f32 (c_j = r_j - alpha[j])
//   passes: 8-bit digits of the keys [0, d]   chunk: L   vec: 16-byte rows
//   wide: 64-bit positions   max_items: bound on the long columns' chunks
//   blocks: one an SM   r: (m,) f32 out (residual form)   g: (d,) f32 out
//   ws, zws: scratch of sparse_task_workspace's sizes, zws zero
//   stamps: NULL, or (blocks, 32) u64 for the phases' %globaltimer stamps
// Returns the cudaError_t of the launch (0 on success).
int sparse_task_launch(const int* cols, const float* vals, const float* y,
                       const float* w, const long long* idx,
                       const float* valid, const float* coeff,
                       const float* alpha, int alpha_slots, long long m,
                       int K, int d, int passes, int chunk, int vec, int wide,
                       int residual, int global_only, long long max_items,
                       int blocks,
                       float* r, float* g, void* ws, void* zws,
                       unsigned long long* stamps, void* stream) {
  const long long tiles =
      ((long long)d + task::kColTile - 1) / task::kColTile;
  if (passes < 1 || passes > 4 || chunk < 1 || blocks < 1 || K < 0 ||
      d < 0 || m < 0 || tiles > task::kMaxColTiles ||
      (!residual && coeff == nullptr && m > 0)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const task::Layout L =
      task::layout(m, K, d, blocks, wide ? 8 : 4, max_items);
  unsigned char* wb = static_cast<unsigned char*>(ws);
  unsigned char* zb = static_cast<unsigned char*>(zws);
  if (wide) {
    task::Task<unsigned long long> t{};
    t.cols = cols; t.vals = vals; t.y = y; t.w = w; t.idx = idx;
    t.valid = valid; t.coeff = coeff; t.alpha = alpha;
    t.alpha_slots = alpha_slots; t.m = m; t.K = K;
    t.d = d; t.passes = passes; t.chunk = chunk; t.vec = vec;
    t.residual = residual; t.global_only = global_only; t.r = r; t.g = g;
    t.stamps = stamps;
    return task::task_launch(t, L, wb, zb, blocks, s);
  }
  task::Task<unsigned> t{};
  t.cols = cols; t.vals = vals; t.y = y; t.w = w; t.idx = idx;
  t.valid = valid; t.coeff = coeff; t.alpha = alpha;
  t.alpha_slots = alpha_slots; t.m = m; t.K = K;
  t.d = d; t.passes = passes; t.chunk = chunk; t.vec = vec;
  t.residual = residual; t.global_only = global_only; t.r = r; t.g = g;
  t.stamps = stamps;
  return task::task_launch(t, L, wb, zb, blocks, s);
}

const char* sparse_grad_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
