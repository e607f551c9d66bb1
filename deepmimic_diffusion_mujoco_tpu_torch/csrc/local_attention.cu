// Windowed look-around attention: three entry points on one core, each in a
// float32 and a bf16 form:
//
//   fused_qkv_local_attention_f32  (B3) qkv (B, N, 3*h*dh) -> out (B, N, h*dh),
//     all heads, straight from the QKV projection; prefix key lengths and an
//     attention-dropout keep mask (B, Np, h*K) are optional.
//     fused_qkv_local_attention_bf16 is its bf16 form (a model built with
//     bf16=True): bf16 qkv in, bf16 context out, everything between in
//     float32 exactly as the f32 entry computes it, as the TPU kernel upcasts
//     a bf16 qkv and writes qkv.dtype. Its instance stages bf16 as bf16 and
//     widens in the consumer (Design, bf16); the store rounds once. The
//     float32 instance is unchanged by it.
//   local_attention_heads_f32      (B4) q, k, v (B*h, N, dh) -> out (B*h, N, dh).
//     local_attention_heads_bf16 is its bf16 form: bf16 q, k, v and out. The
//     TPU kernel scales q in q's dtype (`q_ref * scale`: bf16 q times the
//     scale rounded to bf16, the product rounded to bf16) and only then
//     rotates in float32, so this entry rounds q * scale to bf16 in step 2
//     (`round_q`); scores, softmax and P V are float32 and the store rounds
//     once, as in B3's bf16 entry. (B3's TPU kernel upcasts q before it
//     scales: its bf16 entry does not round there.)
//   local_attention_halo_f32       (K3, B3's halo entry) one rank's share of a
//     horizon split over ranks (sequence-sharded sampling): qkv (B, Nh,
//     3*h*dh) is the rank's slab, q0 rows of the previous rank (w, or none at
//     the trajectory's start), its own Nq rows, then the next rank's rows (w,
//     or none at the end or when causal) -> out (B, Nq, h*dh) for its own
//     rows. It is B3 with one chunk of the Nq query rows starting at slab row
//     q0, P = w: the keys are the slab's rows, the slab's ends are the
//     trajectory's (masked as B3 masks its clamped edges), prefix lengths
//     come in slab rows, and the rotary table's row r holds slab row r's
//     global position, so Q and K rotate where the unsharded kernel rotates
//     them. A row whose keys are all masked gets the mean of V over the
//     chunk's Nq + 2w key slots (the unsharded kernel's chunk is 128 rows).
//     local_attention_halo_bf16 is its bf16 form (a bf16 model's horizon
//     split): B3's bf16 core from slab row q0, a bf16 slab in, a bf16
//     context out.
//
// Replaces the TPU kernels deepmimic_diffusion_mujoco_tpu/ops/pallas/
// fused_local_attention.py:fused_qkv_local_attention (B3) and
// ops/pallas/local_attention_kernel.py:local_attention_tpu (B4). It computes
// what they compute, with their chunk plan (ops/fused_local_attention.py
// `plan`): the padded sequence (Np rows, pad rows are zero keys that take
// part in the softmax) runs in chunks of C query rows whose keys are the
// chunk itself plus P rows on each side, clamped at the edges where the
// clamped duplicates are masked. B3's single plan is one chunk of Np rows
// (P 0); its sliced plan is C 128 with P = w (or 128); B4 is C 128, P 128.
// For a chunk c the valid keys are therefore exactly the rows
// [c*C - P, (c+1)*C + P) within [0, Np). Rotary runs at absolute positions
// (queries at i + look_forward * w, keys at j), masks are the window /
// exact / causal ones, and keys at or past the sequence's length are masked.
//
// Bound on an H100 at the transformer's shapes (dh 64, w 16, h 8): a query
// and head has 33 unmasked keys (|i - j| <= w), so the work is about
// 4 * 33 * dh = 8.4 kflop against 1 KB of QKV read and context written:
// 8 flops a byte, under the f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20, so the
// bound is set by bytes (16.8 MB, 5.0 us at B 16 x H 128).
//
// Design. One block per (query slab of S rows within a chunk, head, batch
// row); the launch plan (S, the staged key rows `cap`, the compute units) is
// chosen in Python (ops/fused_local_attention.py `attention_plan`, from the
// timings of ops/local_attention_sweep.py). A block
//   1. stages its slab's Q, its key band's K (the rows the slab's windows
//      reach within the chunk), the band's V and, with rotary, the cos/sin
//      rows of Q's and K's positions from a table the wrapper caches, with
//      16-byte cp.async from every thread: Q, K and the tables under one
//      mbarrier, V under another, so the block waits on one memory round
//      trip and V lands while Q K^T runs; rows past N are zeroed;
//   2. once Q and K land, scales Q and rotates Q and K in place, each
//      (row, pair of dims) once per block, then one block barrier;
//   3. gives each warp RPW query rows and the keys their windows reach (at
//      most RPW + 3w), walked a tile of keys at a time with the online
//      softmax; a row's allowed keys are one interval (windows, exact and
//      causal cuts, length), so a key's mask is two comparisons. On the
//      tensor cores (RPW 16, 16-key tiles) Q K^T and P V are 3xTF32
//      mma.sync.m16n8k8 (each operand split into two tf32 halves; f32
//      accuracy, where plain TF32 would miss 1e-4), the score fragment
//      serving as P V's A fragment. On the CUDA cores (RPW 8, 48-key tiles)
//      a row's 4 lanes split each tile's keys and the output dims, the
//      weights crossing between them by shuffles. Either way scores,
//      softmax state and the context stay in registers until the lanes
//      store the context rows. No block barrier after step 2;
//   4. only where lengths are given and some row has every key masked:
//      stages the chunk's K key rows of V a tile at a time (one more
//      barrier a tile) and gives that row the mean of V over them, times
//      the keep mask: the TPU kernel's softmax over K equal -1e9 scores.
// Masked keys outside the band have weight exp(-1e9 - max) = 0 in the TPU
// kernel too, so the band gives the same result for every other row. Where
// a band does not fit in shared memory even at the smallest slab (dh 128
// with w 128), the block stages it in segments of `cap` rows, the online
// softmax carrying across them, with one barrier and one round trip each.
// Shared-memory rows have a stride of dh + 4 floats, so the rows a warp
// reads at once sit in different banks.
//
// What limits the float32 form at B 16 x H 128 (ops/local_attention_sweep.py's
// clock stamps, H100): all blocks stage at once, so the load phase runs at
// the card's bandwidth, and only then does any block compute; launch, the
// mbarrier set-up and the rotation add a few microseconds of latency.
//
// bf16 (T = bf16). The staged rows are bf16 as they come: Q, K and V with
// 16-byte cp.async into rows of DH + 8 values (a 16-byte pad, so the rows a
// warp reads fall in different banks), Q and K under bars[0] and V under
// bars[1] as in the float32 form, so V lands while Q K^T runs. Only Q's and
// K's real rows are copied; V's rows past N are zero stores. The consumers
// widen (a 16-bit shift): step 2 reads the bf16 Q and K rows and writes the
// float32 scaled and rotated rows that Q K^T reads (3xTF32, the float32
// form's values), taking cos/sin from the table in L2 (one bulk L2 prefetch
// of the block's table rows goes out with the copies; staging them, as the
// float32 form does, was slower in ops/local_attention_sweep.py --bf16:
// the table rows outweigh the bf16 rows); P V builds its B fragment
// straight from the bf16 V rows. A bf16 value widened to float32 is a TF32
// value (8 mantissa bits of 10), so V's TF32 low half is zero and P V takes
// two products, P_lo V and P_hi V, where the float32 form's third adds
// zeros. Half the staged bytes and no cos/sin rows let a plan hold two or
// three blocks an SM (ops/fused_local_attention.py `attention_plan`, elem
// 2). Its kernel asks ptxas for one block an SM (launch bounds), which keeps
// the CUDA-core instances' set-up values out of local memory.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrappers (ops/fused_local_attention.py, ops/local_attention_kernel.py)
// validate shapes, dtypes, contiguity and the plan before they call in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "mma_tf32.h"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 232448;  // a block's shared memory, dynamic and static
constexpr int kStaticSmem = 16;   // the two mbarriers

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;         // element (row, d) of head y, batch z at
  const void* k;         //   base + z * in_z + y * in_y + row * in_row + d
  const void* v;         //   (float, or bf16 in the bf16 entry)
  void* out;             //   out + z * out_z + y * out_y + row * out_row + d
  const int* lengths;    // (batch,) valid keys per sequence, or null
  const float* keep;     // keep + z * keep_z + row * keep_row + y * K + kk, or null
  const float* rot;      // (positions, dh / 2, 2): cos, sin of pos * freq (with rotary)
  long long in_z, in_y, in_row;
  long long out_z, out_y, out_row;
  long long keep_z, keep_row;
  int N;                 // real rows (rows in [N, Np) are zero)
  int Np;                // padded rows
  int q0, Nq;            // query rows [q0, q0 + Nq): chunks start at q0 (0 and Np but in K3)
  int w, lf, causal, exact, rotary;
  int C, P, K;           // chunk rows, neighbour rows per side, keys per chunk
  float scale;           // dh ** -0.5 (B4's bf16 entry: rounded to bf16)
  int round_q;           // B4's bf16 entry: q * scale rounded to bf16 before the rotation
  float inv_keep;        // 1 / keep_prob
};

struct Plan {
  int slab;  // S: query rows per block, a multiple of the rows per warp, at most kMaxWarps warps
  int cap;   // K and V rows staged at once (the whole band unless it does not fit)
};

// Query rows a warp owns: 16 on the tensor cores (one m16 tile), 8 on the CUDA cores.
__host__ __device__ constexpr int rows_per_warp(bool mma) { return mma ? 16 : 8; }

// The key rows [lo, hi) that query rows [q0, q1) of one chunk can see: the
// chunk's key range cut to the windows they reach (look_backward 1).
__host__ __device__ inline void key_band(const Args& a, int q0, int q1, int* lo, int* hi) {
  const int base = a.q0 + (q0 - a.q0) / a.C * a.C;  // the chunk's first row
  int l = base - a.P;
  int h = base + a.C + a.P;
  const int wl = (q0 / a.w - 1) * a.w;
  int wh = ((q1 - 1) / a.w + a.lf + 1) * a.w;
  if (a.causal && wh > q1) wh = q1;
  l = l > wl ? l : wl;
  h = h < wh ? h : wh;
  *lo = l > 0 ? l : 0;
  *hi = h < a.Np ? h : a.Np;
}

// Key row of chunk key slot kk (0 <= kk < K): the previous chunk's last P
// rows, the chunk, the next chunk's first P rows, clamped at the edges.
__device__ __forceinline__ int chunk_key_row(const Args& a, int c, int kk) {
  if (a.P == 0) return kk;
  const int base = a.q0 + c * a.C;
  if (kk < a.P) return max(base - a.P, 0) + kk;
  if (kk < a.P + a.C) return base + kk - a.P;
  return min(base + a.C, a.Np - a.P) + kk - a.P - a.C;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Arrives on `bar` once every cp.async this thread has issued so far is done.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Prefetches `bytes` (a multiple of 16) of global memory from `src` (16-byte
// aligned) into L2, one bulk request.
__device__ __forceinline__ void l2_prefetch(const void* src, uint32_t bytes) {
  if (bytes > 0)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes)
                 : "memory");
}

// Four bf16 values (8 bytes) widened to float32 (exact: a 16-bit shift).
__device__ __forceinline__ float4 widen4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Element i of a staged row, as float32.
__device__ __forceinline__ float elem(const float* row, int i) { return row[i]; }
__device__ __forceinline__ float elem(const bf16* row, int i) {
  return __uint_as_float(static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(row)[i]) << 16);
}

// Staged row stride, in elements: the float32 form's rows DH + 4 floats, the
// bf16 form's staged rows DH + 8 values (16 bytes of pad either way)
template <int DH, typename E>
__host__ __device__ constexpr int row_stride() {
  return std::is_same_v<E, float> ? DH + 4 : DH + 8;
}

// Two and four context values to `p`, rounded once where T is bf16.
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store4(float* p, float x, float y, float z, float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}
__device__ __forceinline__ void store4(bf16* p, float x, float y, float z, float w) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x, y), b = __floats2bfloat162_rn(z, w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
}

// Stage rows [0, n) of one operand into dst (row stride row_stride<DH, E>):
// row r from src(r), or zeros where src(r) is null. Every thread copies
// 16-byte pieces (4 floats or 8 bf16 values, as they are) with cp.async and
// arrives on `bar` once its pieces land (one arrival a thread); the zero
// rows are plain stores, which a block barrier makes visible.
template <int DH, typename E, typename Src>
__device__ __forceinline__ void stage(E* dst, int n, Src src, uint64_t* bar, int tid,
                                      int nthreads) {
  constexpr int kPer = 16 / sizeof(E);  // elements a piece
  constexpr int kVec = DH / kPer;
  for (int e = tid; e < n * kVec; e += nthreads) {
    const int r = e / kVec, v = e % kVec;
    const E* row = src(r);
    E* d = dst + r * row_stride<DH, E>() + kPer * v;
    if (row != nullptr)
      copy16(d, row + kPer * v);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  mbar_arrive_on_copies(bar);
}

// x * mul, rounded to bf16 (nearest even) where `round` is set.
__device__ __forceinline__ float scaled(float x, float mul, bool round) {
  const float y = x * mul;
  return round ? __bfloat162float(__float2bfloat16_rn(y)) : y;
}

// One rotation item: x1, x2 the four (dim, dim + DH/2) pairs, scaled by
// `mul` (the product rounded to bf16 where `round` is set) and, with a table
// row, rotated by its (cos, sin) float4s t01, t23. Both forms' step 2 run it,
// so they compute the same values.
__device__ __forceinline__ void rotate_item(float4 a, float4 b, const float4* t, float mul,
                                            bool round, float4* x1p, float4* x2p) {
  float x1[4] = {scaled(a.x, mul, round), scaled(a.y, mul, round), scaled(a.z, mul, round),
                 scaled(a.w, mul, round)};
  float x2[4] = {scaled(b.x, mul, round), scaled(b.y, mul, round), scaled(b.z, mul, round),
                 scaled(b.w, mul, round)};
  if (t != nullptr) {
    const float4 t01 = t[0], t23 = t[1];
    const float cs[4] = {t01.x, t01.z, t23.x, t23.z}, sn[4] = {t01.y, t01.w, t23.y, t23.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float y1 = x1[c] * cs[c] - x2[c] * sn[c];
      const float y2 = x2[c] * cs[c] + x1[c] * sn[c];
      x1[c] = y1;
      x2[c] = y2;
    }
  }
  *x1p = make_float4(x1[0], x1[1], x1[2], x1[3]);
  *x2p = make_float4(x2[0], x2[1], x2[2], x2[3]);
}

// Scale (the product rounded to bf16 where `round` is set) and, with `tab`,
// rotate staged rows [0, rows) in place: item (r, g) is the four (dim, dim +
// DH/2) pairs 4g .. 4g + 3 of row r, so no two threads touch one value;
// `tab` row r holds those pairs' (cos, sin) at row r's position.
template <int DH>
__device__ __forceinline__ void rotate_rows(float* base, const float* tab, int rows, float mul,
                                            bool round, int tid, int nthreads) {
  constexpr int kItems = DH / 8;
#pragma unroll 4
  for (int e = tid; e < rows * kItems; e += nthreads) {
    const int r = e / kItems, g = e % kItems;
    float4* x1p = reinterpret_cast<float4*>(base + r * (DH + 4)) + g;
    float4* x2p = x1p + kItems;
    rotate_item(*x1p, *x2p,
                tab != nullptr ? reinterpret_cast<const float4*>(tab + r * (DH + 4)) + 2 * g
                               : nullptr,
                mul, round, x1p, x2p);
  }
}

// The bf16 form's step 2: rows [0, real) of the staged bf16 rows `src`
// widened, scaled and, with `tab` (row r at tab + r * DH floats: the table
// in L2), rotated into the float32 rows `dst`, as rotate_rows does them in
// place; rows [real, rows) of dst are zero.
template <int DH>
__device__ __forceinline__ void widen_rows(float* dst, const bf16* src, const float* tab,
                                           int rows, int real, float mul, bool round, int tid,
                                           int nthreads) {
  constexpr int kItems = DH / 8;
#pragma unroll 4
  for (int e = tid; e < rows * kItems; e += nthreads) {
    const int r = e / kItems, g = e % kItems;
    float4* x1p = reinterpret_cast<float4*>(dst + r * (DH + 4)) + g;
    float4* x2p = x1p + kItems;
    if (r < real) {
      const uint2* s = reinterpret_cast<const uint2*>(src + r * (DH + 8)) + g;
      rotate_item(widen4(s[0]), widen4(s[kItems]),
                  tab != nullptr ? reinterpret_cast<const float4*>(tab + r * DH) + 2 * g
                                 : nullptr,
                  mul, round, x1p, x2p);
    } else {
      *x1p = make_float4(0.f, 0.f, 0.f, 0.f);
      *x2p = *x1p;
    }
  }
}

// o += p * row (this lane's dims of one staged row: groups of four g * L + h)
template <int DH, int L, typename E>
__device__ __forceinline__ void accumulate(float* o, float p, const E* row, int h) {
#pragma unroll
  for (int g = 0; g < DH / (4 * L); ++g) {
    float4 vv;
    if constexpr (std::is_same_v<E, float>)
      vv = reinterpret_cast<const float4*>(row)[g * L + h];
    else
      vv = widen4(reinterpret_cast<const uint2*>(row)[g * L + h]);
    o[4 * g] = fmaf(p, vv.x, o[4 * g]);
    o[4 * g + 1] = fmaf(p, vv.y, o[4 * g + 1]);
    o[4 * g + 2] = fmaf(p, vv.z, o[4 * g + 2]);
    o[4 * g + 3] = fmaf(p, vv.w, o[4 * g + 3]);
  }
}

// The keys query row i may see form one interval [*jlo, *jhi): its windows,
// the exact / causal cuts and the sequence's length (none past the slab).
__device__ __forceinline__ void row_keys(const Args& a, int i, int len, int s1, int* jlo,
                                         int* jhi) {
  const int wi = i / a.w;
  int lo = (wi - 1) * a.w, hi = (wi + a.lf + 1) * a.w;
  if (a.causal) {
    hi = min(hi, i + 1);
    if (a.exact) lo = max(lo, i - a.w);
  } else if (a.exact) {
    lo = max(lo, i - a.w);
    hi = min(hi, i + a.w * a.lf + 1);
  }
  *jlo = lo;
  *jhi = i < s1 ? min(hi, len) : lo;
}

// The A fragment (rows g and g + 8, dims k0 + t and k0 + t + 4) of a warp's
// 16 staged query rows from `qrow` (row g), as tf32 (hi, lo) pairs.
template <int DH>
__device__ __forceinline__ void q_fragment(const float* qrow, int k0, int t, uint32_t* hi,
                                           uint32_t* lo) {
  split_tf32(qrow[k0 + t], &hi[0], &lo[0]);
  split_tf32(qrow[8 * (DH + 4) + k0 + t], &hi[1], &lo[1]);
  split_tf32(qrow[k0 + t + 4], &hi[2], &lo[2]);
  split_tf32(qrow[8 * (DH + 4) + k0 + t + 4], &hi[3], &lo[3]);
}

// DH: head width; MMA: the products on the tensor cores (3xTF32 m16n8k8,
// 16 query rows a warp, 16-key tiles), else on the CUDA cores (8 rows a
// warp, 48-key tiles: a warp's whole band at w 16).
//
// CUDA cores: a row's L = 4 lanes split each tile's keys (lane h of the row
// takes keys t0 + L m + h) and the output dims (float4s g L + h).
// Tensor cores: the warp's 16 rows are one m16 tile; lane (g, t) = (lane /
// 4, lane % 4) holds rows g and g + 8 of the fragments: scores of keys
// t0 + 8 n + 2 t and + 1, outputs of dims 8 d + 2 t and + 1. P V reads a
// k-step's keys 2t and 2t + 1 as its logical keys t and t + 4, so the score
// fragment is P V's A fragment as it stands.
//
// T: the element type of qkv and the context (float, or bf16 in the bf16
// entry); scores and sums are float32 either way. Shared memory, in order:
// float32: Q (S rows), K, V (cap rows each) and, with rotary, the cos/sin
// rows of Q's and K's positions (S, cap), all of DH + 4 floats;
// bf16: the staged bf16 Q, K, V (S, cap, cap rows of DH + 8 values), then
// the float32 rotated Q and K (S, cap rows of DH + 4 floats).
template <int DH, bool MMA, typename T>
__device__ __forceinline__ void windowed_attention(const Args& a, const Plan& p) {
  constexpr int kStride = DH + 4;
  constexpr int RPW = rows_per_warp(MMA);
  constexpr int TILE = MMA ? 16 : 48;        // keys per tile
  constexpr int L = 32 / RPW;
  constexpr int KPL = TILE / L;              // CUDA cores: keys per lane per tile
  constexpr int R = MMA ? 2 : 1;             // query rows per lane
  constexpr int kOut = MMA ? DH / 2 : DH / L;  // output values per lane
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  constexpr int kVStride = row_stride<DH, T>();  // staged rows, elements of T
  extern __shared__ float4 smem4[];
  __shared__ uint64_t bars[2];  // 0: Q and K landed, 1: V landed
  // qs, ks: the rows Q K^T reads (float32); vs: V as staged; qr, kr: the
  // bf16 form's staged Q and K (the float32 form stages into qs, ks)
  T* const qr = reinterpret_cast<T*>(smem4);  // S x kVStride
  T* const kr = qr + p.slab * kVStride;       // cap x kVStride
  T* const vs = kr + p.cap * kVStride;        // cap x kVStride
  float* const qs = kBf16 ? reinterpret_cast<float*>(vs + p.cap * kVStride)
                          : reinterpret_cast<float*>(qr);  // S x kStride
  float* const ks = kBf16 ? qs + p.slab * kStride : reinterpret_cast<float*>(kr);
  // float32 with rotary: the (cos, sin) rows of the queries' and the keys' positions
  float* const qt = reinterpret_cast<float*>(vs + p.cap * kStride);  // S x kStride
  float* const kt = qt + p.slab * kStride;                           // cap x kStride
  const bool tables = a.rotary && !kBf16;  // cos/sin rows staged

  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int spc = (a.C + p.slab - 1) / p.slab;  // slabs per chunk
  const int c = blockIdx.x / spc;
  const int s0 = a.q0 + c * a.C + (blockIdx.x % spc) * p.slab;
  const int s1 = min(min(s0 + p.slab, a.q0 + (c + 1) * a.C), a.q0 + a.Nq);
  const int head = blockIdx.y, z = blockIdx.z;
  const long long in_base = z * a.in_z + head * a.in_y;
  const T* qb = static_cast<const T*>(a.q) + in_base;
  const T* kb = static_cast<const T*>(a.k) + in_base;
  const T* vb = static_cast<const T*>(a.v) + in_base;
  const int len = a.lengths != nullptr ? a.lengths[z] : a.Np;
  int blo, bhi;
  key_band(a, s0, s1, &blo, &bhi);

  // this lane's query rows and key share; its warp's key band
  const int h = MMA ? lane & 3 : lane / RPW;   // MMA: t
  const int r = MMA ? lane >> 2 : lane % RPW;  // MMA: g
  const int q0 = s0 + warp * RPW;
  const bool active = q0 < s1;
  int wlo = 0, whi = 0;
  if (active) key_band(a, q0, min(q0 + RPW, s1), &wlo, &whi);
  int rows[R], jlo[R], jhi[R];
  const float* keep_row[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    rows[u] = q0 + r + 8 * u;
    row_keys(a, rows[u], len, s1, &jlo[u], &jhi[u]);
    keep_row[u] = a.keep != nullptr && rows[u] < s1
                      ? a.keep + z * a.keep_z + (rows[u] - a.q0) * a.keep_row + head * a.K
                      : nullptr;
  }
  const int slot0 = a.P - a.q0 - c * a.C;  // chunk key slot of key row j: j + slot0

  if (tid == 0) {  // each thread arrives once a stage: Q, K (and their tables); V
    mbar_init(&bars[0], (tables ? 4 : 2) * nthreads);
    mbar_init(&bars[1], nthreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float o[kOut];
#pragma unroll
  for (int e = 0; e < kOut; ++e) o[e] = 0.f;
  // MMA at DH <= 64: this lane's Q fragments (hi, lo), split once and kept
  constexpr bool kKeepQ = MMA && DH <= 64;
  uint32_t qh[kKeepQ ? DH / 8 : 1][4], ql[kKeepQ ? DH / 8 : 1][4];
  // each row's running max, and this lane's share of its sum
  float m[R], l[R];
#pragma unroll
  for (int u = 0; u < R; ++u) m[u] = -INFINITY, l[u] = 0.f;

  int phase = 0;  // bars[1] phases so far
  for (int lo = blo; lo < bhi; lo += p.cap, ++phase) {
    const int hi = min(lo + p.cap, bhi);
    if (lo > blo) __syncthreads();  // every warp is done with the previous segment's rows
    // 1. one round trip: Q and K under bars[0], V under bars[1]
    const int nq = lo == blo ? s1 - s0 : 0;
    const int q_real = max(0, min(s0 + nq, a.N) - s0), k_real = max(0, min(hi, a.N) - lo);
    // the bf16 form copies Q's and K's real rows only: step 2 writes the zero rows
    stage<DH>(qr, kBf16 ? q_real : nq, [&](int rr) -> const T* {
      return s0 + rr < a.N ? qb + (long long)(s0 + rr) * a.in_row : nullptr;
    }, &bars[0], tid, nthreads);
    stage<DH>(kr, kBf16 ? k_real : hi - lo, [&](int rr) -> const T* {
      return lo + rr < a.N ? kb + (long long)(lo + rr) * a.in_row : nullptr;
    }, &bars[0], tid, nthreads);
    stage<DH>(vs, hi - lo, [&](int rr) -> const T* {
      return lo + rr < a.N ? vb + (long long)(lo + rr) * a.in_row : nullptr;
    }, &bars[1], tid, nthreads);
    const int qpos = s0 + a.lf * a.w;
    if (kBf16 && a.rotary && tid == 0) {  // the table rows step 2 reads, on their way to L2
      l2_prefetch(a.rot + (long long)qpos * DH, q_real * DH * sizeof(float));
      l2_prefetch(a.rot + (long long)lo * DH, k_real * DH * sizeof(float));
    }
    if (tables) {
      stage<DH>(qt, nq, [&](int rr) -> const float* {
        return s0 + rr < a.N ? a.rot + (long long)(qpos + rr) * DH : nullptr;
      }, &bars[0], tid, nthreads);
      stage<DH>(kt, hi - lo, [&](int rr) -> const float* {
        return lo + rr < a.N ? a.rot + (long long)(lo + rr) * DH : nullptr;
      }, &bars[0], tid, nthreads);
    }
    mbar_wait(&bars[0], phase & 1);

    // 2. scale Q, rotate Q and K (the zero rows stay zero), then the one barrier
    if constexpr (kBf16) {
      const float* qtab = a.rotary ? a.rot + (long long)qpos * DH : nullptr;
      const float* ktab = a.rotary ? a.rot + (long long)lo * DH : nullptr;
      if (nq > 0) widen_rows<DH>(qs, qr, qtab, nq, q_real, a.scale, a.round_q, tid, nthreads);
      widen_rows<DH>(ks, kr, ktab, hi - lo, k_real, 1.f, false, tid, nthreads);
    } else {
      if (q_real > 0)
        rotate_rows<DH>(qs, a.rotary ? qt : nullptr, q_real, a.scale, a.round_q, tid, nthreads);
      if (a.rotary) rotate_rows<DH>(ks, kt, k_real, 1.f, false, tid, nthreads);
    }
    __syncthreads();

    if constexpr (kKeepQ) {
      if (lo == blo) {
#pragma unroll
        for (int k0 = 0; k0 < DH; k0 += 8)
          q_fragment<DH>(qs + (q0 + r - s0) * kStride, k0, h, qh[k0 / 8], ql[k0 / 8]);
      }
    }

    // 3. this warp's keys in this segment, a tile at a time
    const int t_beg = max(wlo, lo), t_end = min(whi, hi);
    int j_end[R];
#pragma unroll
    for (int u = 0; u < R; ++u) j_end[u] = min(jhi[u], t_end);
    bool v_landed = false;
    for (int t0 = t_beg; t0 < t_end; t0 += TILE) {
      float s[MMA ? 8 : KPL];  // MMA: key n-tile n, row u, key 2t + e at s[4n + 2u + e]
      if constexpr (MMA) {
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e] = 0.f;
        // the two n-tiles' key rows (clamped into the segment)
        const float* krow0 = ks + (min(t0 + r, t_end - 1) - lo) * kStride;
        const float* krow1 = ks + (min(t0 + 8 + r, t_end - 1) - lo) * kStride;
#pragma unroll
        for (int k0 = 0; k0 < DH; k0 += 8) {
          uint32_t ah_[4], al_[4], bh[2], bl[2];
          if constexpr (!kKeepQ) q_fragment<DH>(qs + (q0 + r - s0) * kStride, k0, h, ah_, al_);
          const uint32_t* ah = kKeepQ ? qh[kKeepQ ? k0 / 8 : 0] : ah_;
          const uint32_t* al = kKeepQ ? ql[kKeepQ ? k0 / 8 : 0] : al_;
          split_tf32(krow0[k0 + h], &bh[0], &bl[0]);
          split_tf32(krow0[k0 + h + 4], &bh[1], &bl[1]);
          mma_3xtf32(s, ah, al, bh, bl);
          split_tf32(krow1[k0 + h], &bh[0], &bl[0]);
          split_tf32(krow1[k0 + h + 4], &bh[1], &bl[1]);
          mma_3xtf32(s + 4, ah, al, bh, bl);
        }
      } else {
        int krow[KPL];  // staged row of each key (in float4s), clamped into the segment
#pragma unroll
        for (int mm = 0; mm < KPL; ++mm) {
          s[mm] = 0.f;
          krow[mm] = (min(t0 + L * mm + h, t_end - 1) - lo) * (kStride / 4);
        }
        const float4* q4 = reinterpret_cast<const float4*>(qs + (rows[0] - s0) * kStride);
        const float4* k4 = reinterpret_cast<const float4*>(ks);
#pragma unroll 8
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 qv = q4[d4];
#pragma unroll
          for (int mm = 0; mm < KPL; ++mm) s[mm] = dot4(qv, k4[krow[mm] + d4], s[mm]);
        }
      }
      // score e's key and row (u)
      auto key_of = [&](int e) {
        return MMA ? t0 + 8 * (e >> 2) + 2 * h + (e & 1) : t0 + L * e + h;
      };
      auto row_of = [&](int e) { return MMA ? (e >> 1) & 1 : 0; };
      constexpr int kS = MMA ? 8 : KPL;
      float tmax[R];
#pragma unroll
      for (int u = 0; u < R; ++u) tmax[u] = -INFINITY;
#pragma unroll
      for (int e = 0; e < kS; ++e) {
        const int j = key_of(e), u = row_of(e);
        s[e] = j >= jlo[u] && j < j_end[u] ? s[e] : -INFINITY;
        tmax[u] = fmaxf(tmax[u], s[e]);
      }
      float corr[R], m_use[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        // the row's other lanes: L lanes RPW apart, or the 4 lanes of a quad
#pragma unroll
        for (int off = MMA ? 1 : RPW; off < (MMA ? 4 : 32); off <<= 1)
          tmax[u] = fmaxf(tmax[u], __shfl_xor_sync(0xffffffffu, tmax[u], off));
        const float m_new = fmaxf(m[u], tmax[u]);
        m_use[u] = m_new == -INFINITY ? 0.f : m_new;
        corr[u] = expf(m[u] - m_use[u]);  // 0 while the row has no unmasked key
        m[u] = m_new;
        l[u] *= corr[u];
      }
#pragma unroll
      for (int e = 0; e < kS; ++e) {
        const int u = row_of(e);
        s[e] = expf(s[e] - m_use[u]);
        l[u] += s[e];
      }
#pragma unroll
      for (int e = 0; e < kOut; ++e) o[e] *= corr[MMA ? (e >> 1) & 1 : 0];
#pragma unroll
      for (int e = 0; e < kS; ++e) {
        const int j = key_of(e), u = row_of(e);
        if (keep_row[u] != nullptr && j < t_end) s[e] *= keep_row[u][j + slot0] * a.inv_keep;
      }
      if (!v_landed) {
        mbar_wait(&bars[1], phase & 1);
        v_landed = true;
      }
      if constexpr (MMA) {
#pragma unroll
        for (int k8 = 0; k8 < 2; ++k8) {  // keys t0 + 8 k8 + (2t, 2t + 1) as logical t, t + 4
          uint32_t ah[4], al[4];
          split_tf32(s[4 * k8], &ah[0], &al[0]);
          split_tf32(s[4 * k8 + 2], &ah[1], &al[1]);
          split_tf32(s[4 * k8 + 1], &ah[2], &al[2]);
          split_tf32(s[4 * k8 + 3], &ah[3], &al[3]);
          const T* vrow0 = vs + (min(t0 + 8 * k8 + 2 * h, t_end - 1) - lo) * kVStride;
          const T* vrow1 = vs + (min(t0 + 8 * k8 + 2 * h + 1, t_end - 1) - lo) * kVStride;
#pragma unroll
          for (int d = 0; d < DH / 8; ++d) {
            uint32_t bh[2], bl[2];
            if constexpr (kBf16) {  // widened bf16 is TF32: lo = 0, two products
              bh[0] = __float_as_uint(elem(vrow0, 8 * d + r));
              bh[1] = __float_as_uint(elem(vrow1, 8 * d + r));
              mma_tf32(o + 4 * d, al, bh);
              mma_tf32(o + 4 * d, ah, bh);
            } else {
              split_tf32(vrow0[8 * d + r], &bh[0], &bl[0]);
              split_tf32(vrow1[8 * d + r], &bh[1], &bl[1]);
              mma_3xtf32(o + 4 * d, ah, al, bh, bl);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < TILE; ++kk) {
          const float pk = __shfl_sync(0xffffffffu, s[kk / L], r + RPW * (kk % L));
          accumulate<DH, L>(o, pk, vs + (min(t0 + kk, t_end - 1) - lo) * kVStride, h);
        }
      }
    }
    mbar_wait(&bars[1], phase & 1);  // no copy is in flight past the segment
  }
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int off = MMA ? 1 : RPW; off < (MMA ? 4 : 32); off <<= 1)
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], off);

  // 4. rows whose keys are all masked (only with key lengths): the mean of V
  // over the chunk's K key rows, times the keep mask, V staged a tile at a time
  bool masked[R], any_masked = false;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    masked[u] = active && m[u] == -INFINITY && rows[u] < min(s1, a.N);
    any_masked = any_masked || masked[u];
  }
  if (a.lengths != nullptr) {
    if (__syncthreads_or(any_masked)) {
      const float inv_k = 1.f / static_cast<float>(a.K);
#pragma unroll
      for (int e = 0; e < kOut; ++e)
        if (masked[MMA ? (e >> 1) & 1 : 0]) o[e] = 0.f;
      for (int t0 = 0; t0 < a.K; t0 += p.cap, ++phase) {
        if (t0 > 0) __syncthreads();
        const int nt = min(p.cap, a.K - t0);
        stage<DH>(vs, nt, [&](int rr) -> const T* {
          const int j = chunk_key_row(a, c, t0 + rr);
          return j < a.N ? vb + (long long)j * a.in_row : nullptr;
        }, &bars[1], tid, nthreads);
        mbar_wait(&bars[1], phase & 1);
        __syncthreads();  // the zero rows are written
#pragma unroll
        for (int u = 0; u < R; ++u) {
          if (!masked[u]) continue;
          for (int kk = 0; kk < nt; ++kk) {
            const float wgt = keep_row[u] != nullptr ? inv_k * keep_row[u][t0 + kk] * a.inv_keep
                                                     : inv_k;
            const T* vrow = vs + kk * kVStride;
            if constexpr (MMA) {
#pragma unroll
              for (int d = 0; d < DH / 8; ++d) {
                o[4 * d + 2 * u] = fmaf(wgt, elem(vrow, 8 * d + 2 * h), o[4 * d + 2 * u]);
                o[4 * d + 2 * u + 1] =
                    fmaf(wgt, elem(vrow, 8 * d + 2 * h + 1), o[4 * d + 2 * u + 1]);
              }
            } else {
              accumulate<DH, L>(o, wgt, vrow, h);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < R; ++u)
        if (masked[u]) l[u] = 1.f;
    }
  }

  // 5. the context rows
#pragma unroll
  for (int u = 0; u < R; ++u) {
    if (!(active && rows[u] < min(s1, a.N))) continue;
    T* out_row = static_cast<T*>(a.out) + z * a.out_z + head * a.out_y +
                 (long long)(rows[u] - a.q0) * a.out_row;
    const float inv_l = 1.f / l[u];
    if constexpr (MMA) {
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
        store2(out_row + 8 * d + 2 * h, o[4 * d + 2 * u] * inv_l, o[4 * d + 2 * u + 1] * inv_l);
    } else {
#pragma unroll
      for (int g = 0; g < kOut / 4; ++g)
        store4(out_row + 4 * (g * L + h), o[4 * g] * inv_l, o[4 * g + 1] * inv_l,
               o[4 * g + 2] * inv_l, o[4 * g + 3] * inv_l);
    }
  }
}

// Q, K and V rows, and with rotary the (cos, sin) rows of Q's and K's positions
size_t smem_bytes(int dh, const Plan& p, bool rotary) {
  return sizeof(float) * (size_t)((p.slab + 2 * p.cap) + (rotary ? p.slab + p.cap : 0)) *
         (dh + 4);
}

// The bf16 form: bf16 Q, K and V rows, then float32 rotated Q and K rows
// (the kernel's layout)
size_t smem_bytes_bf16(int dh, const Plan& p) {
  return sizeof(bf16) * (size_t)(p.slab + 2 * p.cap) * (dh + 8) +
         sizeof(float) * (size_t)(p.slab + p.cap) * (dh + 4);
}

template <typename T>
size_t smem_bytes_of(int dh, const Plan& p, bool rotary) {
  return std::is_same_v<T, bf16> ? smem_bytes_bf16(dh, p) : smem_bytes(dh, p, rotary);
}

// The two forms' kernels, one body. The bf16 form's asks for one block an SM
// (minBlocks 1): with the maximum threads alone ptxas capped its CUDA-core
// instances at 80-128 registers and put set-up values in local memory.
template <int DH, bool MMA>
__global__ void __launch_bounds__(kMaxWarps * 32)
windowed_attention_kernel(const Args a, const Plan p) {
  windowed_attention<DH, MMA, float>(a, p);
}

template <int DH, bool MMA>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
windowed_attention_bf16_kernel(const Args a, const Plan p) {
  windowed_attention<DH, MMA, bf16>(a, p);
}

template <int DH, bool MMA, typename T>
int launch_as(const Args& a, const Plan& p, dim3 grid, cudaStream_t stream) {
  void (*const kernel)(Args, Plan) = std::is_same_v<T, bf16>
                                         ? windowed_attention_bf16_kernel<DH, MMA>
                                         : windowed_attention_kernel<DH, MMA>;
  const size_t smem = smem_bytes_of<T>(DH, p, a.rotary);
  // Dynamic shared memory allowed so far, per device: the attribute applies
  // to the current device only. 48 KB holds static and dynamic bytes
  // together: without the static ones a plan just under 48 KB of dynamic
  // bytes would be refused at launch.
  constexpr int kMaxDevices = 64;
  static size_t configured[kMaxDevices] = {};
  if (smem + kStaticSmem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (!(dev < kMaxDevices && smem <= configured[dev])) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < kMaxDevices) configured[dev] = smem;
    }
  }
  kernel<<<grid, p.slab / rows_per_warp(MMA) * 32, smem, stream>>>(a, p);
  return (int)cudaGetLastError();
}

template <int DH, typename T>
int launch_dh(const Args& a, const Plan& p, int mma, dim3 grid, cudaStream_t stream) {
  return mma ? launch_as<DH, true, T>(a, p, grid, stream)
             : launch_as<DH, false, T>(a, p, grid, stream);
}

template <typename T>
int launch(const Args& a, int dh, const Plan& p, int mma, int batch, int heads,
           cudaStream_t stream) {
  const int rpw = rows_per_warp(mma);
  if (a.N <= 0 || a.Np < a.N || a.w <= 0 || a.C <= 0 || a.Nq % a.C != 0 || a.q0 < 0 ||
      a.q0 + a.Nq > a.Np || p.cap <= 0 ||
      p.slab <= 0 || p.slab % rpw != 0 || p.slab / rpw > kMaxWarps ||
      (a.rotary && a.rot == nullptr) ||
      smem_bytes_of<T>(dh, p, a.rotary) + kStaticSmem > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.Nq / a.C * ((a.C + p.slab - 1) / p.slab), heads, batch);
  switch (dh) {
    case 16: return launch_dh<16, T>(a, p, mma, grid, stream);
    case 32: return launch_dh<32, T>(a, p, mma, grid, stream);
    case 64: return launch_dh<64, T>(a, p, mma, grid, stream);
    case 128: return launch_dh<128, T>(a, p, mma, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args common(int dh, int window, int causal, int exact, int rotary, const float* rot) {
  Args a = {};
  a.w = window;
  a.lf = causal ? 0 : 1;
  a.causal = causal;
  a.exact = exact;
  a.rotary = rotary;
  a.rot = rot;
  a.scale = static_cast<float>(pow(static_cast<double>(dh), -0.5));
  a.inv_keep = 1.f;
  return a;
}

// B3 on qkv and out of element type T.
template <typename T>
int fused_qkv(const T* qkv, const int* lengths, const float* keep, const float* rot, T* out,
              int B, int N, int Np, int heads, int dim_head, int window, int causal, int exact,
              int rotary, int C, int P, int K, float inv_keep_prob, int slab, int cap, int mma,
              void* stream) {
  Args a = common(dim_head, window, causal, exact, rotary, rot);
  const long long hd = (long long)heads * dim_head;
  a.q = qkv;
  a.k = qkv + hd;
  a.v = qkv + 2 * hd;
  a.out = out;
  a.lengths = lengths;
  a.keep = keep;
  a.in_z = (long long)N * 3 * hd;
  a.in_y = dim_head;
  a.in_row = 3 * hd;
  a.out_z = (long long)N * hd;
  a.out_y = dim_head;
  a.out_row = hd;
  a.keep_row = (long long)heads * K;
  a.keep_z = (long long)Np * a.keep_row;
  a.N = N;
  a.Np = Np;
  a.q0 = 0;
  a.Nq = Np;
  a.C = C;
  a.P = P;
  a.K = K;
  a.inv_keep = inv_keep_prob;
  return launch<T>(a, dim_head, Plan{slab, cap}, mma, B, heads,
                   static_cast<cudaStream_t>(stream));
}

// x rounded to bf16, nearest even, on the host (x finite).
float round_bf16(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  memcpy(&x, &u, sizeof x);
  return x;
}

// B4 on q, k, v and out of element type T.
template <typename T>
int per_head(const T* q, const T* k, const T* v, const float* rot, T* out, int BH, int N,
             int dim_head, int window, int causal, int exact, int rotary, int slab, int cap, int mma,
             void* stream) {
  if (N % 128 != 0) return (int)cudaErrorInvalidValue;
  Args a = common(dim_head, window, causal, exact, rotary, rot);
  if (std::is_same_v<T, bf16>) {  // the TPU kernel's bf16 `q * scale`
    a.scale = round_bf16(a.scale);
    a.round_q = 1;
  }
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.in_z = a.out_z = (long long)N * dim_head;
  a.in_y = a.out_y = 0;
  a.in_row = a.out_row = dim_head;
  a.N = a.Np = a.Nq = N;
  a.q0 = 0;
  a.C = a.P = 128;
  a.K = 3 * 128;
  return launch<T>(a, dim_head, Plan{slab, cap}, mma, BH, 1, static_cast<cudaStream_t>(stream));
}

// K3 on a slab and out of element type T.
template <typename T>
int halo(const T* qkv, const int* lengths, const float* rot, T* out, int B, int Nh, int q0,
         int Nq, int heads, int dim_head, int window, int causal, int exact, int rotary, int slab,
         int cap, int mma, void* stream) {
  if (q0 != 0 && q0 != window) return (int)cudaErrorInvalidValue;
  Args a = common(dim_head, window, causal, exact, rotary, rot);
  const long long hd = (long long)heads * dim_head;
  a.q = qkv;
  a.k = qkv + hd;
  a.v = qkv + 2 * hd;
  a.out = out;
  a.lengths = lengths;
  a.in_z = (long long)Nh * 3 * hd;
  a.in_y = dim_head;
  a.in_row = 3 * hd;
  a.out_z = (long long)Nq * hd;
  a.out_y = dim_head;
  a.out_row = hd;
  a.N = a.Np = Nh;
  a.q0 = q0;
  a.Nq = a.C = Nq;
  a.P = window;
  a.K = Nq + 2 * window;
  return launch<T>(a, dim_head, Plan{slab, cap}, mma, B, heads,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// B3. `rot` is the (Np + lf * w, dh / 2, 2) cos/sin table (unused without
// rotary); slab, cap and mma (the products on the tensor cores) are the
// launch plan. Returns 0 on success, else a cudaError_t value
// (cudaErrorInvalidValue for a head width or plan the kernel does not take).
int fused_qkv_local_attention_f32(const float* qkv, const int* lengths, const float* keep,
                                  const float* rot, float* out, int B, int N, int Np, int heads,
                                  int dim_head, int window, int causal, int exact, int rotary,
                                  int C, int P, int K, float inv_keep_prob, int slab, int cap,
                                  int mma, void* stream) {
  return fused_qkv(qkv, lengths, keep, rot, out, B, N, Np, heads, dim_head, window, causal,
                   exact, rotary, C, P, K, inv_keep_prob, slab, cap, mma, stream);
}

// B3's bf16 form: qkv and out bf16 (16-byte aligned), the rest as above.
int fused_qkv_local_attention_bf16(const void* qkv, const int* lengths, const float* keep,
                                   const float* rot, void* out, int B, int N, int Np, int heads,
                                   int dim_head, int window, int causal, int exact, int rotary,
                                   int C, int P, int K, float inv_keep_prob, int slab, int cap,
                                   int mma, void* stream) {
  return fused_qkv(static_cast<const bf16*>(qkv), lengths, keep, rot, static_cast<bf16*>(out),
                   B, N, Np, heads, dim_head, window, causal, exact, rotary, C, P, K,
                   inv_keep_prob, slab, cap, mma, stream);
}

// B4: 128-row chunks, keys the three whole blocks around each (N % 128 == 0).
int local_attention_heads_f32(const float* q, const float* k, const float* v, const float* rot,
                              float* out, int BH, int N, int dim_head, int window, int causal,
                              int exact, int rotary, int slab, int cap, int mma, void* stream) {
  return per_head(q, k, v, rot, out, BH, N, dim_head, window, causal, exact, rotary, slab, cap,
                  mma, stream);
}

// B4's bf16 form: q, k, v and out bf16 (16-byte aligned), the rest as above.
int local_attention_heads_bf16(const void* q, const void* k, const void* v, const float* rot,
                               void* out, int BH, int N, int dim_head, int window, int causal,
                               int exact, int rotary, int slab, int cap, int mma, void* stream) {
  return per_head(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), rot, static_cast<bf16*>(out), BH, N, dim_head,
                  window, causal, exact, rotary, slab, cap, mma, stream);
}

// K3, B3's halo entry (the header): qkv (B, Nh, 3*h*dh) a rank's slab whose
// own rows are [q0, q0 + Nq); out (B, Nq, h*dh); lengths (B,) in slab rows,
// or null; rot the table from the slab's first row's position on.
int local_attention_halo_f32(const float* qkv, const int* lengths, const float* rot, float* out,
                             int B, int Nh, int q0, int Nq, int heads, int dim_head, int window,
                             int causal, int exact, int rotary, int slab, int cap, int mma,
                             void* stream) {
  return halo(qkv, lengths, rot, out, B, Nh, q0, Nq, heads, dim_head, window, causal, exact,
              rotary, slab, cap, mma, stream);
}

// K3's bf16 form: qkv and out bf16 (16-byte aligned), the rest as above.
int local_attention_halo_bf16(const void* qkv, const int* lengths, const float* rot, void* out,
                              int B, int Nh, int q0, int Nq, int heads, int dim_head, int window,
                              int causal, int exact, int rotary, int slab, int cap, int mma,
                              void* stream) {
  return halo(static_cast<const bf16*>(qkv), lengths, rot, static_cast<bf16*>(out), B, Nh, q0,
              Nq, heads, dim_head, window, causal, exact, rotary, slab, cap, mma, stream);
}

// Dynamic shared memory a block of the float32 (bf16 0) or bf16 (bf16 1) form
// takes under a plan: what the launch asks for, from the kernel's layout.
int local_attention_smem_bytes(int bf16_form, int dh, int slab, int cap, int rotary) {
  const Plan p{slab, cap};
  return (int)(bf16_form ? smem_bytes_bf16(dh, p) : smem_bytes(dh, p, rotary));
}

const char* local_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
