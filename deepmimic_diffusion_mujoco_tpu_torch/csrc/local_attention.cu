// Windowed look-around attention, float32, two entry points on one core:
//
//   fused_qkv_local_attention_f32  (B3) qkv (B, N, 3*h*dh) -> out (B, N, h*dh),
//     all heads, straight from the QKV projection; prefix key lengths and an
//     attention-dropout keep mask (B, Np, h*K) are optional.
//   local_attention_heads_f32      (B4) q, k, v (B*h, N, dh) -> out (B*h, N, dh).
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
// Design. One block per (query tile of 32 rows, head, batch row). A query
// tile sees only the key band its windows reach within its chunk, at most
// 32 + 3w rows, and the block
//   1. stages its queries (scaled, rotated) in shared memory;
//   2. walks the band in tiles of 32 keys, stages each tile rotated, and
//      writes the 32 x 32 scores into a shared score strip (masked -inf);
//   3. takes each row's softmax over the strip (one warp per row), times the
//      keep mask and 1/keep_prob where given;
//   4. walks the band again with the value tiles and accumulates P V in
//      registers, one query row and dh/4 dims per thread;
//   5. only where some row has every key masked (possible only with key
//      lengths): walks the chunk's K key rows with the value tiles and gives
//      that row the mean of V over them, times the keep mask. That is the TPU
//      kernel's softmax over a row of equal -1e9 scores.
// Masked keys outside the band have weight exp(-1e9 - max) = 0 in the TPU
// kernel too, so the band gives the same result for every other row.
// The products read the staged rows as float4 (row stride dh + 4: 16-byte
// aligned, and conflict-free with one row per lane), since shared-memory
// loads, not FMAs, limit the scalar form.
//
// Bound on an H100 at the transformer's shapes (dh 64, w 16, h 8): a query
// and head has 33 unmasked keys (|i - j| <= w), so the work is about
// 4 * 33 * dh = 8.4 kflop against 1 KB of QKV read and context written:
// 8 flops a byte, under the f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20, so
// the bound is set by bytes. The kernel does more than the bound counts: the
// whole band (48-64 keys), rotary recomputed for each query tile that reads
// a key row, and every product in f32 on the CUDA cores. Tensor cores
// (wgmma, bf16), TMA and sharing one head's rotated keys across query tiles
// are later work.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrappers (ops/fused_local_attention.py, ops/local_attention_kernel.py)
// validate shapes, dtypes and contiguity before they call in.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 32;  // query rows per block: one per lane
constexpr int kTK = 32;  // key rows per staged tile

struct Args {
  const float* q;        // element (row, d) of head y, batch z at
  const float* k;        //   base + z * in_z + y * in_y + row * in_row + d
  const float* v;
  float* out;            //   out + z * out_z + y * out_y + row * out_row + d
  const int* lengths;    // (batch,) valid keys per sequence, or null
  const float* keep;     // keep + z * keep_z + row * keep_row + y * K + kk, or null
  const float* freqs;    // (dh,) rotary inverse frequencies, each half repeated
  long long in_z, in_y, in_row;
  long long out_z, out_y, out_row;
  long long keep_z, keep_row;
  int N;                 // real rows (rows in [N, Np) are zero)
  int Np;                // padded rows
  int w, lf, causal, exact, rotary;
  int C, P, K;           // chunk rows, neighbour rows per side, keys per chunk
  float scale;           // dh ** -0.5
  float inv_keep;        // 1 / keep_prob
};

// The key rows [lo, hi) that query rows [q0, q1) can see: their chunk's
// key range cut to the windows they reach (look_backward 1).
__host__ __device__ inline void key_band(const Args& a, int q0, int q1, int* lo, int* hi) {
  const int c = q0 / a.C;
  int l = c * a.C - a.P;
  int h = (c + 1) * a.C + a.P;
  const int wl = (q0 / a.w - 1) * a.w;
  int wh = ((q1 - 1) / a.w + a.lf + 1) * a.w;
  if (a.causal && wh > q1) wh = q1;
  l = l > wl ? l : wl;
  h = h < wh ? h : wh;
  *lo = l > 0 ? l : 0;
  *hi = h < a.Np ? h : a.Np;
}

__device__ __forceinline__ bool allowed(const Args& a, int i, int j) {
  const int wi = i / a.w, wj = j / a.w;
  if (wj < wi - 1 || wj > wi + a.lf) return false;
  if (a.causal) {
    if (i < j) return false;
    if (a.exact && i > j + a.w) return false;
  } else if (a.exact) {
    if (j - a.w * a.lf > i || i > j + a.w) return false;
  }
  return true;
}

__host__ __device__ constexpr int row_stride(int dh) { return dh + 4; }  // 16-byte aligned

// Stage rows [first, first + kRows) of one head of an operand (row r at
// base + r * stride, dh contiguous floats) into dst (row stride
// row_stride(DH)): times `mul` and, with `rotary`, rotated to position
// row + shift; rows at or past `end` are zero. Every thread issues all its
// float4 loads before it uses any, so a tile costs one memory round trip.
template <int DH, int kRows>
__device__ __forceinline__ void stage_rows(float* dst, const float* base, long long stride,
                                           int first, int end, float mul, int shift,
                                           const float* freq, bool rotary, int tid) {
  constexpr int kVec = DH / 4;
  constexpr int kItems = kRows * kVec;
  constexpr int kPer = (kItems + kThreads - 1) / kThreads;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 x[kPer], y[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = tid + u * kThreads, r = e / kVec, v = e % kVec;
    const bool ok = e < kItems && first + r < end;
    const float4* src = reinterpret_cast<const float4*>(base + (first + r) * stride);
    x[u] = ok ? __ldg(src + v) : zero;
    y[u] = ok && rotary ? __ldg(src + (v + kVec / 2) % kVec) : zero;  // the rotary partner
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = tid + u * kThreads, r = e / kVec, v = e % kVec;
    if (e >= kItems) continue;
    float xs[4] = {x[u].x * mul, x[u].y * mul, x[u].z * mul, x[u].w * mul};
    if (rotary) {
      const float ys[4] = {y[u].x * mul, y[u].y * mul, y[u].z * mul, y[u].w * mul};
      const float sign = 4 * v < DH / 2 ? -1.f : 1.f;
      const float pos = static_cast<float>(first + r + shift);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float sn, cs;
        sincosf(pos * freq[4 * v + c], &sn, &cs);
        xs[c] = xs[c] * cs + sign * ys[c] * sn;
      }
    }
    reinterpret_cast<float4*>(dst + r * row_stride(DH))[v] =
        make_float4(xs[0], xs[1], xs[2], xs[3]);
  }
}

// Key row of chunk key slot kk (0 <= kk < K): the previous chunk's last P
// rows, the chunk, the next chunk's first P rows, clamped at the edges.
__device__ __forceinline__ int chunk_key_row(const Args& a, int c, int kk) {
  if (a.P == 0) return kk;
  if (kk < a.P) return max(c * a.C - a.P, 0) + kk;
  if (kk < a.P + a.C) return c * a.C + kk - a.P;
  return min((c + 1) * a.C, a.Np - a.P) + kk - a.P - a.C;
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
windowed_attention_kernel(const Args a, const int s_stride) {
  constexpr int kQS = row_stride(DH);   // conflict-free for a row per lane
  constexpr int kDPT = DH / kWarps;     // output dims per thread (a multiple of 4)
  constexpr int kKPT = kTK / kWarps;    // scores per thread per key tile
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kTQ x kQS
  float* kvs = qs + kTQ * kQS;          // kTK x kQS
  float* freq = kvs + kTK * kQS;        // DH
  float* S = freq + DH;                 // kTQ x s_stride scores, then weights
  __shared__ int fully_masked[kTQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kTQ;
  const int q1 = min(q0 + kTQ, a.Np);
  const int head = blockIdx.y, z = blockIdx.z;
  const long long in_base = z * a.in_z + head * a.in_y;
  const float* qb = a.q + in_base;
  const float* kb = a.k + in_base;
  const float* vb = a.v + in_base;
  const int c = q0 / a.C;
  const int len = a.lengths != nullptr ? a.lengths[z] : a.Np;
  int lo, hi;
  key_band(a, q0, q1, &lo, &hi);

  for (int d = tid; d < DH; d += kThreads) freq[d] = a.freqs[d];
  if (tid < kTQ) fully_masked[tid] = 0;
  __syncthreads();

  // 1. queries, scaled then rotated to i + lf * w; rows past N are zero
  stage_rows<DH, kTQ>(qs, qb, a.in_row, q0, a.N, a.scale, a.lf * a.w, freq, a.rotary, tid);

  // 2. scores over the band, tile by tile; lane = query row
  const int i = q0 + lane;
  const float4* q4 = reinterpret_cast<const float4*>(qs + lane * kQS);
  for (int t0 = lo; t0 < hi; t0 += kTK) {
    __syncthreads();
    stage_rows<DH, kTK>(kvs, kb, a.in_row, t0, min(hi, a.N), 1.f, 0, freq, a.rotary, tid);
    __syncthreads();
    float acc[kKPT];
#pragma unroll
    for (int m = 0; m < kKPT; ++m) acc[m] = 0.f;
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 qv = q4[d4];
#pragma unroll
      for (int m = 0; m < kKPT; ++m)
        acc[m] = dot4(qv, reinterpret_cast<const float4*>(kvs + (warp + kWarps * m) * kQS)[d4],
                      acc[m]);
    }
#pragma unroll
    for (int m = 0; m < kKPT; ++m) {
      const int j = t0 + warp + kWarps * m;
      const bool ok = i < q1 && j < hi && j < len && allowed(a, i, j);
      S[lane * s_stride + (j - lo)] = ok ? acc[m] : -INFINITY;
    }
  }
  __syncthreads();

  // 3. row softmax over the band (a warp per row), times the keep mask
  const int nb = hi - lo;
  for (int r = warp; r < kTQ; r += kWarps) {
    float* row = S + r * s_stride;
    float mx = -INFINITY;
    for (int col = lane; col < nb; col += 32) mx = fmaxf(mx, row[col]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (mx == -INFINITY) {  // every key masked (or a row past Np)
      if (lane == 0) fully_masked[r] = 1;
      for (int col = lane; col < nb; col += 32) row[col] = 0.f;
      continue;
    }
    float sum = 0.f;
    for (int col = lane; col < nb; col += 32) {
      const float e = expf(row[col] - mx);
      row[col] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int qi = q0 + r;
    const float* keep_row =
        a.keep != nullptr ? a.keep + z * a.keep_z + qi * a.keep_row + head * a.K : nullptr;
    for (int col = lane; col < nb; col += 32) {
      float p = row[col] / sum;
      if (keep_row != nullptr) p = p * keep_row[lo + col - c * a.C + a.P] * a.inv_keep;
      row[col] = p;
    }
  }

  // 4. P V over the band; lane = query row, warp = a slice of dims
  float o[kDPT];
#pragma unroll
  for (int e = 0; e < kDPT; ++e) o[e] = 0.f;
  const int d0 = warp * kDPT;
  for (int t0 = lo; t0 < hi; t0 += kTK) {
    __syncthreads();
    stage_rows<DH, kTK>(kvs, vb, a.in_row, t0, min(hi, a.N), 1.f, 0, freq, false, tid);
    __syncthreads();
    const int nk = min(kTK, hi - t0);
    const float* prow = S + lane * s_stride + (t0 - lo);
    for (int kk = 0; kk < nk; ++kk) {
      const float p = prow[kk];
      const float4* v4 = reinterpret_cast<const float4*>(kvs + kk * kQS + d0);
#pragma unroll
      for (int e = 0; e < kDPT / 4; ++e) {
        const float4 v = v4[e];
        o[4 * e] = fmaf(p, v.x, o[4 * e]);
        o[4 * e + 1] = fmaf(p, v.y, o[4 * e + 1]);
        o[4 * e + 2] = fmaf(p, v.z, o[4 * e + 2]);
        o[4 * e + 3] = fmaf(p, v.w, o[4 * e + 3]);
      }
    }
  }

  // 5. rows whose keys are all masked (only with key lengths): the TPU
  // softmax is uniform over the chunk's K key rows, so they take the mean of
  // V over those rows (times the keep mask), accumulated tile by tile as in 4.
  __syncthreads();
  const bool masked_row = i < a.N && fully_masked[lane];
  if (__syncthreads_or(masked_row)) {
    const float* keep_row =
        a.keep != nullptr ? a.keep + z * a.keep_z + i * a.keep_row + head * a.K : nullptr;
    const float inv_k = 1.f / static_cast<float>(a.K);
    if (masked_row) {
#pragma unroll
      for (int e = 0; e < kDPT; ++e) o[e] = 0.f;
    }
    for (int t0 = 0; t0 < a.K; t0 += kTK) {
      __syncthreads();
      for (int e = tid; e < kTK * DH; e += kThreads) {
        const int r = e / DH, d = e % DH, j = t0 + r < a.K ? chunk_key_row(a, c, t0 + r) : a.N;
        kvs[r * kQS + d] = j < a.N ? vb[j * a.in_row + d] : 0.f;
      }
      __syncthreads();
      if (!masked_row) continue;
      const int nk = min(kTK, a.K - t0);
      for (int kk = 0; kk < nk; ++kk) {
        const float p = keep_row != nullptr ? inv_k * keep_row[t0 + kk] * a.inv_keep : inv_k;
        const float4* v4 = reinterpret_cast<const float4*>(kvs + kk * kQS + d0);
#pragma unroll
        for (int e = 0; e < kDPT / 4; ++e) {
          const float4 v = v4[e];
          o[4 * e] = fmaf(p, v.x, o[4 * e]);
          o[4 * e + 1] = fmaf(p, v.y, o[4 * e + 1]);
          o[4 * e + 2] = fmaf(p, v.z, o[4 * e + 2]);
          o[4 * e + 3] = fmaf(p, v.w, o[4 * e + 3]);
        }
      }
    }
  }
  if (i < a.N) {
    float* out_row = a.out + z * a.out_z + head * a.out_y + (long long)i * a.out_row + d0;
#pragma unroll
    for (int e = 0; e < kDPT; ++e) out_row[e] = o[e];
  }
}

int max_band(const Args& a) {
  int most = 0;
  for (int q0 = 0; q0 < a.Np; q0 += kTQ) {
    int lo, hi;
    key_band(a, q0, q0 + kTQ < a.Np ? q0 + kTQ : a.Np, &lo, &hi);
    if (hi - lo > most) most = hi - lo;
  }
  return most;
}

template <int DH>
int launch_as(const Args& a, dim3 grid, cudaStream_t stream) {
  const int s_stride = (max_band(a) + kTK - 1) / kTK * kTK + 1;  // odd: no bank conflicts
  const size_t smem =
      sizeof(float) * (size_t)((kTQ + kTK) * row_stride(DH) + DH + kTQ * s_stride);
  // Dynamic shared memory allowed so far, per device: the attribute applies
  // to the current device only.
  constexpr int kMaxDevices = 64;
  static size_t configured[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (!(dev < kMaxDevices && smem <= configured[dev])) {
      e = cudaFuncSetAttribute(windowed_attention_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < kMaxDevices) configured[dev] = smem;
    }
  }
  windowed_attention_kernel<DH><<<grid, kThreads, smem, stream>>>(a, s_stride);
  return (int)cudaGetLastError();
}

int launch(const Args& a, int dh, dim3 grid, cudaStream_t stream) {
  if (a.N <= 0 || a.Np < a.N || a.w <= 0 || a.C <= 0 || (a.C % kTQ != 0 && a.C != a.Np))
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch_as<16>(a, grid, stream);
    case 32: return launch_as<32>(a, grid, stream);
    case 64: return launch_as<64>(a, grid, stream);
    case 128: return launch_as<128>(a, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args common(int dh, int window, int causal, int exact, int rotary, const float* freqs) {
  Args a = {};
  a.w = window;
  a.lf = causal ? 0 : 1;
  a.causal = causal;
  a.exact = exact;
  a.rotary = rotary;
  a.freqs = freqs;
  a.scale = static_cast<float>(pow(static_cast<double>(dh), -0.5));
  a.inv_keep = 1.f;
  return a;
}

}  // namespace

extern "C" {

// B3. Returns 0 on success, else a cudaError_t value (cudaErrorInvalidValue
// for a head width or plan the kernel does not take).
int fused_qkv_local_attention_f32(const float* qkv, const int* lengths, const float* keep,
                                  const float* freqs, float* out, int B, int N, int Np,
                                  int heads, int dim_head, int window, int causal, int exact,
                                  int rotary, int C, int P, int K, float inv_keep_prob,
                                  void* stream) {
  Args a = common(dim_head, window, causal, exact, rotary, freqs);
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
  a.C = C;
  a.P = P;
  a.K = K;
  a.inv_keep = inv_keep_prob;
  const dim3 grid((Np + kTQ - 1) / kTQ, heads, B);
  return launch(a, dim_head, grid, static_cast<cudaStream_t>(stream));
}

// B4: 128-row chunks, keys the three whole blocks around each (N % 128 == 0).
int local_attention_heads_f32(const float* q, const float* k, const float* v,
                              const float* freqs, float* out, int BH, int N, int dim_head,
                              int window, int causal, int exact, int rotary, void* stream) {
  if (N % 128 != 0) return (int)cudaErrorInvalidValue;
  Args a = common(dim_head, window, causal, exact, rotary, freqs);
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.in_z = a.out_z = (long long)N * dim_head;
  a.in_y = a.out_y = 0;
  a.in_row = a.out_row = dim_head;
  a.N = a.Np = N;
  a.C = a.P = 128;
  a.K = 3 * 128;
  const dim3 grid(N / kTQ, 1, BH);
  return launch(a, dim_head, grid, static_cast<cudaStream_t>(stream));
}

const char* local_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
