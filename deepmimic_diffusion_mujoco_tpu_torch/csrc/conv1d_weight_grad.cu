// Weight gradient of a "same"-padded 1-D convolution, float32, channel-last:
//   dW[t, ci, co] = sum_{b, h} x[b, h + t - pad_l, ci] * dy[b, h, co]
// with x (B, H, Cin), dy (B, H, Cout), dW (k, Cin, Cout), pad_l = (k - 1) / 2
// and rows of x outside [0, H) read as zeros.
//
// Replaces deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_weight_grad.py:
// conv1d_weight_grad (the TPU kernel for the dW of every Conv1dBlock). The
// TPU kernel transposes both operands to time-major so that each tap's rows
// are one contiguous slice for the MXU; here a block computes its own row
// offsets instead, and keeps the kernel's one real idea: one block computes
// all k taps of its (Cin, Cout) tile, so every dy row it reads serves k taps.
//
// What bounds it. 2 k Cin Cout B H flops against (B H (Cin + Cout) +
// k Cin Cout) * 4 bytes: the operations, at every shape of the U-Net and the
// ValueFunction. In float32 on the CUDA cores that floor is FLOPs / 67
// TFLOP/s; on the tensor cores in 3xTF32 (three TF32 products per f32
// product) it is FLOPs / (495 / 3) TFLOP/s. The ValueFunction's shapes
// (B 16, H 4-64, 32-256 channels) are far below either: a launch there is
// latency, one launch and one or two memory round trips at best. Measured
// on an H100 (PERF.md), the deep shapes run at 3.4-3.7x the 3xTF32 bound:
// three mma.sync a product plus the operands' loads and splits keep each
// warp's issue busy, and the c + accumulator registers (about 230 at k 5)
// leave one 256-thread CTA an SM.
//
// Design. Per call one launch, no workspace; the launch plan is Python
// (ops/conv_weight_grad.py:wgrad_plan) and arrives as the ints of Plan.
//   - Tiles. A block owns a tci x tco tile of (Cin, Cout) (tci a multiple
//     of 16, tco of 32, both from the plan, so Cin 35 or Cout 32 is not
//     padded to 64) for all k taps. Its warps split the tile into 16 x 32
//     pieces: one m16 x four n8 tiles of mma.sync.m16n8k8.
//   - Rows. The reduction runs over the R = B H rows of x and dy flattened,
//     packed across batch rows: a chunk is `rows` consecutive dy rows (a
//     multiple of 8, the mma's k) and the rows + k - 1 x rows around them,
//     staged whole. Tap t of dy row r reads staged x row r + t; where that
//     row belongs to another batch row (the convolution's zero padding) the
//     A fragment takes a zero instead, from each row's position h in its
//     batch row. Short H (4, 8) therefore costs no padded rows.
//   - Products. 3xTF32 on the tensor cores (csrc/mma_tf32.h; operands split
//     by truncation, two instructions each): the dy (B) fragments of a
//     k-step are loaded and split once and serve all k taps;
//     each tap's A fragment is the staged x tile read t rows further on. The
//     tensor cores add in round-toward-zero, which over thousands of rows
//     drifts past 1e-5 of max |dW|; so a chunk (at most 64 rows) adds up in
//     fresh fragments on the tensor cores, which then join float32
//     accumulators rounded to nearest. A float32 path on the CUDA cores lost
//     to this at every main-path shape on an H100 and is not kept.
//   - Slices. Where the channels are few, a plan gives each 16 x 32 piece
//     of the tile `slices` warps, which take every slices-th k-step of a
//     chunk; their sums add in slice order in shared memory.
//   - Split reduction without a workspace. The plan's `cluster` CTAs of one
//     tile form a thread block cluster and split its chunks into contiguous
//     ranges. Each CTA leaves its partial tile in its shared memory; after a
//     cluster barrier, rank q adds its 1/C of the tile's elements over all
//     ranks in rank order through distributed shared memory and writes
//     them. No atomics, no second kernel: two launches give the same bits.
//     Clusters above 8 CTAs use the non-portable size (up to 16).
//   - Loads. cp.async (16 bytes where aligned, zero-filled outside the
//     tensors) into a ring of `stages` chunks, each with a "full" and an
//     "empty" mbarrier; the ring is filled up front, so a CTA with no more
//     chunks than stages waits on one memory round trip.
//
// The bf16 form (bf16 x and dy) is csrc/conv1d_weight_grad_bf16.cu.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/conv_weight_grad.py) validates shapes, dtypes and
// contiguity, chooses the plan once per shape and passes it in.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.h"

namespace coop = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;        // with the non-portable cluster size
constexpr int kMaxSmem = 227 * 1024;   // a CTA's shared memory, dynamic and static
// The kernel's static shared memory: the ring's full and empty mbarriers
constexpr size_t kStaticSmem = 2 * kMaxStages * sizeof(uint64_t);
constexpr int kWarpCi = 16;            // a warp's piece of the tile: 16 input channels
constexpr int kWarpCo = 32;            // ... x 32 output channels
constexpr int kNT = kWarpCo / 8;       // n8 tiles of a warp's piece
constexpr int kMaxRows = 64;           // dy rows per chunk, at most
constexpr int kStep = 8;               // rows of a k-step: m16n8k8 (3xTF32)
constexpr int kPassTaps = 5;           // taps a pass over a staged chunk computes
constexpr int kPadCols = 8;            // staged row stride = tile width + 8: with a
                                       // stride of 8 (mod 32) words the fragment
                                       // loads of a warp hit 32 banks

// The launch plan (ops/conv_weight_grad.py:WgradPlan, in this order).
struct Plan {
  int tci;      // input channels per tile, a multiple of kWarpCi
  int tco;      // output channels per tile, a multiple of kWarpCo
  int rows;     // dy rows per chunk, a multiple of the k-step, at most kMaxRows
  int stages;   // ring depth
  int cluster;  // CTAs per tile; rank q takes chunks [q n / C, (q + 1) n / C)
  int slices;   // warps per piece of the tile; slice s takes k-steps s, s + S, ...
};

// Shared memory of one plan: the ring of staged chunks and, with slices or a
// cluster, the partial tile (k x tci rows of tco + kPadCols), which reuses
// the ring once every chunk is consumed.
struct Layout {
  int sx, sd;    // row strides of staged x and dy, in floats
  int x_rows;    // staged x rows a chunk: rows + k - 1
  int stage;     // one ring stage, in floats
  int ring;      // floats
  int part;      // floats
  size_t bytes;  // dynamic shared memory
};

__host__ __device__ inline Layout layout(const Plan& p, int K) {
  Layout l;
  l.sx = p.tci + kPadCols;
  l.sd = p.tco + kPadCols;
  l.x_rows = p.rows + K - 1;
  l.stage = l.x_rows * l.sx + p.rows * l.sd;
  l.ring = p.stages * l.stage;
  l.part = p.cluster > 1 || p.slices > 1 ? K * p.tci * l.sd : 0;
  const size_t ring = sizeof(float) * (size_t)l.ring, part = sizeof(float) * (size_t)l.part;
  l.bytes = ring > part ? ring : part;
  return l;
}

__host__ __device__ inline int plan_threads(const Plan& p) {
  return p.slices * (p.tci / kWarpCi) * (p.tco / kWarpCo) * 32;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: `valid` false writes zeros and reads nothing.
__device__ __forceinline__ void copy4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Arrives on `bar` once every cp.async this thread has issued so far is done.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
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

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Start the copies of rows [r0, r0 + n) x channels [c0, c0 + width) of
// `src` (rows of ld floats, R of them) into `dst` (row stride `stride`),
// kW floats a copy (16-byte or 4-byte cp.async); rows outside [0, R) and
// channels past ld become zeros.
template <int kW>
__device__ __forceinline__ void stage_rows(float* dst, int stride, int n, int width,
                                           const float* src, int ld, long long r0, int R, int c0,
                                           int tid, int threads) {
  const int per_row = width / kW;
  const int ds = threads / per_row, dq = threads % per_row;
  int s = tid / per_row, q = tid % per_row;  // this thread's first copy; then steps of threads
  while (s < n) {
    const long long r = r0 + s;
    const int c = c0 + kW * q;
    const bool ok = r >= 0 && r < R && c < ld;
    const float* from = ok ? src + r * ld + c : src;
    if constexpr (kW == 4)
      copy16(dst + s * stride + kW * q, from, ok);
    else
      copy4(dst + s * stride + q, from, ok);
    s += ds;
    q += dq;
    if (q >= per_row) {
      q -= per_row;
      ++s;
    }
  }
}

// h in [0, 2 H) wrapped into [0, H)
__device__ __forceinline__ int wrap(int h, int H) { return h >= H ? h - H : h; }

// Taps [P0, P0 + NP) of one k-step into the pass's fragments c. Lane
// (g, t4) holds the A fragment's input channels g, g + 8 and the k-step's
// rows t4, t4 + 4 (staged x rows x0, x1; positions ha, hb in their batch
// rows).
template <int K, int P0, int NP>
__device__ __forceinline__ void mma_taps(float (&c)[NP][kNT][4], const uint32_t (&bh)[kNT][2],
                                         const uint32_t (&bl)[kNT][2], const float* x0,
                                         const float* x1, int sx, int ha, int hb, int H) {
  constexpr int kPad = (K - 1) / 2;
#pragma unroll
  for (int u = 0; u < NP; ++u) {
    const int t = P0 + u;
    // x row r + t - pad_l lies in row r's batch row
    const bool va = (unsigned)(ha + t - kPad) < (unsigned)H;
    const bool vb = (unsigned)(hb + t - kPad) < (unsigned)H;
    uint32_t ah[4], al[4];
    split_tf32_trunc(va ? x0[t * sx] : 0.f, &ah[0], &al[0]);
    split_tf32_trunc(va ? x0[t * sx + 8] : 0.f, &ah[1], &al[1]);
    split_tf32_trunc(vb ? x1[t * sx] : 0.f, &ah[2], &al[2]);
    split_tf32_trunc(vb ? x1[t * sx + 8] : 0.f, &ah[3], &al[3]);
#pragma unroll
    for (int n = 0; n < kNT; ++n) mma_3xtf32(c[u][n], ah, al, bh[n], bl[n]);
  }
}

// One staged chunk on the tensor cores, taps [P0, P0 + kPassTaps) and then
// the next pass, over the warp's k-steps (rows k_first, k_first + k_step,
// ... of the chunk). `xs` points at staged x row 0, column (warp's first
// input channel + g); `ds` at staged dy row 0, column (warp's first output
// channel + g); ha, hb are the positions of the lane's rows t4, t4 + 4 of
// the first k-step in their batch rows, dh = k_step mod H. The dy (B) fragments of a k-step
// are split once and serve the pass's taps. The pass's products add up on
// the tensor cores in fresh fragments over the whole chunk (at most
// 3 kMaxRows / 8 additions rounded toward zero), which join the float32
// accumulators once, at its end.
template <int K, int P0>
__device__ __forceinline__ void chunk_mma(float (&acc)[K][kNT][4], const float* xs,
                                          const float* ds, int sx, int sd, int k_first,
                                          int k_step, int rows, int ha0, int hb0, int dh, int H,
                                          int t4) {
  constexpr int NP = K - P0 < kPassTaps ? K - P0 : kPassTaps;
  float c[NP][kNT][4];
#pragma unroll
  for (int u = 0; u < NP; ++u)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[u][n][j] = 0.f;
  int ha = ha0, hb = hb0;
  for (int k0 = k_first; k0 < rows; k0 += k_step) {
    uint32_t bh[kNT][2], bl[kNT][2];
    const float* d0 = ds + (k0 + t4) * sd;
    const float* d1 = d0 + 4 * sd;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      split_tf32_trunc(d0[8 * n], &bh[n][0], &bl[n][0]);
      split_tf32_trunc(d1[8 * n], &bh[n][1], &bl[n][1]);
    }
    const float* x0 = xs + (k0 + t4) * sx;
    mma_taps<K, P0, NP>(c, bh, bl, x0, x0 + 4 * sx, sx, ha, hb, H);
    ha = wrap(ha + dh, H);
    hb = wrap(hb + dh, H);
  }
#pragma unroll
  for (int u = 0; u < NP; ++u)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[P0 + u][n][j] += c[u][n][j];
  if constexpr (P0 + NP < K)
    chunk_mma<K, P0 + NP>(acc, xs, ds, sx, sd, k_first, k_step, rows, ha0, hb0, dh, H, t4);
}

// out[row, co], out[row, co + 1] = a, b where they lie inside Cout
__device__ __forceinline__ void store_pair(float* out, size_t row, int co, int Cout, float a,
                                           float b) {
  if ((Cout & 1) == 0 && co < Cout) {
    *reinterpret_cast<float2*>(out + row * Cout + co) = make_float2(a, b);
  } else {
    if (co < Cout) out[row * Cout + co] = a;
    if (co + 1 < Cout) out[row * Cout + co + 1] = b;
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Grid: tiles x cluster CTAs, 1-D, clusters of p.cluster along x. `vec`:
// Cin and Cout are multiples of 4 and x, dy start on 16 bytes, so rows are
// staged as 16-byte pieces; else one float at a time.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
conv1d_weight_grad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          float* __restrict__ out, int R, int H, int Cin, int Cout, const Plan p,
                          int vec) {
  constexpr int kPad = (K - 1) / 2;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ring = smem;
  const Layout l = layout(p, K);
  const int C = p.cluster;
  const int rank = blockIdx.x % C;
  const int tile = blockIdx.x / C;
  const int tiles_co = (Cout + p.tco - 1) / p.tco;
  const int co0 = (tile % tiles_co) * p.tco, ci0 = (tile / tiles_co) * p.tci;
  const int tid = threadIdx.x, threads = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int warps_co = p.tco / kWarpCo;
  const int pieces = (p.tci / kWarpCi) * warps_co;  // warps of one slice
  const int slice = warp / pieces, piece = warp % pieces;
  const int ciw = (piece / warps_co) * kWarpCi, cow = (piece % warps_co) * kWarpCo;
  const int g = lane >> 2, t4 = lane & 3;
  const int k_step = kStep * p.slices, dh = k_step % H;

  const int n_chunks = (R + p.rows - 1) / p.rows;
  const int c_begin = (int)((long long)n_chunks * rank / C);
  const int n = (int)((long long)n_chunks * (rank + 1) / C) - c_begin;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], threads);
      mbar_init(&empty[s], threads);
    }
  }
  __syncthreads();

  // Start the copies of chunk c_begin + i into ring stage i % stages: dy
  // rows [r0, r0 + rows) and x rows [r0 - pad_l, r0 + rows + k - 1 - pad_l)
  // of the tile's channels, zeros outside the tensors.
  auto produce = [&](int i) {
    float* xs = ring + (i % p.stages) * l.stage;
    float* ds = xs + l.x_rows * l.sx;
    const long long r0 = (long long)(c_begin + i) * p.rows;
    if (vec) {
      stage_rows<4>(xs, l.sx, l.x_rows, p.tci, x, Cin, r0 - kPad, R, ci0, tid, threads);
      stage_rows<4>(ds, l.sd, p.rows, p.tco, dy, Cout, r0, R, co0, tid, threads);
    } else {
      stage_rows<1>(xs, l.sx, l.x_rows, p.tci, x, Cin, r0 - kPad, R, ci0, tid, threads);
      stage_rows<1>(ds, l.sd, p.rows, p.tco, dy, Cout, r0, R, co0, tid, threads);
    }
    mbar_arrive_on_copies(&full[i % p.stages]);
  };

  float acc[K][kNT][4];
#pragma unroll
  for (int t = 0; t < K; ++t)
#pragma unroll
    for (int m = 0; m < kNT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][m][j] = 0.f;

  const int pre = n < p.stages ? n : p.stages;
  for (int i = 0; i < pre; ++i) produce(i);
  for (int i = 0; i < n; ++i) {
    const int st = i % p.stages;
    const uint32_t parity = (i / p.stages) & 1;
    mbar_wait(&full[st], parity);
    const float* xs = ring + st * l.stage;
    const float* ds = xs + l.x_rows * l.sx;
    const long long row0 = (long long)(c_begin + i) * p.rows + kStep * slice;
    // the place in its batch row of this lane's first row, t4 of the slice's first k-step
    const int ha = (int)((row0 + t4) % H);
    chunk_mma<K, 0>(acc, xs + ciw + g, ds + cow + g, l.sx, l.sd, kStep * slice, k_step, p.rows,
                    ha, (ha + 4) % H, dh, H, t4);
    mbar_arrive(&empty[st]);
    if (i + p.stages < n) {  // refill this stage once every thread has read it
      mbar_wait(&empty[st], parity);
      produce(i + p.stages);
    }
  }

  const int ci_a = ciw + g;              // this lane's input channels in the tile: ci_a, + 8
  const int co_a = cow + 2 * t4;         // ... and output channels co_a + 8 n, + 1
  if (C == 1 && p.slices == 1) {
#pragma unroll
    for (int t = 0; t < K; ++t)
#pragma unroll
      for (int m = 0; m < kNT; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ci = ci0 + ci_a + 8 * u;
          if (ci < Cin)
            store_pair(out, (size_t)t * Cin + ci, co0 + co_a + 8 * m, Cout, acc[t][m][2 * u],
                       acc[t][m][2 * u + 1]);
        }
    return;
  }

  // The partial tile, rows (t, ci) of stride sd, in this CTA's shared memory
  // (the ring is free: every chunk has been consumed by every thread): the
  // slices' sums added in slice order.
  for (int sl = 0; sl < p.slices; ++sl) {
    __syncthreads();
    if (slice != sl) continue;
#pragma unroll
    for (int t = 0; t < K; ++t)
#pragma unroll
      for (int m = 0; m < kNT; ++m)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float2* at =
              reinterpret_cast<float2*>(smem + (t * p.tci + ci_a + 8 * u) * l.sd + co_a + 8 * m);
          const float2 v = sl == 0 ? make_float2(0.f, 0.f) : *at;
          *at = make_float2(v.x + acc[t][m][2 * u], v.y + acc[t][m][2 * u + 1]);
        }
  }
  if (C > 1)
    cluster_sync();  // every rank's partial tile is in place
  else
    __syncthreads();

  // This rank's 1/C of the tile's float4s, summed over the ranks in rank order.
  coop::cluster_group cluster = coop::this_cluster();
  const int q4 = p.tco / 4;
  const int items = K * p.tci * q4;
  const int lo = (int)((long long)items * rank / C), hi = (int)((long long)items * (rank + 1) / C);
  for (int e = lo + tid; e < hi; e += threads) {
    const int row = e / q4, q = 4 * (e % q4);  // row = t * tci + ci
    const int idx = (row * l.sd + q) / 4;
    float4 s = smem4[idx];
    if (C > 1) {
      s = *cluster.map_shared_rank(smem4 + idx, 0);
      for (int r = 1; r < C; ++r) s = add4(s, *cluster.map_shared_rank(smem4 + idx, r));
    }
    const int t = row / p.tci, ci = ci0 + row % p.tci, co = co0 + q;
    if (ci >= Cin || co >= Cout) continue;
    const size_t o = ((size_t)t * Cin + ci) * Cout + co;
    if ((Cout & 3) == 0) {
      *reinterpret_cast<float4*>(out + o) = s;
    } else {
      const float v[4] = {s.x, s.y, s.z, s.w};
      for (int j = 0; j < 4 && co + j < Cout; ++j) out[o + j] = v[j];
    }
  }
  if (C > 1) cluster_sync();  // no rank leaves while another may still read its shared memory
}

// The plan's own consistency; false for a plan the kernel does not take.
bool plan_ok(const Plan& p, int K) {
  if (p.tci <= 0 || p.tci % kWarpCi || p.tco <= 0 || p.tco % kWarpCo || p.rows <= 0 ||
      p.rows % kStep || p.rows > kMaxRows || p.stages < 1 || p.stages > kMaxStages ||
      p.cluster < 1 || p.cluster > kMaxCluster || p.slices < 1)
    return false;
  const int threads = plan_threads(p);
  return threads >= 32 && threads <= kMaxThreads &&
         layout(p, K).bytes + kStaticSmem <= (size_t)kMaxSmem;
}

template <int K>
int launch_as(const float* x, const float* dy, float* out, int R, int H, int Cin, int Cout,
              const Plan& p, int vec, cudaStream_t stream) {
  const auto kernel = conv1d_weight_grad_kernel<K>;
  const Layout l = layout(p, K);
  // Attributes set so far, per device: they apply to the current device only.
  // 48 KB holds static and dynamic bytes together: without the static ones a
  // plan just under 48 KB of dynamic bytes would be refused at launch.
  constexpr int kMaxDevices = 64;
  static size_t smem_set[kMaxDevices] = {};
  static bool wide_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool known = dev < kMaxDevices;
  if (l.bytes + kStaticSmem > 48 * 1024 && !(known && l.bytes <= smem_set[dev])) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.bytes);
    if (e != cudaSuccess) return (int)e;
    if (known) smem_set[dev] = l.bytes;
  }
  if (p.cluster > kPortableCluster && !(known && wide_set[dev])) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    if (known) wide_set[dev] = true;
  }
  const int tiles = ((Cin + p.tci - 1) / p.tci) * ((Cout + p.tco - 1) / p.tco);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.cluster);
  cfg.blockDim = dim3(plan_threads(p));
  cfg.dynamicSmemBytes = l.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, x, dy, out, R, H, Cin, Cout, p, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

Plan read_plan(const int* v) { return Plan{v[0], v[1], v[2], v[3], v[4], v[5]}; }

int launch(const float* x, const float* dy, float* out, int B, int H, int Cin, int Cout, int k,
           const int* plan, void* stream) {
  const Plan p = read_plan(plan);
  if (B <= 0 || H <= 0 || Cin <= 0 || Cout <= 0 || (long long)B * H > 0x7fffffff ||
      !plan_ok(p, k))
    return (int)cudaErrorInvalidValue;
  const int R = B * H;
  const int vec = Cin % 4 == 0 && Cout % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_as<1>(x, dy, out, R, H, Cin, Cout, p, vec, s);
    case 3: return launch_as<3>(x, dy, out, R, H, Cin, Cout, p, vec, s);
    case 5: return launch_as<5>(x, dy, out, R, H, Cin, Cout, p, vec, s);
    case 7: return launch_as<7>(x, dy, out, R, H, Cin, Cout, p, vec, s);
    case 9: return launch_as<9>(x, dy, out, R, H, Cin, Cout, p, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out: (k, Cin, Cout); `plan` points to the 6 ints of struct Plan. Returns
// 0 on success, else a cudaError_t value (cudaErrorInvalidValue for a
// kernel size, shape or plan the kernel does not take).
int conv1d_weight_grad_f32(const float* x, const float* dy, float* out, int B, int H, int Cin,
                           int Cout, int k, const int* plan, void* stream) {
  return launch(x, dy, out, B, H, Cin, Cout, k, plan, stream);
}

// The dynamic shared memory (bytes) the kernel lays out for a plan at kernel
// size k, or -1 for a plan it does not take.
int conv1d_weight_grad_smem_bytes(int k, const int* plan) {
  const Plan p = read_plan(plan);
  return plan_ok(p, k) ? (int)layout(p, k).bytes : -1;
}

const char* conv1d_weight_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
