// Fused "same" Conv1d(k) + bias -> GroupNorm(groups, eps) -> affine -> Mish,
// float32, channel-last: x (B, H, Cin), w (k, Cin, Cout), bias/gamma/beta
// (Cout,), out (B, H, Cout).
//
// Replaces deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_block_kernel.py:
// conv_gn_mish (the TPU kernel behind every Conv1dBlock of the temporal
// U-Net). It computes what that kernel computes, not how: the TPU body's
// im2col and one-hot group matmuls are layout workarounds for the MXU.
//
// What bounds it. Per output 2 k Cin float32 FMAs on the CUDA cores (TF32
// would miss the 1e-4 tolerance at k Cin up to 10,240), against about 4
// bytes of activations moved: the operations bound. GroupNorm couples the
// H x (Cout / groups) outputs of one (batch row, group), so they need one
// reduction. At the U-Net's deep levels (H 8 when serving, H 20 when
// training) a (row, group) pair is a skinny product, 8-24 rows deep in k Cin
// up to 10,240, and its group's weights (k Cin Cout / groups floats) are
// used for only H rows: read from L2 once per batch row, they cap the kernel
// at the L2's bandwidth (about 2-3 TB/s measured for this access) well
// before the FMAs do. There are also only B x groups pairs (128 at serving's
// B 16) for 132 SMs.
//
// Design. One thread block cluster of C CTAs (C in {1, 2, 4, 8}) per R batch
// rows (R in 1..4) and one group, both chosen per shape on the host:
//   - R rows share every weight chunk a CTA stages, so L2 weight traffic
//     falls R-fold;
//   - the C ranks split the input channels into contiguous ranges, so the
//     k Cin reduction runs on C SMs and the grid (B / R) x groups x C still
//     fills the card.
// Measured on an H100 (PERF.md), R = C = 2 is best at the deep levels and
// R = C = 1 elsewhere; a C of 1 launches without the cluster attribute.
// Per rank, per tile of output rows:
//   1. The convolution as a small matrix product, (R x rows) x (k x rank
//      channels) times (k x rank channels) x (group channels). Input channels
//      go through a ring of 2-4 shared-memory stages of `ck` channels,
//      filled with cp.async (16-byte weight rows where aligned) whose
//      completion a "full" mbarrier per stage tracks; an "empty" mbarrier per
//      stage says every thread has read it. There is no block barrier in the
//      loop. A thread owns an 8-row x 4-channel output tile and keeps 8 + k -
//      1 input values (staged channel-major, read as float4s) in registers
//      across the k taps: 3 + k 16-byte shared loads per 32 k FMAs. The CTA's
//      threads are exactly (tiles) x (slices): each slice takes a contiguous
//      part of every chunk, and the slices' partial sums are added in slice
//      order.
//   2. The rank's partial tile stays in its shared memory. After a cluster
//      barrier, rank r sums its 1/C share of every row's tile over all ranks
//      in rank order through distributed shared memory and adds the bias (no
//      global scratch, no atomics: two launches give the same bits). With
//      one row tile the pre-norm values stay in the rank's own tile (only it
//      reads its share), else they go to `out`.
//   3. GroupNorm statistics per (row, group), two-pass (mean, then sum of
//      squared deviations): each an all-reduce of the C ranks' partials over
//      distributed shared memory, in rank order.
//   4. Normalise, affine, Mish (x * tanh(softplus(x)), softplus computed as
//      max(x, 0) + log1p(exp(-|x|))), written to `out`.
// A final cluster barrier keeps every rank's shared memory alive until the
// others have read it. The group's bias, gamma and beta are copied to shared
// memory with the first chunk, so the epilogue waits on no global load.
//
// The next levers: 3xTF32 on the tensor cores (the f32 inner loop reaches
// about a third of the CUDA cores' peak at best), then a TMA multicast of
// each weight chunk across the clusters of one group (every batch row reads
// the same weights).
//
// The horizon-sharded form (sequence-sharded sampling: each rank holds H / R
// frames, and GroupNorm's statistics span every rank's rows) splits the work
// into two launches around a merge the host does across the ranks:
//   K1 conv_gn_stats_f32: the same kernel with kStats set. Its input is the
//      rank's rows with a k / 2-row halo on each side, (B, H + k - 1, Cin),
//      convolved without padding; it writes the pre-norm conv + bias
//      (B, H, Cout) and, per (batch row, group), the local mean and the sum
//      of squared deviations from it (M2), two-pass, as steps 1-3 compute
//      them, and skips step 4.
//   K2 gn_affine_mish_f32: elementwise, (pre - mean) * rstd * gamma + beta,
//      then Mish in step 4's form, with the merged (mean, rstd) of each
//      (batch row, group). It reads and writes each value once: bytes bound
//      it. A float4 a thread where the groups' widths are multiples of 4.
//      gn_affine_mish_bf16 is K2 of a bf16 model: the same float32 values
//      (from K1's bf16 form, csrc/conv_gn_mish_bf16.cu), one bf16 rounding
//      at the store.
// The merge (Chan's parallel variance in float64) is ops/conv_block_kernel.py's.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/conv_block_kernel.py) validates shapes, dtypes and
// contiguity, chooses the plan once per shape and passes it in.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace coop = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTM = 8;                   // output rows per thread
constexpr int kTN = 4;                   // output channels per thread
constexpr int kMaxStages = 4;
constexpr int kMaxRows = 4;              // batch rows per cluster
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kMaxGroupChannels = 256;   // a weight row's float4s fit the CTA's threads
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic + static shared memory of one CTA
// The kernel's static shared memory: the ring's mbarriers, the statistics'
// slots and the group's bias / gamma / beta.
constexpr size_t kStaticSmem =
    16 * kMaxStages + sizeof(float) * (2 * kMaxRows + 3 * kMaxGroupChannels);
// What a CTA takes, static and dynamic together, before the kernel opts in to more
constexpr size_t kDefaultSmem = 48 * 1024;

// Chosen on the host (ops/conv_block_kernel.py: make_plan), passed by value.
struct Plan {
  int cluster;  // CTAs per (R batch rows, group); rank r takes input channels
                // [Cin r / C, Cin (r + 1) / C)
  int rows;     // R: batch rows per cluster
  int threads;  // R * (tile_h / kTM) * (cgp / kTN) * slices
  int slices;   // ways each chunk's channels are split among the CTA's threads
  int tile_h;   // output rows per tile, a multiple of kTM
  int ck;       // input channels per stage, a multiple of slices
  int stages;   // depth of the shared-memory ring
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Shared-memory layout of one plan, in floats (ops/conv_block_kernel.py:
// smem_bytes mirrors it).
struct Layout {
  int cgp;          // channels per group, rounded up to kTN
  int ntc;          // cgp / kTN: output tiles across the channels
  int rg;           // tile_h / kTM: row groups of one batch row
  int n_out;        // threads that share one slice: R * rg * ntc
  int wr;           // row groups side by side in a warp where one row group spans 32+ threads
  int xs_row;       // floats of one batch row of one staged channel (padded for float4 reads)
  int xs_ci;        // R * xs_row: one staged input channel
  int ws_size;      // k * ck * cgp: one stage's weights
  int stage;        // ws_size + ck * xs_ci
  int ring;         // max(stages * stage, slices' partial tiles, reduction scratch)
  int sub;          // tile_h * cgp: one batch row's tile
  int tile;         // R * sub: the rank's partial tile, read by every rank
  int n_tiles;      // ceil(H / tile_h); two tile buffers when more than one
  size_t bytes;     // dynamic shared memory
};

__host__ __device__ inline Layout layout(const Plan& p, int H, int cg, int K) {
  Layout l;
  l.cgp = ceil_div(cg, kTN) * kTN;
  l.ntc = l.cgp / kTN;
  l.rg = p.tile_h / kTM;
  l.n_out = p.rows * l.rg * l.ntc;
  // A warp whose 32 threads share one row group reads 32 distinct weight
  // float4s per tap (4 shared-memory wavefronts); 2-4 row groups x 8-16
  // channel groups read 1-2.
  const int rgt = p.rows * l.rg;
  l.wr = l.ntc < 32 ? 1 : rgt % 4 == 0 ? 4 : rgt % 2 == 0 ? 2 : 1;
  l.xs_row = p.tile_h - kTM + ceil_div(kTM + K - 1, 4) * 4;
  l.xs_ci = p.rows * l.xs_row;
  l.ws_size = K * p.ck * l.cgp;
  l.stage = l.ws_size + p.ck * l.xs_ci;
  l.sub = p.tile_h * l.cgp;
  l.tile = p.rows * l.sub;
  int ring = p.stages * l.stage;
  if (p.slices > 1 && p.slices * l.tile > ring) ring = p.slices * l.tile;
  if (p.rows * p.threads > ring) ring = p.rows * p.threads;
  l.ring = ring;
  l.n_tiles = ceil_div(H, p.tile_h);
  l.bytes = sizeof(float) * ((size_t)l.ring + (l.n_tiles > 1 ? 2 : 1) * (size_t)l.tile);
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: `valid` false writes zeros and reads nothing.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// A barrier over every rank's threads: the cluster's, or the CTA's where the
// cluster is the CTA alone (C 1 launches without the cluster attribute).
__device__ __forceinline__ void ranks_sync(int C) {
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// `p`, a shared-memory address of this CTA, in rank q's shared memory.
template <typename T>
__device__ __forceinline__ T* rank_ptr(T* p, int q, int C) {
  return C > 1 ? coop::this_cluster().map_shared_rank(p, q) : p;
}

// v[u] := the sum of v[u] over the CTA's threads (warp 0 adds them in a
// fixed order) and then over the cluster's ranks in rank order, for each of
// the nb rows; every thread gets the same bits. `red` holds nb * threads
// floats; `slots` (kMaxRows floats) must differ between calls whose remote
// reads may overlap.
__device__ __forceinline__ void cluster_totals(float (&v)[kMaxRows], int nb, float* red,
                                               float* slots, int threads, int C) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < kMaxRows; ++u)
    if (u < nb) red[u * threads + tid] = v[u];
  __syncthreads();
  if (tid < 32) {
    for (int u = 0; u < nb; ++u) {
      float s = 0.f;
      for (int i = tid; i < threads; i += 32) s += red[u * threads + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (tid == 0) slots[u] = s;
    }
  }
  ranks_sync(C);  // every rank's slots are written, and red[] may be reused
#pragma unroll
  for (int u = 0; u < kMaxRows; ++u) {
    if (u < nb) {
      float total = 0.f;
      for (int q = 0; q < C; ++q) total += *rank_ptr(&slots[u], q, C);
      v[u] = total;
    }
  }
}

// Adds `val` to acc[u] for the one u == rb, with every index static.
__device__ __forceinline__ void add_to_row(float (&acc)[kMaxRows], int rb, float val) {
#pragma unroll
  for (int u = 0; u < kMaxRows; ++u)
    if (u == rb) acc[u] += val;
}

__device__ __forceinline__ float row_value(const float (&v)[kMaxRows], int rb) {
  float r = 0.f;
#pragma unroll
  for (int u = 0; u < kMaxRows; ++u)
    if (u == rb) r = v[u];
  return r;
}

// kVecW: the group's weight columns are 16-byte aligned and cg % 4 == 0, so
// each weight row is copied as 16-byte pieces. kStats: K1 (the header): x is
// (B, H + K - 1, Cin) with its halo, `out` gets the pre-norm values and
// `stats` (B, groups, 2) each (batch row, group)'s local (mean, M2).
template <int K, bool kVecW, bool kStats>
__global__ void __launch_bounds__(kMaxThreads, 2)
conv_gn_mish_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ out,
                    float* __restrict__ stats_out, int B, int H, int Cin, int Cout, int groups,
                    Plan p, float eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ float stats[2][kMaxRows];
  __shared__ float affine[3][kMaxGroupChannels];  // the group's bias, gamma, beta
  constexpr int kPad = K / 2;
  constexpr int kXW = (kTM + K - 1 + 3) / 4 * 4;  // input window, in whole float4s

  const int cg = Cout / groups;
  const Layout l = layout(p, H, cg, K);
  const int Hin = kStats ? H + K - 1 : H;  // rows of x
  const int C = p.cluster;
  const int rank = blockIdx.x % C;  // a 1-D grid of 1-D clusters
  const int cl = blockIdx.x / C;    // (row block, group)
  const int g = cl % groups;
  const int b0 = (cl / groups) * p.rows;
  const int nb = B - b0 < p.rows ? B - b0 : p.rows;  // batch rows that exist
  const int tid = threadIdx.x;
  const int threads = p.threads;

  const int cin_lo = (int)((long long)Cin * rank / C);
  const int cin_hi = (int)((long long)Cin * (rank + 1) / C);
  const int n_chunks = ceil_div(cin_hi - cin_lo, p.ck);

  // this thread's output tile (batch row rb, rows r0.., channels c0..) and
  // its slice of every chunk
  const int slice = tid / l.n_out;
  const int o = tid - slice * l.n_out;
  const int o_hi = o / l.wr;
  const int rgi = (o_hi / l.ntc) * l.wr + (o - o_hi * l.wr);  // row group over the R rows
  const int rb = rgi / l.rg;
  const int r0 = (rgi - rb * l.rg) * kTM;
  const int c0 = (o_hi % l.ntc) * kTN;
  const int cps = p.ck / p.slices;
  const int ci_lo = slice * cps;

  // this thread's place in the staging copies (divisions once, not per copy)
  const int xrows = p.tile_h + K - 1;
  const int x_n = p.rows * xrows;  // staged rows of one channel, over the batch rows
  const int x_ci = tid % p.ck, x_q0 = tid / p.ck, x_step = threads / p.ck;
  const int x_rb0 = x_q0 / xrows, x_r0 = x_q0 % xrows;
  const int x_drb = x_step / xrows, x_dr = x_step % xrows;
  const int w_q = tid % l.ntc, w_r0 = tid / l.ntc, w_step = threads / l.ntc;
  const int w_rows = K * p.ck;
  const int w_tap0 = w_r0 / p.ck, w_ci0 = w_r0 % p.ck;
  const int w_dtap = w_step / p.ck, w_dci = w_step % p.ck;
  const bool x_copies = tid < x_step * p.ck, w_copies = tid < w_step * l.ntc;

  const float* wg = w + (size_t)g * cg;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], threads);
      mbar_init(&empty[s], threads);
    }
  }
  // The epilogue's bias, gamma and beta, fetched now: the first chunk's
  // "full" barrier covers these copies too.
  for (int c = tid; c < cg; c += threads) {
    copy4(&affine[0][c], bias + g * cg + c, true);
    if (!kStats) {
      copy4(&affine[1][c], gamma + g * cg + c, true);
      copy4(&affine[2][c], beta + g * cg + c, true);
    }
  }
  __syncthreads();

  // Stage input channels [cin_lo + chunk * ck, + ck) of the rows tile h0
  // needs, for every batch row, into ring stage seq % stages; padding
  // (sequence ends, rows past B, channels past the rank's range or cg) is
  // zero-filled by the copies themselves. With kStats, x row h0 + r is the
  // "same" conv's row h0 - K / 2 + r: the halo stands in for the padding.
  auto produce = [&](int seq, int chunk, int h0) {
    const int st = seq % p.stages;
    float* ws = smem + st * l.stage;
    float* xs = ws + l.ws_size + x_ci * l.xs_ci;
    const int cbase = cin_lo + chunk * p.ck;
    if (x_copies) {
      const int cin = cbase + x_ci;
      const bool cin_ok = cin < cin_hi;
      int xb = x_rb0, xr = x_r0;
      for (int q = x_q0; q < x_n; q += x_step) {
        const int h = kStats ? h0 + xr : h0 - kPad + xr;
        const bool ok = cin_ok && xb < nb && h >= 0 && h < Hin;
        copy4(xs + xb * l.xs_row + xr, ok ? x + ((size_t)(b0 + xb) * Hin + h) * Cin + cin : x,
              ok);
        xb += x_drb;
        xr += x_dr;
        if (xr >= xrows) {
          xr -= xrows;
          ++xb;
        }
      }
    }
    if (w_copies) {
      int tap = w_tap0, ci = w_ci0;
      for (int r = w_r0; r < w_rows; r += w_step) {
        const int cin = cbase + ci;
        const bool ok = cin < cin_hi;
        const float* src = wg + ((size_t)tap * Cin + cin) * Cout + kTN * w_q;
        float* dst = ws + r * l.cgp + kTN * w_q;
        if (kVecW) {
          copy16(dst, ok ? src : w, ok);
        } else {
#pragma unroll
          for (int q = 0; q < kTN; ++q) {
            const bool okq = ok && kTN * w_q + q < cg;
            copy4(dst + q, okq ? src + q : w, okq);
          }
        }
        tap += w_dtap;
        ci += w_dci;
        if (ci >= p.ck) {
          ci -= p.ck;
          ++tap;
        }
      }
    }
    mbar_arrive_on_copies(&full[st]);
  };

  // this rank's share of each batch row's tile: float4s [lo4, hi4) of sub4
  const int sub4 = l.sub / 4;
  const int lo4 = (int)((long long)sub4 * rank / C);
  const int hi4 = (int)((long long)sub4 * (rank + 1) / C);
  const bool single = l.n_tiles == 1;  // pre-norm values stay in the rank's own tile

  int seq = 0;  // chunks staged so far, over all tiles: ring stage and mbarrier phase
  float stat[kMaxRows];
#pragma unroll
  for (int u = 0; u < kMaxRows; ++u) stat[u] = 0.f;

  for (int t = 0; t < l.n_tiles; ++t) {
    const int h0 = t * p.tile_h;
    float acc[kTM][kTN];
#pragma unroll
    for (int j = 0; j < kTM; ++j)
#pragma unroll
      for (int q = 0; q < kTN; ++q) acc[j][q] = 0.f;

    const int pre = n_chunks < p.stages - 1 ? n_chunks : p.stages - 1;
    for (int i = 0; i < pre; ++i) produce(seq + i, i, h0);
    for (int i = 0; i < n_chunks; ++i) {
      const int s = seq + i;
      const int st = s % p.stages;
      mbar_wait(&full[st], (s / p.stages) & 1);
      const float* ws = smem + st * l.stage + c0;
      const float* xs = smem + st * l.stage + l.ws_size + rb * l.xs_row + r0;
      for (int ci = ci_lo; ci < ci_lo + cps; ++ci) {
        float xv[kXW];
        const float4* xp = reinterpret_cast<const float4*>(xs + ci * l.xs_ci);
#pragma unroll
        for (int m = 0; m < kXW / 4; ++m) {
          const float4 v = xp[m];
          xv[4 * m] = v.x;
          xv[4 * m + 1] = v.y;
          xv[4 * m + 2] = v.z;
          xv[4 * m + 3] = v.w;
        }
#pragma unroll
        for (int tap = 0; tap < K; ++tap) {
          const float4 wv = *reinterpret_cast<const float4*>(ws + (tap * p.ck + ci) * l.cgp);
#pragma unroll
          for (int j = 0; j < kTM; ++j) {
            acc[j][0] = fmaf(xv[j + tap], wv.x, acc[j][0]);
            acc[j][1] = fmaf(xv[j + tap], wv.y, acc[j][1]);
            acc[j][2] = fmaf(xv[j + tap], wv.z, acc[j][2]);
            acc[j][3] = fmaf(xv[j + tap], wv.w, acc[j][3]);
          }
        }
      }
      mbar_arrive(&empty[st]);
      // refill the stage chunk i - 1 used, once every thread has read it
      const int nx = i + p.stages - 1;
      if (nx < n_chunks) {
        const int prev = s - 1;
        if (prev >= 0) mbar_wait(&empty[prev % p.stages], (prev / p.stages) & 1);
        produce(seq + nx, nx, h0);
      }
    }
    seq += n_chunks;

    // the rank's partial tile, rows [rb][h][c]: slices added in slice order
    float* tile = smem + l.ring + (t & 1) * l.tile;
    if (p.slices > 1) {
      __syncthreads();  // every thread is done with the ring, which now holds the slices' sums
      float* part = smem;
#pragma unroll
      for (int j = 0; j < kTM; ++j)
        *reinterpret_cast<float4*>(part + (slice * l.tile / l.cgp + rgi * kTM + j) * l.cgp +
                                   c0) = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      __syncthreads();
      const float4* part4 = reinterpret_cast<const float4*>(part);
      const int n4 = l.tile / 4;
      for (int i4 = tid; i4 < n4; i4 += threads) {
        float4 v = part4[i4];
        for (int sl = 1; sl < p.slices; ++sl) {
          const float4 u = part4[sl * n4 + i4];
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        reinterpret_cast<float4*>(tile)[i4] = v;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTM; ++j)
        *reinterpret_cast<float4*>(tile + (rgi * kTM + j) * l.cgp + c0) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    // Every rank's partial tile is complete. (Tile t - 1's buffer, which
    // tile t + 1 reuses, was read by every rank before it reached here.)
    ranks_sync(C);

    // this rank's share: the sum over ranks in rank order, plus the bias
    for (int b = 0; b < nb; ++b) {
      for (int i4 = b * sub4 + lo4 + tid; i4 < b * sub4 + hi4; i4 += threads) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < C; ++q) {
          const float4 u = reinterpret_cast<const float4*>(rank_ptr(tile, q, C))[i4];
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        const int row = (i4 - b * sub4) / l.ntc, c = 4 * (i4 - b * sub4) - row * l.cgp;
        const int h = h0 + row;
        if (h >= H) continue;
        const float vals[4] = {v.x, v.y, v.z, v.w};
        float* dst = single ? tile + 4 * i4 : out + ((size_t)(b0 + b) * H + h) * Cout + g * cg + c;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q < cg) {
            const float val = vals[q] + affine[0][c + q];
            dst[q] = val;
            add_to_row(stat, b, val);
          }
        }
      }
    }
  }

  // GroupNorm statistics per batch row, two-pass; each thread rereads only
  // the pre-norm values it wrote.
  float* red = smem;  // the ring is idle from here on
  const float n = (float)H * (float)cg;
  float mean[kMaxRows], inv[kMaxRows];
  cluster_totals(stat, nb, red, stats[0], threads, C);
#pragma unroll
  for (int u = 0; u < kMaxRows; ++u) {
    mean[u] = stat[u] / n;
    stat[u] = 0.f;
  }
  for (int t = 0; t < l.n_tiles; ++t) {
    const float* tile = smem + l.ring + (t & 1) * l.tile;
    for (int b = 0; b < nb; ++b) {
      for (int i4 = b * sub4 + lo4 + tid; i4 < b * sub4 + hi4; i4 += threads) {
        const int row = (i4 - b * sub4) / l.ntc, c = 4 * (i4 - b * sub4) - row * l.cgp;
        const int h = t * p.tile_h + row;
        if (h >= H) continue;
        const float* src =
            single ? tile + 4 * i4 : out + ((size_t)(b0 + b) * H + h) * Cout + g * cg + c;
        const float m = row_value(mean, b);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q < cg) {
            const float d = src[q] - m;
            add_to_row(stat, b, d * d);
          }
        }
      }
    }
  }
  cluster_totals(stat, nb, red, stats[1], threads, C);
  if (C > 1) cluster_arrive();  // this rank has read every rank's statistics
#pragma unroll
  for (int u = 0; u < kMaxRows; ++u) inv[u] = 1.f / sqrtf(stat[u] / n + eps);
  if (kStats && rank == 0 && tid == 0) {
    for (int b = 0; b < nb; ++b) {
      stats_out[((size_t)(b0 + b) * groups + g) * 2] = row_value(mean, b);
      stats_out[((size_t)(b0 + b) * groups + g) * 2 + 1] = row_value(stat, b);
    }
  }

  // K1 leaves the pre-norm values in `out`: only a single tile's, kept in
  // shared memory, still have to go there.
  for (int t = 0; t < ((kStats && !single) ? 0 : l.n_tiles); ++t) {
    const float* tile = smem + l.ring + (t & 1) * l.tile;
    for (int b = 0; b < nb; ++b) {
      for (int i4 = b * sub4 + lo4 + tid; i4 < b * sub4 + hi4; i4 += threads) {
        const int row = (i4 - b * sub4) / l.ntc, c = 4 * (i4 - b * sub4) - row * l.cgp;
        const int h = t * p.tile_h + row;
        if (h >= H) continue;
        float* dst = out + ((size_t)(b0 + b) * H + h) * Cout + g * cg + c;
        const float* src = single ? tile + 4 * i4 : dst;
        const float m = row_value(mean, b), s = row_value(inv, b);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cc = c + q;
          if (cc < cg) {
            if (kStats) {
              dst[q] = src[q];
            } else {
              const float v = (src[q] - m) * s * affine[1][cc] + affine[2][cc];
              const float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
              dst[q] = v * tanhf(sp);
            }
          }
        }
      }
    }
  }
  if (C > 1) cluster_wait();  // no rank leaves while another may still read its shared memory
}

// K2: out = Mish((pre - mean) * rstd * gamma + beta) with `stats` (B, groups,
// 2) holding each (batch row, group)'s (mean, rstd); kV values a thread
// (4 where C and the group width are multiples of 4), grid-stride. TOut is
// float, or bf16 (each value rounded once at the store).
template <int kV, typename TOut>
__global__ void __launch_bounds__(256)
gn_affine_mish_kernel(const float* __restrict__ pre, const float* __restrict__ stats,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      TOut* __restrict__ out, long long n, int HC, int C, int cg) {
  const int groups = C / cg;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n / kV; i += stride) {
    const long long e = i * kV;
    const int b = (int)(e / HC);
    const int c = (int)(e % C);
    const float* st = stats + ((size_t)b * groups + c / cg) * 2;
    const float m = st[0], s = st[1];
    float v[4];
    if constexpr (kV == 4) {
      const float4 u = reinterpret_cast<const float4*>(pre)[i];
      v[0] = u.x;
      v[1] = u.y;
      v[2] = u.z;
      v[3] = u.w;
    } else {
      v[0] = pre[e];
    }
#pragma unroll
    for (int q = 0; q < kV; ++q) {
      const float y = (v[q] - m) * s * gamma[c + q] + beta[c + q];
      const float sp = fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)));
      v[q] = y * tanhf(sp);
    }
    if constexpr (std::is_same_v<TOut, float>) {
      if constexpr (kV == 4) {
        reinterpret_cast<float4*>(out)[i] = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        out[e] = v[0];
      }
    } else if constexpr (kV == 4) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      reinterpret_cast<uint2*>(out)[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                    *reinterpret_cast<const uint32_t*>(&hi));
    } else {
      out[e] = __float2bfloat16_rn(v[0]);
    }
  }
}

// K2's launch for an output of type TOut (`out` may be `pre` where TOut is float).
template <typename TOut>
int launch_k2(const float* pre, const float* stats, const float* gamma, const float* beta,
              TOut* out, int B, int H, int C, int groups, void* stream) {
  if (B <= 0 || H <= 0 || C <= 0 || groups <= 0 || C % groups) return (int)cudaErrorInvalidValue;
  const int cg = C / groups;
  const long long n = (long long)B * H * C;
  const bool vec = cg % 4 == 0 && reinterpret_cast<uintptr_t>(pre) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(TOut)) == 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long items = vec ? n / 4 : n;
  const long long most = 8LL * sms;
  const int grid = (int)((items + 255) / 256 < most ? (items + 255) / 256 : most);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    gn_affine_mish_kernel<4, TOut><<<grid, 256, 0, s>>>(pre, stats, gamma, beta, out, n, H * C,
                                                        C, cg);
  else
    gn_affine_mish_kernel<1, TOut><<<grid, 256, 0, s>>>(pre, stats, gamma, beta, out, n, H * C,
                                                        C, cg);
  return (int)cudaGetLastError();
}

// The plan's own consistency; false for a plan the kernel does not take.
bool plan_ok(const Plan& p, int H, int Cin, int cg, int K) {
  if (p.cluster != 1 && p.cluster != 2 && p.cluster != 4 && p.cluster != kMaxCluster)
    return false;
  if (p.rows < 1 || p.rows > kMaxRows || p.tile_h <= 0 || p.tile_h % kTM || p.slices <= 0 ||
      p.ck <= 0 || p.ck % p.slices)
    return false;
  if (p.stages < 2 || p.stages > kMaxStages || cg > kMaxGroupChannels || Cin < p.cluster)
    return false;
  const Layout l = layout(p, H, cg, K);
  return p.threads == l.n_out * p.slices && p.threads >= 32 && p.threads <= kMaxThreads &&
         p.ck <= p.threads && l.ntc <= p.threads &&
         l.bytes + kStaticSmem <= kMaxSmem;
}

template <int K, bool kVecW, bool kStats>
cudaError_t configure(const Plan& p, size_t smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, int grid, cudaStream_t stream) {
  // Dynamic shared memory allowed so far, per device: the attribute applies
  // to the current device only. Without it a plan whose dynamic bytes fit
  // 48 KB but not beside the static ones is refused at launch and held to 0
  // clusters by cudaOccupancyMaxActiveClusters.
  constexpr int kMaxDevices = 64;
  static size_t configured[kMaxDevices] = {};
  if (smem + kStaticSmem > kDefaultSmem) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (!(dev < kMaxDevices && smem <= configured[dev])) {
      e = cudaFuncSetAttribute(conv_gn_mish_kernel<K, kVecW, kStats>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      if (dev < kMaxDevices) configured[dev] = smem;
    }
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(p.threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = p.cluster > 1 ? 1 : 0;
  return cudaSuccess;
}

template <int K, bool kVecW, bool kStats>
int launch_as(const float* x, const float* w, const float* bias, const float* gamma,
              const float* beta, float* out, float* stats, int B, int H, int Cin, int Cout,
              int groups, const Plan& p, float eps, cudaStream_t stream) {
  const Layout l = layout(p, H, Cout / groups, K);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int grid = ceil_div(B, p.rows) * groups * p.cluster;
  cudaError_t e = configure<K, kVecW, kStats>(p, l.bytes, &cfg, attr, grid, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, conv_gn_mish_kernel<K, kVecW, kStats>, x, w, bias, gamma, beta,
                         out, stats, B, H, Cin, Cout, groups, p, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int K, bool kVecW, bool kStats>
int max_clusters_as(int H, int Cout, int groups, const Plan& p, int* n) {
  const Layout l = layout(p, H, Cout / groups, K);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<K, kVecW, kStats>(p, l.bytes, &cfg, attr, 1024 * p.cluster, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (p.cluster > 1)
    return (int)cudaOccupancyMaxActiveClusters(
        n, reinterpret_cast<const void*>(conv_gn_mish_kernel<K, kVecW, kStats>), &cfg);
  // one CTA per "cluster": the CTAs per SM the card holds, times its SMs
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv_gn_mish_kernel<K, kVecW, kStats>, p.threads, l.bytes)) != cudaSuccess)
    return (int)e;
  *n = per_sm * sms;
  return (int)cudaSuccess;
}

Plan read_plan(const int* v) { return Plan{v[0], v[1], v[2], v[3], v[4], v[5], v[6]}; }

bool shape_ok(int B, int H, int Cin, int Cout, int groups) {
  return groups > 0 && Cout % groups == 0 && B > 0 && H > 0 && Cin > 0;
}

// B1 (stats null) or K1 (stats given), dispatched on k and the weight copies.
int launch_k(const float* x, const float* w, const float* bias, const float* gamma,
             const float* beta, float* out, float* stats, int B, int H, int Cin, int Cout, int k,
             int groups, float eps, const int* plan, void* stream) {
  if (!shape_ok(B, H, Cin, Cout, groups)) return (int)cudaErrorInvalidValue;
  const Plan p = read_plan(plan);
  if (!plan_ok(p, H, Cin, Cout / groups, k)) return (int)cudaErrorInvalidValue;
  const bool vec = (Cout / groups) % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV_GN_MISH_LAUNCH(KK, ST)                                                           \
  return vec ? launch_as<KK, true, ST>(x, w, bias, gamma, beta, out, stats, B, H, Cin, Cout,  \
                                       groups, p, eps, s)                                     \
             : launch_as<KK, false, ST>(x, w, bias, gamma, beta, out, stats, B, H, Cin, Cout, \
                                        groups, p, eps, s);
#define CONV_GN_MISH_CASE(KK)         \
  case KK:                            \
    if (stats != nullptr) {           \
      CONV_GN_MISH_LAUNCH(KK, true)   \
    }                                 \
    CONV_GN_MISH_LAUNCH(KK, false)
  switch (k) {
    CONV_GN_MISH_CASE(1)
    CONV_GN_MISH_CASE(3)
    CONV_GN_MISH_CASE(5)
    CONV_GN_MISH_CASE(7)
    CONV_GN_MISH_CASE(9)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CONV_GN_MISH_CASE
#undef CONV_GN_MISH_LAUNCH
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t value (cudaErrorInvalidValue for
// a kernel size, group width or plan the kernel does not take). `plan`
// points to the 7 ints of struct Plan.
int conv_gn_mish_f32(const float* x, const float* w, const float* bias,
                     const float* gamma, const float* beta, float* out, int B,
                     int H, int Cin, int Cout, int k, int groups, float eps,
                     const int* plan, void* stream) {
  return launch_k(x, w, bias, gamma, beta, out, nullptr, B, H, Cin, Cout, k, groups, eps, plan,
                  stream);
}

// K1: x (B, H + k - 1, Cin) with its halo; pre (B, H, Cout); stats (B,
// groups, 2), each (batch row, group)'s local (mean, M2). Returns as above.
int conv_gn_stats_f32(const float* x, const float* w, const float* bias, float* pre,
                      float* stats, int B, int H, int Cin, int Cout, int k, int groups,
                      const int* plan, void* stream) {
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  return launch_k(x, w, bias, nullptr, nullptr, pre, stats, B, H, Cin, Cout, k, groups, 0.f,
                  plan, stream);
}

// K2: out (B, H, C) = Mish((pre - mean) * rstd * gamma + beta), stats (B,
// groups, 2) the merged (mean, rstd). `out` may be `pre`.
int gn_affine_mish_f32(const float* pre, const float* stats, const float* gamma,
                       const float* beta, float* out, int B, int H, int C, int groups,
                       void* stream) {
  return launch_k2(pre, stats, gamma, beta, out, B, H, C, groups, stream);
}

// K2's bf16 form: the same, `out` (B, H, C) bf16.
int gn_affine_mish_bf16(const float* pre, const float* stats, const float* gamma,
                        const float* beta, void* out, int B, int H, int C, int groups,
                        void* stream) {
  return launch_k2(pre, stats, gamma, beta, static_cast<__nv_bfloat16*>(out), B, H, C, groups,
                   stream);
}

// For one plan on the current device: the dynamic shared memory it takes
// (bytes) and how many of its clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0 means it cannot be scheduled). `vec`
// selects the 16-byte weight copies. Returns a cudaError_t value.
int conv_gn_mish_f32_plan_check(int H, int Cin, int Cout, int k, int groups, const int* plan,
                                int vec, int stats, int* smem_bytes, int* max_clusters) {
  if (!shape_ok(1, H, Cin, Cout, groups)) return (int)cudaErrorInvalidValue;
  const Plan p = read_plan(plan);
  if (!plan_ok(p, H, Cin, Cout / groups, k)) return (int)cudaErrorInvalidValue;
  *smem_bytes = (int)layout(p, H, Cout / groups, k).bytes;
#define CONV_GN_MISH_CHECK(KK)                                                            \
  case KK:                                                                                \
    if (stats)                                                                            \
      return vec ? max_clusters_as<KK, true, true>(H, Cout, groups, p, max_clusters)      \
                 : max_clusters_as<KK, false, true>(H, Cout, groups, p, max_clusters);    \
    return vec ? max_clusters_as<KK, true, false>(H, Cout, groups, p, max_clusters)       \
               : max_clusters_as<KK, false, false>(H, Cout, groups, p, max_clusters);
  switch (k) {
    CONV_GN_MISH_CHECK(1)
    CONV_GN_MISH_CHECK(3)
    CONV_GN_MISH_CHECK(5)
    CONV_GN_MISH_CHECK(7)
    CONV_GN_MISH_CHECK(9)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CONV_GN_MISH_CHECK
}

const char* conv_gn_mish_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
