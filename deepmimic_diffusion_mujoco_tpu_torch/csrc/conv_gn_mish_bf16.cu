// Fused "same" Conv1d(k) + bias -> GroupNorm(groups, eps) -> affine -> Mish
// at bf16: x (B, H, Cin) and w (k, Cin, Cout) bf16; bias, gamma, beta
// (Cout,) float32; out (B, H, Cout) bf16, channel-last.
//
// Replaces deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_block_kernel.py:
// conv_gn_mish as the temporal U-Net calls it under `bf16=True` (its
// Conv1dBlock passes bf16 x and w): the products of bf16 values summed in
// float32 (`preferred_element_type=jnp.float32`), the float32 bias,
// GroupNorm, affine and Mish in float32, one bf16 store. csrc/conv_gn_mish.cu
// is the float32 form.
//
// What bounds it. Per (batch row, group) the conv is an H x (k Cin) x
// (Cout / groups) product: 2 k Cin bf16 operations per output on the tensor
// cores (989 TFLOP/s dense on an H100 SXM) against about 4 bytes of
// activations, and the group's k Cin Cout / groups weights, which every batch
// row uses. At the U-Net's serving shapes the operations take about half the
// time of the bytes, and of the bytes the weights are most (115 of 130 MB a
// dim-128 forward at B 16): the bound is the weight stream, 0.039 ms a
// forward. A CTA that streams a group's weights for one batch row alone (the
// first form of this kernel) reads them B times from L2, a few MB each, at
// the rate one SM draws: 40x the bound.
//
// Design. One thread block cluster of C CTAs (C in 1, 2, 4, 8) per R batch
// rows (R in 1..16) and one group; R, C and the rest are the host's plan
// (ops/conv_block_kernel.py: bf16_plan, fitted to ops/conv_block_sweep.py
// --bf16 on an H100, PERF.md):
//   1. R batch rows share every staged weight chunk: the CTA's product has
//      M = R x H rows (H 8 with R 8: one 64-row wgmma tile, no padding), so
//      L2 weight traffic falls R-fold.
//   2. The C ranks split the group's input channels by 64-channel chunks
//      (split 0): each streams 1/C of the weights, and the grid, groups x
//      ceil(B / R) x C, fills the card where the shape allows. Or, with R 1,
//      they split a batch row's rows into 16-row multiples (split 1: K1's long
//      rank horizons, and B1's longest), each streaming all weights for its
//      rows.
//   3. Warp-specialised ring of 1-4 stages, each a 64-channel chunk: one
//      producer warp's lane issues TMA loads (cuTensorMapEncodeTiled maps,
//      made per launch on the host) and each stage's "full" mbarrier counts
//      the bytes; the consumer warps release a stage on its "empty"
//      mbarrier. The input rows come as boxes of (64 channels x the batch
//      row's H + k - 1 rows), 128-byte rows swizzled (SWIZZLE_128B) so that
//      ldmatrix reads them without bank conflicts; rows outside the sequence
//      are out of bounds and TMA zero-fills them, which is the "same" padding.
//      The weights come as atoms of (up to 64 output channels) x (64 channels
//      x k taps), N contiguous, swizzled by the atom's row width. TMA needs
//      16-byte global strides: where Cin (x: the first block's 35 channels)
//      or the group's columns (w) are no multiple of 8, or a base is not
//      16-byte aligned, the consumer threads stage that operand themselves
//      into the same layout (loads of 16 bytes where aligned, else of one
//      value) after the stage's "full" barrier, then meet at a named barrier.
//   4. The product: the conv's tap t is a row offset into the staged rows,
//      and batch rows sit XR rows apart, so A (the input rows) comes from
//      registers: each lane names its own row to ldmatrix, no im2col and no
//      copy per tap. B (the weights) is read from shared memory. The wgmma
//      instance (mma 0) runs wgmma.m64nNk16 (bf16 in, float32 accumulators;
//      N = the atom, one instruction per atom) on each warpgroup's 64-row
//      tiles: two taps' A fragments are loaded, then their products issued
//      as one group and waited for (a register written while a group is in
//      flight, or a group on a divergent path, makes ptxas serialise every
//      product); the mma.sync instance (mma 1)
//      runs m16n8k16 on each warp's 16-row tiles with B through
//      ldmatrix.trans, for shapes whose rows leave a 64-row tile mostly
//      empty. Either is chosen by the plan, never as a fallback.
//   5. With the channel split, each rank owns ceil(R H / C) of the CTA's rows:
//      after a cluster barrier (every ring drained) each consumer pushes its
//      partial values of every row into the owner's receive buffer (over the
//      ring) with distributed shared-memory stores, and after a second the
//      owner sums its rows' C slots in rank order and adds the bias (no
//      atomics, no global scratch, no remote load's round trip: two launches
//      give the same bits). Without it the values stay in the accumulators.
//   6. GroupNorm, two-pass: per batch row, the owned rows' sums (each row
//      over a few lanes, each batch row's rows over a warp), all-reduced over
//      the ranks in rank order; the mean; then the sums of squared deviations the same way.
//      Normalise, affine, Mish (x n / (n + 2) with n = e^x (e^x + 2): one
//      exponential), one bf16 store. The consumers stage the group's bias,
//      gamma and beta while the first chunk is in flight.
// A final cluster barrier keeps every rank's shared memory alive until the
// others have read it.
//
// K1 at bf16 (conv_gn_stats_bf16; the horizon-sharded form of a bf16 model,
// csrc/conv_gn_mish.cu's header): the same kernel on a rank's rows with their
// k / 2-row halo on each side, (B, H + k - 1, Cin), read without padding.
// After step 6's two reductions it writes the float32 pre-norm rows (conv +
// bias: the values B1's bf16 form normalises) and each (batch row, group)'s
// mean and M2 (the sum of squared deviations), and stops. K2
// (csrc/conv_gn_mish.cu, gn_affine_mish_bf16) normalises with the merged
// statistics and rounds once to bf16.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/conv_block_kernel.py: conv_gn_mish_bf16_cuda) checks
// shapes, dtypes and contiguity and chooses the plan (bf16_plan).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.h"
#include "wgmma_bf16.h"

namespace coop = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCk = 64;            // input channels a chunk: one 128-byte staged row
constexpr int kMaxRows = 16;       // batch rows a CTA
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxStages = 4;
constexpr int kMaxWgs = 2;         // consumer warpgroups
constexpr int kMaxThreads = 128 * kMaxWgs + 32;  // and the producer warp
constexpr int kMaxGroupChannels = 256;
constexpr int kMaxBox = 256;       // rows of one TMA box
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic + static shared memory of one CTA
// The static shared memory: mbarriers, the statistics' slots and values, the
// group's bias / gamma / beta.
constexpr size_t kStaticSmem = 16 * kMaxStages + 4 * 4 * kMaxRows + 4 * 3 * kMaxGroupChannels;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kAlign = 1024;    // the ring's swizzle period: the dynamic base is rounded up

// Chosen on the host (ops/conv_block_kernel.py: BF16Plan), passed by value.
struct Plan {
  int rows;     // R: batch rows a CTA, sharing every staged chunk
  int cluster;  // C: CTAs a cluster
  int split;    // 0: the ranks split the input channels by chunks; 1: the rows (R 1)
  int stages;   // ring depth
  int mma;      // 0: wgmma on 64-row tiles; 1: mma.sync on 16-row tiles
  int wgs;      // consumer warpgroups
  int tma;      // 1: TMA for each operand that allows it; 0: the consumers stage both
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The product's N: the group's channels rounded up to a power of two, 8 at least.
__host__ __device__ inline int pad_n(int cg) {
  int n = 8;
  while (n < cg) n *= 2;
  return n;
}

// Accumulator tiles a warp (mma.sync) or warpgroup (wgmma) holds: 64 floats a
// thread (N 256: one tile, 128).
__host__ __device__ constexpr int tiles_per(int n) { return n <= 16 ? 8 : n >= 128 ? 1 : 128 / n; }

// Shared-memory layout of one plan (ops/conv_block_kernel.py: bf16_smem_bytes
// mirrors it). Offsets in bytes from the 1024-aligned base.
struct Layout {
  int n;          // pad_n(cg)
  int hc;         // output rows of one batch row a CTA holds: H, or the row split's share
  int m;          // R hc: the CTA's output rows
  int hp;         // staged rows a batch row needs: hc + K - 1
  int br;         // rows of one x box (a multiple of 8, at most kMaxBox)
  int nbox;       // x boxes a batch row
  int xr;         // staged rows a batch row: nbox br
  int ts;         // floats of one output-tile row: n + 4
  size_t x_bytes;  // R xr 128
  size_t w_bytes;  // K kCk n 2
  size_t stage;    // x_bytes + w_bytes, rounded up to kAlign
  size_t tile;     // partial tiles (ranks', slices'), over the drained ring
  size_t rowsum;   // offset of the owned rows' sums (m floats), past the ring and the tile
  size_t bytes;    // dynamic shared memory, alignment slack included
};

__host__ __device__ inline Layout layout(const Plan& p, int H, int cg, int K) {
  Layout l;
  l.n = pad_n(cg);
  l.hc = p.split ? ceil_div(ceil_div(H, p.cluster), 16) * 16 : H;
  l.m = p.rows * l.hc;
  l.hp = l.hc + K - 1;
  l.nbox = ceil_div(l.hp, kMaxBox);
  l.br = ceil_div(ceil_div(l.hp, l.nbox), 8) * 8;
  l.xr = l.nbox * l.br;
  l.ts = l.n + 4;
  l.x_bytes = (size_t)p.rows * l.xr * 2 * kCk;
  l.w_bytes = (size_t)K * kCk * l.n * 2;
  l.stage = (l.x_bytes + l.w_bytes + kAlign - 1) / kAlign * kAlign;
  // the channel split's receive buffer: C ranks' partials of each rank's
  // ceil(m / C) owned rows
  const bool csplit = p.cluster > 1 && !p.split;
  l.tile = csplit ? sizeof(float) * (size_t)p.cluster * ceil_div(l.m, p.cluster) * l.ts : 0;
  // the mma.sync instance's slices' partial tiles: (slices - 1) x 16-row tiles
  // of N floats, at most one fewer than the consumer warps
  const size_t parts = p.mma ? sizeof(float) * (4 * p.wgs - 1) * 16 * (size_t)l.n : 0;
  if (parts > l.tile) l.tile = parts;
  const size_t ring = p.stages * l.stage;
  l.rowsum = ring > l.tile ? ring : l.tile;
  l.bytes = kAlign + l.rowsum + sizeof(float) * (size_t)l.m;
  return l;
}

bool plan_ok(const Plan& p, int H, int Cin, int cg, int K) {
  if (p.rows < 1 || p.rows > kMaxRows || p.stages < 1 || p.stages > kMaxStages) return false;
  if (p.cluster != 1 && p.cluster != 2 && p.cluster != 4 && p.cluster != kMaxCluster)
    return false;
  if (p.split != 0 && p.split != 1) return false;
  if (p.split == 1 && p.rows != 1) return false;
  if (p.split == 0 && ceil_div(Cin, kCk) < p.cluster) return false;  // a chunk a rank at least
  if (p.mma != 0 && p.mma != 1) return false;
  if (p.wgs < 1 || p.wgs > kMaxWgs || (p.tma != 0 && p.tma != 1)) return false;
  if (cg < 1 || cg > kMaxGroupChannels || H < 1 || Cin < 1 || K < 1 || K % 2 == 0 || K > 255)
    return false;
  const Layout l = layout(p, H, cg, K);
  // every output row in one pass of the accumulators
  if (l.m > p.wgs * tiles_per(l.n) * 64) return false;
  return l.bytes + kStaticSmem <= kMaxSmem;
}

// A barrier over every rank's threads: the cluster's, or the CTA's where the
// cluster is the CTA alone (C 1 launches without the cluster attribute).
__device__ __forceinline__ void ranks_sync(int C) {
  if (C > 1) {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

// `p`, a shared-memory address of this CTA, in rank q's shared memory.
template <typename T>
__device__ __forceinline__ T* rank_ptr(T* p, int q, int C) {
  return C > 1 ? coop::this_cluster().map_shared_rank(p, q) : p;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Mish, x tanh(softplus(x)), in one exponential: with e = exp(x) and n = e (e
// + 2), tanh(log1p(e)) = n / (n + 2); past 20 it is 1 in float32 (softplus's
// own threshold).
__device__ __forceinline__ float mish(float x) {
  if (x > 20.f) return x;
  const float e = expf(x);
  const float n = e * (e + 2.f);
  return x * n / (n + 2.f);
}

__device__ __forceinline__ uint16_t bf16_bits(const bf16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// 8 consecutive bf16 of a row (zeros past `valid` of them), as 16 bytes:
// one load where `vec`, else one per value.
__device__ __forceinline__ uint4 load8(const bf16* src, int valid, bool vec) {
  if (valid >= 8 && vec) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = e < valid ? bf16_bits(src + e) : 0u;
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
}

// kN: the product's N (pad_n(cg)); kMma: the mma.sync instance; l: the plan's
// layout at this shape (computed on the host, as layout() is). `stats_out`
// non-null: K1 (x of Hx = H + K - 1 rows, off 0; pre_out and stats_out
// written, out unused); else B1 (Hx = H, off = K / 2).
template <int kN, bool kMma>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv_gn_mish_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ x,
                         const bf16* __restrict__ w, const float* __restrict__ bias,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         bf16* __restrict__ out, float* __restrict__ pre_out,
                         float* __restrict__ stats_out, int B, int H, int Hx, int off, int Cin,
                         int Cout, int K, int groups, float eps, const Plan p, const Layout l,
                         int tma_x, int tma_w) {
  constexpr int kNI = kN < 64 ? kN : 64;  // one weight atom's width (one wgmma's N)
  constexpr int kNA = kN / kNI;           // atoms
  constexpr int kS = 2 * kNI;             // bytes of one atom row
  constexpr int kTpw = tiles_per(kN);
  constexpr int kAcc = kN / 2;            // accumulators of one tile, a thread

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ float slots[2][kMaxRows];   // this rank's partial sums, read by every rank
  __shared__ float mstat[2][kMaxRows];   // each batch row's mean, then rstd (B1) or M2 (K1)
  __shared__ float affine[3][kMaxGroupChannels];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + kAlign - 1) & ~(uint32_t)(kAlign - 1)) - raw);

  const int cg = Cout / groups;
  const int C = p.cluster;
  const int rank = blockIdx.x % C;  // a 1-D grid of 1-D clusters
  const int cl = blockIdx.x / C;    // (row block, group)
  const int g = cl % groups, gc = g * cg;
  const int b0 = (cl / groups) * p.rows;
  const int h0 = p.split ? rank * l.hc : 0;  // the CTA's first output row of a batch row
  const int nch_all = ceil_div(Cin, kCk);
  const int ch_lo = p.split ? 0 : nch_all * rank / C;
  const int nch = (p.split ? nch_all : nch_all * (rank + 1) / C) - ch_lo;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cwarps = 4 * p.wgs, cthreads = 32 * cwarps;
  const size_t atom_bytes = (size_t)K * kCk * kS;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], cwarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float* recv = reinterpret_cast<float*>(smem);  // over the ring, once it is drained
  const bool csplit = C > 1 && !p.split;          // the ranks' partial tiles are summed
  // The consumers' 16-row A fragments: row base[u] + (lane & 15) of the CTA's
  // m rows, staged at row srow[u] (+ the tap); has[u] false for the producer.
  int base[kTpw], srow[kTpw];
  bool has[kTpw];
  float acc[kTpw][kAcc];
  int slices = 1;  // the mma.sync instance's k-step split (below)
#pragma unroll
  for (int u = 0; u < kTpw; ++u) {
    has[u] = false;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[u][e] = 0.f;
  }
  if (warp == cwarps) {
    // The producer: stage i of the ring takes chunk ch_lo + i once its
    // previous chunk is released. One arrival with the TMA bytes; with no TMA
    // operand the arrival alone tells the consumers the stage is theirs.
    if (lane == 0) {
      const int nb = B - b0 < p.rows ? B - b0 : p.rows;
      const uint32_t bytes = (tma_x ? (uint32_t)(nb * l.xr * 2 * kCk) : 0u) +
                             (tma_w ? (uint32_t)l.w_bytes : 0u);
      for (int i = 0; i < nch; ++i) {
        const int s = i % p.stages, f = i / p.stages;
        if (f > 0) mbar_wait(&empty[s], (f - 1) & 1);
        uint8_t* xs = smem + s * l.stage;
        uint8_t* ws = xs + l.x_bytes;
        const int c0 = (ch_lo + i) * kCk;
        mbar_arrive_expect_tx(&full[s], bytes);
        if (tma_x)
          for (int r = 0; r < nb; ++r)
            for (int j = 0; j < l.nbox; ++j)
              tma_load_3d(xs + (size_t)(r * l.xr + j * l.br) * 2 * kCk, &xmap, &full[s], c0,
                          h0 - off + j * l.br, b0 + r);
        if (tma_w)
          for (int a = 0; a < kNA; ++a)
            tma_load_3d(ws + a * atom_bytes, &wmap, &full[s], gc + a * kNI, c0, 0);
      }
    }
    __syncwarp();
  } else {
    // The consumers. Where the mma.sync instance has more warps than 16-row
    // tiles, the warps split each tile's k-steps into `slices` (warp w: slot w
    // / slices, every slices-th k-step from w % slices): more warps at work,
    // shorter float32 chains of sums.
    const int wg = warp >> 2;
    if (kMma) {
      const int mt16 = ceil_div(l.m, 16);
      while (2 * slices * mt16 <= cwarps) slices *= 2;
    }
    const int slots = cwarps / slices, slot = warp / slices, slice = warp % slices;
#pragma unroll
    for (int u = 0; u < kTpw; ++u) {
      if (kMma) {
        base[u] = (slot + u * slots) * 16;
        has[u] = base[u] < l.m;
      } else {
        const int mt = wg + u * p.wgs;
        base[u] = mt * 64 + 16 * (warp & 3);
        has[u] = mt * 64 < l.m;  // the warpgroup's tile: uniform over its four warps
      }
      const int m = base[u] + (lane & 15);
      srow[u] = m < l.m ? (m / l.hc) * l.xr + m % l.hc : 0;
    }
    const uint32_t a_col = (lane >> 4) * 16;  // bytes: the fragment's second 8 columns
    const bool x_vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool w_vec = Cout % 8 == 0 && cg % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    // the epilogue's bias, gamma and beta, loaded while the first chunk is in flight
    for (int c = tid; c < cg; c += cthreads) {
      affine[0][c] = bias[gc + c];
      if (gamma != nullptr) {
        affine[1][c] = gamma[gc + c];
        affine[2][c] = beta[gc + c];
      }
    }

    for (int i = 0; i < nch; ++i) {
      const int s = i % p.stages;
      mbar_wait(&full[s], (i / p.stages) & 1);
      uint8_t* xs = smem + s * l.stage;
      uint8_t* ws = xs + l.x_bytes;
      const int c0 = (ch_lo + i) * kCk;
      if (!tma_x) {  // (batch row, staged row, 8-channel piece) a thread at a time
        const int items = p.rows * l.hp * 8;
        for (int it = tid; it < items; it += cthreads) {
          const int q = it & 7, rj = it >> 3;
          const int r = rj / l.hp, j = rj % l.hp;
          const int b = b0 + r, hx = h0 - off + j, c = c0 + 8 * q;
          const bool ok = b < B && hx >= 0 && hx < Hx && c < Cin;
          const uint4 v = ok ? load8(x + ((size_t)b * Hx + hx) * Cin + c, Cin - c, x_vec)
                             : make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(xs + swz((uint32_t)(r * l.xr + j) * 128 + 16 * q, 128)) = v;
        }
      }
      if (!tma_w) {  // (tap, channel, 8 output channels) a thread at a time
        const int items = K * kCk * (kN / 8);
        for (int it = tid; it < items; it += cthreads) {
          const int n = 8 * (it % (kN / 8)), row = it / (kN / 8);
          const int t = row / kCk, c = c0 + row % kCk;
          const bool ok = c < Cin && n < cg;
          const uint4 v = ok ? load8(w + ((size_t)t * Cin + c) * Cout + gc + n, cg - n, w_vec)
                             : make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(ws + (n / kNI) * atom_bytes +
                                    swz((uint32_t)row * kS + 2 * (n % kNI), kS)) = v;
        }
        fence_proxy_async();  // the wgmma instance reads them through the async proxy
      }
      if (!tma_x || !tma_w) named_sync(cthreads);
      const uint32_t xa = smem_u32(xs), wa = smem_u32(ws);

      if constexpr (kMma) {
        // per lane: the B row of ldmatrix.trans (x4: n tiles n0, n0 + 8; x2: one)
        const int bk = ((lane >> 3) & 1) * 8 + (lane & 7), bn = (lane >> 4) * 8;
#pragma unroll
        for (int u = 0; u < kTpw; ++u) {
          if (!has[u]) continue;
          for (int t = 0; t < K; ++t) {
#pragma unroll
            for (int ks = 0; ks < kCk / 16; ++ks) {  // k-step t (kCk / 16) + ks: this slice's
              if (((t * (kCk / 16) + ks) & (slices - 1)) != slice) continue;
              uint32_t a[4];
              ldsm_x4(a, xa + swz((uint32_t)(srow[u] + t) * 128 + 32 * ks + a_col, 128));
              const uint32_t kr = t * kCk + 16 * ks + bk;
              if constexpr (kN == 8) {
                uint32_t b[2];
                ldsm_x2_trans(b, wa + swz(kr * kS, kS));
                mma_bf16(acc[u], a, b);
              } else {
#pragma unroll
                for (int np = 0; np < kN / 16; ++np) {
                  const int n = 16 * np + bn;
                  uint32_t b[4];
                  ldsm_x4_trans(b, wa + (n / kNI) * atom_bytes + swz(kr * kS + 2 * (n % kNI), kS));
                  mma_bf16(acc[u] + 8 * np, a, b);
                  mma_bf16(acc[u] + 8 * np + 4, a, b + 2);
                }
              }
            }
          }
        }
      } else {
        // wgmma: the A fragments of two taps (each tap's four k16 steps) are
        // loaded, then their products issued as one group and waited for, so
        // that no other instruction writes a product's registers while a
        // group is in flight, and no group is issued on a divergent path
        // (either makes ptxas serialise every product)
        uint32_t a0[kCk / 16][4], a1[kCk / 16][4];
        auto load = [&](uint32_t(&a)[kCk / 16][4], int srow_u, int t) {
#pragma unroll
          for (int ks = 0; ks < kCk / 16; ++ks)
            ldsm_x4(a[ks], xa + swz((uint32_t)(srow_u + t) * 128 + 32 * ks + a_col, 128));
        };
        auto issue = [&](uint32_t(&a)[kCk / 16][4], float* acc_u, int t) {
#pragma unroll
          for (int ks = 0; ks < kCk / 16; ++ks)
#pragma unroll
            for (int at = 0; at < kNA; ++at)
              wgmma_m64k16<kNI>(acc_u + at * (kNI / 2), a[ks],
                                wgmma_desc(wa + at * atom_bytes + (t * kCk + 16 * ks) * kS, kS));
        };
#pragma unroll
        for (int u = 0; u < kTpw; ++u) {
          if (!has[u]) continue;
          int t = 0;
          for (; t + 1 < K; t += 2) {
            load(a0, srow[u], t);
            load(a1, srow[u], t + 1);
            wgmma_fence();
            issue(a0, acc[u], t);
            issue(a1, acc[u], t + 1);
            wgmma_commit();
            wgmma_wait<0>();
          }
          if (t < K) {  // the last of an odd tap count
            load(a0, srow[u], t);
            wgmma_fence();
            issue(a0, acc[u], t);
            wgmma_commit();
            wgmma_wait<0>();
          }
        }
#pragma unroll
        for (int u = 0; u < kTpw; ++u)
#pragma unroll
          for (int e = 0; e < kAcc; ++e) reg_fence(acc[u][e]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    named_sync(cthreads);  // the ring is drained; every consumer's bias, gamma, beta are staged
    if (slices > 1) {
      // the slices' partial tiles, over the drained ring; slice 0 adds them
      // in slice order and keeps the tile, the others drop out
      float* part = reinterpret_cast<float*>(smem);
      const int mrows = ceil_div(l.m, 16) * 16;
#pragma unroll
      for (int u = 0; u < kTpw; ++u) {
        if (!has[u] || slice == 0) continue;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(
                part + ((size_t)(slice - 1) * mrows + base[u] + (lane >> 2) + 8 * half) * kN +
                8 * j + 2 * (lane & 3)) =
                make_float2(acc[u][4 * j + 2 * half], acc[u][4 * j + 2 * half + 1]);
      }
      named_sync(cthreads);
#pragma unroll
      for (int u = 0; u < kTpw; ++u) {
        if (!has[u]) continue;
        if (slice != 0) {
          has[u] = false;
          continue;
        }
        for (int q = 1; q < slices; ++q)
#pragma unroll
          for (int j = 0; j < kN / 8; ++j)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float2 v = *reinterpret_cast<const float2*>(
                  part + ((size_t)(q - 1) * mrows + base[u] + (lane >> 2) + 8 * half) * kN +
                  8 * j + 2 * (lane & 3));
              acc[u][4 * j + 2 * half] += v.x;
              acc[u][4 * j + 2 * half + 1] += v.y;
            }
      }
    }
  }

  // Epilogue, every thread. The statistics: each row's sum of its owned
  // values in rowsum, then (reduce) each batch row's rows over a warp (lanes,
  // then shuffles) into this rank's slots, then the slots over the ranks in
  // rank order: fixed orders, so two launches give the same bits. Pass 0: the
  // sums and mean; pass 1: the sums of squared deviations, then rstd (B1) or
  // M2 (K1).
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const float n_inv = 1.f / (float)(H * cg), hc_inv = 1.f / (float)l.hc;
  float* rowsum = reinterpret_cast<float*>(smem + l.rowsum);
  auto reduce = [&](int pass, int lo, int hi) {  // rowsum holds rows [lo, hi)
    __syncthreads();
    for (int r = warp; r < p.rows; r += nwarps) {
      const int m0 = r * l.hc > lo ? r * l.hc : lo;
      const int m1 = (r + 1) * l.hc < hi ? (r + 1) * l.hc : hi;
      float v = 0.f;
      for (int m = m0 + lane; m < m1; m += 32) v += rowsum[m - lo];
      v = warp_sum(v);
      if (lane == 0) slots[pass][r] = v;
    }
    ranks_sync(C);  // every rank's slots are written
    if (tid < p.rows) {
      float total = 0.f;
      for (int q = 0; q < C; ++q) total += *rank_ptr(&slots[pass][tid], q, C);
      mstat[pass][tid] = pass ? (stats_out != nullptr ? total : 1.f / sqrtf(total * n_inv + eps))
                              : total * n_inv;
    }
    __syncthreads();
  };
  // the batch row of CTA row m (a float reciprocal, then corrected: exact)
  auto batch_row = [&](int m) {
    int r = (int)((float)m * hc_inv);
    r -= r * l.hc > m;
    r += (r + 1) * l.hc <= m;
    return r;
  };

  if (!csplit) {
    // Without a channel split every value is this CTA's own: straight from
    // the accumulators. Thread (warp, lane) holds rows base[u] + lane / 4 and
    // + 8, columns 8 j + 2 (lane % 4) and + 1; a row's four lanes meet by
    // shuffles.
    const int q4 = lane & 3;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int u = 0; u < kTpw; ++u) {
        if (!has[u]) continue;  // uniform over the warp
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = base[u] + (lane >> 2) + 8 * half;
          const int r = batch_row(m);
          const bool valid = m < l.m && b0 + r < B && h0 + m - r * l.hc < H;
          const float mean = pass && valid ? mstat[0][r] : 0.f;
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < kN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 8 * j + 2 * q4 + e;
              if (n < cg) {
                const float y = acc[u][4 * j + 2 * half + e] + affine[0][n] - mean;
                v += pass ? y * y : y;
              }
            }
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (q4 == 0 && m < l.m) rowsum[m] = valid ? v : 0.f;
        }
      }
      reduce(pass, 0, l.m);
    }
    if (C > 1) asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");  // slots read
#pragma unroll
    for (int u = 0; u < kTpw; ++u) {
      if (!has[u]) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = base[u] + (lane >> 2) + 8 * half;
        const int r = batch_row(m), h = h0 + m - r * l.hc;
        if (m >= l.m || b0 + r >= B || h >= H) continue;
        const size_t o = ((size_t)(b0 + r) * H + h) * Cout + gc;
        const float mean = mstat[0][r], rstd = mstat[1][r];
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const int n = 8 * j + 2 * q4;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            y[e] = acc[u][4 * j + 2 * half + e] + (n + e < cg ? affine[0][n + e] : 0.f);
            if (stats_out == nullptr)
              y[e] = mish((y[e] - mean) * rstd * affine[1][n + e < cg ? n + e : 0] +
                          affine[2][n + e < cg ? n + e : 0]);
          }
          if (n + 1 < cg && ((o + n) & 1) == 0) {  // two values, 4- or 8-byte aligned
            if (stats_out != nullptr)
              *reinterpret_cast<float2*>(pre_out + o + n) = make_float2(y[0], y[1]);
            else
              *reinterpret_cast<__nv_bfloat162*>(out + o + n) = __floats2bfloat162_rn(y[0], y[1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (n + e >= cg) continue;
              if (stats_out != nullptr)
                pre_out[o + n + e] = y[e];
              else
                out[o + n + e] = __float2bfloat16_rn(y[e]);
            }
          }
        }
      }
    }
  } else {
    // The channel split's epilogue, every thread. Rank q owns rows [q Q, (q +
    // 1) Q) of the CTA's m, Q = ceil(m / C). Each consumer pushes its partial
    // values of every row to the owner's receive buffer, slot [this rank]
    // (distributed shared-memory stores: no round trip), and the owner sums
    // the C slots in rank order. A row goes to kLpr neighbouring lanes (a
    // power of two, cg or more, at most a warp), each taking every kLpr-th
    // channel; the block takes nthreads / kLpr rows at a time.
    constexpr int kLpr = kN < 32 ? kN : 32;
    const int Q = ceil_div(l.m, C);
    const int lo = rank * Q, hi = l.m < lo + Q ? l.m : lo + Q;
    const int sub = tid & (kLpr - 1), per_step = nthreads / kLpr;
    const int steps = ceil_div(hi - lo, per_step);
    // this thread's row at step `it`: m, its batch row r, and whether (b0 +
    // r, m - r hc) exists
    auto row_at = [&](int it, int& m, int& r, bool& valid) {
      m = lo + it * per_step + tid / kLpr;
      r = batch_row(m);
      valid = m < hi && b0 + r < B && m - r * l.hc < H;
    };
    ranks_sync(C);  // every rank's ring is drained: the pushes may land
#pragma unroll
    for (int u = 0; u < kTpw; ++u) {
      if (!has[u]) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = base[u] + (lane >> 2) + 8 * half;
        if (m >= l.m) continue;
        const int q = m / Q;
        float* row = rank_ptr(recv, q, C) + ((size_t)rank * Q + m - q * Q) * l.ts;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
          *reinterpret_cast<float2*>(row + 8 * j + 2 * (lane & 3)) =
              make_float2(acc[u][4 * j + 2 * half], acc[u][4 * j + 2 * half + 1]);
      }
    }
    ranks_sync(C);  // every push has landed
    float* tile = recv;  // slot 0 holds the summed rows from pass 0 on
    // Two passes: the sums (pass 0 first sums the ranks' partial tiles in rank
    // order and adds the bias, in place), then the sums of squared deviations
    // from the mean. Each row over its lanes, each batch row's rows over a warp
    // (lanes, then shuffles), then over the ranks in rank order: fixed orders,
    // so two launches give the same bits.
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      for (int it = 0; it < steps; ++it) {  // the same trip count in every lane
        int m, r;
        bool valid;
        row_at(it, m, r, valid);
        const float mean = pass && valid ? mstat[0][r] : 0.f;
        float v = 0.f;
        if (pass == 0) {  // every slot of the row's channels loaded, then summed in rank order
          float part_q[kN / kLpr][kMaxCluster];
#pragma unroll
          for (int k = 0; k < kN / kLpr; ++k)
#pragma unroll
            for (int q = 0; q < kMaxCluster; ++q)
              part_q[k][q] = valid && sub + k * kLpr < cg && q < C
                                 ? recv[((size_t)q * Q + m - lo) * l.ts + sub + k * kLpr] : 0.f;
#pragma unroll
          for (int k = 0; k < kN / kLpr; ++k) {
            const int n = sub + k * kLpr;
            if (!valid || n >= cg) continue;
            float y = 0.f;
#pragma unroll
            for (int q = 0; q < kMaxCluster; ++q)
              if (q < C) y += part_q[k][q];
            y += affine[0][n];
            tile[(m - lo) * l.ts + n] = y;
            v += y;
          }
        } else {
          for (int n = sub; valid && n < cg; n += kLpr) {
            const float d = tile[(m - lo) * l.ts + n] - mean;
            v += d * d;
          }
        }
#pragma unroll
        for (int o = kLpr >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (m < hi && sub == 0) rowsum[m - lo] = valid ? v : 0.f;
      }
      reduce(pass, lo, hi);
    }
    if (C > 1) asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");  // slots read

    for (int it = 0; it < steps; ++it) {
      int m, r;
      bool valid;
      row_at(it, m, r, valid);
      if (!valid) continue;
      const size_t o = ((size_t)(b0 + r) * H + m - r * l.hc) * Cout + gc;
      const float mean = mstat[0][r], rstd = mstat[1][r];
      for (int n = sub; n < cg; n += kLpr) {
        const float v = tile[(m - lo) * l.ts + n];
        if (stats_out != nullptr)
          pre_out[o + n] = v;
        else
          out[o + n] = __float2bfloat16_rn(mish((v - mean) * rstd * affine[1][n] + affine[2][n]));
      }
    }
  }
  if (stats_out != nullptr && rank == 0 && tid < p.rows && b0 + tid < B) {
    stats_out[((size_t)(b0 + tid) * groups + g) * 2] = mstat[0][tid];
    stats_out[((size_t)(b0 + tid) * groups + g) * 2 + 1] = mstat[1][tid];
  }
  if (C > 1) asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// -- host ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the CUDA runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A 3-D bf16 tensor map: dims innermost first, strides of dims 1 and 2 in bytes.
bool make_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
              uint64_t s1, uint64_t s2, uint32_t b0, uint32_t b1, uint32_t b2, int swizzle_bytes) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                      : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kN, bool kMma>
cudaError_t configure(const Plan& p, size_t smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, int grid, cudaStream_t stream) {
  // Dynamic shared memory allowed so far, per device (the attribute applies
  // to the current device only); 48 KB holds static and dynamic bytes together.
  constexpr int kMaxDevices = 64;
  static size_t configured[kMaxDevices] = {};
  if (smem + kStaticSmem > kDefaultSmem) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (!(dev < kMaxDevices && smem <= configured[dev])) {
      e = cudaFuncSetAttribute(conv_gn_mish_bf16_kernel<kN, kMma>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      if (dev < kMaxDevices) configured[dev] = smem;
    }
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(32 * (4 * p.wgs + 1));
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

struct Args {
  const bf16* x;
  const bf16* w;
  const float *bias, *gamma, *beta;
  bf16* out;
  float *pre, *stats;
  int B, H, Hx, off, Cin, Cout, K, groups;
  float eps;
};

template <int kN, bool kMma>
int launch_as(const Args& a, const Plan& p, cudaStream_t stream) {
  const int cg = a.Cout / a.groups;
  const Layout l = layout(p, a.H, cg, a.K);
  const bool tma_x = p.tma && a.Cin % 8 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const bool tma_w = p.tma && a.Cout % 8 == 0 && cg % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  constexpr int kNI = kN < 64 ? kN : 64;
  CUtensorMap xmap{}, wmap{};
  if (tma_x && !make_map(&xmap, a.x, a.Cin, a.Hx, a.B, 2ull * a.Cin, 2ull * a.Cin * a.Hx, kCk,
                         l.br, 1, 128))
    return (int)cudaErrorInvalidValue;
  if (tma_w && !make_map(&wmap, a.w, a.Cout, a.Cin, a.K, 2ull * a.Cout, 2ull * a.Cout * a.Cin, kNI,
                         kCk, a.K, 2 * kNI))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int grid = ceil_div(a.B, p.rows) * a.groups * p.cluster;
  cudaError_t e = configure<kN, kMma>(p, l.bytes, &cfg, attr, grid, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, conv_gn_mish_bf16_kernel<kN, kMma>, xmap, wmap, a.x, a.w, a.bias,
                         a.gamma, a.beta, a.out, a.pre, a.stats, a.B, a.H, a.Hx, a.off, a.Cin,
                         a.Cout, a.K, a.groups, a.eps, p, l, (int)tma_x, (int)tma_w);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many of the plan's clusters (C 1: CTAs) the card holds at once.
template <int kN, bool kMma>
int max_clusters_as(int H, int cg, int K, const Plan& p, int* n) {
  const Layout l = layout(p, H, cg, K);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<kN, kMma>(p, l.bytes, &cfg, attr, 1024 * p.cluster, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (p.cluster > 1)
    return (int)cudaOccupancyMaxActiveClusters(
        n, reinterpret_cast<const void*>(conv_gn_mish_bf16_kernel<kN, kMma>), &cfg);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv_gn_mish_bf16_kernel<kN, kMma>, cfg.blockDim.x, l.bytes)) != cudaSuccess)
    return (int)e;
  *n = per_sm * sms;
  return (int)cudaSuccess;
}

Plan read_plan(const int* v) { return Plan{v[0], v[1], v[2], v[3], v[4], v[5], v[6]}; }

// `CALL(kN, kMma)` for the plan's instance: N = pad_n(cg), mma.sync or wgmma.
#define BF16_DISPATCH(n, mma, CALL)                      \
  switch (n) {                                           \
    case 8: return mma ? CALL(8, true) : CALL(8, false);       \
    case 16: return mma ? CALL(16, true) : CALL(16, false);    \
    case 32: return mma ? CALL(32, true) : CALL(32, false);    \
    case 64: return mma ? CALL(64, true) : CALL(64, false);    \
    case 128: return mma ? CALL(128, true) : CALL(128, false); \
    case 256: return mma ? CALL(256, true) : CALL(256, false); \
    default: return (int)cudaErrorInvalidValue;          \
  }

int launch(const Args& a, const int* plan, void* stream) {
  if (a.B <= 0 || a.groups <= 0 || a.Cout % a.groups != 0) return (int)cudaErrorInvalidValue;
  const Plan p = read_plan(plan);
  const int cg = a.Cout / a.groups;
  if (!plan_ok(p, a.H, a.Cin, cg, a.K)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BF16_LAUNCH(NN, MM) launch_as<NN, MM>(a, p, s)
  BF16_DISPATCH(pad_n(cg), p.mma, BF16_LAUNCH)
#undef BF16_LAUNCH
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t value (cudaErrorInvalidValue for
// a shape or plan the kernel does not take). `plan` points to the 7 ints of
// struct Plan.
int conv_gn_mish_bf16(const void* x, const void* w, const float* bias, const float* gamma,
                      const float* beta, void* out, int B, int H, int Cin, int Cout, int k,
                      int groups, float eps, const int* plan, void* stream) {
  const Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, gamma, beta,
               static_cast<bf16*>(out), nullptr, nullptr, B, H, H, k / 2, Cin, Cout, k, groups,
               eps};
  return launch(a, plan, stream);
}

// K1 at bf16: x (B, H + k - 1, Cin) bf16 with its halo, w bf16, bias float32;
// pre (B, H, Cout) float32 (conv + bias, before the norm); stats (B, groups,
// 2) float32, each (batch row, group)'s (mean, M2). Returns as above.
int conv_gn_stats_bf16(const void* x, const void* w, const float* bias, float* pre,
                       float* stats, int B, int H, int Cin, int Cout, int k, int groups,
                       const int* plan, void* stream) {
  if (pre == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, nullptr, nullptr,
               nullptr, pre, stats, B, H, H + k - 1, 0, Cin, Cout, k, groups, 0.f};
  return launch(a, plan, stream);
}

// The dynamic shared memory one plan lays out (bytes), or -1 for a plan the
// kernel does not take.
long long conv_gn_mish_bf16_smem_bytes(int H, int Cin, int Cout, int k, int groups,
                                       const int* plan) {
  if (groups <= 0 || Cout % groups != 0) return -1;
  const Plan p = read_plan(plan);
  if (!plan_ok(p, H, Cin, Cout / groups, k)) return -1;
  return (long long)layout(p, H, Cout / groups, k).bytes;
}

// The plan's shared memory (bytes) and how many of its clusters the card
// holds at once (C 1: CTAs), into *smem and *clusters; the kernel's
// shared-memory opt-in is made here. Returns as above.
int conv_gn_mish_bf16_plan_check(int H, int Cin, int Cout, int k, int groups, const int* plan,
                                 int* smem, int* clusters) {
  if (groups <= 0 || Cout % groups != 0) return (int)cudaErrorInvalidValue;
  const Plan p = read_plan(plan);
  const int cg = Cout / groups;
  if (!plan_ok(p, H, Cin, cg, k)) return (int)cudaErrorInvalidValue;
  *smem = (int)layout(p, H, cg, k).bytes;
#define BF16_CLUSTERS(NN, MM) max_clusters_as<NN, MM>(H, cg, k, p, clusters)
  BF16_DISPATCH(pad_n(cg), p.mma, BF16_CLUSTERS)
#undef BF16_CLUSTERS
}

const char* conv_gn_mish_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
