// Weight gradient of a "same"-padded 1-D convolution at bf16, channel-last:
//   dW[t, ci, co] = sum_{b, h} x[b, h + t - pad_l, ci] * dy[b, h, co]
// with bf16 x (B, H, Cin) and dy (B, H, Cout), float32 sums and a float32 dW
// (k, Cin, Cout), pad_l = (k - 1) / 2, rows of x outside [0, H) read as zeros.
//
// Replaces deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_weight_grad.py:
// conv1d_weight_grad as a model built with bf16=True calls it: its conv
// block's backward hands B2 bf16 x and a bf16 cotangent, and the Pallas
// kernel sums their products in float32 (preferred_element_type=float32).
// csrc/conv1d_weight_grad.cu is the float32 form. The Pallas kernel's one
// real idea is kept: a block computes all k taps of its (Cin, Cout) tile, so
// every dy row it stages serves k taps.
//
// What bounds it. 2 k Cin Cout B H operations on the tensor cores (989
// TFLOP/s dense bf16 on an H100 SXM) against 2 B H (Cin + Cout) bytes read
// and 4 k Cin Cout written: the operations at the deep shapes, the float32
// dW's bytes at a few; the shallow shapes (H 40-160, 128-256 channels: under
// a microsecond of either) are latency: a launch, a first TMA round trip,
// an epilogue.
//
// Design. Per call one launch, no workspace; the plan is Python's
// (ops/conv_weight_grad.py: wgrad_bf16_plan, fitted to
// ops/conv_weight_grad_sweep.py --bf16 on an H100) and arrives as the ints
// of Plan.
//   - Products: wgmma.mma_async m64nNk16, bf16 in, float32 accumulators
//     (csrc/wgmma_bf16.h). M is the tile's 64 input channels, N a warpgroup's
//     output channels (nw: 16, 32 or 64), K 16 rows of the reduction over
//     the B H rows of x and dy flattened.
//   - B = dy from shared memory, N contiguous ("MN-major"), swizzled by its
//     row width (nw 64: 128 bytes), one atom of nw columns a warpgroup. One
//     staged dy chunk serves every tap.
//   - A = the tap's x rows transposed, from registers. Tap t is a shift of t
//     rows along the reduction, and a wgmma descriptor cannot start at an
//     arbitrary row inside a swizzle atom, so each lane names its own row to
//     ldmatrix.trans (x staged as 128-byte rows of the tile's 64 channels,
//     swizzled) and the zero padding between batch rows is applied to the
//     loaded fragment from each row's place h in its batch row. Every tap's
//     fragments of a few k-steps (kGroup, as registers allow) are loaded
//     first, then issued as one wgmma group and waited for: a register
//     written while a group is in flight, or a group issued on a divergent
//     path, makes ptxas serialise every wgmma.
//   - Warpgroups. A 64 x nw float32 accumulator costs nw / 2 registers a
//     thread for each tap, so the CTA's warpgroups (wgs, 1-3) split its
//     work on the same staged chunk: by output channels (split 0:
//     each warpgroup all k taps of its nw columns, a tile of wgs nw
//     columns), or by taps (split 1: each kt = ceil(k / wgs) taps of the
//     tile's nw columns; taps past k read zeros and are dropped). Each
//     (kt, nw, wgs) is its own instance (WGRAD_BF16_INSTANCES), with no
//     more accumulators than its launch bounds leave registers for.
//   - Loads. A ring of `stages` chunks in flight by TMA, filled up front by
//     thread 0 and refilled by the last warp to finish with a stage (a
//     count in shared memory). No producer warp: a ninth warp would put a
//     third warp on one SM sub-partition and cut every thread's registers
//     to 168. dy comes as one box of (nw columns x rows) an atom, x as one
//     box of (64 channels x rows + k - 1 rows) from row r0 - pad_l;
//     rows outside [0, B H) and channels past Cin or Cout are out of bounds
//     and TMA zero-fills them. Each operand is staged by its own width: TMA
//     needs 16-byte row strides, so where Cin (x; or Cout, dy) is no multiple
//     of 8 (the first block's 35 channels) or its base is not 16-byte
//     aligned, the CTA's threads stage that operand themselves with plain
//     loads into the same swizzled layout once the stage's "full" barrier
//     has passed, and meet at a barrier; the other keeps TMA.
//   - Float32 chains. The tensor cores add in round-toward-zero, which over
//     thousands of rows drifts past 1e-5 of max |dW|. A warpgroup's
//     accumulators therefore sum at most kMaxChainSteps k-steps (1,024 rows):
//     either the rank's rows are no more (chain 0), or every `chain` k-steps
//     they join a float32 partial tile in shared memory, rounded to nearest,
//     and start again from zero.
//   - Split reduction without a workspace. The plan's `cluster` CTAs of one
//     tile form a thread block cluster (non-portable above 8, up to 16) and
//     split its chunks into contiguous ranges. Each CTA leaves its partial
//     tile in its shared memory (over the drained ring, or the chain's
//     tile); after a cluster barrier, rank q adds its 1/C of the tile's
//     elements over all ranks in rank order through distributed shared
//     memory and writes them. No atomics: two launches give the same bits.
//     With one CTA a tile and no chain join the accumulators go straight to
//     dW.
//   - A lost mbarrier arrival traps after 2^24 polls instead of hanging.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/conv_weight_grad.py: conv1d_weight_grad_bf16_cuda)
// checks shapes, dtypes and contiguity, chooses the plan once per shape and
// checks it against this file's layout (conv1d_weight_grad_bf16_plan_check).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.h"
#include "wgmma_bf16.h"

namespace coop = cooperative_groups;

namespace {

constexpr int kM = 64;              // input channels a tile: the wgmma's M, one 128-byte x row
constexpr int kStep = 16;           // rows a k-step: the wgmma's K
constexpr int kMaxRows = 128;       // dy rows a chunk (x boxes of rows + k - 1 <= 256 rows)
constexpr int kMaxStages = 4;
constexpr int kMaxWgs = 3;          // warpgroups a CTA
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;     // with the non-portable cluster size
constexpr int kMaxChainSteps = 64;  // k-steps a tensor-core chain sums, at most
constexpr int kMaxK = 9;
constexpr int kPad = 8;             // floats past a partial-tile row: rows 8 banks apart
constexpr size_t kAlign = 1024;     // the ring's swizzle period: the dynamic base is rounded up
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic + static shared memory of one CTA
// The static shared memory: each stage's "full" mbarrier and count of warps done with it
constexpr size_t kStaticSmem = kMaxStages * (sizeof(uint64_t) + sizeof(int));
constexpr size_t kDefaultSmem = 48 * 1024;

// The kernel's instances (kt taps a warpgroup, nw columns a warpgroup, wgs
// warpgroups): each holds kt nw / 2 accumulators a thread, at most 160 with
// one or two warpgroups (255 registers a thread: each SM sub-partition's
// 16,384 hold two warps of 255) and 96 with three (168).
// ops/conv_weight_grad.py mirrors the list (BF16_INSTANCES).
#define WGRAD_BF16_INSTANCES(X)                                             \
  X(1, 32, 1) X(1, 64, 2) X(2, 32, 3) X(2, 64, 2) X(2, 64, 3) X(3, 32, 1)   \
  X(3, 32, 2) X(3, 64, 2) X(3, 64, 3) X(4, 64, 2) X(5, 16, 1) X(5, 16, 2)   \
  X(5, 32, 1) X(5, 32, 2) X(5, 64, 1) X(5, 64, 2) X(7, 32, 1) X(9, 32, 1)

// The launch plan (ops/conv_weight_grad.py: WgradBf16Plan, in this order).
struct Plan {
  int nw;       // output channels a warpgroup (its wgmma N): 16, 32 or 64
  int wgs;      // warpgroups, 1..kMaxWgs
  int split;    // 0: the warpgroups split the output channels; 1: the taps
  int rows;     // dy rows a chunk: a multiple of kStep, at most kMaxRows
  int stages;   // ring depth
  int cluster;  // CTAs a tile; rank q takes chunks [q n / C, (q + 1) n / C)
  int chain;    // k-steps between joins into the float32 tile; 0: none (a rank's rows are fewer)
  int tma_x;    // 1: x by TMA where Cin and its base allow; 0: the threads stage x
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Taps a warpgroup computes.
__host__ __device__ inline int taps_per(const Plan& p, int K) {
  return p.split ? ceil_div(K, p.wgs) : K;
}

// Shared-memory layout of one plan at kernel size K (ops/conv_weight_grad.py:
// bf16_smem_bytes mirrors it). Offsets in bytes from the 1024-aligned base.
struct Layout {
  int tco;           // output channels a tile: nw, or wgs nw with the channel split
  int slots;         // tap slots of the partial tile: K, or kt wgs with the tap split
  int x_rows;        // staged x rows a stage: rows + slots - 1, rounded up to 8
  int ps;            // floats of a partial-tile row: tco + kPad
  int atom;          // bytes of one dy atom: rows x 2 nw
  int x_bytes;       // x_rows x 128
  int stage;         // x_bytes + the dy atoms, rounded up to kAlign
  int part;          // offset of the float32 partial tile: 0 over the ring, or past it (chain)
  size_t bytes;      // dynamic shared memory, alignment slack included
};

__host__ __device__ inline Layout layout(const Plan& p, int K) {
  Layout l;
  const int kt = taps_per(p, K);
  l.tco = p.split ? p.nw : p.nw * p.wgs;
  l.slots = p.split ? kt * p.wgs : K;
  l.x_rows = ceil_div(p.rows + l.slots - 1, 8) * 8;
  l.ps = l.tco + kPad;
  l.atom = p.rows * 2 * p.nw;
  l.x_bytes = l.x_rows * 2 * kM;
  l.stage = ceil_div(l.x_bytes + p.rows * 2 * l.tco, (int)kAlign) * (int)kAlign;
  const size_t ring = (size_t)p.stages * l.stage;
  const size_t part = p.cluster > 1 || p.chain > 0
                          ? sizeof(float) * (size_t)l.slots * kM * l.ps : 0;
  l.part = p.chain > 0 ? (int)ring : 0;
  l.bytes = kAlign + (p.chain > 0 ? ring + part : (ring > part ? ring : part));
  return l;
}

__host__ __device__ constexpr bool has_instance(int kt, int nw, int wgs) {
#define WGRAD_BF16_HAS(KT, NW, WGS) (kt == KT && nw == NW && wgs == WGS) ||
  return WGRAD_BF16_INSTANCES(WGRAD_BF16_HAS) false;
#undef WGRAD_BF16_HAS
}

// The plan's own consistency at kernel size K; false for a plan the kernel
// does not take.
bool plan_ok(const Plan& p, int K) {
  if (K < 1 || K > kMaxK || K % 2 == 0) return false;
  if (p.nw != 16 && p.nw != 32 && p.nw != 64) return false;
  if (p.wgs < 1 || p.wgs > kMaxWgs || (p.split != 0 && p.split != 1)) return false;
  if (p.split && p.wgs < 2) return false;
  if (p.rows < kStep || p.rows > kMaxRows || p.rows % kStep) return false;
  if (p.stages < 1 || p.stages > kMaxStages || p.cluster < 1 || p.cluster > kMaxCluster)
    return false;
  if (p.chain < 0 || p.chain > kMaxChainSteps || (p.tma_x != 0 && p.tma_x != 1)) return false;
  if (!has_instance(taps_per(p, K), p.nw, p.wgs)) return false;
  return layout(p, K).bytes + kStaticSmem <= kMaxSmem;
}

// k-steps of the longest tensor-core chain a launch at R rows sums.
int longest_chain(const Plan& p, int R) {
  const int steps = ceil_div(ceil_div(R, p.rows), p.cluster) * (p.rows / kStep);
  return p.chain > 0 && p.chain < steps ? p.chain : steps;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// h in [0, 2 H) wrapped into [0, H)
__device__ __forceinline__ int wrap(int h, int H) { return h >= H ? h - H : h; }

// 0xffff in the half of a bf16 pair whose row is valid: row 2 t4 in the low
// half, 2 t4 + 1 in the high one, as ldmatrix packs a fragment
__device__ __forceinline__ uint32_t pair_mask(bool lo, bool hi) {
  return (lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u);
}

// 8 consecutive bf16 of a row (zeros past `valid` of them), as 16 bytes: one
// load where `vec`, else one per value.
__device__ __forceinline__ uint4 load8(const uint16_t* src, int valid, bool vec) {
  if (valid >= 8 && vec) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = e < valid ? (uint32_t)src[e] : 0u;
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
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

// Grid: tiles x cluster CTAs, 1-D, clusters of p.cluster along x; a tile is
// 64 input channels x l.tco output channels, all k taps. Block: WGS
// warpgroups. x and dy are the bits of bf16 values.
template <int KT, int NW, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1)
wgrad_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap dmap, const uint16_t* __restrict__ x,
                  const uint16_t* __restrict__ dy, float* __restrict__ out, int R, int H,
                  int Cin, int Cout, int K, const Plan p, const Layout l, int tma_x,
                  int tma_d) {
  constexpr int kS = 2 * NW;   // bytes of a dy atom row
  constexpr int kAcc = NW / 2;  // accumulators a thread, a tap
  constexpr int kWarps = 4 * WGS, kThreads = 32 * kWarps;
  // k-steps a wgmma group: kGroup KT fragments of 4 registers beside the KT
  // NW / 2 accumulators, within the instance's registers
  constexpr int kGroup = KT >= 7 ? 1 : KT >= 5 ? 2 : KT >= 3 ? (WGS == 3 ? 2 : 3) : 4;

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kMaxStages];
  __shared__ int released[kMaxStages];  // warps done with the stage's chunk
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + kAlign - 1) & ~(uint32_t)(kAlign - 1)) - raw);
  float* part = reinterpret_cast<float*>(smem + l.part);

  const int C = p.cluster;
  const int rank = blockIdx.x % C, tile = blockIdx.x / C;
  const int tiles_co = ceil_div(Cout, l.tco);
  const int co0 = (tile % tiles_co) * l.tco, ci0 = (tile / tiles_co) * kM;
  const int n_chunks = ceil_div(R, p.rows);
  const int c_lo = (int)((long long)n_chunks * rank / C);
  const int nch = (int)((long long)n_chunks * (rank + 1) / C) - c_lo;
  const int pad = (K - 1) / 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Chunk c_lo + i into stage i % stages: one arrival with the TMA bytes;
  // with no TMA operand the arrival alone hands the stage to the threads.
  const uint32_t bytes = (tma_x ? (uint32_t)(p.rows + K - 1) * 2 * kM : 0u) +
                         (tma_d ? (uint32_t)p.rows * 2 * l.tco : 0u);
  auto produce = [&](int i) {
    const int s = i % p.stages;
    uint8_t* xs = smem + (size_t)s * l.stage;
    uint8_t* ds = xs + l.x_bytes;
    const int r0 = (c_lo + i) * p.rows;
    mbar_arrive_expect_tx(&full[s], bytes);
    if (tma_x) tma_load_3d(xs, &xmap, &full[s], ci0, r0 - pad, 0);
    if (tma_d)
      for (int a = 0; a < l.tco / NW; ++a)
        tma_load_3d(ds + a * l.atom, &dmap, &full[s], co0 + a * NW, r0, 0);
  };
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    mbar_init_fence();
    for (int i = 0; i < p.stages && i < nch; ++i) produce(i);  // the ring, filled up front
  }
  __syncthreads();

  // The thread's place: warpgroup wg (its taps from tap0, its columns of dy
  // atom `atom`), warp wq of it (input channels 16 wq.. of the tile).
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int tap0 = p.split ? wg * KT : 0;
  const int atom = p.split ? 0 : wg;
  float acc[KT][kAcc];
#pragma unroll
  for (int u = 0; u < KT; ++u)
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[u][e] = 0.f;
  bool joined = false;  // the partial tile holds this thread's earlier chains
  // Adds the accumulators into this thread's elements of the partial tile
  // (float32, rounded to nearest) and zeroes them for the next chain.
  auto join = [&]() {
#pragma unroll
    for (int u = 0; u < KT; ++u)
#pragma unroll
      for (int e = 0; e < kAcc; ++e) reg_fence(acc[u][e]);
#pragma unroll
    for (int u = 0; u < KT; ++u)
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2* at = reinterpret_cast<float2*>(
              part + ((tap0 + u) * kM + 16 * wq + g + 8 * half) * l.ps + atom * NW + 8 * j +
              2 * t4);
          const float2 v = joined ? *at : make_float2(0.f, 0.f);
          *at = make_float2(v.x + acc[u][4 * j + 2 * half], v.y + acc[u][4 * j + 2 * half + 1]);
          acc[u][4 * j + 2 * half] = 0.f;
          acc[u][4 * j + 2 * half + 1] = 0.f;
        }
    joined = true;
  };

  const bool x_vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool d_vec = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  // The lane's ldmatrix row in a k-step and its 16-byte piece of the
  // 128-byte x row: matrix j = lane / 8 covers rows 8 (j / 2).. and input
  // channels 16 wq + 8 (j % 2).., so .trans yields the A fragment (input
  // channels g, g + 8; rows 2 t4 (+1), 2 t4 + 8 (+1)).
  const uint32_t a_off = (uint32_t)((lane & 7) + 8 * (lane >> 4)) * 128 +
                         16 * (2 * wq + ((lane >> 3) & 1));
  const int d1 = 1 % H, d8 = 8 % H, d9 = 9 % H, d16 = kStep % H;
  int steps = 0;  // k-steps of the running chain
  for (int i = 0; i < nch; ++i) {
    const int s = i % p.stages;
    mbar_wait(&full[s], (i / p.stages) & 1);
    uint8_t* xs = smem + (size_t)s * l.stage;
    uint8_t* ds = xs + l.x_bytes;
    const int r0 = (c_lo + i) * p.rows;
    if (!tma_x) {  // (staged row, 8-channel piece) a thread at a time
      const int items = (p.rows + K - 1) * 8;
      for (int it = tid; it < items; it += kThreads) {
        const int q = it & 7, j = it >> 3;
        const int r = r0 - pad + j, c = ci0 + 8 * q;
        const uint4 v = r >= 0 && r < R && c < Cin
                            ? load8(x + (size_t)r * Cin + c, Cin - c, x_vec)
                            : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(xs + swz((uint32_t)j * 128 + 16 * q, 128)) = v;
      }
    }
    if (!tma_d) {  // (row, 8 output channels) a thread at a time, into the atoms
      const int per = l.tco / 8, items = p.rows * per;
      for (int it = tid; it < items; it += kThreads) {
        const int pc = it % per, j = it / per;
        const int r = r0 + j, c = co0 + 8 * pc;
        const uint4 v = r < R && c < Cout ? load8(dy + (size_t)r * Cout + c, Cout - c, d_vec)
                                          : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(ds + (8 * pc / NW) * l.atom +
                                  swz((uint32_t)j * kS + 2 * (8 * pc % NW), kS)) = v;
      }
      fence_proxy_async();  // wgmma reads dy through the async proxy
    }
    if (!tma_x || !tma_d) __syncthreads();
    const uint32_t xa = smem_u32(xs), da = smem_u32(ds) + atom * l.atom;
    int h0 = (r0 + 2 * t4) % H;  // the place of the lane's row 2 t4 in its batch row
    // kG k-steps a group (kGroup, or one at a time for the last few): every
    // tap's fragments of them loaded, then their KT kG products issued as one
    // wgmma group and waited for.
    auto group = [&](int ks, auto G) {
      constexpr int kG = decltype(G)::value;
      if (p.chain > 0 && steps + kG > p.chain) {  // a chain never outruns p.chain k-steps
        join();
        steps = 0;
      }
      uint32_t a[kG][KT][4];
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        const int h1 = wrap(h0 + d1, H), h8 = wrap(h0 + d8, H), h9 = wrap(h0 + d9, H);
#pragma unroll
        for (int u = 0; u < KT; ++u) {
          const int t = tap0 + u, o = t - pad;
          const bool on = t < K;  // the tap split's last warpgroup may pass k
          ldsm_x4_trans(a[q][u],
                        xa + swz((uint32_t)((ks + q) * kStep + t) * 128 + a_off, 128));
          const uint32_t m0 = pair_mask(on && (unsigned)(h0 + o) < (unsigned)H,
                                        on && (unsigned)(h1 + o) < (unsigned)H);
          const uint32_t m8 = pair_mask(on && (unsigned)(h8 + o) < (unsigned)H,
                                        on && (unsigned)(h9 + o) < (unsigned)H);
          a[q][u][0] &= m0;
          a[q][u][1] &= m0;
          a[q][u][2] &= m8;
          a[q][u][3] &= m8;
        }
        h0 = wrap(h0 + d16, H);
      }
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        const uint64_t desc = wgmma_desc(da + (uint32_t)((ks + q) * kStep * kS), kS);
#pragma unroll
        for (int u = 0; u < KT; ++u) wgmma_m64k16<NW>(acc[u], a[q][u], desc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      steps += kG;
    };
    const int nks = p.rows / kStep;
    int ks = 0;
    if (p.chain == 0 || p.chain >= kGroup)
      for (; ks + kGroup <= nks; ks += kGroup) group(ks, std::integral_constant<int, kGroup>{});
    for (; ks < nks; ++ks) group(ks, std::integral_constant<int, 1>{});
    __syncwarp();
    // The last warp done with the stage refills it: every other warp's
    // reads of it (ldmatrix, and wgmma's, waited for) have returned.
    if (lane == 0 && i + p.stages < nch && atomicAdd(&released[s], 1) == kWarps - 1) {
      released[s] = 0;  // published by produce's arrival, which the next users wait on
      produce(i + p.stages);
    }
    __syncwarp();
  }

  // Epilogue. One CTA a tile and no chain join: the accumulators straight to
  // dW. Thread (wq, g, t4) holds input channels 16 wq + g (+ 8) and output
  // channels 8 j + 2 t4 (+ 1) of its warpgroup's columns.
  if (C == 1 && p.chain == 0) {
#pragma unroll
    for (int u = 0; u < KT; ++u)
#pragma unroll
      for (int e = 0; e < kAcc; ++e) reg_fence(acc[u][e]);
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      const int t = tap0 + u;
      if (t >= K) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = ci0 + 16 * wq + g + 8 * half;
        if (ci >= Cin) continue;
#pragma unroll
        for (int j = 0; j < NW / 8; ++j)
          store_pair(out, (size_t)t * Cin + ci, co0 + atom * NW + 8 * j + 2 * t4, Cout,
                     acc[u][4 * j + 2 * half], acc[u][4 * j + 2 * half + 1]);
      }
    }
    return;
  }
  // Otherwise the partial tile: over the ring once every warp has drained it
  // (chain 0), or the chain's own, which holds the earlier chains' sums.
  if (p.chain == 0) __syncthreads();  // every warp is done with the ring
  join();
  if (C > 1)
    cluster_sync();  // every rank's partial tile is in place
  else
    __syncthreads();

  // This rank's 1/C of the tile's float4s (taps below K), summed over the
  // ranks in rank order.
  coop::cluster_group cluster = coop::this_cluster();
  const int q4 = l.tco / 4;
  const int items = K * kM * q4;
  const int lo = (int)((long long)items * rank / C), hi = (int)((long long)items * (rank + 1) / C);
  const float4* part4 = reinterpret_cast<const float4*>(part);
  for (int e = lo + tid; e < hi; e += blockDim.x) {
    const int row = e / q4, c = 4 * (e % q4);  // row = t kM + m
    const int idx = (row * l.ps + c) / 4;
    float4 sum = part4[idx];
    if (C > 1) {
      float4 v[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < C) v[r] = *cluster.map_shared_rank(part4 + idx, r);
      sum = v[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < C) sum = add4(sum, v[r]);
    }
    const int t = row / kM, ci = ci0 + row % kM, co = co0 + c;
    if (ci >= Cin || co >= Cout) continue;
    const size_t o = ((size_t)t * Cin + ci) * Cout + co;
    if ((Cout & 3) == 0) {
      *reinterpret_cast<float4*>(out + o) = sum;
    } else {
      const float w[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int j = 0; j < 4 && co + j < Cout; ++j) out[o + j] = w[j];
    }
  }
  if (C > 1) cluster_sync();  // no rank leaves while another may still read its shared memory
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
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A bf16 (rows, cols) row-major tensor as a 3-D map (cols, rows, 1), boxes of
// (box_cols, box_rows, 1) swizzled by the box's row of 2 box_cols bytes.
bool make_map(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
              uint32_t box_cols, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {cols, rows, 1};
  const cuuint64_t strides[2] = {2 * cols, 2 * cols * rows};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const int sw_bytes = 2 * box_cols;
  const CUtensorMapSwizzle sw = sw_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : sw_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : sw_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KT, int NW, int WGS>
cudaError_t configure(const Plan& p, size_t smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, int grid, cudaStream_t stream) {
  // Attributes set so far, per device (they apply to the current device
  // only); 48 KB holds static and dynamic bytes together.
  constexpr int kMaxDevices = 64;
  static size_t configured[kMaxDevices] = {};
  static bool wide[kMaxDevices] = {};
  const auto kernel = wgrad_bf16_kernel<KT, NW, WGS>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev < kMaxDevices;
  if (smem + kStaticSmem > kDefaultSmem && !(known && smem <= configured[dev])) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (known) configured[dev] = smem;
  }
  if (p.cluster > kPortableCluster && !(known && wide[dev])) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    if (known) wide[dev] = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(128 * WGS);
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
  const uint16_t* x;
  const uint16_t* dy;
  float* out;
  int R, H, Cin, Cout, K;
};

template <int KT, int NW, int WGS>
int launch_as(const Args& a, const Plan& p, cudaStream_t stream) {
  const Layout l = layout(p, a.K);
  const bool tma_x = p.tma_x && a.Cin % 8 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const bool tma_d = a.Cout % 8 == 0 && reinterpret_cast<uintptr_t>(a.dy) % 16 == 0;
  CUtensorMap xmap{}, dmap{};
  if (tma_x && !make_map(&xmap, a.x, a.Cin, a.R, kM, p.rows + a.K - 1))
    return (int)cudaErrorInvalidValue;
  if (tma_d && !make_map(&dmap, a.dy, a.Cout, a.R, NW, p.rows)) return (int)cudaErrorInvalidValue;
  const int grid = ceil_div(a.Cin, kM) * ceil_div(a.Cout, l.tco) * p.cluster;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<KT, NW, WGS>(p, l.bytes, &cfg, attr, grid, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, wgrad_bf16_kernel<KT, NW, WGS>, xmap, dmap, a.x, a.dy, a.out, a.R,
                         a.H, a.Cin, a.Cout, a.K, p, l, (int)tma_x, (int)tma_d);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many of the plan's clusters (cluster 1: CTAs) the card holds at once.
template <int KT, int NW, int WGS>
int max_clusters_as(const Plan& p, int K, int* n) {
  const Layout l = layout(p, K);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<KT, NW, WGS>(p, l.bytes, &cfg, attr, 1024 * p.cluster, nullptr);
  if (e != cudaSuccess) return (int)e;
  const auto kernel = wgrad_bf16_kernel<KT, NW, WGS>;
  if (p.cluster > 1)
    return (int)cudaOccupancyMaxActiveClusters(n, reinterpret_cast<const void*>(kernel), &cfg);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, cfg.blockDim.x,
                                                         l.bytes)) != cudaSuccess)
    return (int)e;
  *n = per_sm * sms;
  return (int)cudaSuccess;
}

Plan read_plan(const int* v) { return Plan{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]}; }

}  // namespace

extern "C" {

// x (B, H, Cin) and dy (B, H, Cout) bf16, out (k, Cin, Cout) float32; `plan`
// points to the 8 ints of struct Plan. Returns 0 on success, else a
// cudaError_t value (cudaErrorInvalidValue for a kernel size, shape or plan
// the kernel does not take, a chain longer than kMaxChainSteps among them).
int conv1d_weight_grad_bf16(const void* x, const void* dy, float* out, int B, int H, int Cin,
                            int Cout, int k, const int* plan, void* stream) {
  const Plan p = read_plan(plan);
  if (B <= 0 || H <= 0 || Cin <= 0 || Cout <= 0 || (long long)B * H > 0x3fffffff ||
      !plan_ok(p, k))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(dy), out, B * H, H,
               Cin, Cout, k};
  if (longest_chain(p, a.R) > kMaxChainSteps) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kt = taps_per(p, k);
#define WGRAD_BF16_LAUNCH(KT, NW, WGS) \
  if (kt == KT && p.nw == NW && p.wgs == WGS) return launch_as<KT, NW, WGS>(a, p, s);
  WGRAD_BF16_INSTANCES(WGRAD_BF16_LAUNCH)
#undef WGRAD_BF16_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) the kernel lays out for a plan at kernel
// size k, or -1 for a plan it does not take.
int conv1d_weight_grad_bf16_smem_bytes(int k, const int* plan) {
  const Plan p = read_plan(plan);
  return plan_ok(p, k) ? (int)layout(p, k).bytes : -1;
}

// The plan's shared memory (bytes) and how many of its clusters the card
// holds at once (cluster 1: CTAs), into *smem and *clusters; the kernel's
// shared-memory and cluster opt-ins are made here. Returns as above.
int conv1d_weight_grad_bf16_plan_check(int k, const int* plan, int* smem, int* clusters) {
  const Plan p = read_plan(plan);
  if (!plan_ok(p, k)) return (int)cudaErrorInvalidValue;
  *smem = (int)layout(p, k).bytes;
  const int kt = taps_per(p, k);
#define WGRAD_BF16_CLUSTERS(KT, NW, WGS) \
  if (kt == KT && p.nw == NW && p.wgs == WGS) return max_clusters_as<KT, NW, WGS>(p, k, clusters);
  WGRAD_BF16_INSTANCES(WGRAD_BF16_CLUSTERS)
#undef WGRAD_BF16_CLUSTERS
  return (int)cudaErrorInvalidValue;
}

const char* conv1d_weight_grad_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
