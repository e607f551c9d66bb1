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
// What bounds it. 2 k Cin bf16 operations per output on the tensor cores
// (989 TFLOP/s dense on an H100 SXM) against about 4 bytes of activations and
// the group's k Cin Cout / groups weights read once per CTA: at the U-Net's
// serving shapes the card could do the work in about a tenth of the float32
// kernel's operations bound, and the weights (read from L2 once per batch
// row) are what a CTA waits on.
//
// Design (a simple first form; TMA, wgmma and clusters are later work). One
// CTA of 8 warps per (group, batch row). Per CTA the convolution is an
// H x (k Cin) x (Cout / groups) product:
//   1. Input channels go through a ring of 2-4 stages of `ck` channels (16,
//      32 or 64; the plan keeps the most bytes in flight that fit): the batch
//      row's H + k - 1 rows (zeros at the "same" padding and past Cin, so a
//      reduction depth k Cin that is no multiple of 16 is zero-padded) and
//      the chunk's k x ck x (group channels, rounded up to 8) weights, both
//      bf16, with 16-byte cp.async where rows are aligned (Cin, or the group
//      width and Cout, multiples of 8), else element by element. Rows are
//      padded by 8 values so that the ldmatrix rows of one load fall in
//      different banks. A thread's 16-byte pieces keep one column and step
//      through the rows, so the addresses advance by additions (no division
//      per piece).
//   2. The output is cut into m16 x (up to 4 n8) jobs; warps take jobs, and
//      where there are fewer jobs than warps the warps of one job split its
//      k-steps into slices. Each k-step (tap t, 16 channels) is one
//      ldmatrix.x4 of A (rows h + t of the staged input: the tap is a row
//      offset, no im2col) and one ldmatrix.x4.trans of B per two n tiles,
//      then mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (csrc/mma_bf16.h).
//      Jobs beyond 4 a warp run in further passes over the ring.
//   3. The slices' accumulators go to a float32 tile in shared memory in
//      slice order (no atomics: two launches give the same bits); the bias
//      is added there.
//   4. GroupNorm over (H, group channels), two-pass (mean, then the mean of
//      squared deviations), each a block reduction in a fixed order; normalise, affine, Mish (as csrc/conv_gn_mish.cu), one
//      bf16 store per value.
// A CTA's output tile lives in shared memory, so the longest horizon a shape
// takes is bounded by it: the wrapper refuses a shape whose plan does not fit.
//
// K1 at bf16 (conv_gn_stats_bf16; the horizon-sharded form of a bf16 model,
// csrc/conv_gn_mish.cu's header): the same kernel on a rank's rows with their
// k / 2-row halo on each side, (B, H + k - 1, Cin), read without padding (the
// ring stages the same H + k - 1 rows, so a plan's layout is B1's at H). After
// step 3 and step 4's two reductions it writes the float32 pre-norm tile
// (conv + bias: the values B1's bf16 form normalises) and each (batch row,
// group)'s local mean and M2 (the sum of squared deviations), and stops. K2
// (csrc/conv_gn_mish.cu, gn_affine_mish_bf16) normalises with the merged
// statistics and rounds once to bf16.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/conv_block_kernel.py: conv_gn_mish_bf16_cuda) checks
// shapes, dtypes and contiguity and chooses the plan (bf16_plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.h"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 8;
constexpr int kThreads = 32 * kMaxWarps;
constexpr int kJobsPerWarp = 4;      // m16 x (4 n8) accumulators a warp holds at once
constexpr int kMaxGroupChannels = 256;
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic + static shared memory of one CTA
// The block reduction's partials
constexpr size_t kStaticSmem = sizeof(float) * kMaxWarps;
constexpr size_t kDefaultSmem = 48 * 1024;

// Chosen on the host (ops/conv_block_kernel.py: bf16_plan), passed by value.
struct Plan {
  int ck;      // input channels per ring stage: 16, 32 or 64
  int stages;  // ring depth, 2 to kMaxStages
};
constexpr int kMaxStages = 4;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Shared-memory layout of one plan (ops/conv_block_kernel.py: bf16_smem_bytes
// mirrors it). Strides in elements; offsets in bytes.
struct Layout {
  int cgp;        // group channels rounded up to 8
  int hp;         // H + k - 1 staged input rows
  int xs;         // ck + 8: bf16 of one staged input row
  int wr;         // cgp + 8: bf16 of one staged weight row (tap, channel)
  int x_stage;    // hp xs: one stage's input, bf16
  int w_stage;    // k ck wr: one stage's weights, bf16
  int mt;         // m16 tiles covering H rows
  int ps;         // cgp + 4: floats of one row of the output tile
  size_t stage;   // bytes of one stage
  size_t zero;    // offset of the zero row (xs bf16) that padded m rows read
  size_t pre;     // offset of the float32 output tile, mt 16 x ps
  size_t bytes;   // dynamic shared memory
};

__host__ __device__ inline Layout layout(const Plan& p, int H, int cg, int K) {
  Layout l;
  l.cgp = ceil_div(cg, 8) * 8;
  l.hp = H + K - 1;
  l.xs = p.ck + 8;
  l.wr = l.cgp + 8;
  l.x_stage = l.hp * l.xs;
  l.w_stage = K * p.ck * l.wr;
  l.mt = ceil_div(H, 16);
  l.ps = l.cgp + 4;
  l.stage = 2 * (size_t)(l.x_stage + l.w_stage);
  l.zero = p.stages * l.stage;
  l.pre = l.zero + 2 * (size_t)l.xs;
  l.bytes = l.pre + sizeof(float) * (size_t)(16 * l.mt) * l.ps;
  return l;
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most n of this thread's committed copy groups are pending.
__device__ __forceinline__ void copies_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Sum of v over the block in a fixed order: lanes, then warps. Every thread
// gets the same total.
__device__ __forceinline__ float block_sum(float v, float* red, int lane, int warp, int warps) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < warps; ++i) s += red[i];
  __syncthreads();  // red is free for the next sum
  return s;
}

__global__ void __launch_bounds__(kThreads)
conv_gn_mish_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const float* __restrict__ bias, const float* __restrict__ gamma,
                         const float* __restrict__ beta, bf16* __restrict__ out,
                         float* __restrict__ pre_out, float* __restrict__ stats_out, int H,
                         int Hx, int off, int Cin, int Cout, int K, int groups, float eps,
                         const Plan p) {
  extern __shared__ uint4 smem16[];
  __shared__ float red[kMaxWarps];
  char* smem = reinterpret_cast<char*>(smem16);
  const int cg = Cout / groups;
  const Layout l = layout(p, H, cg, K);
  const int CK = p.ck;
  const int g = blockIdx.x % groups, b = blockIdx.x / groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int ntiles = l.cgp / 8, nj = ceil_div(ntiles, 4);
  const int jobs = l.mt * nj;
  int S = 1;  // slices: warps that split one job's k-steps
  while (2 * S * jobs <= warps) S *= 2;
  const int slots = warps / S, slice = warp % S, slot = warp / S;
  const int ksteps = K * (CK / 16);
  const int nch = ceil_div(Cin, CK);
  const bool x_vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = cg % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  bf16* zero_row = reinterpret_cast<bf16*>(smem + l.zero);
  float* pre = reinterpret_cast<float*>(smem + l.pre);
  for (int i = tid; i < l.xs / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(zero_row)[i] = make_uint4(0u, 0u, 0u, 0u);

  // Stage chunk `ch` into ring buffer `buf` and commit its copies as one
  // group (an empty one past the last chunk): cp.async where aligned, plain
  // stores (zeros included) elsewhere; the caller's barrier publishes both.
  auto stage = [&](int ch, int buf) {
    if (ch >= nch) {
      copies_commit();
      return;
    }
    bf16* xs_ = reinterpret_cast<bf16*>(smem + buf * l.stage);
    bf16* ws_ = xs_ + l.x_stage;
    const int c0 = ch * CK;
    const bf16 zero = __float2bfloat16_rn(0.f);
    if (x_vec) {  // CK / 8 pieces a row divide the block: one column a thread
      const int pieces = CK / 8, v = tid % pieces, step = blockDim.x / pieces;
      const int ci = c0 + 8 * v;
      for (int row = tid / pieces; row < l.hp; row += step) {
        const int h = row - off;
        bf16* dst = xs_ + row * l.xs + 8 * v;
        if (h >= 0 && h < Hx && ci < Cin)
          copy16(dst, x + ((size_t)b * Hx + h) * Cin + ci);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int e = tid; e < l.hp * CK; e += blockDim.x) {
        const int row = e / CK, c = e % CK;
        const int h = row - off, ci = c0 + c;
        xs_[row * l.xs + c] =
            (h >= 0 && h < Hx && ci < Cin) ? x[((size_t)b * Hx + h) * Cin + ci] : zero;
      }
    }
    if (w_vec && blockDim.x % (l.cgp / 8) == 0) {  // one column a thread, as above
      const int pieces = l.cgp / 8, v = tid % pieces, step = blockDim.x / pieces;
      int row = tid / pieces, t = row / CK, c = row % CK;
      for (; row < K * CK; row += step) {
        bf16* dst = ws_ + row * l.wr + 8 * v;
        if (c0 + c < Cin)
          copy16(dst, w + ((size_t)t * Cin + c0 + c) * Cout + g * cg + 8 * v);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        c += step;
        if (c >= CK) {
          t += c / CK;
          c %= CK;
        }
      }
    } else if (w_vec) {
      const int pieces = l.cgp / 8;
      for (int e = tid; e < K * CK * pieces; e += blockDim.x) {
        const int row = e / pieces, v = e % pieces;
        const int t = row / CK, ci = c0 + row % CK;
        bf16* dst = ws_ + row * l.wr + 8 * v;
        if (ci < Cin)
          copy16(dst, w + ((size_t)t * Cin + ci) * Cout + g * cg + 8 * v);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int e = tid; e < K * CK * l.cgp; e += blockDim.x) {
        const int row = e / l.cgp, n = e % l.cgp;
        const int t = row / CK, ci = c0 + row % CK;
        ws_[row * l.wr + n] =
            (ci < Cin && n < cg) ? w[((size_t)t * Cin + ci) * Cout + g * cg + n] : zero;
      }
    }
    copies_commit();
  };

  const int per_pass = slots * kJobsPerWarp;
  for (int j0 = 0; j0 < jobs; j0 += per_pass) {
    // this warp's jobs: the m tile's staged row for this lane's ldmatrix
    // address (-1: a padded row, read from the zero row), the job's n tiles
    int a_row[kJobsPerWarp], n0[kJobsPerWarp], mrow[kJobsPerWarp];
    bool has[kJobsPerWarp];
    float acc[kJobsPerWarp][4][4];
#pragma unroll
    for (int u = 0; u < kJobsPerWarp; ++u) {
      const int job = j0 + u * slots + slot;
      has[u] = slot < slots && job < jobs;
      const int mi = has[u] ? job / nj : 0;
      n0[u] = has[u] ? (job % nj) * 4 : 0;
      mrow[u] = mi * 16;
      const int m = mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      a_row[u] = m < H ? m : -1;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
    }
    const int a_col = (lane >> 4) * 8;
    const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8, b_col = (lane >> 4) * 8;

    const int ST = p.stages;
    for (int c = 0; c < ST - 1; ++c) stage(c, c);
    for (int ch = 0; ch < nch; ++ch) {
      // the chunk ST - 1 ahead goes to the buffer every warp finished with
      // before the last barrier; then all but the newest ST - 1 groups land
      stage(ch + ST - 1, (ch + ST - 1) % ST);
      copies_wait(ST - 1);
      __syncthreads();  // chunk ch has landed, its plain stores included
      const bf16* xs_ = reinterpret_cast<const bf16*>(smem + (ch % ST) * l.stage);
      const bf16* ws_ = xs_ + l.x_stage;
      for (int i = slice; i < ksteps; i += S) {
        const int t = i / (CK / 16), kk = (i % (CK / 16)) * 16;
#pragma unroll
        for (int u = 0; u < kJobsPerWarp; ++u) {
          if (!has[u]) continue;
          uint32_t a[4];
          ldmatrix_x4(a, a_row[u] >= 0 ? xs_ + (a_row[u] + t) * l.xs + kk + a_col
                                       : zero_row + kk + a_col);
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            const int nt = n0[u] + 2 * pr;
            if (nt >= ntiles) continue;
            uint32_t bfr[4];
            ldmatrix_x4_trans(bfr, ws_ + (t * CK + kk + b_row) * l.wr + nt * 8 + b_col);
            mma_bf16(acc[u][2 * pr], a, bfr);
            if (nt + 1 < ntiles) mma_bf16(acc[u][2 * pr + 1], a, bfr + 2);
          }
        }
      }
      __syncthreads();  // every warp is done with this buffer before it is refilled
    }

    // 3. the slices' sums into the output tile, in slice order
    for (int s = 0; s < S; ++s) {
      if (slice == s) {
#pragma unroll
        for (int u = 0; u < kJobsPerWarp; ++u) {
          if (!has[u]) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nt = n0[u] + j;
            if (nt >= ntiles) continue;
            const int n = nt * 8 + 2 * (lane & 3);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float2* dst = reinterpret_cast<float2*>(
                  pre + (mrow[u] + (lane >> 2) + 8 * half) * l.ps + n);
              float2 v = make_float2(acc[u][j][2 * half], acc[u][j][2 * half + 1]);
              if (s > 0) {
                const float2 o = *dst;
                v.x += o.x;
                v.y += o.y;
              }
              *dst = v;
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // 4. bias, then GroupNorm (two-pass), affine, Mish
  const int gc = g * cg;
  for (int e = tid; e < H * cg; e += blockDim.x) {
    const int m = e / cg, n = e % cg;
    pre[m * l.ps + n] += bias[gc + n];
  }
  __syncthreads();
  const float n_inv = 1.f / (float)(H * cg);
  float v = 0.f;
  for (int e = tid; e < H * cg; e += blockDim.x) v += pre[(e / cg) * l.ps + e % cg];
  const float mean = block_sum(v, red, lane, warp, warps) * n_inv;
  v = 0.f;
  for (int e = tid; e < H * cg; e += blockDim.x) {
    const float d = pre[(e / cg) * l.ps + e % cg] - mean;
    v += d * d;
  }
  const float m2 = block_sum(v, red, lane, warp, warps);
  if (stats_out != nullptr) {  // K1: the pre-norm rows and the local (mean, M2)
    for (int e = tid; e < H * cg; e += blockDim.x) {
      const int m = e / cg, n = e % cg;
      pre_out[((size_t)b * H + m) * Cout + gc + n] = pre[m * l.ps + n];
    }
    if (tid == 0) {
      stats_out[((size_t)b * groups + g) * 2] = mean;
      stats_out[((size_t)b * groups + g) * 2 + 1] = m2;
    }
    return;
  }
  const float rstd = 1.f / sqrtf(m2 * n_inv + eps);
  for (int e = tid; e < H * cg; e += blockDim.x) {
    const int m = e / cg, n = e % cg;
    const float y = (pre[m * l.ps + n] - mean) * rstd * gamma[gc + n] + beta[gc + n];
    const float sp = fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)));
    out[((size_t)b * H + m) * Cout + gc + n] = __float2bfloat16_rn(y * tanhf(sp));
  }
}

bool plan_ok(const Plan& p, int H, int Cin, int cg, int K) {
  if (p.ck != 16 && p.ck != 32 && p.ck != 64) return false;
  if (p.stages < 2 || p.stages > kMaxStages) return false;
  if (cg < 1 || cg > kMaxGroupChannels || H < 1 || Cin < 1 || K < 1 || K % 2 == 0) return false;
  return layout(p, H, cg, K).bytes + kStaticSmem <= kMaxSmem;
}

// B1 (x of Hx = H rows, read from row -k/2: off = k/2) or K1 (x of Hx = H +
// k - 1 rows with their halo, off 0; pre and stats written, out unused).
int launch(const void* x, const void* w, const float* bias, const float* gamma,
           const float* beta, void* out, float* pre, float* stats, int B, int H, int Hx, int off,
           int Cin, int Cout, int k, int groups, float eps, const int* plan, void* stream) {
  if (B <= 0 || groups <= 0 || Cout % groups != 0) return (int)cudaErrorInvalidValue;
  const Plan p{plan[0], plan[1]};
  const int cg = Cout / groups;
  if (!plan_ok(p, H, Cin, cg, k)) return (int)cudaErrorInvalidValue;
  const size_t smem = layout(p, H, cg, k).bytes;
  // Dynamic shared memory allowed so far, per device (the attribute applies
  // to the current device only). 48 KB holds static and dynamic bytes together.
  constexpr int kMaxDevices = 64;
  static size_t configured[kMaxDevices] = {};
  if (smem + kStaticSmem > kDefaultSmem) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (!(dev < kMaxDevices && smem <= configured[dev])) {
      e = cudaFuncSetAttribute(conv_gn_mish_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < kMaxDevices) configured[dev] = smem;
    }
  }
  const int grid = B * groups;
  conv_gn_mish_bf16_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, gamma, beta,
      static_cast<bf16*>(out), pre, stats, H, Hx, off, Cin, Cout, k, groups, eps, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t value (cudaErrorInvalidValue for
// a shape or plan the kernel does not take). `plan` points to the 2 ints of
// struct Plan.
int conv_gn_mish_bf16(const void* x, const void* w, const float* bias, const float* gamma,
                      const float* beta, void* out, int B, int H, int Cin, int Cout, int k,
                      int groups, float eps, const int* plan, void* stream) {
  return launch(x, w, bias, gamma, beta, out, nullptr, nullptr, B, H, H, k / 2, Cin, Cout, k,
                groups, eps, plan, stream);
}

// K1 at bf16: x (B, H + k - 1, Cin) bf16 with its halo, w bf16, bias float32;
// pre (B, H, Cout) float32 (conv + bias, before the norm); stats (B, groups,
// 2) float32, each (batch row, group)'s local (mean, M2). Returns as above.
int conv_gn_stats_bf16(const void* x, const void* w, const float* bias, float* pre,
                       float* stats, int B, int H, int Cin, int Cout, int k, int groups,
                       const int* plan, void* stream) {
  if (pre == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
  return launch(x, w, bias, nullptr, nullptr, nullptr, pre, stats, B, H, H + k - 1, 0, Cin, Cout,
                k, groups, 0.f, plan, stream);
}

// The dynamic shared memory one plan lays out (bytes), or -1 for a plan the
// kernel does not take.
long long conv_gn_mish_bf16_smem_bytes(int H, int Cin, int Cout, int k, int groups,
                                       const int* plan) {
  if (groups <= 0 || Cout % groups != 0) return -1;
  const Plan p{plan[0], plan[1]};
  if (!plan_ok(p, H, Cin, Cout / groups, k)) return -1;
  return (long long)layout(p, H, Cout / groups, k).bytes;
}

const char* conv_gn_mish_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
