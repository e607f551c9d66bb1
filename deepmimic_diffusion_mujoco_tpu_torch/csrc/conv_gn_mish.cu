// Fused "same" Conv1d(k) + bias -> GroupNorm(groups, eps) -> affine -> Mish,
// float32, channel-last: x (B, H, Cin), w (k, Cin, Cout), bias/gamma/beta
// (Cout,), out (B, H, Cout).
//
// Replaces deepmimic_diffusion_mujoco_tpu/ops/pallas/conv_block_kernel.py:
// conv_gn_mish (the TPU kernel behind every Conv1dBlock of the temporal
// U-Net). It computes what that kernel computes, not how: the TPU body's
// im2col and one-hot group matmuls are layout workarounds for the MXU.
//
// Design. One block per (batch row, group): GroupNorm's statistics cover
// (H, Cout / groups) of one row, so a block owns every value its
// normalisation needs and no reduction crosses blocks. Per block, for each
// tile of output rows:
//   1. The convolution as a small matrix product, (rows) x (k * Cin) times
//      (k * Cin) x (group channels). Input channels go through shared
//      memory in chunks of `ck`, double-buffered with cp.async so the next
//      chunk loads while this one is multiplied. A thread owns a 4-row x
//      4-channel output tile and keeps 4 + k - 1 input values in registers
//      across the k taps (13 shared loads per 80 FMAs at k 5). When a tile
//      has fewer outputs than the block has threads x 16, the input
//      channels are split among `slices` groups of threads and their
//      partial sums are added in shared memory, in a fixed order.
//   2. Bias added, pre-norm values written to `out`.
//   3. Two-pass GroupNorm statistics (mean, then sum of squared deviations)
//      with block reductions, reading `out` back (it is in L1/L2).
//   4. Normalise, affine, Mish (x * tanh(softplus(x)), softplus computed as
//      max(x, 0) + log1p(exp(-|x|))), written over `out`.
//
// Bound on an H100 at the U-Net's shapes: float32 FMAs outside the tensor
// cores (2 k Cin flops per output against about 4 bytes moved per output).
// The grid is B * groups blocks, fewer than the card's 132 SMs at B < 17,
// and every block of one group reads the group's weights again from L2.
// Tensor cores (wgmma, bf16) and sharing weights across blocks are later
// work.
//
// Plain C interface (no PyTorch headers) so nvcc builds it in seconds; the
// Python wrapper (ops/conv_block_kernel.py) validates shapes, dtypes and
// contiguity before it calls in.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 4;                   // output rows per thread
constexpr int kTN = 4;                   // output channels per thread
constexpr int kMaxGroupChannels = 256;   // a weight row's columns fit one pass of the block
constexpr size_t kSmemBudget = 200 * 1024;

// Tiling, chosen on the host for one (H, Cin, Cout, groups, k) and passed by
// value. Sizes are in floats.
struct Plan {
  int cgp;        // channels per group, rounded up to kTN
  int tile_h;     // output rows per tile, a multiple of kTM
  int n_out;      // threads that own an output tile: (tile_h / kTM) * (cgp / kTN)
  int slices;     // kThreads / n_out: ways the input channels are split
  int ck;         // input channels per pipeline stage
  int xs_stride;  // ck + 1: row stride of the staged input
  int xs_size;    // (tile_h + k - 1) * xs_stride, rounded up to 4
  int ws_size;    // k * ck * cgp
};

// Sum of v over the block, returned to every thread. `red` holds kWarps
// floats; the trailing barrier lets the caller reuse it at once.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[i];
  __syncthreads();
  return s;
}

// kVecW: the group's weight columns are 16-byte aligned and cg % 4 == 0, so
// each weight row is copied as float4s.
template <int K, bool kVecW>
__global__ void __launch_bounds__(kThreads)
conv_gn_mish_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ gamma,
                    const float* __restrict__ beta, float* __restrict__ out,
                    int H, int Cin, int Cout, int groups, Plan p, float eps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  constexpr int kPad = K / 2;
  constexpr int kWin = kTM + K - 1;

  const int cg = Cout / groups;
  const int b = blockIdx.x / groups;
  const int g = blockIdx.x % groups;
  const int tid = threadIdx.x;

  // this thread's output tile and input-channel slice
  const int ntc = p.cgp / kTN;
  const int slice = tid / p.n_out;           // >= p.slices: no tile of its own
  const int o = tid % p.n_out;
  const int r0 = (o / ntc) * kTM;
  const int c0 = (o % ntc) * kTN;
  const bool computes = slice < p.slices;

  // this thread's place in the staging copies (divisions once, not per element)
  const int xrows = p.tile_h + K - 1;
  const int x_ci = tid % p.ck, x_r0 = tid / p.ck, x_step = kThreads / p.ck;
  const int w_cols = kVecW ? p.cgp / 4 : p.cgp;
  const int w_q = tid % w_cols, w_ci0 = tid / w_cols, w_step = kThreads / w_cols;
  const bool w_copies = tid < w_step * w_cols;

  const float* xb = x + (size_t)b * H * Cin;
  const float* wg = w + (size_t)g * cg;
  float* ob = out + (size_t)b * H * Cout + (size_t)g * cg;
  float* part = smem + 2 * (p.ws_size + p.xs_size);  // slices x tile_h x cgp

  // Issue the copies of input channels [ci0, ci0 + ck) into stage `buf`;
  // padding (sequence ends, channels past Cin or cg) is stored as zeros.
  auto stage = [&](int h0, int ci0, int buf) {
    float* ws = smem + buf * p.ws_size;
    float* xs = smem + 2 * p.ws_size + buf * p.xs_size;
    const int cin = ci0 + x_ci;
    for (int r = x_r0; r < xrows; r += x_step) {
      const int h = h0 - kPad + r;
      float* dst = xs + r * p.xs_stride + x_ci;
      if (h >= 0 && h < H && cin < Cin)
        __pipeline_memcpy_async(dst, xb + (size_t)h * Cin + cin, sizeof(float));
      else
        *dst = 0.f;
    }
    if (!w_copies) return;
#pragma unroll
    for (int tap = 0; tap < K; ++tap) {
      for (int ci = w_ci0; ci < p.ck; ci += w_step) {
        const int wcin = ci0 + ci;
        const float* src = wg + ((size_t)tap * Cin + wcin) * Cout;
        float* row = ws + (tap * p.ck + ci) * p.cgp;
        if (kVecW) {
          if (wcin < Cin)
            __pipeline_memcpy_async(row + 4 * w_q, src + 4 * w_q, 4 * sizeof(float));
          else
            *reinterpret_cast<float4*>(row + 4 * w_q) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          if (wcin < Cin && w_q < cg)
            __pipeline_memcpy_async(row + w_q, src + w_q, sizeof(float));
          else
            row[w_q] = 0.f;
        }
      }
    }
  };

  const int n_chunks = (Cin + p.ck - 1) / p.ck;
  float sum = 0.f;
  for (int h0 = 0; h0 < H; h0 += p.tile_h) {
    float acc[kTM][kTN];
#pragma unroll
    for (int j = 0; j < kTM; ++j)
#pragma unroll
      for (int q = 0; q < kTN; ++q) acc[j][q] = 0.f;

    stage(h0, 0, 0);
    __pipeline_commit();
    for (int i = 0; i < n_chunks; ++i) {
      if (i + 1 < n_chunks) {
        // stage (i+1)&1 was last read by chunk i-1, which every thread has
        // finished: the barrier at the end of the previous iteration
        stage(h0, (i + 1) * p.ck, (i + 1) & 1);
        __pipeline_commit();
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // chunk i is in shared memory for every thread
      if (computes) {
        const float* ws = smem + (i & 1) * p.ws_size + c0;
        const float* xr = smem + 2 * p.ws_size + (i & 1) * p.xs_size + r0 * p.xs_stride;
        for (int ci = slice; ci < p.ck; ci += p.slices) {
          float xv[kWin];
#pragma unroll
          for (int m = 0; m < kWin; ++m) xv[m] = xr[m * p.xs_stride + ci];
#pragma unroll
          for (int tap = 0; tap < K; ++tap) {
            const float4 wv = *reinterpret_cast<const float4*>(ws + (tap * p.ck + ci) * p.cgp);
#pragma unroll
            for (int j = 0; j < kTM; ++j) {
              acc[j][0] = fmaf(xv[j + tap], wv.x, acc[j][0]);
              acc[j][1] = fmaf(xv[j + tap], wv.y, acc[j][1]);
              acc[j][2] = fmaf(xv[j + tap], wv.z, acc[j][2]);
              acc[j][3] = fmaf(xv[j + tap], wv.w, acc[j][3]);
            }
          }
        }
      }
      __syncthreads();  // chunk i consumed: its stage may be refilled
    }

    // slices' partial sums -> shared memory; then bias + sum over slices in
    // slice order, pre-norm values to `out`
    if (computes) {
#pragma unroll
      for (int j = 0; j < kTM; ++j)
        *reinterpret_cast<float4*>(part + (slice * p.tile_h + r0 + j) * p.cgp + c0) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
    __syncthreads();
    for (int i = tid; i < p.tile_h * p.cgp; i += kThreads) {
      const int r = i / p.cgp, c = i % p.cgp;
      const int h = h0 + r;
      if (h < H && c < cg) {
        float v = bias[g * cg + c];
        for (int s = 0; s < p.slices; ++s) v += part[(s * p.tile_h + r) * p.cgp + c];
        ob[(size_t)h * Cout + c] = v;
        sum += v;
      }
    }
    // `part` is next written after the next tile's chunk loop and its barriers
  }

  // GroupNorm statistics, two-pass. block_sum's barriers make this block's
  // writes to `out` visible to all of its threads.
  const int n = H * cg;
  const float mean = block_sum(sum, red) / (float)n;
  float sq = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const float d = ob[(size_t)(i / cg) * Cout + i % cg] - mean;
    sq += d * d;
  }
  const float var = block_sum(sq, red) / (float)n;
  const float inv = 1.f / sqrtf(var + eps);

  for (int i = tid; i < n; i += kThreads) {
    const int cc = i % cg;
    float* ptr = ob + (size_t)(i / cg) * Cout + cc;
    const float v = (*ptr - mean) * inv * gamma[g * cg + cc] + beta[g * cg + cc];
    const float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    *ptr = v * tanhf(sp);
  }
}

size_t smem_bytes(const Plan& p) {
  return sizeof(float) * (2 * ((size_t)p.ws_size + p.xs_size) +
                          (size_t)p.slices * p.tile_h * p.cgp);
}

// The tiling for one call; returns false if no chunk size fits the budget.
bool make_plan(int H, int Cin, int cg, int K, Plan* p) {
  p->cgp = (cg + kTN - 1) / kTN * kTN;
  const int h_cover = (H + kTM - 1) / kTM * kTM;
  const int h_max = kThreads * kTM * kTN / p->cgp / kTM * kTM;
  p->tile_h = h_cover < h_max ? h_cover : h_max;
  p->n_out = (p->tile_h / kTM) * (p->cgp / kTN);
  p->slices = kThreads / p->n_out;
  for (int ck = 16; ck >= 1; ck /= 2) {
    if (ck > 1 && ck / 2 >= Cin) continue;  // no wider than Cin needs
    p->ck = ck;
    p->xs_stride = ck + 1;
    p->xs_size = ((p->tile_h + K - 1) * p->xs_stride + 3) / 4 * 4;
    p->ws_size = K * ck * p->cgp;
    if (smem_bytes(*p) <= kSmemBudget) return true;
  }
  return false;
}

template <int K, bool kVecW>
int launch_as(const float* x, const float* w, const float* bias, const float* gamma,
              const float* beta, float* out, int B, int H, int Cin, int Cout,
              int groups, const Plan& p, float eps, cudaStream_t stream) {
  // Dynamic shared memory allowed so far, per device: the attribute applies
  // to the current device only.
  constexpr int kMaxDevices = 64;
  static size_t configured[kMaxDevices] = {};
  const size_t smem = smem_bytes(p);
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const bool cached = dev < kMaxDevices && smem <= configured[dev];
    if (!cached) {
      e = cudaFuncSetAttribute(conv_gn_mish_kernel<K, kVecW>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < kMaxDevices) configured[dev] = smem;
    }
  }
  conv_gn_mish_kernel<K, kVecW><<<B * groups, kThreads, smem, stream>>>(
      x, w, bias, gamma, beta, out, H, Cin, Cout, groups, p, eps);
  return (int)cudaGetLastError();
}

template <int K>
int launch(const float* x, const float* w, const float* bias, const float* gamma,
           const float* beta, float* out, int B, int H, int Cin, int Cout,
           int groups, float eps, cudaStream_t stream) {
  if (groups <= 0 || Cout % groups != 0 || H <= 0 || Cin <= 0)
    return (int)cudaErrorInvalidValue;
  const int cg = Cout / groups;
  Plan p;
  if (cg > kMaxGroupChannels || !make_plan(H, Cin, cg, K, &p))
    return (int)cudaErrorInvalidValue;
  const bool vec = cg % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? launch_as<K, true>(x, w, bias, gamma, beta, out, B, H, Cin, Cout, groups, p,
                                  eps, stream)
             : launch_as<K, false>(x, w, bias, gamma, beta, out, B, H, Cin, Cout, groups, p,
                                   eps, stream);
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t value (cudaErrorInvalidValue for
// a kernel size or group width the kernel does not take).
int conv_gn_mish_f32(const float* x, const float* w, const float* bias,
                     const float* gamma, const float* beta, float* out, int B,
                     int H, int Cin, int Cout, int k, int groups, float eps,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(x, w, bias, gamma, beta, out, B, H, Cin, Cout, groups, eps, s);
    case 3: return launch<3>(x, w, bias, gamma, beta, out, B, H, Cin, Cout, groups, eps, s);
    case 5: return launch<5>(x, w, bias, gamma, beta, out, B, H, Cin, Cout, groups, eps, s);
    case 7: return launch<7>(x, w, bias, gamma, beta, out, B, H, Cin, Cout, groups, eps, s);
    case 9: return launch<9>(x, w, bias, gamma, beta, out, B, H, Cin, Cout, groups, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* conv_gn_mish_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
