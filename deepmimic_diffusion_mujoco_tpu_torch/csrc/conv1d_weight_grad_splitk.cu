// The earlier weight-gradient kernel, kept only as the yardstick that
// ops/conv_weight_grad_sweep.py times beside csrc/conv1d_weight_grad.cu: no
// path of the port calls it. It computes the same function,
//   dW[t, ci, co] = sum_{b, h} x[b, h + t - pad_l, ci] * dy[b, h, co],
// in float32 on the CUDA cores: 64 x 64 channel tiles, 20-row chunks of one
// batch row, a thread owning 4 x 4 channels for all k taps, and the B * H
// reduction split across `splits` blocks that each write a partial dW to a
// workspace, which a second kernel (sum_splits_kernel) adds in split order.
// The sweep picks the split count as the port once did
// (ops/conv_weight_grad_sweep.py:splitk_splits) and allocates the
// workspace.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileCi = 64;   // input channels per block
constexpr int kTileCo = 64;   // output channels per block
constexpr int kRows = 20;     // rows of one batch row per chunk (divides H 160/80/40/20)
constexpr int kTM = 4;        // input channels per thread
constexpr int kTN = 4;        // output channels per thread
static_assert((kTileCi / kTM) * (kTileCo / kTN) == kThreads, "one 4x4 tile per thread");

// kVec: Cin and Cout are multiples of 4 and x, dy start on 16 bytes, so rows
// are staged as float4s; else one float at a time.
template <int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
conv1d_weight_grad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          float* __restrict__ out, int H, int Cin, int Cout,
                          int chunks_per_row, int n_chunks, int splits) {
  constexpr int kPadL = (K - 1) / 2;
  constexpr int kXRows = kRows + K - 1;
  __shared__ __align__(16) float xs[2][kXRows * kTileCi];
  __shared__ __align__(16) float ds[2][kRows * kTileCo];

  const int co0 = blockIdx.x * kTileCo;
  const int ci0 = blockIdx.y * kTileCi;
  const int split = blockIdx.z;
  const int c_begin = (int)((long long)n_chunks * split / splits);
  const int c_end = (int)((long long)n_chunks * (split + 1) / splits);
  const int tid = threadIdx.x;
  const int tx = tid % (kTileCo / kTN);   // this thread's output channels: tx * 4 ..
  const int ty = tid / (kTileCo / kTN);   // this thread's input channels: ty * 4 ..

  // Start the copies of chunk c into stage `buf`; rows outside [0, H) and
  // channels past Cin / Cout are stored as zeros.
  auto stage = [&](int c, int buf) {
    const int b = c / chunks_per_row;
    const int h0 = (c % chunks_per_row) * kRows;
    const float* xb = x + (size_t)b * H * Cin;
    const float* db = dy + (size_t)b * H * Cout;
    if (kVec) {
      for (int i = tid; i < kXRows * (kTileCi / 4); i += kThreads) {
        const int r = i / (kTileCi / 4), q = 4 * (i % (kTileCi / 4));
        const int h = h0 - kPadL + r, ci = ci0 + q;
        float* dst = &xs[buf][r * kTileCi + q];
        if (h >= 0 && h < H && ci < Cin)
          __pipeline_memcpy_async(dst, xb + (size_t)h * Cin + ci, 4 * sizeof(float));
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int i = tid; i < kRows * (kTileCo / 4); i += kThreads) {
        const int r = i / (kTileCo / 4), q = 4 * (i % (kTileCo / 4));
        const int h = h0 + r, co = co0 + q;
        float* dst = &ds[buf][r * kTileCo + q];
        if (h < H && co < Cout)
          __pipeline_memcpy_async(dst, db + (size_t)h * Cout + co, 4 * sizeof(float));
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = tid; i < kXRows * kTileCi; i += kThreads) {
        const int r = i / kTileCi, q = i % kTileCi;
        const int h = h0 - kPadL + r, ci = ci0 + q;
        float* dst = &xs[buf][r * kTileCi + q];
        if (h >= 0 && h < H && ci < Cin)
          __pipeline_memcpy_async(dst, xb + (size_t)h * Cin + ci, sizeof(float));
        else
          *dst = 0.f;
      }
      for (int i = tid; i < kRows * kTileCo; i += kThreads) {
        const int r = i / kTileCo, q = i % kTileCo;
        const int h = h0 + r, co = co0 + q;
        float* dst = &ds[buf][r * kTileCo + q];
        if (h < H && co < Cout)
          __pipeline_memcpy_async(dst, db + (size_t)h * Cout + co, sizeof(float));
        else
          *dst = 0.f;
      }
    }
  };

  float acc[K][kTM][kTN];
#pragma unroll
  for (int t = 0; t < K; ++t)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[t][i][j] = 0.f;

  const int n = c_end - c_begin;
  if (n > 0) {
    stage(c_begin, 0);
    __pipeline_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      // stage (i+1)&1 was last read by chunk i-1, which every thread has
      // finished: the barrier at the end of the previous iteration
      stage(c_begin + i + 1, (i + 1) & 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // chunk i is in shared memory for every thread

    const float* xr = xs[i & 1] + ty * kTM;
    const float* dr = ds[i & 1] + tx * kTN;
    // window of K input rows: row r + t feeds tap t of output row r
    float4 win[K];
#pragma unroll
    for (int t = 0; t < K - 1; ++t) win[t] = *reinterpret_cast<const float4*>(xr + t * kTileCi);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      win[K - 1] = *reinterpret_cast<const float4*>(xr + (r + K - 1) * kTileCi);
      const float4 d = *reinterpret_cast<const float4*>(dr + r * kTileCo);
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const float xv[kTM] = {win[t].x, win[t].y, win[t].z, win[t].w};
#pragma unroll
        for (int m = 0; m < kTM; ++m) {
          acc[t][m][0] = fmaf(xv[m], d.x, acc[t][m][0]);
          acc[t][m][1] = fmaf(xv[m], d.y, acc[t][m][1]);
          acc[t][m][2] = fmaf(xv[m], d.z, acc[t][m][2]);
          acc[t][m][3] = fmaf(xv[m], d.w, acc[t][m][3]);
        }
      }
#pragma unroll
      for (int t = 0; t < K - 1; ++t) win[t] = win[t + 1];
    }
    __syncthreads();  // chunk i consumed: its stage may be refilled
  }

  // this split's dW tile (zeros for a split without chunks)
  float* dst = out + (size_t)split * K * Cin * Cout;
  const int co = co0 + tx * kTN;
  const bool vec_out = Cout % 4 == 0 && co + kTN <= Cout;
#pragma unroll
  for (int t = 0; t < K; ++t) {
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      const int ci = ci0 + ty * kTM + m;
      if (ci >= Cin) continue;
      float* row = dst + ((size_t)t * Cin + ci) * Cout + co;
      if (vec_out) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[t][m][0], acc[t][m][1], acc[t][m][2], acc[t][m][3]);
      } else {
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          if (co + j < Cout) row[j] = acc[t][m][j];
      }
    }
  }
}

// out[i] = sum over s of ws[s * n + i], s in order.
__global__ void sum_splits_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                  size_t n, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += ws[(size_t)k * n + i];
    out[i] = s;
  }
}

template <int K>
int launch(const float* x, const float* dy, float* out, float* ws, int B, int H, int Cin,
           int Cout, int splits, cudaStream_t stream) {
  const int chunks_per_row = (H + kRows - 1) / kRows;
  const int n_chunks = B * chunks_per_row;
  const dim3 grid((Cout + kTileCo - 1) / kTileCo, (Cin + kTileCi - 1) / kTileCi, splits);
  float* dst = splits > 1 ? ws : out;
  const bool vec = Cin % 4 == 0 && Cout % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  if (vec)
    conv1d_weight_grad_kernel<K, true><<<grid, kThreads, 0, stream>>>(
        x, dy, dst, H, Cin, Cout, chunks_per_row, n_chunks, splits);
  else
    conv1d_weight_grad_kernel<K, false><<<grid, kThreads, 0, stream>>>(
        x, dy, dst, H, Cin, Cout, chunks_per_row, n_chunks, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t n = (size_t)K * Cin * Cout;
  size_t blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<(unsigned)blocks, 256, 0, stream>>>(ws, out, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out: (k, Cin, Cout); ws: splits * k * Cin * Cout floats when splits > 1
// (may be null otherwise). Returns 0 on success, else a cudaError_t value
// (cudaErrorInvalidValue for a kernel size or argument the kernel does not
// take).
int conv1d_weight_grad_splitk_f32(const float* x, const float* dy, float* out, float* ws, int B,
                           int H, int Cin, int Cout, int k, int splits, void* stream) {
  if (B <= 0 || H <= 0 || Cin <= 0 || Cout <= 0 || splits < 1 || (splits > 1 && !ws) ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch<1>(x, dy, out, ws, B, H, Cin, Cout, splits, s);
    case 3: return launch<3>(x, dy, out, ws, B, H, Cin, Cout, splits, s);
    case 5: return launch<5>(x, dy, out, ws, B, H, Cin, Cout, splits, s);
    case 7: return launch<7>(x, dy, out, ws, B, H, Cin, Cout, splits, s);
    case 9: return launch<9>(x, dy, out, ws, B, H, Cin, Cout, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* conv1d_weight_grad_splitk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
