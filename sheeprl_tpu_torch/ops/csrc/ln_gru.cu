// Fused LayerNorm-GRU cell, forward, for Hopper (sm_90a).
//
// Counterpart of the TPU kernel sheeprl_tpu/ops/pallas_gru.py::_gru_kernel
// (launched by _gru_pallas through pl.pallas_call).  For joint [B, K],
// w [3H, K] (nn.Linear layout), optional b [3H], g/beta [3H], h [B, H]:
//
//   a  = joint @ w^T + b                  (fp32 accumulation)
//   n  = LayerNorm(a) over the 3H row     (centered two-pass variance, eps)
//   r  = sigmoid(n[:H]);  c = tanh(r * n[H:2H]);  u = sigmoid(n[2H:] - 1)
//   h' = u * c + (1 - u) * h              (cast to h's dtype)
//
// Two launches on the caller's stream:
//   1. projection_kernel: a tiled shared-memory GEMM (64x64 output tile per
//      block, 16-deep K slabs, 4x4 outputs per thread, fp32 FMAs) writing the
//      [B, 3H] projection, bias added, to an fp32 scratch the wrapper
//      allocates;
//   2. ln_gate_kernel: one block per batch row, block reductions for the mean
//      and the centered variance, then the affine transform and the gates.
// Any B, K and H; fp32 and bf16 inputs; fp32 arithmetic throughout.
// The C entry point returns the first cudaGetLastError() that is not
// cudaSuccess, so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kRowThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
projection_kernel(const T* __restrict__ joint, const T* __restrict__ w, const T* __restrict__ b,
                  float* __restrict__ a, int M, int N, int K) {
  // K-major tiles: xs[k][m] and ws[k][n]; +4 pads the rows off one bank
  __shared__ float xs[kBK][kBM + 4];
  __shared__ float ws[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[kTM][kTN] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // neighbouring threads read neighbouring k of one row: both operands are
    // K-contiguous in memory
    for (int i = tid; i < kBM * kBK; i += kGemmThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      const int gk = k0 + c;
      const int gm = m0 + r;
      const int gn = n0 + r;
      xs[c][r] = (gm < M && gk < K) ? to_float(joint[(size_t)gm * K + gk]) : 0.f;
      ws[c][r] = (gn < N && gk < K) ? to_float(w[(size_t)gn * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float xv[kTM];
      float wv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) xv[i] = xs[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) wv[j] = ws[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N) a[(size_t)gm * N + gn] = acc[i][j] + (b != nullptr ? to_float(b[gn]) : 0.f);
    }
  }
}

// Sum over the block; every thread gets the result.  `red` holds one slot
// per warp and is reused by consecutive calls, hence the leading barrier.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = (blockDim.x + 31) / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < warps ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_gate_kernel(const float* __restrict__ a, const T* __restrict__ g, const T* __restrict__ beta,
               const T* __restrict__ h, T* __restrict__ out, int H, float eps) {
  __shared__ float red[32];
  const int row = blockIdx.x;
  const int N = 3 * H;
  const float* arow = a + (size_t)row * N;

  float s = 0.f;
  for (int j = threadIdx.x; j < N; j += blockDim.x) s += arow[j];
  const float mean = block_sum(s, red) / N;
  float v = 0.f;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float d = arow[j] - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(block_sum(v, red) / N + eps);

  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    const float nr = (arow[j] - mean) * rstd * to_float(g[j]) + to_float(beta[j]);
    const float nc = (arow[H + j] - mean) * rstd * to_float(g[H + j]) + to_float(beta[H + j]);
    const float nu = (arow[2 * H + j] - mean) * rstd * to_float(g[2 * H + j]) + to_float(beta[2 * H + j]);
    const float r = sigmoid(nr);
    const float c = tanhf(r * nc);
    const float u = sigmoid(nu - 1.f);
    const float hv = to_float(h[(size_t)row * H + j]);
    store(out + (size_t)row * H + j, u * c + (1.f - u) * hv);
  }
}

template <typename T>
int launch(const void* joint, const void* w, const void* b, const void* g, const void* beta, const void* h,
           void* out, float* scratch, int B, int K, int H, float eps, cudaStream_t stream) {
  const int N = 3 * H;
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  projection_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(joint), static_cast<const T*>(w), static_cast<const T*>(b), scratch, B, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ln_gate_kernel<T><<<B, kRowThreads, 0, stream>>>(scratch, static_cast<const T*>(g), static_cast<const T*>(beta),
                                                   static_cast<const T*>(h), static_cast<T*>(out), H, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `b` may be null (no bias).  `scratch`
// is an fp32 [B, 3H] buffer.  Returns 0 or a cudaError_t code.
extern "C" int ln_gru_forward(int dtype, const void* joint, const void* w, const void* b, const void* g,
                              const void* beta, const void* h, void* out, float* scratch, int B, int K, int H,
                              float eps, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(joint, w, b, g, beta, h, out, scratch, B, K, H, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(joint, w, b, g, beta, h, out, scratch, B, K, H, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ln_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
