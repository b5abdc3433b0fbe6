// Fused N-model VP-SDE OR step epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel superdiff_tpu/ops/pallas/fused_step.py:36 (_kernel,
// called through fused_sde_step_pallas). Per batch row b, all fp32:
//
//   w        = softmax(T logq[b, :])                       (OR weights)
//   dx       = -dt (da x - 2 beta sum_n w_n s_n) + sqrt(2 sigma beta dt) eps
//   x_new    = x + dx ;  f_next = da x_new ;  v_n = da x - 2 beta s_n
//   logq_n  += sum_D (f_next - v_n)(dt v_n + 2 dx + dt f_next) / (4 sigma beta)
//   logq    -= max_n logq
//
// Bound on the H100: bytes. The pass reads the N score rows, x and eps and
// writes x_new, (N + 3) B D 4 bytes: 6.1 MB at the CIFAR main path (N = 2,
// B = 100, D = 3072), 1.8 us at 3.35 TB/s, so in practice the launch bounds it.
//
// Design: one block per batch row (100 blocks on 132 SMs at the main path);
// threads stride the row in float4 (a scalar loop when D % 4 != 0 or a
// pointer is not 16-byte aligned; any D is taken). Each block
// takes the softmax over N from its row's logq once; each thread keeps N
// partial sums in registers (N is a runtime argument up to kMaxModels; the
// guarded, unrolled model loops keep the accumulators out of local memory).
// The N sums are reduced in a fixed order (warp shuffles, then warp 0 over
// the warps), with no atomics, so logq is the same from run to run.
// T * logq is rounded before the max is subtracted (no FMA contraction), as
// the reference computes it: at T = 1e6 a contracted product would move the
// OR weights by the rounding error times T.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxModels = 8;

// One element: the EM update (returns x + dx) and the N Itô numerators.
__device__ __forceinline__ float step_element(float xv, float ev, const float (&sv)[kMaxModels],
                                              const float (&w)[kMaxModels],
                                              float (&acc)[kMaxModels], int N, float da,
                                              float two_beta, float dt, float noise) {
  float bal = 0.0f;
#pragma unroll
  for (int n = 0; n < kMaxModels; ++n)
    if (n < N) bal += w[n] * sv[n];
  const float dx = -dt * (da * xv - two_beta * bal) + noise * ev;
  const float out = xv + dx;
  const float f_next = da * out;
#pragma unroll
  for (int n = 0; n < kMaxModels; ++n) {
    if (n < N) {
      const float v = da * xv - two_beta * sv[n];
      acc[n] += (f_next - v) * (dt * v + 2.0f * dx + dt * f_next);
    }
  }
  return out;
}

__global__ void __launch_bounds__(kThreads)
fused_sde_step_kernel(const float* __restrict__ s, const float* __restrict__ x,
                      const float* __restrict__ eps, const float* __restrict__ logq,
                      float* __restrict__ new_x, float* __restrict__ new_logq, int N,
                      int B, int D, int vec4, float sigma, float beta, float da, float dt,
                      float temperature) {
  const int b = blockIdx.x;
  const size_t row = static_cast<size_t>(b) * D;
  const size_t model_stride = static_cast<size_t>(B) * D;

  // OR weights of this row: softmax over the (rounded) T * logq
  float w[kMaxModels];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < kMaxModels; ++n) {
    w[n] = n < N ? __fmul_rn(temperature, logq[b * N + n]) : -CUDART_INF_F;
    m = fmaxf(m, w[n]);
  }
  float z = 0.0f;
#pragma unroll
  for (int n = 0; n < kMaxModels; ++n) {
    w[n] = n < N ? expf(w[n] - m) : 0.0f;
    z += w[n];
  }
#pragma unroll
  for (int n = 0; n < kMaxModels; ++n) w[n] = w[n] / z;

  const float two_beta = 2.0f * beta;
  const float noise = sqrtf(2.0f * sigma * beta * dt);
  float acc[kMaxModels];
#pragma unroll
  for (int n = 0; n < kMaxModels; ++n) acc[n] = 0.0f;

  if (vec4) {
    const int d4 = D >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x + row);
    const float4* e4 = reinterpret_cast<const float4*>(eps + row);
    float4* o4 = reinterpret_cast<float4*>(new_x + row);
    for (int i = threadIdx.x; i < d4; i += kThreads) {
      const float4 xv = x4[i], ev = e4[i];
      float sv[4][kMaxModels];
#pragma unroll
      for (int n = 0; n < kMaxModels; ++n) {
        if (n < N) {
          const float4 t = reinterpret_cast<const float4*>(s + n * model_stride + row)[i];
          sv[0][n] = t.x;
          sv[1][n] = t.y;
          sv[2][n] = t.z;
          sv[3][n] = t.w;
        }
      }
      float4 o;
      o.x = step_element(xv.x, ev.x, sv[0], w, acc, N, da, two_beta, dt, noise);
      o.y = step_element(xv.y, ev.y, sv[1], w, acc, N, da, two_beta, dt, noise);
      o.z = step_element(xv.z, ev.z, sv[2], w, acc, N, da, two_beta, dt, noise);
      o.w = step_element(xv.w, ev.w, sv[3], w, acc, N, da, two_beta, dt, noise);
      o4[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < D; i += kThreads) {
      float sv[kMaxModels];
#pragma unroll
      for (int n = 0; n < kMaxModels; ++n)
        if (n < N) sv[n] = s[n * model_stride + row + i];
      new_x[row + i] =
          step_element(x[row + i], eps[row + i], sv, w, acc, N, da, two_beta, dt, noise);
    }
  }

  // deterministic block reduction of the N sums
  __shared__ float red[kMaxModels][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < kMaxModels; ++n) {
    if (n < N) {
      float v = acc[n];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[n][warp] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float den = 4.0f * sigma * beta;
    float out[kMaxModels];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < kMaxModels; ++n) {
      if (n < N) {
        float total = 0.0f;
        for (int k = 0; k < kWarps; ++k) total += red[n][k];
        out[n] = logq[b * N + n] + total / den;
        mx = fmaxf(mx, out[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < kMaxModels; ++n)
      if (n < N) new_logq[b * N + n] = out[n] - mx;
  }
}

}  // namespace

extern "C" int fused_sde_step_max_models() { return kMaxModels; }

extern "C" int fused_sde_step_launch(const void* sscores, const void* x, const void* eps,
                                     const void* logq, void* new_x, void* new_logq, int N,
                                     int B, int D, float sigma, float beta, float da,
                                     float dt, float temperature, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const int vec4 = D % 4 == 0 && aligned(sscores) && aligned(x) && aligned(eps) &&
                   aligned(new_x);
  fused_sde_step_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sscores), static_cast<const float*>(x),
      static_cast<const float*>(eps), static_cast<const float*>(logq),
      static_cast<float*>(new_x), static_cast<float*>(new_logq), N, B, D, vec4, sigma,
      beta, da, dt, temperature);
  return static_cast<int>(cudaGetLastError());
}
