// Fused sigma-space OR-composition step epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel superdiff_tpu/ops/pallas/sd_fused_step.py::_kernel
// (called through sd_or_step_pallas). Per latent row b (all fp32):
//
//   kappa  = softmax([T (ll_obj + logp), T ll_bg])[0]
//   vf     = v_unc + g ((v_bg - v_unc) + kappa (v_obj - v_bg))
//   dx     = 2 dsigma vf + sqrt(2 |dsigma| sigma) eps ;  x_new = x + dx
//   ll_i  += -sum(v_i (dx + dsigma v_i)) / sigma          (i = obj, bg)
//
// Bound on the H100: bytes. At the 512 px main path (B=8, D=16384) the pass
// reads five (B, D) fp32 rows and writes one, ~3.1 MB, ~1 us at 3.35 TB/s,
// so in practice the launch itself bounds it.
//
// Design: one block per row would put 8 blocks on 132 SMs. Instead the grid
// splits every row into `nsplit` chunks (pass 1); each block writes the new
// x of its chunk and its two partial dot products to a scratch buffer.
// Pass 2 (one thread per row) adds the partials in a fixed order. No
// atomics: the result is the same from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float or_kappa(const float* ll, int b, float temperature,
                                          float logp) {
  const float a = temperature * (ll[2 * b] + logp);
  const float c = temperature * ll[2 * b + 1];
  const float m = fmaxf(a, c);
  const float ea = expf(a - m);
  const float eb = expf(c - m);
  return ea / (ea + eb);
}

__global__ void __launch_bounds__(kThreads)
or_step_pass1(const float* __restrict__ v_obj, const float* __restrict__ v_bg,
              const float* __restrict__ v_unc, const float* __restrict__ x,
              const float* __restrict__ eps, const float* __restrict__ ll,
              float* __restrict__ new_x, float* __restrict__ partial, int D,
              int chunk, float sigma, float dsigma, float temperature, float logp,
              float guidance) {
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int b = blockIdx.y;
  const float kappa = or_kappa(ll, b, temperature, logp);
  const float noise = sqrtf(2.0f * fabsf(dsigma) * sigma);
  const size_t row = static_cast<size_t>(b) * D;
  const int lo = split * chunk;
  const int hi = min(D, lo + chunk);
  float s_obj = 0.0f, s_bg = 0.0f;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float vo = v_obj[row + i];
    const float vb = v_bg[row + i];
    const float vu = v_unc[row + i];
    const float vf = vu + guidance * ((vb - vu) + kappa * (vo - vb));
    const float dx = 2.0f * dsigma * vf + noise * eps[row + i];
    new_x[row + i] = x[row + i] + dx;
    s_obj += vo * (dx + dsigma * vo);
    s_bg += vb * (dx + dsigma * vb);
  }
  // deterministic block reduction: warp shuffles, then warp 0 over warps
  __shared__ float red[2][kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    s_obj += __shfl_xor_sync(0xffffffffu, s_obj, off);
    s_bg += __shfl_xor_sync(0xffffffffu, s_bg, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s_obj;
    red[1][warp] = s_bg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float to = 0.0f, tb = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) {
      to += red[0][w];
      tb += red[1][w];
    }
    partial[(static_cast<size_t>(b) * nsplit + split) * 2] = to;
    partial[(static_cast<size_t>(b) * nsplit + split) * 2 + 1] = tb;
  }
}

__global__ void or_step_pass2(const float* __restrict__ ll,
                              const float* __restrict__ partial,
                              float* __restrict__ new_ll, float* __restrict__ kappa_out,
                              int B, int nsplit, float sigma, float temperature,
                              float logp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float to = 0.0f, tb = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    to += partial[(static_cast<size_t>(b) * nsplit + s) * 2];
    tb += partial[(static_cast<size_t>(b) * nsplit + s) * 2 + 1];
  }
  kappa_out[b] = or_kappa(ll, b, temperature, logp);
  new_ll[2 * b] = ll[2 * b] - to / sigma;
  new_ll[2 * b + 1] = ll[2 * b + 1] - tb / sigma;
}

}  // namespace

extern "C" int sd_or_step_nsplit(int B, int D) {
  // enough blocks to cover the SMs twice, but no chunk under 1024 elements
  int want = (264 + B - 1) / B;
  int most = (D + 1023) / 1024;
  int n = want < most ? want : most;
  return n < 1 ? 1 : n;
}

extern "C" int sd_or_step_launch(const void* v_obj, const void* v_bg, const void* v_unc,
                                 const void* x, const void* eps, const void* ll,
                                 void* new_x, void* new_ll, void* kappa, void* partial,
                                 int B, int D, int nsplit, float sigma, float dsigma,
                                 float temperature, float logp, float guidance,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunk = (D + nsplit - 1) / nsplit;
  or_step_pass1<<<dim3(nsplit, B), kThreads, 0, s>>>(
      static_cast<const float*>(v_obj), static_cast<const float*>(v_bg),
      static_cast<const float*>(v_unc), static_cast<const float*>(x),
      static_cast<const float*>(eps), static_cast<const float*>(ll),
      static_cast<float*>(new_x), static_cast<float*>(partial), D, chunk, sigma, dsigma,
      temperature, logp, guidance);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  or_step_pass2<<<(B + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(ll), static_cast<const float*>(partial),
      static_cast<float*>(new_ll), static_cast<float*>(kappa), B, nsplit, sigma,
      temperature, logp);
  return static_cast<int>(cudaGetLastError());
}
