// Fused LayerNorm + GEGLU feed-forward + residual, for Hopper (sm_90a).
//
// Replaces the TPU kernel superdiff_tpu/ops/pallas/geglu_ffn.py::_kernel
// (called through _ffn_impl from geglu_ffn_block):
//
//   out = x + (v * gelu_erf(g)) W2^T + b2,   [v | g] = LN(x) W1^T + b1
//
// with the LayerNorm in fp32 (fast variance max(E[x^2] - mu^2, 0)), bf16
// operands, fp32 accumulation and fp32 biases, and LN(x) and the gated
// hidden h rounded to bf16 before their products, as the TPU kernel does.
// Weights arrive in PyTorch's Linear layout: W1 (2F, C) with the value half
// first, W2 (C, F).
//
// Bound on the H100: operations. Each main-path block at C in {320, 640,
// 1280}, F = 4C, M = 24 * {4096, 1024, 256} does 6 M C F = 242 GFLOP
// (0.24 ms at 989 TFLOP/s); its bytes are far below the ridge point.
//
// Design. A (bm, C) fp32 accumulator at C = 1280 does not fit one SM's
// registers or shared memory for a useful bm, so the block is split where
// the TPU kernel rounds anyway, into three launches:
//   1. geglu_ln:   LN(x) * gamma + beta -> xn bf16 (M, C), one warp per row;
//   2. geglu_up:   xn W1^T for 64 value and the matching 64 gate columns,
//                  + b1, exact erf gelu, h = v * gelu(g) -> bf16 (M, F);
//   3. geglu_down: h W2^T + b2 + x -> bf16 (M, C).
// No number changes; the cost is xn and h written and read back (M*(C+F)*2
// bytes each way). Both products are one tiled mma.sync GEMM: 128-row block
// tiles, 8 warps of 32 rows, 32-deep k tiles in a 3-stage cp.async ring,
// fragments by ldmatrix. wgmma and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;            // block rows
constexpr int kBK = 32;             // k tile
constexpr int kLd = kBK + 8;        // smem row stride (80 B: 16 B rows, no ldmatrix conflicts)
constexpr int kStages = 3;
constexpr int kThreads = 256;       // 8 warps: 4 along M x 2 along N
constexpr int kUpCols = 64;         // geglu_up: value columns per block (and as many gate)
constexpr int kDownCols = 64;       // geglu_down: output columns per block

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

// One block tile of A (kBM x K, row-major, lda; only the first `rows` rows
// exist, the others re-read the last one and are never stored) times B^T,
// where the block's `kBRows` B rows (k contiguous) start at `brow(r)`. Warp
// (wm, wn) accumulates rows [wm*32, +32) against smem B rows [wn*NT*8, +NT*8).
template <int NT, typename BRow>
__device__ __forceinline__ void block_gemm(float (&acc)[2][NT][4], const bf16* a, size_t lda,
                                           int rows, const BRow& brow, int K, bf16* smem) {
  constexpr int kBRows = 2 * NT * 8;
  constexpr int kStage = (kBM + kBRows) * kLd;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;

  auto load = [&](int stage, int k0) {
    bf16* sa = smem + stage * kStage;
    bf16* sb = sa + kBM * kLd;
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      sdt::cp_async16(sa + r * kLd + c, a + min(r, rows - 1) * lda + k0 + c);
    }
    for (int i = tid; i < kBRows * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      sdt::cp_async16(sb + r * kLd + c, brow(r) + k0 + c);
    }
  };

  const int nk = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kBK);
    sdt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    sdt::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, (kt + kStages - 1) * kBK);
    sdt::cp_async_commit();
    const bf16* sa = smem + (kt % kStages) * kStage;
    const bf16* sb = sa + kBM * kLd;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        sdt::ldmatrix_x4(af[mi], sa + (wm * 32 + mi * 16 + lane % 16) * kLd + ks * 16 +
                                     (lane / 16) * 8);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t bfr[4];
        sdt::ldmatrix_x4(bfr, sb + (wn * NT * 8 + jp * 16 + lane % 8 + (lane / 16) * 8) * kLd +
                                  ks * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          sdt::mma_bf16_16816(acc[mi][2 * jp], af[mi], bfr[0], bfr[1]);
          sdt::mma_bf16_16816(acc[mi][2 * jp + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  sdt::cp_async_wait<0>();
}

template <int NT>
constexpr int smem_bytes() {
  return kStages * (kBM + 2 * NT * 8) * kLd * static_cast<int>(sizeof(bf16));
}

__global__ void __launch_bounds__(kThreads)
geglu_ln(const bf16* __restrict__ x, const float* __restrict__ gamma,
         const float* __restrict__ beta, bf16* __restrict__ xn, int M, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const size_t row = static_cast<size_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= static_cast<size_t>(M)) return;
  const bf16* xr = x + row * C;
  float s = 0.0f, ss = 0.0f;
  for (int c = lane * 8; c < C; c += 32 * 8) {
    const uint4 chunk = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&chunk);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float v = __bfloat162float(e[u]);
      s += v;
      ss += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float mu = s / C;
  const float rs = rsqrtf(fmaxf(ss / C - mu * mu, 0.0f) + eps);
  for (int c = lane * 8; c < C; c += 32 * 8) {
    const uint4 chunk = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&chunk);
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float a = (__bfloat162float(e[2 * u]) - mu) * rs * gamma[c + 2 * u] + beta[c + 2 * u];
      const float b =
          (__bfloat162float(e[2 * u + 1]) - mu) * rs * gamma[c + 2 * u + 1] + beta[c + 2 * u + 1];
      op[u] = sdt::pack_f32(a, b);
    }
    *reinterpret_cast<uint4*>(xn + row * C + c) = o;
  }
}

// Smem B rows of a geglu_up block: warp wn's 64 rows are its 32 value rows
// (W1 rows n0 + wn*32 + i) followed by the matching 32 gate rows (F + ...),
// so one thread holds v and g of the same output element.
__global__ void __launch_bounds__(kThreads)
geglu_up(const bf16* __restrict__ xn, const bf16* __restrict__ w1,
         const float* __restrict__ b1, bf16* __restrict__ h, int M, int C, int F) {
  constexpr int NT = 8;  // per warp: 4 value + 4 gate n-tiles of 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * kUpCols;
  const size_t m0 = static_cast<size_t>(blockIdx.y) * kBM;
  auto brow = [&](int r) {
    const int wn = r / 64, i = r % 64;
    const int n = n0 + wn * 32 + (i % 32) + (i >= 32 ? F : 0);
    return w1 + static_cast<size_t>(n) * C;
  };
  float acc[2][NT][4] = {};
  block_gemm<NT>(acc, xn + m0 * C, C, min(kBM, static_cast<int>(M - m0)), brow, C, smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * t;
      const size_t r0 = m0 + wm * 32 + mi * 16 + g;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (r0 + 8 * hr >= static_cast<size_t>(M)) continue;
        const float* av = &acc[mi][j][2 * hr];
        const float* ag = &acc[mi][j + NT / 2][2 * hr];
        const float h0 = (av[0] + b1[n]) * gelu_erf(ag[0] + b1[F + n]);
        const float h1 = (av[1] + b1[n + 1]) * gelu_erf(ag[1] + b1[F + n + 1]);
        *reinterpret_cast<uint32_t*>(h + (r0 + 8 * hr) * F + n) = sdt::pack_f32(h0, h1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
geglu_down(const bf16* __restrict__ h, const bf16* __restrict__ w2,
           const float* __restrict__ b2, const bf16* __restrict__ x,
           bf16* __restrict__ out, int M, int C, int F) {
  constexpr int NT = 4;  // per warp: 32 output columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n0 = blockIdx.x * kDownCols;
  const size_t m0 = static_cast<size_t>(blockIdx.y) * kBM;
  auto brow = [&](int r) { return w2 + static_cast<size_t>(n0 + r) * F; };
  float acc[2][NT][4] = {};
  block_gemm<NT>(acc, h + m0 * F, F, min(kBM, static_cast<int>(M - m0)), brow, F, smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * t;
      const size_t r0 = m0 + wm * 32 + mi * 16 + g;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (r0 + 8 * hr >= static_cast<size_t>(M)) continue;
        const size_t off = (r0 + 8 * hr) * C + n;
        const float* a = &acc[mi][j][2 * hr];
        const float o0 = a[0] + b2[n] + __bfloat162float(x[off]);
        const float o1 = a[1] + b2[n + 1] + __bfloat162float(x[off + 1]);
        *reinterpret_cast<uint32_t*>(out + off) = sdt::pack_f32(o0, o1);
      }
    }
  }
}

}  // namespace

// Column tile: C and F must be multiples of it (M may be any size).
extern "C" int geglu_col_tile() { return kUpCols; }

extern "C" int geglu_block_launch(const void* x, const void* gamma, const void* beta,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* xn, void* h, void* out, int M, int C,
                                  int F, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int up_smem = smem_bytes<8>(), down_smem = smem_bytes<4>();
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(geglu_up, cudaFuncAttributeMaxDynamicSharedMemorySize, up_smem);
    cudaFuncSetAttribute(geglu_down, cudaFuncAttributeMaxDynamicSharedMemorySize, down_smem);
    configured = true;
  }
  const bf16* xb = static_cast<const bf16*>(x);
  geglu_ln<<<(M + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      xb, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<bf16*>(xn), M, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (M + kBM - 1) / kBM;
  geglu_up<<<dim3(F / kUpCols, m_tiles), kThreads, up_smem, s>>>(
      static_cast<const bf16*>(xn), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<bf16*>(h), M, C, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  geglu_down<<<dim3(C / kDownCols, m_tiles), kThreads, down_smem, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), xb, static_cast<bf16*>(out), M, C, F);
  return static_cast<int>(cudaGetLastError());
}
