// Long-row softmax attention in the d-major layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel superdiff_tpu/ops/pallas/flash_attention.py::
// _make_pvtd_kernel (pvtd1 / pvtd2, called through _flash_eod from
// flash_mha_eod). Layouts as the JAX entry point has them: q, v and the
// output in (B, H, D, L), k in (B, H, L, D) (k may be a strided view with
// unit stride along D). Numerics follow pvtd:
//   * q is pre-scaled by bf16(sm_scale * log2 e) and rounded to bf16;
//   * scores are bf16 x bf16 products accumulated in fp32 (base-2 logits);
//   * p = exp2(s - rowmax) is rounded to bf16 and that same bf16 p feeds both
//     the P.V numerator and the row sum (the TPU kernel's ones row in V^T);
//   * fp32 accumulation, one divide at the end, output in bf16.
//
// Softmax across kv tiles: TWO PASSES over k. Pass 1 computes Q.K^T tile by
// tile and keeps only the row max; pass 2 recomputes the scores and
// accumulates exp2(s - max) against V. Every probability is therefore
// exp2(s - final max), rounded to bf16 once, exactly as pvtd (which holds the
// whole kv row in one block) rounds it, at the cost of one extra Q.K^T.
//
// Bound on the H100 at the main-path shapes (H=8): the 4096-token layer with
// D=40 at B=24 does 4*24*8*4096^2*40 = 515 GFLOP (0.52 ms at 989 TFLOP/s)
// and 3.2e9 exp2 (about 0.8 ms on the SFUs), so it is bound by exp2, not the
// tensor cores; the 1024-token layer (D=80, B=24) is about 64 GFLOP.
// Design: mma.sync m16n8k16 bf16, 8 warps of 16 query rows each (128-row q
// tile, so each K/V tile read from memory serves 128 queries), 64-wide kv
// tiles double-buffered in shared memory with cp.async so the next tile
// loads while this one is multiplied. The QK^T contraction over D=40 is
// padded to 48 with zeros in shared memory. wgmma and TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using sdt::ld_pair;
using sdt::mma_bf16_16816;

constexpr int kWarps = 8;
constexpr int kBQ = kWarps * 16;  // query rows per block
constexpr int kBK = 64;           // kv columns per tile
constexpr int kThreads = kWarps * 32;

template <int D>
struct Shape {
  static constexpr int DP = (D + 15) / 16 * 16;  // QK^T contraction, padded
  static constexpr int KS = DP / 16;             // k-steps of Q.K^T
  static constexpr int NT = D / 8;               // n-tiles of the output
  static constexpr int SK = DP + 8;              // sK row stride (bank spread)
  static constexpr int SV = kBK + 8;             // sV row stride
  static constexpr int SQ = kBQ + 8;             // sQ row stride
  static constexpr int kSmem = (D * SQ + 2 * kBK * SK + 2 * D * SV) * 2;  // bytes
};

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_eod_kernel(const bf16* __restrict__ qt, const bf16* __restrict__ k,
                const bf16* __restrict__ vt, bf16* __restrict__ out, int H, int L,
                long long k_sb, long long k_sh, long long k_sl, float scale) {
  using S = Shape<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // q tile (d-major, reused for o); two k tiles (kv-major); two v tiles (d-major)
  auto sQ = reinterpret_cast<bf16(*)[S::SQ]>(smem_raw);
  auto sKs = reinterpret_cast<bf16(*)[kBK][S::SK]>(smem_raw + D * S::SQ * 2);
  auto sVs = reinterpret_cast<bf16(*)[D][S::SV]>(smem_raw + (D * S::SQ + 2 * kBK * S::SK) * 2);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const bf16* qbase = qt + bh * D * L;
  const bf16* vbase = vt + bh * D * L;
  const bf16* kbase = k + b * k_sb + h * k_sh;
  bf16* obase = out + bh * D * L;

  // zero the padded contraction columns of both k tiles once; loads never
  // touch them
  if constexpr (S::DP > D) {
    for (int i = tid; i < 2 * kBK * (S::DP - D); i += kThreads) {
      const int j = i / (S::DP - D);
      sKs[j / kBK][j % kBK][D + i % (S::DP - D)] = __float2bfloat16_rn(0.0f);
    }
  }
  // q tile (D, kBQ): kBQ / 8 16-byte chunks per d-row
  // (queries past L, in the last tile when L % kBQ != 0, are zeros and are
  // never stored)
  for (int i = tid; i < D * (kBQ / 8); i += kThreads) {
    const int d = i / (kBQ / 8), c = i % (kBQ / 8);
    if (q0 + c * 8 < L) {
      sdt::copy16(&sQ[d][c * 8], qbase + static_cast<size_t>(d) * L + q0 + c * 8);
    } else {
      *reinterpret_cast<uint4*>(&sQ[d][c * 8]) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  // Q fragments, pre-scaled and rounded to bf16 as the TPU kernel does
  const float sc = __bfloat162float(__float2bfloat16_rn(scale));
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  auto qs = [&](int row, int d) -> bf16 {
    if (d >= D) return __float2bfloat16_rn(0.0f);
    return __float2bfloat16_rn(__bfloat162float(sQ[d][row]) * sc);
  };
  uint32_t qf[S::KS][4];
#pragma unroll
  for (int ks = 0; ks < S::KS; ++ks) {
    const int c0 = ks * 16 + 2 * t;
    qf[ks][0] = sdt::pack_bf16(qs(r0, c0), qs(r0, c0 + 1));
    qf[ks][1] = sdt::pack_bf16(qs(r1, c0), qs(r1, c0 + 1));
    qf[ks][2] = sdt::pack_bf16(qs(r0, c0 + 8), qs(r0, c0 + 9));
    qf[ks][3] = sdt::pack_bf16(qs(r1, c0 + 8), qs(r1, c0 + 9));
  }

  // async tile loads into buffer `buf` (one commit group per call)
  auto load_k = [&](int buf, int kv0) {
    for (int i = tid; i < kBK * (D / 8); i += kThreads) {
      const int j = i / (D / 8), c = i % (D / 8);
      sdt::cp_async16(&sKs[buf][j][c * 8], kbase + (kv0 + j) * k_sl + c * 8);
    }
  };
  auto load_v = [&](int buf, int kv0) {
    for (int i = tid; i < D * (kBK / 8); i += kThreads) {
      const int d = i / (kBK / 8), c = i % (kBK / 8);
      sdt::cp_async16(&sVs[buf][d][c * 8], vbase + static_cast<size_t>(d) * L + kv0 + c * 8);
    }
  };
  // Walk the kv tiles with the next tile in flight: `body(buf)` runs on a
  // landed tile; `with_v` also streams V.
  const int n_tiles = L / kBK;
  auto sweep = [&](bool with_v, auto&& body) {
    load_k(0, 0);
    if (with_v) load_v(0, 0);
    sdt::cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
      if (it + 1 < n_tiles) {
        load_k((it + 1) & 1, (it + 1) * kBK);
        if (with_v) load_v((it + 1) & 1, (it + 1) * kBK);
      }
      sdt::cp_async_commit();
      sdt::cp_async_wait<1>();
      __syncthreads();  // tile `it` landed for every thread
      body(it & 1);
      __syncthreads();  // its buffer is free for tile it + 2
    }
    sdt::cp_async_wait<0>();
  };
  auto scores = [&](int buf, float (&s)[kBK / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        const bf16* kr = &sKs[buf][nt * 8 + g][ks * 16 + 2 * t];
        mma_bf16_16816(s[nt], qf[ks], ld_pair(kr), ld_pair(kr + 8));
      }
    }
  };

  // pass 1: row max of the base-2 scores
  float m0 = -INFINITY, m1 = -INFINITY;
  float s[kBK / 8][4];
  sweep(false, [&](int buf) {
    scores(buf, s);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  });
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }

  // pass 2: bf16 probabilities against V, and their row sum
  float o[S::NT][4];
#pragma unroll
  for (int dt = 0; dt < S::NT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;
  sweep(true, [&](int buf) {
    scores(buf, s);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sv = s[2 * kk + half];
        const bf16 p00 = __float2bfloat16_rn(exp2f(sv[0] - m0));
        const bf16 p01 = __float2bfloat16_rn(exp2f(sv[1] - m0));
        const bf16 p10 = __float2bfloat16_rn(exp2f(sv[2] - m1));
        const bf16 p11 = __float2bfloat16_rn(exp2f(sv[3] - m1));
        l0 += __bfloat162float(p00) + __bfloat162float(p01);
        l1 += __bfloat162float(p10) + __bfloat162float(p11);
        pa[2 * half] = sdt::pack_bf16(p00, p01);
        pa[2 * half + 1] = sdt::pack_bf16(p10, p11);
      }
#pragma unroll
      for (int dt = 0; dt < S::NT; ++dt) {
        const bf16* vr = &sVs[buf][dt * 8 + g][kk * 16 + 2 * t];
        mma_bf16_16816(o[dt], pa, ld_pair(vr), ld_pair(vr + 8));
      }
    }
  });
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // o / l, staged d-major through sQ for coalesced stores
#pragma unroll
  for (int dt = 0; dt < S::NT; ++dt) {
    const int d = dt * 8 + 2 * t;
    sQ[d][r0] = __float2bfloat16_rn(o[dt][0] / l0);
    sQ[d + 1][r0] = __float2bfloat16_rn(o[dt][1] / l0);
    sQ[d][r1] = __float2bfloat16_rn(o[dt][2] / l1);
    sQ[d + 1][r1] = __float2bfloat16_rn(o[dt][3] / l1);
  }
  __syncthreads();
  for (int i = tid; i < D * (kBQ / 8); i += kThreads) {
    const int d = i / (kBQ / 8), c = i % (kBQ / 8);
    if (q0 + c * 8 < L) {
      sdt::copy16(obase + static_cast<size_t>(d) * L + q0 + c * 8, &sQ[d][c * 8]);
    }
  }
}

template <int D>
int launch(const void* qt, const void* k, const void* vt, void* out, int B, int H,
           int L, long long k_sb, long long k_sh, long long k_sl, float scale,
           cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(attn_eod_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Shape<D>::kSmem);
    configured = true;
  }
  dim3 grid((L + kBQ - 1) / kBQ, H, B);
  attn_eod_kernel<D><<<grid, kThreads, Shape<D>::kSmem, s>>>(
      static_cast<const bf16*>(qt), static_cast<const bf16*>(k),
      static_cast<const bf16*>(vt), static_cast<bf16*>(out), H, L, k_sb, k_sh, k_sl,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Head dims this library is instantiated for (SD-1.x: 320/8, 640/8, 1280/8;
// D = 160 takes 130 KB of dynamic shared memory, under the opt-in attribute
// that launch<D> sets); the wrapper raises on others.
extern "C" int attn_eod_supports(int D) { return D == 40 || D == 80 || D == 160; }

// kv tile: L must be a multiple of it.
extern "C" int attn_eod_tile() { return kBK; }

extern "C" int attn_eod_launch(const void* qt, const void* k, const void* vt, void* out,
                               int B, int H, int D, int L, long long k_sb, long long k_sh,
                               long long k_sl, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch<40>(qt, k, vt, out, B, H, L, k_sb, k_sh, k_sl, scale, s);
    case 80: return launch<80>(qt, k, vt, out, B, H, L, k_sb, k_sh, k_sl, scale, s);
    case 160: return launch<160>(qt, k, vt, out, B, H, L, k_sb, k_sh, k_sl, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
