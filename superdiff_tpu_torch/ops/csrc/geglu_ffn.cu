// Fused LayerNorm + GEGLU feed-forward + residual, for Hopper (sm_90a).
//
// Replaces the TPU kernel superdiff_tpu/ops/pallas/geglu_ffn.py::_kernel
// (called through _ffn_impl from geglu_ffn_block and geglu_ffn):
//
//   out = x + (v * gelu(g)) W2^T + b2,   [v | g] = LN(x) W1^T + b1
//
// or, unfused (geglu_ffn: no LayerNorm, no residual), out = (v * gelu(g))
// W2^T + b2 with [v | g] = x W1^T + b1. Two compile-time choices of the
// TPU kernel's: the gelu flavour (the erf polynomial below, or tanh as
// jax.nn.gelu(approximate=True) computes it in fp32, with tanhf) and LN +
// residual on or off (off: the LN launch is skipped, geglu_up reads x as
// the TPU kernel's xn_ref[:] = x_ref[:] does, geglu_down adds no x).
//
// with the LayerNorm in fp32 (fast variance max(E[x^2] - mu^2, 0)), bf16
// operands, fp32 accumulation and fp32 bias adds, LN(x) and the gated hidden
// h rounded to bf16 before their products, as the TPU kernel does, and its
// gelu: the FMA-only polynomial of _gelu_kernel (within 1.2e-6 of the exact
// erf gelu). Weights arrive in PyTorch's Linear layout: W1 (2F, C) with the
// value half first, W2 (C, F). gamma, beta, b1 and b2 are read as stored,
// bf16 or fp32 (a bit each in `vec_bf16`).
//
// Bound on the H100: operations. Each main-path block at C in {320, 640,
// 1280}, F = 4C, M = 24 * {4096, 1024, 256} does 6 M C F = 242 GFLOP
// (0.24 ms at 989 TFLOP/s); at C = 320 the down-projection alone is bound
// by the bytes of h (M F 2 bytes read).
//
// Design. A (bm, C) fp32 accumulator at C = 1280 does not fit an SM, so the
// block is split where the TPU kernel rounds anyway, into three launches:
//   1. geglu_ln:   LN(x) * gamma + beta -> xn bf16 (M, C), 8-32 lanes per
//                  row, 16-byte loads of x, gamma and beta;
//   2. geglu_up:   xn W1^T, then + b1, h = v * gelu(g) -> bf16 (M, F);
//   3. geglu_down: h W2^T + b2 + x -> bf16 (M, C).
// Both products run on one persistent, warp-specialised wgmma core
// (gemm_body), launched on clusters of two CTAs, one CTA per SM. A cluster
// walks pairs of 128-row panels (rank r takes panel 2 pair + r) times
// column tiles, p = cluster, + clusters, ... (column tiles innermost, so
// the clusters in flight share the A panels through L2). In each CTA, of
// the producer warpgroup, thread 256 keeps a ring of 64-deep k blocks full
// by TMA (128-byte swizzle, mbarriers; 4 stages up, 5 down): its own A box
// (128 rows of xn or h) and half of the B rows both CTAs use, multicast
// into both, so each B row crosses L2 once per cluster (geglu_up: rank 0
// the 128 value rows of W1, rank 1 the 128 matching gate rows F + n0..;
// geglu_down: 80 of the 160 rows of W2 each). A stage is refilled once
// every consumer warp of both CTAs released it. Thread 288 stores each
// finished tile by TMA from the staging tile (and, in geglu_down, then
// loads the next tile's residual x into it), so no consumer waits for a
// store. Both consumer warpgroups work on one tile, 64 rows each, one
// m64nNk16 SS wgmma per k16 step: geglu_up 128 x 256 (128 value and the
// matching 128 gate columns, so each thread holds v and g of the same h
// element; a 128-register accumulator), geglu_down 128 x 160 (C in {320,
// 640, 1280} is a whole number of tiles). Wide tiles keep shared memory
// under its 128 bytes a clock: two consumers taking 128 x 128 tiles in
// turns (ping-pong, which hides one's epilogue under the other's products)
// asked for about 160 bytes a clock of TMA writes and wgmma reads, and the
// products ran at 69 % of the tensor peak against 95 % here, which beat the
// overlap (so did two 128 x 128 accumulators, the next tile's products
// issued between this one's epilogue steps: slower than either). The
// epilogue runs while thread 256 fills the ring for the next
// tile: geglu_up adds b1 and computes the gelu polynomial on the FP32 pipe
// into the staging tile (two 64-column boxes, 128-byte swizzle);
// geglu_down adds b2 and the residual x (five 32-column boxes, 64-byte
// swizzle) in fp32, in place. Tensor maps zero-fill and clip the last row
// panel (any M; a pair's second panel may lie wholly past M and stores
// nothing) and the last column tile (C and F multiples of 64).
//
// What binds it (measured, PERF.md §6): the products run near the tensor peak;
// geglu_up's epilogue (about 23 FP32 operations per h element) does not
// overlap them and costs about as much again at C = 320; geglu_down at C =
// 320 moves h from HBM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "sm90_common.cuh"

namespace sdt {
namespace sm90 {
namespace {  // internal linkage, as sm90_common.cuh says why

constexpr int kCols = 64;           // C and F must be multiples of it (one TMA box wide)
constexpr int kRows = 128;          // rows of a tile
constexpr int kThreads = 384;       // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kBox = kRows * 128;   // one (128 rows, 64 columns) bf16 box, 16 KB
constexpr int kLnThreads = 256;

// Both consumers on one tile, 64 rows each (one m64nNk16 SS wgmma per k16
// step): geglu_up 128 x 256 (128 value + 128 gate columns of [v | g], 128
// columns of h), geglu_down 128 x 160 (columns of out)
template <bool UP>
struct Cfg {
  static constexpr int N = UP ? 256 : 160;      // wgmma N
  static constexpr int TN = UP ? 128 : 160;     // output columns of a tile
  static constexpr int STAGE = kBox + N * 128;  // A box + N rows of B, 64 deep
  static constexpr int STAGES = UP ? 4 : 5;
  // the output tile: up h in two (128 rows, 64 columns) boxes, 128-byte
  // swizzle; down x, then out, in five (128, 32) boxes, 64-byte swizzle
  static constexpr int SBOX = UP ? kBox : kRows * 64;
  static constexpr int STAGING = UP ? 2 * kBox : 5 * kRows * 64;
  // alignment slack, barriers, the ring, the staging tile
  static constexpr int SMEM = 1024 + 1024 + STAGES * STAGE + STAGING;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// gelu as the TPU kernel computes it (geglu_ffn.py::_gelu_kernel): Phi(x) - 1/2
// = xc * p(n) with xc = clamp(x, +-5.5), n = xc^2 * 2 / 5.5^2 - 1, p of degree
// 14 by Horner, gelu = x * (1/2 + xc * p); K values in lockstep, in place
template <int K>
__device__ __forceinline__ void gelu_poly(float (&x)[K]) {
  constexpr float kCoef[15] = {
      1.285519294e-01f, -6.417257621e-02f, 4.773779589e-02f, -3.878402957e-02f,
      3.206722320e-02f, -2.614160622e-02f, 2.038480692e-02f, -1.456035862e-02f,
      1.016421201e-02f, -7.878193782e-03f, 4.723569624e-03f, -1.051773090e-03f,
      6.399065034e-04f, -1.428040806e-03f, 6.562366469e-04f};
  float xc[K], n[K], p[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    xc[i] = fminf(fmaxf(x[i], -5.5f), 5.5f);
    n[i] = xc[i] * xc[i] * (2.0f / (5.5f * 5.5f)) - 1.0f;
    p[i] = kCoef[14];
  }
#pragma unroll
  for (int j = 13; j >= 0; --j) {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = fmaf(p[i], n[i], kCoef[j]);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) x[i] *= fmaf(xc[i], p[i], 0.5f);
}

// gelu as jax.nn.gelu(approximate=True) computes it in fp32:
// x * 0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), tanhf (not tanh.approx)
template <int K>
__device__ __forceinline__ void gelu_tanh(float (&x)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float inner = 0.7978845608028654f * (x[i] + 0.044715f * (x[i] * x[i] * x[i]));
    x[i] = x[i] * (0.5f * (1.0f + tanhf(inner)));
  }
}

// two neighbouring values of a bias vector of T (bf16 or fp32), loaded as one
template <typename T>
using pair_t = std::conditional_t<sizeof(T) == 2, __nv_bfloat162, float2>;
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 to_float2(float2 v) { return v; }

// values i .. i + 7 (16-byte loads)
__device__ __forceinline__ void vec8(const void* p, int i, bool bf, float (&out)[8]) {
  if (bf) {
    const uint4 u = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + i);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 a = q[0], b = q[1];
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  }
}

// `lanes` (8, 16 or 32) lanes per row, five 16-byte chunks each at C = 320,
// 640 and 1280, so a warp keeps its loads busy at C = 320 (40 chunks a row)
// and the rows of C = 1280 still spread over the SMs; the second pass over
// x reads L1
__global__ void __launch_bounds__(kLnThreads)
geglu_ln(const bf16* __restrict__ x, const void* __restrict__ gamma,
         const void* __restrict__ beta, int vec_bf16, bf16* __restrict__ xn, int M, int C,
         float eps, int lanes) {
  const int sub = threadIdx.x % lanes;
  const size_t row = static_cast<size_t>(blockIdx.x) * (kLnThreads / lanes) + threadIdx.x / lanes;
  // rows past M compute on the last row (every lane takes part in the
  // shuffles) and store nothing
  const bf16* xr = x + min(row, static_cast<size_t>(M - 1)) * C;
  float s = 0.0f, ss = 0.0f;
  for (int c = sub * 8; c < C; c += lanes * 8) {
    float e[8];
    vec8(xr, c, true, e);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s += e[u];
      ss += e[u] * e[u];
    }
  }
#pragma unroll
  for (int off = lanes / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (row >= static_cast<size_t>(M)) return;
  const float mu = s / C;
  const float rs = rsqrtf(fmaxf(ss / C - mu * mu, 0.0f) + eps);
  for (int c = sub * 8; c < C; c += lanes * 8) {
    float e[8], ga[8], be[8];
    vec8(xr, c, true, e);
    vec8(gamma, c, vec_bf16 & 1, ga);
    vec8(beta, c, vec_bf16 & 2, be);
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      op[u] = pack_bf16x2((e[2 * u] - mu) * rs * ga[2 * u] + be[2 * u],
                          (e[2 * u + 1] - mu) * rs * ga[2 * u + 1] + be[2 * u + 1]);
    }
    *reinterpret_cast<uint4*>(xn + row * C + c) = o;
  }
}

// The persistent GEMM of both products. UP: A = xn, or x unfused (M, K =
// C), B = W1 (2N, K), N = F, epilogue GEGLU (tanh gelu if TANH) -> h
// (tensor map `to`). Down: A = h (M, K = F), B = W2 (N, K), N = C, residual
// x (map `tx`) if RESID, out (`to`). `bias`: b1 (2N) or b2 (N), of T (bf16
// or fp32).
template <bool UP, typename T, bool TANH = false, bool RESID = true>
__device__ __forceinline__ void gemm_body(const CUtensorMap& ta, const CUtensorMap& tb,
                                          const CUtensorMap& tx, const CUtensorMap& to,
                                          const T* __restrict__ bias, int M, int N, int K) {
  using G = Cfg<UP>;
  constexpr int ST = G::STAGES, TN = G::TN, WN = G::N;
  // geglu_down with the residual loads x into the staging tile; every other
  // body waits for the last store to have read it (sempty)
  constexpr bool LOADX = !UP && RESID;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle atoms want 1024-byte alignment
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_full = base, bar_empty = base + 64;     // the k-block ring
  // the staging tile: written by the consumers (sfull), free again once its
  // store has read it (sempty; down: its x for the next tile loaded, xfull)
  const uint32_t bar_sfull = base + 128, bar_sempty = base + 136, bar_xfull = base + 144;
  const uint32_t sst = base + 1024;           // stage s: A at sst + s * STAGE, then B
  const uint32_t stg = sst + ST * G::STAGE;   // the staging tile
  unsigned char* stg_p = gbase + (stg - base);

  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  // the cluster's pair of row panels: this CTA's is 2 * (pair) + rank
  const uint32_t rank = cluster_rank();
  const int n_n = (N + TN - 1) / TN, n_mp = ((M + kRows - 1) / kRows + 1) / 2;
  const int pairs = n_mp * n_n, nk = K / 64;
  const int cl = blockIdx.x / 2, n_cl = gridDim.x / 2;
  auto m0_of = [&](int p) { return (p / n_n * 2 + static_cast<int>(rank)) * kRows; };
  // staging boxes of the tile at column n0 that lie inside the N columns
  auto boxes = [&](int n0) {
    const int b = (N - n0) / (UP ? 64 : 32);
    return b < TN / (UP ? 64 : 32) ? b : TN / (UP ? 64 : 32);
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 16);  // lane 0 of every consumer warp, both CTAs
    }
    mbar_init(bar_sfull, 8);  // lane 0 of every consumer warp
    mbar_init(bar_sempty, 1);
    mbar_init(bar_xfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both CTAs' barriers exist before either multicasts or arrives

  if (wg == 2) {
    // ---- producer warpgroup: thread 256 keeps the ring full, thread 288
    // stores each tile (and loads geglu_down's next residual tile) ----
    setmaxnreg_dec<40>();
    if (tid == 256) {
      int it = 0;
      for (int i = 0, p = cl; p < pairs; ++i, p += n_cl) {
        const int m0 = m0_of(p), n0 = p % n_n * TN;
        for (int k = 0; k < nk; ++k, ++it) {
          const int s = it % ST;
          mbar_wait(bar_empty + 8 * s, ((it / ST) & 1) ^ 1);
          const uint32_t bar = bar_full + 8 * s, sa = sst + s * G::STAGE, sb = sa + kBox;
          mbar_expect_tx(bar, G::STAGE);
          tma_load(sa, &ta, bar, k * 64, m0, 0, 0);
          // this CTA's half of the tile's B rows, into both CTAs: geglu_up
          // rank 0 the 128 value rows of W1, rank 1 their gate rows
          // F + n0..; geglu_down 80 of the 160 W2 rows each (zeros past C)
          const int r = static_cast<int>(rank);
          tma_load_multicast(sb + rank * (WN / 2) * 128, &tb, bar, 3, k * 64,
                             UP ? n0 + r * N : n0 + (WN / 2) * r, 0, 0);
        }
      }
    } else if (tid == 288) {
      // the tile's x into the staging tile
      auto load_x = [&](int p) {
        const int m0 = m0_of(p), n0 = p % n_n * TN, nb = boxes(n0);
        mbar_expect_tx(bar_xfull, nb * G::SBOX);
        for (int b = 0; b < nb; ++b) {
          tma_load(stg + b * G::SBOX, &tx, bar_xfull, n0 + 32 * b, m0, 0, 0);
        }
      };
      if (LOADX && cl < pairs) load_x(cl);
      for (int i = 0, p = cl; p < pairs; ++i, p += n_cl) {
        const int m0 = m0_of(p), n0 = p % n_n * TN, nb = boxes(n0);
        mbar_wait(bar_sfull, i & 1);
        if (m0 < M) {  // (the pair's second panel may lie past M)
          for (int b = 0; b < nb; ++b) {
            tma_store(&to, stg + b * G::SBOX, n0 + (UP ? 64 : 32) * b, m0, 0, 0);
          }
          tma_store_wait_read();
        }
        if constexpr (!LOADX) {
          mbar_arrive(bar_sempty);
        } else if (p + n_cl < pairs) {
          load_x(p + n_cl);
        }
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: rows 64 wg.. of every tile ----
    setmaxnreg_inc<232>();
    const int t = tid % 128, warp = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
    float acc[WN / 2];
    // the stage of ring position `it` is free once every consumer warp of
    // both CTAs has read it
    auto release = [&](int it) {
      if (lane == 0) {
        mbar_arrive_rank(bar_empty + 8 * (it % ST), 0);
        mbar_arrive_rank(bar_empty + 8 * (it % ST), 1);
      }
    };
    for (int i = 0, p = cl; p < pairs; ++i, p += n_cl) {
      const int m0 = m0_of(p), n0 = p % n_n * TN, nb = boxes(n0);
      fence_regs(acc);
      for (int k = 0; k < nk; ++k) {
        const int it = i * nk + k, s = it % ST;
        mbar_wait(bar_full + 8 * s, (it / ST) & 1);
        const uint32_t sa = sst + s * G::STAGE + wg * 64 * 128, sb = sst + s * G::STAGE + kBox;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<WN, 0, 0>(acc, desc_k(sa + kk * 32), desc_k(sb + kk * 32), k > 0 || kk > 0);
        }
        wgmma_commit();
        if (k > 0) {
          wgmma_wait<1>();  // k block k - 1 read
          release(it - 1);
        }
      }
      wgmma_wait0();
      fence_regs(acc);
      release(i * nk + nk - 1);

      // ---- epilogue: thread (warp, g, q) holds rows 64 wg + 16 warp + g
      // (+ 8 for acc[4 c + 2], [4 c + 3]) and columns 8 c + 2 q (+ 1); column
      // 8 c of the output is 16-byte chunk j of staging box b, stored in the
      // TMA swizzle: chunk j of row r at j ^ (r % 8) (128-byte rows), at
      // j ^ (r / 2 % 4) (64-byte rows); r % 8 = g ----
      const int rr = 64 * wg + 16 * warp + g;
      // the bias pairs of this thread's columns: c at bp[4 c]
      const pair_t<T>* bp = reinterpret_cast<const pair_t<T>*>(bias) + (n0 + 2 * q) / 2;
      if constexpr (UP) {
        mbar_wait(bar_sempty, (i & 1) ^ 1);  // the last tile's store has read the staging tile
        // v in columns 0-127 of acc, the matching g 128 columns on (their
        // biases N / 2 pairs on)
#pragma unroll
        for (int c = 0; c < TN / 8; ++c) {
          if (c / 8 >= nb) continue;
          const float2 bv = to_float2(bp[4 * c]), bg = to_float2(bp[N / 2 + 4 * c]);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            float gv[2] = {acc[4 * (c + TN / 8) + 2 * hr] + bg.x,
                           acc[4 * (c + TN / 8) + 2 * hr + 1] + bg.y};
            if constexpr (TANH) {
              gelu_tanh(gv);
            } else {
              gelu_poly(gv);
            }
            *reinterpret_cast<uint32_t*>(stg_p + (c / 8) * kBox + (rr + 8 * hr) * 128 +
                                         (((c % 8) ^ g) << 4) + 4 * q) =
                pack_bf16x2((acc[4 * c + 2 * hr] + bv.x) * gv[0],
                            (acc[4 * c + 2 * hr + 1] + bv.y) * gv[1]);
          }
        }
      } else {
        if constexpr (LOADX) {
          mbar_wait(bar_xfull, i & 1);
        } else {
          mbar_wait(bar_sempty, (i & 1) ^ 1);
        }
#pragma unroll
        for (int c = 0; c < TN / 8; ++c) {
          if (c / 4 >= nb) continue;
          const float2 bb = to_float2(bp[4 * c]);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            uint32_t* px = reinterpret_cast<uint32_t*>(
                stg_p + (c / 4) * G::SBOX + (rr + 8 * hr) * 64 + (((c % 4) ^ (g / 2)) << 4) +
                4 * q);
            const float* a = &acc[4 * c + 2 * hr];
            if constexpr (RESID) {
              const float2 xv = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(px));
              *px = pack_bf16x2(a[0] + bb.x + xv.x, a[1] + bb.y + xv.y);
            } else {
              *px = pack_bf16x2(a[0] + bb.x, a[1] + bb.y);
            }
          }
        }
      }
      // written: the storer may store it (each thread's writes made visible
      // to the async proxy, the warp's lane 0 arrives for the warp)
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_sfull);
    }
  }
  cluster_sync();  // no CTA leaves while the other may still arrive on its barriers
}

template <typename T, bool TANH>
__global__ void __launch_bounds__(kThreads, 1)
geglu_up(const __grid_constant__ CUtensorMap txn, const __grid_constant__ CUtensorMap tw1,
         const __grid_constant__ CUtensorMap th, const T* __restrict__ b1, int M, int F, int C) {
  gemm_body<true, T, TANH>(txn, tw1, th, th, b1, M, F, C);
}

template <typename T, bool RESID>
__global__ void __launch_bounds__(kThreads, 1)
geglu_down(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw2,
           const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tout,
           const T* __restrict__ b2, int M, int C, int F) {
  gemm_body<false, T, false, RESID>(th, tw2, tx, tout, b2, M, C, F);
}

// the instance of geglu_up / geglu_down for a bias dtype and a choice
template <typename T>
const void* up_kernel(bool tanh_gelu) {
  return tanh_gelu ? reinterpret_cast<const void*>(geglu_up<T, true>)
                   : reinterpret_cast<const void*>(geglu_up<T, false>);
}
template <typename T>
const void* down_kernel(bool resid) {
  return resid ? reinterpret_cast<const void*>(geglu_down<T, true>)
               : reinterpret_cast<const void*>(geglu_down<T, false>);
}

// geometry row of a row-major bf16 (rows, cols) matrix as a 4-D tensor map
// of (box_cols columns, box_rows rows) boxes, swizzled by `swizzle` bytes
void matrix_geom(long long* g, long long rows, long long cols, long long box_rows,
                 long long box_cols = 64, long long swizzle = 128) {
  const long long row_bytes = cols * 2;
  const long long v[kGeomLen] = {cols, rows, 1, 1, row_bytes, row_bytes * rows,
                                 row_bytes * rows, box_cols, box_rows, swizzle};
  for (int i = 0; i < kGeomLen; ++i) g[i] = v[i];
}

// a launch of `kernel` on clusters of two CTAs, `clusters` of them
cudaLaunchConfig_t pair_config(cudaLaunchAttribute& attr, int clusters, int smem,
                               cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of two that fit on the card at once (the persistent grid)
int max_clusters(const void* kernel, int smem) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pair_config(attr, sm_count() / 2, smem, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n < 1) {
    cudaGetLastError();
    n = sm_count() / 2;
  }
  return n;
}

}  // namespace
}  // namespace sm90
}  // namespace sdt

// vec_bf16: bit 0 gamma, bit 1 beta, bit 2 b1, bit 3 b2 stored as bf16 (else
// fp32). mode: bit 0 the tanh gelu (else the erf polynomial), bit 1 LN and
// residual (else neither: gamma, beta and xn unused). C and F multiples of
// 64, M >= 1; xn (M, C) and h (M, F) scratch. 0, a cudaError_t, or a
// refused tensor-map encoding's CUresult negated.
extern "C" int geglu_block_launch(const void* x, const void* gamma, const void* beta,
                                  const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* xn, void* h, void* out, int M, int C,
                                  int F, float eps, int vec_bf16, int mode, void* stream) {
  using namespace sdt::sm90;
  if (M < 1 || C % kCols || F % kCols) return static_cast<int>(cudaErrorInvalidValue);
  const bool tanh_gelu = mode & 1, fused = mode & 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // xn, W1, h, W2, x, out
  long long geom[6 * kGeomLen];
  matrix_geom(geom + 0 * kGeomLen, M, C, kRows);
  matrix_geom(geom + 1 * kGeomLen, 2LL * F, C, 128);
  matrix_geom(geom + 2 * kGeomLen, M, F, kRows);
  matrix_geom(geom + 3 * kGeomLen, C, F, Cfg<false>::N / 2);
  matrix_geom(geom + 4 * kGeomLen, M, C, kRows, 32, 64);
  matrix_geom(geom + 5 * kGeomLen, M, C, kRows, 32, 64);
  CUtensorMap maps[6];
  const void* const ptrs[6] = {fused ? xn : x, w1, h, w2, x, out};
  if (const int err = encode_maps(maps, ptrs, geom)) return err;
  // the kernels for biases of the stored dtype, and how many clusters of
  // each fit on the card at once
  const bool b1_bf16 = vec_bf16 & 4, b2_bf16 = vec_bf16 & 8;
  const void* up = b1_bf16 ? up_kernel<bf16>(tanh_gelu) : up_kernel<float>(tanh_gelu);
  const void* down = b2_bf16 ? down_kernel<bf16>(fused) : down_kernel<float>(fused);
  static int clusters[2][2][2] = {};  // [up / down][bias bf16][tanh / residual]
  int& up_clusters = clusters[0][b1_bf16][tanh_gelu];
  int& down_clusters = clusters[1][b2_bf16][fused];
  if (up_clusters == 0) {
    cudaFuncSetAttribute(up, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<true>::SMEM);
    up_clusters = max_clusters(up, Cfg<true>::SMEM);
  }
  if (down_clusters == 0) {
    cudaFuncSetAttribute(down, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<false>::SMEM);
    down_clusters = max_clusters(down, Cfg<false>::SMEM);
  }
  cudaError_t err;
  if (fused) {
    const int lanes = C <= 320 ? 8 : C <= 640 ? 16 : 32, ln_rows = kLnThreads / lanes;
    geglu_ln<<<(M + ln_rows - 1) / ln_rows, kLnThreads, 0, s>>>(
        static_cast<const bf16*>(x), gamma, beta, vec_bf16, static_cast<bf16*>(xn), M, C, eps,
        lanes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // pairs of row panels times column tiles: one cluster per pair
  const int m_pairs = ((M + kRows - 1) / kRows + 1) / 2;
  const int up_pairs = m_pairs * ((F + Cfg<true>::TN - 1) / Cfg<true>::TN);
  const int down_pairs = m_pairs * ((C + Cfg<false>::TN - 1) / Cfg<false>::TN);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      pair_config(attr, up_pairs < up_clusters ? up_pairs : up_clusters, Cfg<true>::SMEM, s);
  void* up_args[] = {&maps[0], &maps[1], &maps[2], &b1, &M, &F, &C};
  err = cudaLaunchKernelExC(&cfg, up, up_args);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg = pair_config(attr, down_pairs < down_clusters ? down_pairs : down_clusters,
                    Cfg<false>::SMEM, s);
  void* down_args[] = {&maps[2], &maps[3], &maps[4], &maps[5], &b2, &M, &C, &F};
  err = cudaLaunchKernelExC(&cfg, down, down_args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
