// Softmax attention in the (B, H, L, D) layout, for Hopper (sm_90a).
//
// Replaces the TPU kernels of superdiff_tpu/ops/pallas/flash_attention.py
// that flash_mha and flash_mha_bhld reach:
//   mode 0  one kv block, row sum of the fp32 p   _kernel_1block, _kernel_mh,
//                                                 _kernel_mh_nat
//   mode 1  one kv block, row sum of the bf16 p   _kernel_1block_mxsum,
//                                                 _make_pipe_kernel, _make_pvt_kernel
//   mode 2  several kv blocks, online softmax     _kernel
//   mode 3  short kv (<= 128), bf16 row sum,      _kernel_cross_packed
//           shift max(row max, 0) below 128 kv,
//           denominator rounded to bf16
// The six single-block TPU bodies differ among themselves only in how they
// feed the TPU's matrix unit (chains, a transposed P.V, heads per program,
// per-head lane slices of a packed tile); as functions they are modes 0 and
// 1. _kernel_mh_nat is mode 0 on views of the packed (B, L, H*D)
// projections. _kernel_cross_packed multiplies by block-diagonal K and V
// operands with one 128-row kv block per head: its zero-padded columns give
// logits of exactly 0, which take part in the row max, and its denominator
// comes out of a matmul whose bf16 operand rounds the row sum first. Mode 3
// reproduces both roundings and skips the padded work.
//
// q, k, v and the output are (B, H, L, D) views with unit stride along D
// (any batch, head and row strides, so a view of a packed projection or of a
// (B, L, H, D) tensor is taken as it is). Numerics, as the TPU bodies:
//   * q is pre-scaled by bf16(sm_scale * log2 e) and rounded to bf16;
//   * scores are bf16 x bf16 products accumulated in fp32 (base-2 logits);
//   * p is rounded to bf16 for P.V; fp32 accumulation, one divide at the end,
//     bf16 output.
// Modes 0 and 1 run on the wgmma + TMA core of attn_sm90.cuh, its
// (B, H, L, D) instance: two passes over k (row max, then exp2 against V),
// so every p = exp2(s - final row max), as a whole-row kv block gives it;
// they differ only in whether the row sum adds p before (mode 0, on the
// ALUs) or after (mode 1, on the tensor cores) its rounding to bf16. Views
// are read through 4-D tensor maps, whose zero fill covers the kv tail and
// the D = 40 contraction padding; the output is stored by TMA, packed where
// the view is packed.
//
// Modes 2 and 3 run the mma.sync template below. Mode 3 makes two passes
// like modes 0 and 1. Mode 2 makes ONE pass with the running (m, l, acc) in
// fp32 registers: alpha = exp2(m_prev - m_next) rescales l and acc at every
// kv tile, l adds the fp32 p. Its kv tile (64) is not the TPU kernel's
// block_k: the function is the same, only the maximum each bf16 p is
// rounded against moves.
//
// Any kv length: the last kv tile may be partial. In modes 2 and 3 its rows
// past Lk are zero-filled in shared memory and never read from global memory
// (past Lk lie the next batch's rows or the end of the allocation), their
// scores are -inf (out of the max, p exactly 0), and V's zero rows keep
// 0 * V from turning stale shared memory into NaN. The guards are a template
// parameter (TAIL), compiled in only for kv that is not a multiple of 64:
// measured in one call against the code without them, they cost mode 2 five
// per cent at kv 9216 even where none fires.
//
// Bound on the H100 at the main-path shapes (H = 8): per (b, h) the work is
// 4 Lq Lk D flops and Lq Lk exp2. The 9216-token rows (D = 40, B*H = 192) do
// 1.63e10 exp2 (3.9 ms at 4.18e12/s) against 2.6 ms of tensor-core time, so
// exp2 binds; at D = 160 (576 tokens) the tensor cores bind; at kv 77 (the
// text cross-attention) the q and output streams bind.
// Design of modes 2 and 3: mma.sync m16n8k16 bf16, 8 warps of 16 query rows
// (128-row q tile, the last one guarded when L % 128 != 0), 64-wide kv tiles
// double-buffered with cp.async. K fragments are 32-bit shared loads, V
// (row-major, so the P.V contraction runs down its rows) comes through
// ldmatrix.trans. D = 40 pads the QK^T contraction to 48 in shared memory;
// D = 160 takes 129 KB of dynamic shared memory (opt-in attribute).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_sm90.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using sdt::ld_pair;
using sdt::mma_bf16_16816;

constexpr int kWarps = 8;
constexpr int kBQ = kWarps * 16;  // query rows per block
constexpr int kBK = 64;           // kv rows per tile
constexpr int kThreads = kWarps * 32;

constexpr int kSumF32 = 0, kSumBf16 = 1, kOnline = 2, kCross = 3;

template <int D>
struct Shape {
  static constexpr int DP = (D + 15) / 16 * 16;  // QK^T contraction, padded
  static constexpr int KS = DP / 16;             // k-steps of Q.K^T
  static constexpr int NT = D / 8;               // n-tiles of the output
  static constexpr int SK = DP + 8;              // sQ / sK row stride (bank spread)
  // sV row stride: an odd number of 16-byte units, so the eight row
  // addresses of one ldmatrix fall into distinct banks
  static constexpr int SV = (D / 8) % 2 ? D : D + 8;
  static constexpr int kSmem = (kBQ * SK + 2 * kBK * SK + 2 * kBK * SV) * 2;  // bytes
};

// element strides of one (B, H, L, D) view; the D stride is 1
struct Strides {
  long long b, h, l;
};

template <int D, int MODE, bool TAIL>
__global__ void __launch_bounds__(kThreads)
attn_bhld_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Lq, int Lk,
                 Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  using S = Shape<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // q tile (reused for o); two k tiles; two v tiles; all row-major (row, d)
  auto sQ = reinterpret_cast<bf16(*)[S::SK]>(smem_raw);
  auto sKs = reinterpret_cast<bf16(*)[kBK][S::SK]>(smem_raw + kBQ * S::SK * 2);
  auto sVs = reinterpret_cast<bf16(*)[kBK][S::SV]>(smem_raw + (kBQ + 2 * kBK) * S::SK * 2);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qbase = q + b * sq.b + h * sq.h;
  const bf16* kbase = k + b * sk.b + h * sk.h;
  const bf16* vbase = v + b * sv.b + h * sv.h;
  bf16* obase = out + b * so.b + h * so.h;

  // zero the padded contraction columns of both k tiles once; loads never
  // touch them
  if constexpr (S::DP > D) {
    for (int i = tid; i < 2 * kBK * (S::DP - D); i += kThreads) {
      const int j = i / (S::DP - D);
      sKs[j / kBK][j % kBK][D + i % (S::DP - D)] = __float2bfloat16_rn(0.0f);
    }
  }
  // q tile (kBQ, D): D / 8 16-byte chunks per row (rows past Lq, in the last
  // tile when Lq % kBQ != 0, are zeros and are never stored)
  for (int i = tid; i < kBQ * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    if (q0 + r < Lq) {
      sdt::copy16(&sQ[r][c * 8], qbase + (q0 + r) * sq.l + c * 8);
    } else {
      *reinterpret_cast<uint4*>(&sQ[r][c * 8]) = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  // Q fragments, pre-scaled and rounded to bf16 as the TPU kernels do
  const float sc = __bfloat162float(__float2bfloat16_rn(scale));
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  auto qpair = [&](int row, int c) -> uint32_t {
    if (c >= D) return 0u;
    return sdt::pack_f32(__bfloat162float(sQ[row][c]) * sc,
                         __bfloat162float(sQ[row][c + 1]) * sc);
  };
  uint32_t qf[S::KS][4];
#pragma unroll
  for (int ks = 0; ks < S::KS; ++ks) {
    const int c0 = ks * 16 + 2 * t;
    qf[ks][0] = qpair(r0, c0);
    qf[ks][1] = qpair(r1, c0);
    qf[ks][2] = qpair(r0, c0 + 8);
    qf[ks][3] = qpair(r1, c0 + 8);
  }

  // async tile loads into buffer `buf`; rows past Lk (a partial last tile)
  // are zero-filled and not read
  auto load_k = [&](int buf, int kv0) {
    for (int i = tid; i < kBK * (D / 8); i += kThreads) {
      const int j = i / (D / 8), c = i % (D / 8);
      if (!TAIL || kv0 + j < Lk) {
        sdt::cp_async16(&sKs[buf][j][c * 8], kbase + (kv0 + j) * sk.l + c * 8);
      } else {
        *reinterpret_cast<uint4*>(&sKs[buf][j][c * 8]) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto load_v = [&](int buf, int kv0) {
    for (int i = tid; i < kBK * (D / 8); i += kThreads) {
      const int j = i / (D / 8), c = i % (D / 8);
      if (!TAIL || kv0 + j < Lk) {
        sdt::cp_async16(&sVs[buf][j][c * 8], vbase + (kv0 + j) * sv.l + c * 8);
      } else {
        *reinterpret_cast<uint4*>(&sVs[buf][j][c * 8]) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  // Walk the kv tiles with the next tile in flight: `body(buf, kv0)` runs on
  // a landed tile; `with_v` also streams V.
  const int n_tiles = (Lk + kBK - 1) / kBK;
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
      body(it & 1, it * kBK);
      __syncthreads();  // its buffer is free for tile it + 2
    }
    sdt::cp_async_wait<0>();
  };
  // base-2 logits of one kv tile; the columns past Lk of a partial last tile
  // are -inf (out of the row max, p = exp2(-inf) = 0)
  auto scores = [&](int buf, int kv0, float (&s)[kBK / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        const bf16* kr = &sKs[buf][nt * 8 + g][ks * 16 + 2 * t];
        mma_bf16_16816(s[nt], qf[ks], ld_pair(kr), ld_pair(kr + 8));
      }
    }
    if (TAIL && kv0 + kBK > Lk) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (kv0 + nt * 8 + 2 * t + (c & 1) >= Lk) s[nt][c] = -INFINITY;
        }
      }
    }
  };
  auto tile_max = [&](const float (&s)[kBK / 8][4], float& t0, float& t1) {
    t0 = t1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      t0 = fmaxf(t0, fmaxf(s[nt][0], s[nt][1]));
      t1 = fmaxf(t1, fmaxf(s[nt][2], s[nt][3]));
    }
  };
  auto quad_max = [&](float& x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  };

  // row max of the base-2 scores; mode 3 below 128 kv starts at 0, the
  // logit of the TPU kernel's zero-padded kv columns
  const float m_init = (MODE == kCross && Lk < 128) ? 0.0f : -INFINITY;
  float m0 = m_init, m1 = m_init;
  float l0 = 0.0f, l1 = 0.0f;            // row sums (this thread's share)
  float s[kBK / 8][4];
  float o[S::NT][4];
#pragma unroll
  for (int dt = 0; dt < S::NT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;

  if constexpr (MODE != kOnline) {
    // pass 1: the final row max
    sweep(false, [&](int buf, int kv0) {
      scores(buf, kv0, s);
      float t0, t1;
      tile_max(s, t0, t1);
      m0 = fmaxf(m0, t0);
      m1 = fmaxf(m1, t1);
    });
    quad_max(m0);
    quad_max(m1);
  }

  // p = exp2(s - m) against V; ldmatrix row of this lane inside a 16 x 8 slab
  const int vrow = (lane & 8) + (lane & 7);
  sweep(true, [&](int buf, int kv0) {
    scores(buf, kv0, s);
    if constexpr (MODE == kOnline) {
      float t0, t1;
      tile_max(s, t0, t1);
      quad_max(t0);
      quad_max(t1);
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int dt = 0; dt < S::NT; ++dt) {
        o[dt][0] *= a0;
        o[dt][1] *= a0;
        o[dt][2] *= a1;
        o[dt][3] *= a1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sv4 = s[2 * kk + half];
        const float f00 = exp2f(sv4[0] - m0), f01 = exp2f(sv4[1] - m0);
        const float f10 = exp2f(sv4[2] - m1), f11 = exp2f(sv4[3] - m1);
        const bf16 p00 = __float2bfloat16_rn(f00), p01 = __float2bfloat16_rn(f01);
        const bf16 p10 = __float2bfloat16_rn(f10), p11 = __float2bfloat16_rn(f11);
        if constexpr (MODE == kCross) {
          l0 += __bfloat162float(p00) + __bfloat162float(p01);
          l1 += __bfloat162float(p10) + __bfloat162float(p11);
        } else {
          l0 += f00 + f01;
          l1 += f10 + f11;
        }
        pa[2 * half] = sdt::pack_bf16(p00, p01);
        pa[2 * half + 1] = sdt::pack_bf16(p10, p11);
      }
#pragma unroll
      for (int dt = 0; dt < S::NT; ++dt) {
        uint32_t vb[2];
        sdt::ldmatrix_x2_trans(vb, &sVs[buf][kk * 16 + vrow][dt * 8]);
        mma_bf16_16816(o[dt], pa, vb[0], vb[1]);
      }
    }
  });
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if constexpr (MODE == kCross) {  // the TPU kernel's bf16 denominator
    l0 = __bfloat162float(__float2bfloat16_rn(l0));
    l1 = __bfloat162float(__float2bfloat16_rn(l1));
  }

  // o / l, staged through this warp's rows of sQ for coalesced stores
#pragma unroll
  for (int dt = 0; dt < S::NT; ++dt) {
    const int d = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(&sQ[r0][d]) = sdt::pack_f32(o[dt][0] / l0, o[dt][1] / l0);
    *reinterpret_cast<uint32_t*>(&sQ[r1][d]) = sdt::pack_f32(o[dt][2] / l1, o[dt][3] / l1);
  }
  __syncthreads();
  for (int i = tid; i < kBQ * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    if (q0 + r < Lq) {
      sdt::copy16(obase + (q0 + r) * so.l + c * 8, &sQ[r][c * 8]);
    }
  }
}

template <int D, int MODE, bool TAIL>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int H, int Lq,
           int Lk, const long long* st, float scale, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    // above the 48 KB default at every head dim but 40
    cudaFuncSetAttribute(attn_bhld_kernel<D, MODE, TAIL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<D>::kSmem);
    configured = true;
  }
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  attn_bhld_kernel<D, MODE, TAIL><<<grid, kThreads, Shape<D>::kSmem, s>>>(
      q, k, v, out, Lq, Lk, sq, sk, sv, so, scale);
  return static_cast<int>(cudaGetLastError());
}

// the guarded kernel only where the last kv tile is partial
template <int D, int MODE>
int launch_kv(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int H, int Lq,
              int Lk, const long long* st, float scale, cudaStream_t s) {
  return Lk % kBK ? launch<D, MODE, true>(q, k, v, out, B, H, Lq, Lk, st, scale, s)
                  : launch<D, MODE, false>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
}

template <int D>
int launch_mode(int mode, const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
                int H, int Lq, int Lk, const long long* st, float scale, cudaStream_t s) {
  switch (mode) {
    case kSumF32:
      return sdt::sm90::launch_bhld<D, false>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    case kSumBf16:
      return sdt::sm90::launch_bhld<D, true>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    case kOnline: return launch_kv<D, kOnline>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    case kCross:
      if (Lk > 128) return static_cast<int>(cudaErrorInvalidValue);
      return launch_kv<D, kCross>(q, k, v, out, B, H, Lq, Lk, st, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Head dims this library is instantiated for (SD-1.x: 320/8, 640/8, 1280/8);
// the wrapper raises on others.
extern "C" int attn_bhld_supports(int D) { return D == 40 || D == 80 || D == 160; }

// mode: 0 single block / fp32 row sum, 1 single block / bf16 row sum (both
// on the wgmma + TMA core), 2 online softmax over the kv tiles, 3 short kv
// as _kernel_cross_packed (Lk <= 128). Any Lk >= 1.
// strides: modes 2 and 3, 12 element strides, (batch, head, row) of q, k, v,
// out in turn; modes 0 and 1, the TMA geometry of q, k, v, out
// (sdt::sm90::kGeomLen values each, flash_attention.py::_tma_geometry). A
// refused tensor-map encoding returns a negative CUresult.
extern "C" int attn_bhld_launch(const void* q, const void* k, const void* v, void* out,
                                int B, int H, int D, int Lq, int Lk,
                                const long long* strides, float scale, int mode,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  bf16* o_ = static_cast<bf16*>(out);
  if (Lq < 1 || Lk < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 40: return launch_mode<40>(mode, q_, k_, v_, o_, B, H, Lq, Lk, strides, scale, s);
    case 80: return launch_mode<80>(mode, q_, k_, v_, o_, B, H, Lq, Lk, strides, scale, s);
    case 160: return launch_mode<160>(mode, q_, k_, v_, o_, B, H, Lq, Lk, strides, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
