// One Hopper core for softmax attention (sm_90a): wgmma for both products,
// TMA loads and stores, an mbarrier ring, warp specialisation. The PTX
// wrappers, wgmma descriptors and the tensor-map cache are in
// sm90_common.cuh, shared with geglu_ffn.cu.
//
// Serves two layouts from one kernel template:
//   * d-major (DMAJOR = true): q, v and the output (B, H, D, L), k a
//     (B, H, L, D) view -- _make_pvtd_kernel (flash_attention.cu);
//   * (B, H, L, D) views with unit stride along D (any batch, head and row
//     strides, so views of packed projections too) -- every mode of
//     flash_attention_bhld.cu.
//
// Numerics, as the TPU bodies: q is scaled by bf16(sm_scale * log2 e) and
// rounded to bf16 (in shared memory, before the first wgmma); scores are
// fp32 base-2 logits; p = exp2(s - max) (ex2.approx.ftz), rounded to bf16
// (cvt.rn.bf16x2) for P.V; fp32 accumulation, one divide per output (kShort:
// one per row, then a multiply per output: an item's epilogue is on its
// chain, and one divide per output ran its kv-77 rows about 20 % slower),
// bf16 output. How a consumer walks kv (Body):
//   kTwoPass  pass 1 computes Q.K^T and the row max only, pass 2 recomputes
//             the scores, so every p is rounded against the final row max,
//             as a whole-row kv block gives it (the single-block TPU bodies);
//   kOnline   ONE pass with a running max m: per kv tile alpha =
//             exp2(m - m_next) rescales the fp32 row sum and O, then
//             p = exp2(s - m_next) (the multi-block _kernel; only the tile
//             over which the maximum moves differs from its block_k);
//   kShort    a row of at most 80 kv at D <= 80 (the 77-token text
//             cross-attention): one 80-row kv tile whose scores stay in
//             registers, K read and multiplied once.
// The row sum (Sum) adds the fp32 p on the ALUs (kSumF32: _kernel,
// _kernel_1block, _kernel_mh, _kernel_mh_nat) or the bf16 p on the tensor
// cores (kSumBf16: pvtd, mxsum, pipe, pvt -- the TPU kernels' ones row in
// V^T; here an m64n8k16 wgmma of P against a constant tile of ones, because
// TMA rewrites V's tile, and any ones column in it, at every stage);
// kSumCross is kSumBf16 with _kernel_cross_packed's epilogue: the shift is
// max(row max, 0) below 128 kv (its zero-padded kv columns give logits of
// exactly 0) and the sum is rounded to bf16 before it divides.
//
// Block: CONS consumer warpgroups of 64 query rows each, then one producer
// warpgroup, one thread of which issues every TMA load. setmaxnreg moves
// registers from the producer to the consumers at run time, but ptxas
// compiles every role within the launch bound's share (168 registers at 384
// threads, 128 at 512), so each consumer holds one S tile: the warpgroups'
// turns, not a pipeline inside one, overlap the tensor cores with the
// softmax.
//   * kTwoPass / kOnline: grid (q tiles, H, B); the q tiles load once, then
//     a ring of STAGES K (pass 1) or K+V (pass 2, and every kOnline tile)
//     tiles completing on "full" mbarriers and released by the consumers on
//     "empty" ones.
//   * kShort is PERSISTENT: one block per SM walks a contiguous run of
//     items (b, pair of adjacent heads, 64 query rows), q tiles innermost,
//     the two consumers one head each. Consecutive items share (b, heads):
//     K and V stay in shared memory (one or two K+V slots, the next pair's
//     loading behind the current one). The q tiles come through a ring of
//     Q_SLOTS slots that the producer refills as soon as an item's Q.K^T
//     has read its slot, and the producer's other three warps scale each
//     landed slot, so a consumer's chain per item starts at Q.K^T. Each
//     output tile is stored by TMA from one of two staging tiles, whose
//     read is waited for an item later. Measured at kv 77 on the packed
//     (B, L, 8 * 40) projections: a launch per 128 query rows paid set-up,
//     q latency and store drain serially, one block per SM (its registers),
//     2x the time of one SDPA call; the persistent walk with one head per
//     item, 1.5x (issue-bound, and the packed rows' 80-byte runs cut
//     32-byte sectors of the q and output streams); head pairs make those
//     runs whole sectors, 0.9x.
// S = Q.K^T is an SS wgmma (m64 x BK kv columns, k16 steps over D); the S
// accumulator is converted in place to the A-register fragment of P and
// O += P.V is an RS wgmma (N = D). Operand layouts in shared memory are the
// TMA boxes with the 128-byte swizzle:
//   K         (kv rows, 64 d columns) per 64-column block   K-major B
//   Q (B,H,L,D) (q rows, 64 d columns) per block             K-major A
//   Q d-major (d rows, 64 q)                                MN-major A
//   V (B,H,L,D) (kv rows, 64 d columns) per block            MN-major B
//   V d-major (d rows, 64 kv) per 64-kv block               K-major B
// so neither layout needs a copy. The tensor maps' out-of-bounds zero fill
// supplies the D = 40 contraction padding (a 64-column box over a 40-column
// dim) and the kv tail (rows >= Lk read as zeros even where memory goes on,
// as in packed views); scores past Lk are set to -inf (kShort tests only
// the 8-column group where Lk falls and skips the 16-column chunks wholly
// past Lk: no exp2, no P.V step). The output goes through shared memory (the consumer's q tile, transposed there for the
// d-major layout; kShort's staging tiles) and one TMA store, which clips a
// partial last q tile.
//
// Bound on the H100 (4 Lq Lk D flops and Lq Lk exp2 per (b, h)): at D = 40
// the exp2 on the SFUs (16 / clock / SM) binds, at D = 80 and 160 the tensor
// cores do, at kv <= 128 the q and output streams do. What this core issues
// on top: kTwoPass's second Q.K^T, kOnline's rescale of O per kv tile, the
// D = 40 contraction padded to 48, the m64n8 row-sum products, kShort's
// 80-column score tile; at D = 40 the tensor work and the exp2 overlap only
// across warpgroups.
#pragma once

#include <math.h>

#include "sm90_common.cuh"

namespace sdt {
namespace sm90 {
namespace {  // internal linkage, as sm90_common.cuh says why

constexpr int kSmemBudget = 220 * 1024;     // of the 227 KB a block may use

enum Body : int { kTwoPass, kOnline, kShort };
enum Sum : int { kSumF32, kSumBf16, kSumCross };

template <int D, bool DMAJOR, int BODY>
struct Cfg {
  static constexpr bool SHORT = BODY == kShort;
  // consumer warpgroups of 64 query rows: three where their state fits the
  // 128 registers a thread of a 512-thread block may hold (one S tile, P,
  // O), else two (D = 160: O alone is 80 registers; kOnline at D = 80,
  // with a 128-wide S tile); more warpgroups in turn keep the tensor cores and the SFUs
  // busier than deeper pipelining inside one (measured: two S register sets
  // spilled and ran slower). kShort: two, on the same 64 rows of two
  // adjacent heads, whose packed rows (160 or 320 bytes) are whole 32-byte
  // sectors of the q and output streams.
  static constexpr int CONS = !SHORT && (D == 40 || (D == 80 && BODY == kTwoPass)) ? 3 : 2;
  static constexpr int BQ = SHORT ? 64 : 64 * CONS;  // query rows per block (kShort: per item)
  static constexpr int THREADS = 128 * (CONS + 1);
  // registers a thread may hold (ptxas compiles every role within the
  // launch bound's share, whatever setmaxnreg asks), and the setmaxnreg
  // pair that moves the producer's share to the consumers
  static constexpr int REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = (REGS + (REGS - PRODUCER_REGS) / CONS) / 8 * 8;
  // kv rows per tile (kShort: the smallest multiple of 16 that holds the
  // 77-token text context)
  static constexpr int BK = SHORT ? 80 : BODY == kOnline && D <= 80 ? 128 : 64;
  static_assert(CONS <= 3, "three ones tiles fit beside the barriers");
  static constexpr int DP = (D + 15) / 16 * 16;   // Q.K^T contraction (zeros past D)
  static constexpr int KS = DP / 16;              // its k16 steps
  static constexpr int NB = (D + 63) / 64;        // 64-column blocks of a (rows, D) tile
  static constexpr int Q_BYTES = DMAJOR ? DP * 128 : NB * 64 * 128;  // per consumer
  static constexpr int K_BYTES = NB * BK * 128;
  static constexpr int V_BYTES = DMAJOR ? (BK / 64) * D * 128 : NB * BK * 128;
  static constexpr int KV_BYTES = K_BYTES + V_BYTES;
  static constexpr int STAGE = SHORT ? CONS * KV_BYTES : KV_BYTES;  // kShort: each consumer's head
  static constexpr int Q_ALL = CONS * Q_BYTES;    // one q slot: every consumer's tile
  static constexpr int OUT_BYTES = SHORT ? 64 * D * 2 : 0;  // kShort: a staging tile
  // kShort: one or two K+V slots (two where two q slots fit beside them),
  // then as many q slots as fit, at most four; the streamed bodies: one q
  // slot, a ring of at most four stages
  static constexpr int BASE = 2048 + 2 * CONS * OUT_BYTES;  // alignment slack, barriers, ones, staging
  static constexpr int SHORT_STAGES = (kSmemBudget - BASE - 2 * Q_ALL) / STAGE >= 2 ? 2 : 1;
  static constexpr int Q_SLOTS_FIT = (kSmemBudget - BASE - SHORT_STAGES * STAGE) / Q_ALL;
  static constexpr int Q_SLOTS = !SHORT ? 1 : Q_SLOTS_FIT > 4 ? 4 : Q_SLOTS_FIT;
  static constexpr int STAGES_FIT = (kSmemBudget - BASE - Q_ALL) / STAGE;
  static constexpr int STAGES = SHORT ? SHORT_STAGES : STAGES_FIT > 4 ? 4 : STAGES_FIT;
  static constexpr int SMEM = BASE + Q_SLOTS * Q_ALL + STAGES * STAGE;
  static_assert(STAGES >= (SHORT ? 1 : 2) && Q_SLOTS >= 1 && Q_SLOTS <= 4, "the rings");
  static_assert(!SHORT || (!DMAJOR && D <= 80), "kShort: (B, H, L, D) rows at D <= 80");
  static_assert(D % 8 == 0 && D <= 256, "wgmma N = D");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x * bf16(scale), rounded to bf16, in place over the n16 16-byte chunks of
// a shared-memory tile from chunk i0 in steps of `step` (elementwise: the
// swizzle does not matter; the zero fill stays zero)
__device__ __forceinline__ void scale_bf16(unsigned char* p, int n16, int i0, int step,
                                           float scale) {
  const float sc = __bfloat162float(__float2bfloat16_rn(scale));
  for (int i = i0; i < n16; i += step) {
    uint4 v = reinterpret_cast<uint4*>(p)[i];
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      w[j] = pack_bf16x2(f.x * sc, f.y * sc);
    }
    reinterpret_cast<uint4*>(p)[i] = v;
  }
}

// --- the kernel ----------------------------------------------------------------
//
// Tensor maps (4-D, innermost first): q, k, v, out. (B, H, L, D) operands
// and the d-major k are (D, L, H, B); the d-major q, v and out are
// (L, D, H, B). Grid (ceil(Lq / BQ), H, B), or for kShort one block per SM
// (at most one per item). The maps are __grid_constant__ parameters of the
// __global__ entries below, taken here by reference (TMA reads them in
// parameter space).

template <int D, bool DMAJOR, int BODY, int SUM>
__device__ __forceinline__ void attn_body(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& to,
                                          int Lq, int Lk, int H, int B, float scale) {
  using C = Cfg<D, DMAJOR, BODY>;
  constexpr int BK = C::BK, ST = C::STAGES, QS = C::Q_SLOTS, kConsumers = C::CONS;
  constexpr bool SUM_BF16 = SUM != kSumF32;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle atoms want 1024-byte alignment
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_full = base, bar_empty = base + 64;   // the K / V ring
  const uint32_t bar_qfull = base + 128, bar_qempty = base + 192;  // the q slots
  const uint32_t bar_qready = base + 224;       // kShort: a q slot scaled
  const uint32_t ones = base + 256;             // one 256-byte tile per consumer (<= 3)
  const uint32_t sq = base + 1024;              // q slot j, consumer w: sq + j * Q_ALL + w * Q_BYTES
  const uint32_t sst = sq + QS * C::Q_ALL;      // stage s: K at sst + s * STAGE, then V
  const uint32_t sout = sst + ST * C::STAGE;    // kShort: staging tile j of consumer w at + (j * CONS + w) * OUT_BYTES

  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int n_tiles = (Lk + BK - 1) / BK;
  // kShort: this block's run of items (b, group of CONS heads, q tile),
  // q tiles innermost: `first_item` sets the first and returns how many,
  // `next` steps without a division
  const int n_qt = (Lq + C::BQ - 1) / C::BQ, n_hg = (H + kConsumers - 1) / kConsumers;
  struct Item {
    int qt, hg, b;
  };
  auto first_item = [&](Item& x) {
    const long long n_items = static_cast<long long>(n_qt) * n_hg * B;
    const int first = static_cast<int>(blockIdx.x * n_items / gridDim.x);
    x = {first % n_qt, first / n_qt % n_hg, first / n_qt / n_hg};
    return static_cast<int>((blockIdx.x + 1) * n_items / gridDim.x) - first;
  };
  auto next = [&](Item& x) {
    if (++x.qt == n_qt) {
      x.qt = 0;
      if (++x.hg == n_hg) {
        x.hg = 0;
        ++x.b;
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < QS; ++s) {
      mbar_init(bar_qfull + 8 * s, 1);
      mbar_init(bar_qempty + 8 * s, kConsumers * 4);
      mbar_init(bar_qready + 8 * s, 3);                // the producer's warps 1-3
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the rings full ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid == kConsumers * 128) {
      // every consumer's q tile of the item at rows q0.. into slot `slot`
      auto load_q = [&](int slot, int q0, int h, int b) {
        const uint32_t bar = bar_qfull + 8 * slot, dst = sq + slot * C::Q_ALL;
        mbar_expect_tx(bar, C::Q_ALL);
        for (int w = 0; w < kConsumers; ++w) {
          if constexpr (DMAJOR) {
            tma_load(dst + w * C::Q_BYTES, &tq, bar, q0 + 64 * w, 0, h, b);
          } else {
#pragma unroll
            for (int nb = 0; nb < C::NB; ++nb)
              tma_load(dst + w * C::Q_BYTES + nb * 64 * 128, &tq, bar, nb * 64, q0 + 64 * w, h, b);
          }
        }
      };
      // K and / or V of the kv tile at kv0 into stage s, once the consumers released it
      auto load_kv = [&](int n, int kv0, bool with_k, bool with_v, int h, int b) {
        const int s = n % ST;
        mbar_wait(bar_empty + 8 * s, ((n / ST) & 1) ^ 1);
        const uint32_t bar = bar_full + 8 * s, sk = sst + s * C::STAGE, sv = sk + C::K_BYTES;
        mbar_expect_tx(bar, (with_k ? C::K_BYTES : 0) + (with_v ? C::V_BYTES : 0));
        if (with_k) {
#pragma unroll
          for (int nb = 0; nb < C::NB; ++nb) tma_load(sk + nb * BK * 128, &tk, bar, nb * 64, kv0, h, b);
        }
        if (with_v) {
          if constexpr (DMAJOR) {
#pragma unroll
            for (int c = 0; c < BK / 64; ++c) tma_load(sv + c * D * 128, &tv, bar, kv0 + 64 * c, 0, h, b);
          } else {
#pragma unroll
            for (int nb = 0; nb < C::NB; ++nb) tma_load(sv + nb * BK * 128, &tv, bar, nb * 64, kv0, h, b);
          }
        }
      };
      if constexpr (C::SHORT) {
        // K and V of the group's heads once per (b, group), then the item's
        // q tiles, one per head, into the next slot
        Item x;
        const int n_mine = first_item(x);
        for (int n = 0, n_kv = 0; n < n_mine; ++n, next(x)) {
          const int h0 = x.hg * kConsumers, heads = min(kConsumers, H - h0);
          if (n == 0 || x.qt == 0) {
            const int s = n_kv % ST;
            mbar_wait(bar_empty + 8 * s, ((n_kv / ST) & 1) ^ 1);
            const uint32_t bar = bar_full + 8 * s;
            mbar_expect_tx(bar, heads * C::KV_BYTES);
            for (int w = 0; w < heads; ++w) {
              const uint32_t sk = sst + s * C::STAGE + w * C::KV_BYTES, sv = sk + C::K_BYTES;
#pragma unroll
              for (int nb = 0; nb < C::NB; ++nb) {
                tma_load(sk + nb * BK * 128, &tk, bar, nb * 64, 0, h0 + w, x.b);
                tma_load(sv + nb * BK * 128, &tv, bar, nb * 64, 0, h0 + w, x.b);
              }
            }
            ++n_kv;
          }
          const int slot = n % QS;
          mbar_wait(bar_qempty + 8 * slot, ((n / QS) & 1) ^ 1);
          const uint32_t bar = bar_qfull + 8 * slot;
          mbar_expect_tx(bar, heads * C::Q_BYTES);
          for (int w = 0; w < heads; ++w) {
#pragma unroll
            for (int nb = 0; nb < C::NB; ++nb)
              tma_load(sq + slot * C::Q_ALL + w * C::Q_BYTES + nb * 64 * 128, &tq, bar, nb * 64,
                       x.qt * C::BQ, h0 + w, x.b);
          }
        }
      } else {
        const int h = blockIdx.y, b = blockIdx.z;
        load_q(0, blockIdx.x * C::BQ, h, b);
        // kTwoPass: K alone in pass 1, then K and V (V alone where the one
        // tile's scores stay in registers); kOnline: K and V, one pass
        const int n_loads = BODY == kOnline ? n_tiles : 2 * n_tiles;
        for (int it = 0; it < n_loads; ++it) {
          const bool pass2 = BODY == kOnline || it >= n_tiles;
          const bool with_k = BODY == kOnline || !pass2 || n_tiles > 1;
          load_kv(it, (it < n_tiles ? it : it - n_tiles) * BK, with_k, pass2, h, b);
        }
      }
    } else if constexpr (C::SHORT) {
      // kShort: warps 1-3 scale each landed q slot for the consumers, so
      // their chain per item starts at Q.K^T
      if (tid >= kConsumers * 128 + 32) {
        const int lane = tid % 32;
        Item x;
        const int n_mine = first_item(x);
        for (int n = 0; n < n_mine; ++n) {
          const int slot = n % QS;
          mbar_wait(bar_qfull + 8 * slot, (n / QS) & 1);
          scale_bf16(gbase + (sq + slot * C::Q_ALL - base), C::Q_ALL / 16,
                     tid - kConsumers * 128 - 32, 96, scale);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_qready + 8 * slot);
        }
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: 64 query rows of each item ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int t = tid % 128, warp = t / 32, lane = tid % 32;
    const int g = lane / 4, tq4 = lane % 4;
    const uint32_t my_ones = ones + wg * 256;

    if constexpr (SUM_BF16) {
      if (t < 64) reinterpret_cast<uint32_t*>(gbase + (my_ones - base))[t] = 0x3F803F80u;
      if constexpr (C::SHORT) {  // (the other bodies' scale_q fences it)
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
      }
    }
    // this consumer's q tile scaled in place, made visible to wgmma
    auto scale_q = [&](uint32_t my_q) {
      scale_bf16(gbase + (my_q - base), C::Q_BYTES / 16, t, 128, scale);
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
    };
    // S = (q * scale) K^T over one kv tile, fp32
    auto qk = [&](float (&sacc)[BK / 2], uint32_t my_q, uint32_t sk) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        uint64_t da;
        if constexpr (DMAJOR) {
          da = desc_mn(my_q + kk * 16 * 128, C::Q_BYTES);  // one 64-query atom
        } else {
          da = desc_k(my_q + (kk / 4) * 64 * 128 + (kk % 4) * 32);
        }
        const uint64_t db = desc_k(sk + (kk / 4) * BK * 128 + (kk % 4) * 32);
        wgmma_ss<BK, DMAJOR ? 1 : 0, 0>(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sacc);
    };
    // columns past Lk of a partial last tile: -inf
    auto mask = [&](float (&sacc)[BK / 2], int kv0) {
      if (kv0 + BK > Lk) {
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {  // 8-column groups
          const int col0 = kv0 + 8 * c;
          // kShort (the one tile of a row ending inside it): only the group
          // where Lk falls is tested; the others test every column
          if (C::SHORT && col0 >= Lk) {
#pragma unroll
            for (int i = 4 * c; i < 4 * c + 4; ++i) sacc[i] = -INFINITY;
          } else if (!C::SHORT || col0 + 8 > Lk) {
#pragma unroll
            for (int i = 4 * c; i < 4 * c + 4; ++i) {
              if (col0 + 2 * tq4 + (i & 1) >= Lk) sacc[i] = -INFINITY;
            }
          }
        }
      }
    };
    // this thread's share of the tile's row max (rows g and g + 8 of its
    // warp's 16), and the max over the quad that holds a row
    auto tile_max = [&](const float (&sacc)[BK / 2], float& m0, float& m1) {
#pragma unroll
      for (int i = 0; i < BK / 2; i += 4) {
        m0 = fmaxf(m0, fmaxf(sacc[i], sacc[i + 1]));
        m1 = fmaxf(m1, fmaxf(sacc[i + 2], sacc[i + 3]));
      }
    };
    auto quad_max = [&](float& m0, float& m1) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      }
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };

    float sacc[BK / 2];
    float o[D / 2];
    float lsum[4];       // SUM_BF16: P . ones (m64n8)
    float l0, l1;        // else: this thread's share of the fp32 sum
    auto zero_acc = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) lsum[i] = 0.0f;
      l0 = l1 = 0.0f;
    };
    const uint64_t ones_desc = desc(my_ones, 128, 256, 0);
    // p = exp2(s - m) against the V tile at sv (kv0 its first row): bf16 p
    // into O, the row sum into l0 / l1 (fp32 p) or lsum (bf16 p). kShort
    // skips the 16-column chunks wholly past Lk (p = 0 there: nothing to add).
    // `fresh`: the first product overwrites O and lsum instead of adding
    auto pv = [&](const float (&sacc)[BK / 2], float m0, float m1, uint32_t sv, int kv0,
                  bool fresh) {
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (C::SHORT && kv0 + 16 * kk >= Lk) {
          pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
          continue;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 8 * kk + 4 * half;
          const float f0 = ex2(sacc[i] - m0), f1 = ex2(sacc[i + 1] - m0);
          const float f2 = ex2(sacc[i + 2] - m1), f3 = ex2(sacc[i + 3] - m1);
          if constexpr (!SUM_BF16) {
            l0 += f0 + f1;
            l1 += f2 + f3;
          }
          pa[kk][2 * half] = pack_bf16x2(f0, f1);
          pa[kk][2 * half + 1] = pack_bf16x2(f2, f3);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (C::SHORT && kv0 + 16 * kk >= Lk) continue;
        uint64_t dv;
        if constexpr (DMAJOR) {
          dv = desc_k(sv + (kk / 4) * D * 128 + (kk % 4) * 32);  // d rows
        } else {
          dv = desc_mn(sv + kk * 16 * 128, BK * 128);  // 64-column blocks BK*128 apart
        }
        const int acc = !(fresh && kk == 0);
        wgmma_rs<D, DMAJOR ? 0 : 1>(o, pa[kk], dv, acc);
        if constexpr (SUM_BF16) wgmma_rs<8, 0>(lsum, pa[kk], ones_desc, acc);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      fence_regs(lsum);
    };
    // the row sums, over the quad (fp32 p) or from the ones product
    auto row_sums = [&]() {
      if constexpr (SUM_BF16) {
        l0 = lsum[0];
        l1 = lsum[2];
      } else {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, off);
          l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
      }
      if constexpr (SUM == kSumCross) {  // _kernel_cross_packed's bf16 denominator
        l0 = __bfloat162float(__float2bfloat16_rn(l0));
        l1 = __bfloat162float(__float2bfloat16_rn(l1));
      }
    };
    // the shift: the row max over the quad; max(row max, 0) for
    // _kernel_cross_packed below 128 kv (its zero-padded columns' logits)
    auto shift = [&](float& m0, float& m1) {
      quad_max(m0, m1);
      if (SUM == kSumCross && Lk < 128) {
        m0 = fmaxf(m0, 0.0f);
        m1 = fmaxf(m1, 0.0f);
      }
    };
    // o / l in bf16 into a staging tile ((q, d) rows of D, or (d, q) rows
    // of 64 queries for the d-major layout), made visible to the TMA store
    auto stage = [&](uint32_t tile) {
      const int r0 = 16 * warp + g, r1 = r0 + 8;
      const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
      bf16* st = reinterpret_cast<bf16*>(gbase + (tile - base));
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        const int col = 8 * (i / 4) + 2 * tq4;
        uint32_t lo, hi;
        if constexpr (C::SHORT) {  // see the note at the top
          lo = pack_bf16x2(o[i] * inv0, o[i + 1] * inv0);
          hi = pack_bf16x2(o[i + 2] * inv1, o[i + 3] * inv1);
        } else {
          lo = pack_bf16x2(o[i] / l0, o[i + 1] / l0);
          hi = pack_bf16x2(o[i + 2] / l1, o[i + 3] / l1);
        }
        if constexpr (DMAJOR) {
          const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&lo);
          const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&hi);
          st[col * 64 + r0] = a.x;
          st[(col + 1) * 64 + r0] = a.y;
          st[col * 64 + r1] = c.x;
          st[(col + 1) * 64 + r1] = c.y;
        } else {
          *reinterpret_cast<uint32_t*>(&st[r0 * D + col]) = lo;
          *reinterpret_cast<uint32_t*>(&st[r1 * D + col]) = hi;
        }
      }
      // kShort: the previous item's store (from the other staging tile) has
      // read it before the barrier, so the next item may write that tile
      if (C::SHORT && t == 0) tma_store_wait_read();
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
    };

    if constexpr (C::SHORT) {
      Item x;
      const int n_mine = first_item(x);
      for (int n = 0, n_kv = 0; n < n_mine; ++n, next(x)) {
        const int h = x.hg * kConsumers + wg;  // this consumer's head (none past H)
        if (n == 0 || x.qt == 0) {  // the next (b, group): release its K + V slot, wait for the next
          if (n > 0) release(bar_empty + 8 * ((n_kv - 1) % ST));
          mbar_wait(bar_full + 8 * (n_kv % ST), (n_kv / ST) & 1);
          ++n_kv;
        }
        const uint32_t sk = sst + ((n_kv - 1) % ST) * C::STAGE + wg * C::KV_BYTES;
        const uint32_t sv = sk + C::K_BYTES;
        const int slot = n % QS;
        const uint32_t my_q = sq + slot * C::Q_ALL + wg * C::Q_BYTES;
        mbar_wait(bar_qready + 8 * slot, (n / QS) & 1);  // landed and scaled
        if (h < H) qk(sacc, my_q, sk);
        release(bar_qempty + 8 * slot);  // the producer refills it while this item goes on
        if (h >= H) continue;
        mask(sacc, 0);
        float m0 = -INFINITY, m1 = -INFINITY;
        tile_max(sacc, m0, m1);
        shift(m0, m1);
        l0 = l1 = 0.0f;
        pv(sacc, m0, m1, sv, 0, true);
        row_sums();
        // staging tiles alternate, each store's read awaited one item later
        const uint32_t my_out = sout + ((n & 1) * kConsumers + wg) * C::OUT_BYTES;
        stage(my_out);
        if (t == 0) tma_store(&to, my_out, 0, x.qt * C::BQ, h, x.b);
      }
      if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    } else {
      const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * C::BQ;
      const uint32_t my_q = sq + wg * C::Q_BYTES;
      mbar_wait(bar_qfull, 0);
      scale_q(my_q);
      if constexpr (BODY == kOnline) {
        // one pass: m the running max, alpha = exp2(m - m_next) rescales
        // the row sum and O before this tile's p = exp2(s - m_next) joins
        zero_acc();
        float m0 = -INFINITY, m1 = -INFINITY;
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % ST;
          const uint32_t sk = sst + s * C::STAGE, sv = sk + C::K_BYTES;
          mbar_wait(bar_full + 8 * s, (j / ST) & 1);
          qk(sacc, my_q, sk);
          mask(sacc, j * BK);
          float n0 = m0, n1 = m1;
          tile_max(sacc, n0, n1);
          quad_max(n0, n1);
          const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);
          m0 = n0;
          m1 = n1;
          l0 *= a0;
          l1 *= a1;
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? a1 : a0;
          pv(sacc, m0, m1, sv, j * BK, false);
          release(bar_empty + 8 * s);
        }
      } else {
        // pass 1: the row max
        float m0 = -INFINITY, m1 = -INFINITY;
        for (int it = 0; it < n_tiles; ++it) {
          const int s = it % ST;
          mbar_wait(bar_full + 8 * s, (it / ST) & 1);
          qk(sacc, my_q, sst + s * C::STAGE);
          release(bar_empty + 8 * s);
          mask(sacc, it * BK);
          tile_max(sacc, m0, m1);
        }
        shift(m0, m1);
        // pass 2: p = exp2(s - max), bf16, against V; the row sum (O and the
        // sums live from here on, not through pass 1)
        zero_acc();
        for (int j = 0; j < n_tiles; ++j) {
          const int it = n_tiles + j, s = it % ST;
          const uint32_t sk = sst + s * C::STAGE, sv = sk + C::K_BYTES;
          mbar_wait(bar_full + 8 * s, (it / ST) & 1);
          if (n_tiles > 1) {  // else sacc still holds the one tile's masked scores
            qk(sacc, my_q, sk);
            mask(sacc, j * BK);
          }
          pv(sacc, m0, m1, sv, j * BK, false);
          release(bar_empty + 8 * s);
        }
      }
      row_sums();
      // staged in this consumer's q tile, one TMA store
      stage(my_q);
      if (t == 0 && q0 + 64 * wg < Lq) {
        if constexpr (DMAJOR) tma_store(&to, my_q, q0 + 64 * wg, 0, h, b);
        else tma_store(&to, my_q, 0, q0 + 64 * wg, h, b);
        tma_store_wait_read();
      }
    }
  }
}

// One __global__ entry per body, so a profile tells the bodies apart by
// kernel name.
#define SDT_ATTN_PARAMS                                                                \
  const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,      \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,  \
      int Lq, int Lk, int H, int B, float scale

template <int D, bool DMAJOR, int SUM>
__global__ void __launch_bounds__((Cfg<D, DMAJOR, kTwoPass>::THREADS), 1)
attn_sm90_two_pass(SDT_ATTN_PARAMS) {
  attn_body<D, DMAJOR, kTwoPass, SUM>(tq, tk, tv, to, Lq, Lk, H, B, scale);
}

template <int D, int SUM>
__global__ void __launch_bounds__((Cfg<D, false, kOnline>::THREADS), 1)
attn_sm90_online(SDT_ATTN_PARAMS) {
  attn_body<D, false, kOnline, SUM>(tq, tk, tv, to, Lq, Lk, H, B, scale);
}

template <int D, int SUM>
__global__ void __launch_bounds__((Cfg<D, false, kShort>::THREADS), 1)
attn_sm90_short(SDT_ATTN_PARAMS) {
  attn_body<D, false, kShort, SUM>(tq, tk, tv, to, Lq, Lk, H, B, scale);
}

#undef SDT_ATTN_PARAMS

template <int D, bool DMAJOR, int BODY, int SUM>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Lq,
           int Lk, const long long* geom, float scale, cudaStream_t s) {
  using C = Cfg<D, DMAJOR, BODY>;
  // the boxes this instance's expect_tx counts and staging assume
  const long long want[4][3] = {
      {64, DMAJOR ? C::DP : 64, 128}, {64, C::BK, 128},
      {64, DMAJOR ? D : C::BK, 128}, {DMAJOR ? 64 : D, DMAJOR ? D : 64, 0}};
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j) {
      if (geom[kGeomLen * i + 7 + j] != want[i][j]) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  CUtensorMap maps[4];
  const void* const ptrs[4] = {q, k, v, out};
  if (const int err = encode_maps(maps, ptrs, geom)) return err;
  const auto kernel = [] {
    if constexpr (BODY == kOnline) return attn_sm90_online<D, SUM>;
    else if constexpr (BODY == kShort) return attn_sm90_short<D, SUM>;
    else return attn_sm90_two_pass<D, DMAJOR, SUM>;
  }();
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    configured = true;
  }
  const int n_qt = (Lq + C::BQ - 1) / C::BQ;
  dim3 grid(n_qt, H, B);
  if constexpr (C::SHORT) {
    const long long items = static_cast<long long>(n_qt) * ((H + C::CONS - 1) / C::CONS) * B;
    grid = dim3(static_cast<unsigned>(items < sm_count() ? items : sm_count()));
  }
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(maps[0], maps[1], maps[2], maps[3], Lq, Lk, H, B,
                                           scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace sm90
}  // namespace sdt
