// One Hopper core for single-kv-block softmax attention (sm_90a): wgmma for
// both products, TMA loads and stores, an mbarrier ring, warp specialisation.
//
// Serves two layouts from one kernel template:
//   * d-major (DMAJOR = true): q, v and the output (B, H, D, L), k a
//     (B, H, L, D) view -- _make_pvtd_kernel (flash_attention.cu);
//   * (B, H, L, D) views with unit stride along D (any batch, head and row
//     strides, so views of packed projections too) -- the single-block modes
//     of flash_attention_bhld.cu (_kernel_1block, _kernel_mh, _kernel_mh_nat,
//     _kernel_1block_mxsum, _make_pipe_kernel, _make_pvt_kernel).
//
// Numerics, as the TPU bodies: q is scaled by bf16(sm_scale * log2 e) and
// rounded to bf16 (once, in shared memory, before the first wgmma); scores
// are fp32 base-2 logits; TWO PASSES over k: pass 1 computes Q.K^T and the
// row max only, pass 2 recomputes the scores and forms p = exp2(s - final
// max) (ex2.approx.ftz), rounded to bf16 (cvt.rn.bf16x2) for P.V; the row
// sum adds the fp32 p on the ALUs (SUM_BF16 = false: _kernel_1block,
// _kernel_mh, _kernel_mh_nat) or the bf16 p on the tensor cores
// (SUM_BF16 = true: pvtd, mxsum, pipe, pvt -- the TPU kernels' ones row in
// V^T; here an m64n8k16 wgmma of P against a constant tile of ones, because
// TMA rewrites V's tile, and any ones column in it, at every stage); fp32
// accumulation, one divide, bf16 output.
//
// Block: CONS consumer warpgroups of 64 query rows each (three at D <= 80,
// a 192-row q tile; two at D = 160 and for short rows, 128), then one
// producer warpgroup, one thread of which issues every TMA load (the q
// tiles once, then a ring of STAGES K (pass 1) or K+V (pass 2) tiles
// completing on "full" mbarriers and released by the consumers on "empty"
// ones). setmaxnreg moves registers from the producer to the consumers at
// run time, but ptxas compiles every role within the launch bound's share
// (168 registers at 384 threads, 128 at 512), so each consumer holds one S
// tile: the warpgroups' turns, not a pipeline inside one, overlap the
// tensor cores with the softmax. A row of one kv tile (a SHORT row of at
// most 128 kv, the text cross-attention) keeps pass 1's scores in
// registers: K is loaded and multiplied once, and V loads beside it.
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
// as in packed views); scores past Lk are set to -inf. The output goes
// through the consumer's q tile in shared memory (transposed there for the
// d-major layout) and one TMA store, which clips a partial last q tile.
//
// Bound on the H100 (4 Lq Lk D flops and Lq Lk exp2 per (b, h)): at D = 40
// the exp2 on the SFUs (16 / clock / SM) binds, at D = 80 and 160 the tensor
// cores do. What this core issues on top: pass 1's second Q.K^T, the D = 40
// contraction padded to 48, and the m64n8 row-sum products; at D = 40 that
// tensor work (about 1.2x the exp2 time at peak) and the exp2 overlap only
// across warpgroups.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sdt {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kSmemBudget = 220 * 1024;     // of the 227 KB a block may use

// SHORT: a row of at most 128 kv at D <= 80 (the text cross-attention and
// the short self-attention rows, (B, H, L, D) only) takes one 128-row kv
// tile, whose scores stay in registers between the passes.
template <int D, bool DMAJOR, bool SHORT = false>
struct Cfg {
  // consumer warpgroups of 64 query rows: three where their state fits the
  // 128 registers a thread of a 512-thread block may hold (one S tile, P,
  // O), two at D = 160 (O alone is 80 registers) and for SHORT (a 128-wide
  // S tile); more warpgroups in turn keep the tensor cores and the SFUs
  // busier than deeper pipelining inside one (measured: two S register sets
  // spilled and ran slower)
  static constexpr int CONS = D > 80 || SHORT ? 2 : 3;
  static constexpr int BQ = 64 * CONS;            // query rows per block
  static constexpr int THREADS = 128 * (CONS + 1);
  // registers a thread may hold (ptxas compiles every role within the
  // launch bound's share, whatever setmaxnreg asks), and the setmaxnreg
  // pair that moves the producer's share to the consumers
  static constexpr int REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = (REGS + (REGS - PRODUCER_REGS) / CONS) / 8 * 8;
  static constexpr int BK = SHORT ? 128 : 64;     // kv rows per tile
  static_assert(CONS <= 3, "three ones tiles fit beside the barriers");
  static constexpr int DP = (D + 15) / 16 * 16;   // Q.K^T contraction (zeros past D)
  static constexpr int KS = DP / 16;              // its k16 steps
  static constexpr int NB = (D + 63) / 64;        // 64-column blocks of a (rows, D) tile
  static constexpr int Q_BYTES = DMAJOR ? DP * 128 : NB * 64 * 128;  // per consumer
  static constexpr int K_BYTES = NB * BK * 128;
  static constexpr int V_BYTES = DMAJOR ? (BK / 64) * D * 128 : NB * BK * 128;
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int Q_ALL = CONS * Q_BYTES;
  static constexpr int STAGES_FIT = (kSmemBudget - 2048 - Q_ALL) / STAGE;
  static constexpr int STAGES = STAGES_FIT > 4 ? 4 : STAGES_FIT;
  // 1024 of alignment slack, 1024 of barriers and ones tiles, then the tiles
  static constexpr int SMEM = 2048 + Q_ALL + STAGES * STAGE;
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(D % 8 == 0 && D <= 256, "wgmma N = D");
};

// --- PTX helpers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. Bounded: a wait that
// never ends (a bookkeeping fault) traps, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (n == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// generic-proxy shared-memory writes made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an in-flight wgmma reads or writes: no use of them is
// moved across this point (placed after wgmma_wait0 and before an issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats to a bf16x2 register, round to nearest even; `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout (0 no swizzle, 1 128-byte swizzle)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// 128-byte-swizzled K-major tile of 128-byte rows: 8-row groups 1024 bytes
// apart (SBO); the leading offset is not used
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return desc(addr, 16, 1024, 1); }

// 128-byte-swizzled MN-major tile: 64-element MN atoms `atom` bytes apart
// (LBO), 8-row K groups 1024 bytes apart (SBO)
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t atom) {
  return desc(addr, atom, 1024, 1);
}

// --- wgmma, m64nNk16, bf16 in, fp32 accumulate ------------------------------
// SS: A and B from shared memory (TA / TB: 0 K-major, 1 MN-major); RS: A from
// registers (the m16n8k16 A fragment of each warp's 16 rows), B from shared
// memory. scale_d = 0 overwrites the accumulator. PTX names every register.

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, {%80, %81, %82, %83}, %84, p, 1, 1, %86;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64<TA, TB>(d, da, db, scale_d);
  else wgmma_ss_n128<TA, TB>(d, da, db, scale_d);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  if constexpr (N == 8) wgmma_rs_n8<TB>(d, a, db, scale_d);
  else if constexpr (N == 40) wgmma_rs_n40<TB>(d, a, db, scale_d);
  else if constexpr (N == 80) wgmma_rs_n80<TB>(d, a, db, scale_d);
  else wgmma_rs_n160<TB>(d, a, db, scale_d);
}

// --- the kernel ----------------------------------------------------------------
//
// Tensor maps (4-D, innermost first): q, k, v, out. (B, H, L, D) operands
// and the d-major k are (D, L, H, B); the d-major q, v and out are
// (L, D, H, B). Grid (ceil(Lq / BQ), H, B).

template <int D, bool DMAJOR, bool SUM_BF16, bool SHORT>
__global__ void __launch_bounds__((Cfg<D, DMAJOR, SHORT>::THREADS), 1)
attn_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                 int Lq, int Lk, float scale) {
  using C = Cfg<D, DMAJOR, SHORT>;
  constexpr int BK = C::BK, ST = C::STAGES, kConsumers = C::CONS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle atoms want 1024-byte alignment
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bar_q = base, bar_full = base + 8, bar_empty = base + 8 + 8 * ST;
  const uint32_t ones = base + 256;             // one 256-byte tile per consumer (<= 3)
  const uint32_t sq = base + 1024;              // q tile of consumer w at sq + w * Q_BYTES
  const uint32_t sst = sq + C::Q_ALL;           // stage s: K at sst + s * STAGE, then V

  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Lk + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid == kConsumers * 128) {
      mbar_expect_tx(bar_q, C::Q_ALL);
      for (int w = 0; w < kConsumers; ++w) {
        const uint32_t dst = sq + w * C::Q_BYTES;
        if constexpr (DMAJOR) {
          tma_load(dst, &tq, bar_q, q0 + 64 * w, 0, h, b);
        } else {
#pragma unroll
          for (int nb = 0; nb < C::NB; ++nb)
            tma_load(dst + nb * 64 * 128, &tq, bar_q, nb * 64, q0 + 64 * w, h, b);
        }
      }
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int s = it % ST;
        mbar_wait(bar_empty + 8 * s, ((it / ST) & 1) ^ 1);
        const bool with_v = it >= n_tiles;   // pass 2
        const bool with_k = !with_v || n_tiles > 1;  // one tile: its scores stay in registers
        const int kv0 = (with_v ? it - n_tiles : it) * BK;
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
      }
    }
  } else {
    // ---- consumer warpgroup `wg`: 64 query rows ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int t = tid % 128, warp = t / 32, lane = tid % 32;
    const int g = lane / 4, tq4 = lane % 4;
    const uint32_t my_q = sq + wg * C::Q_BYTES, my_ones = ones + wg * 256;
    unsigned char* my_q_ptr = gbase + (my_q - base);

    if constexpr (SUM_BF16) {
      if (t < 64) reinterpret_cast<uint32_t*>(gbase + (my_ones - base))[t] = 0x3F803F80u;
    }
    // q * bf16(scale), rounded to bf16, in place (elementwise: the swizzle
    // does not matter; the zero fill stays zero)
    mbar_wait(bar_q, 0);
    {
      const __nv_bfloat162 sc2 = __float2bfloat162_rn(scale);
      const float2 scf = __bfloat1622float2(sc2);
      for (int i = t; i < C::Q_BYTES / 16; i += 128) {
        uint4 v = reinterpret_cast<uint4*>(my_q_ptr)[i];
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
          w[j] = pack_bf16x2(f.x * scf.x, f.y * scf.x);
        }
        reinterpret_cast<uint4*>(my_q_ptr)[i] = v;
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);

    // S = (q * scale) K^T over one kv tile (stage s), fp32
    auto qk = [&](float (&sacc)[BK / 2], uint32_t sk) {
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
        for (int i = 0; i < BK / 2; ++i) {
          if (kv0 + 8 * (i / 4) + 2 * tq4 + (i & 1) >= Lk) sacc[i] = -INFINITY;
        }
      }
    };
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    };

    float sacc[BK / 2];
    // pass 1: the row max (rows g and g + 8 of this warp's 16)
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % ST;
      mbar_wait(bar_full + 8 * s, (it / ST) & 1);
      qk(sacc, sst + s * C::STAGE);
      release(s);
      mask(sacc, it * BK);
#pragma unroll
      for (int i = 0; i < BK / 2; i += 4) {
        m0 = fmaxf(m0, fmaxf(sacc[i], sacc[i + 1]));
        m1 = fmaxf(m1, fmaxf(sacc[i + 2], sacc[i + 3]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }

    // pass 2: p = exp2(s - max), bf16, against V; the row sum
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float lsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // SUM_BF16: P . ones (m64n8)
    float l0 = 0.0f, l1 = 0.0f;                // else: this thread's share of the fp32 sum
    const uint64_t ones_desc = desc(my_ones, 128, 256, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int it = n_tiles + j, s = it % ST;
      const uint32_t sk = sst + s * C::STAGE, sv = sk + C::K_BYTES;
      mbar_wait(bar_full + 8 * s, (it / ST) & 1);
      if (n_tiles > 1) {  // else sacc still holds the one tile's masked scores
        qk(sacc, sk);
        mask(sacc, j * BK);
      }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
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
        uint64_t dv;
        if constexpr (DMAJOR) {
          dv = desc_k(sv + (kk / 4) * D * 128 + (kk % 4) * 32);  // d rows
        } else {
          dv = desc_mn(sv + kk * 16 * 128, BK * 128);  // 64-column blocks BK*128 apart
        }
        wgmma_rs<D, DMAJOR ? 0 : 1>(o, pa[kk], dv, 1);
        if constexpr (SUM_BF16) wgmma_rs<8, 0>(lsum, pa[kk], ones_desc, 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      fence_regs(lsum);
      release(s);
    }
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

    // o / l in bf16, staged in this consumer's q tile, one TMA store
    const int r0 = 16 * warp + g, r1 = r0 + 8;
    bf16* st = reinterpret_cast<bf16*>(my_q_ptr);
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const int col = 8 * (i / 4) + 2 * tq4;
      const uint32_t lo = pack_bf16x2(o[i] / l0, o[i + 1] / l0);
      const uint32_t hi = pack_bf16x2(o[i + 2] / l1, o[i + 3] / l1);
      if constexpr (DMAJOR) {  // (d, q) rows of 64 queries
        const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&lo);
        const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&hi);
        st[col * 64 + r0] = a.x;
        st[(col + 1) * 64 + r0] = a.y;
        st[col * 64 + r1] = c.x;
        st[(col + 1) * 64 + r1] = c.y;
      } else {  // (q, d) rows of D
        *reinterpret_cast<uint32_t*>(&st[r0 * D + col]) = lo;
        *reinterpret_cast<uint32_t*>(&st[r1 * D + col]) = hi;
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (t == 0 && q0 + 64 * wg < Lq) {
      if constexpr (DMAJOR) tma_store(&to, my_q, q0 + 64 * wg, 0, h, b);
      else tma_store(&to, my_q, 0, q0 + 64 * wg, h, b);
    }
  }
}

// --- host side -----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint, so the
// library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Values per operand in the geometry table the wrapper computes
// (flash_attention.py::_tma_geometry): 4 dims (elements, innermost first),
// 3 byte strides (dims 1-3), 2 box dims (the box is 1 along dims 2-3), and
// the swizzle (0 or 128 bytes).
constexpr int kGeomLen = 10;

// Tensor maps of q, k, v, out from the table; 0, or the CUresult of a
// refused encoding, negated.
inline int encode_maps(CUtensorMap (&maps)[4], const void* const (&ptrs)[4],
                       const long long* geom) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  for (int i = 0; i < 4; ++i) {
    const long long* g = geom + kGeomLen * i;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g[0]), static_cast<cuuint64_t>(g[1]),
                                static_cast<cuuint64_t>(g[2]), static_cast<cuuint64_t>(g[3])};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(g[4]),
                                   static_cast<cuuint64_t>(g[5]),
                                   static_cast<cuuint64_t>(g[6])};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(g[7]), static_cast<cuuint32_t>(g[8]), 1,
                               1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = fn(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptrs[i]), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          g[9] == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  return 0;
}

template <int D, bool DMAJOR, bool SUM_BF16, bool SHORT = false>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Lq,
           int Lk, const long long* geom, float scale, cudaStream_t s) {
  using C = Cfg<D, DMAJOR, SHORT>;
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
  auto kernel = attn_sm90_kernel<D, DMAJOR, SUM_BF16, SHORT>;
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    configured = true;
  }
  dim3 grid((Lq + C::BQ - 1) / C::BQ, H, B);
  kernel<<<grid, C::THREADS, C::SMEM, s>>>(maps[0], maps[1], maps[2], maps[3], Lq, Lk, scale);
  return static_cast<int>(cudaGetLastError());
}

// The (B, H, L, D) instance: SHORT where the row has at most 128 kv at
// D <= 80 (flash_attention.py::_kv_tile mirrors this choice).
template <int D, bool SUM_BF16>
int launch_bhld(const void* q, const void* k, const void* v, void* out, int B, int H, int Lq,
                int Lk, const long long* geom, float scale, cudaStream_t s) {
  if constexpr (D <= 80) {
    if (Lk <= 128) return launch<D, false, SUM_BF16, true>(q, k, v, out, B, H, Lq, Lk, geom, scale, s);
  }
  return launch<D, false, SUM_BF16>(q, k, v, out, B, H, Lq, Lk, geom, scale, s);
}

}  // namespace sm90
}  // namespace sdt
