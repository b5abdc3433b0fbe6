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
// (B, L, H, D) tensor is taken as it is), read through 4-D tensor maps whose
// zero fill covers the kv tail and the D = 40 contraction padding; the
// output is stored by TMA, packed where the view is packed. Every mode runs
// on the wgmma + TMA core of attn_sm90.cuh:
//   * modes 0, 1 and 3: two passes over 64-row kv tiles (row max, then exp2
//     against V), so every p = exp2(s - final row max) as a whole-row kv
//     block gives it; a row of at most 80 kv at D <= 80 takes the core's
//     persistent short body (one 80-row tile, scores kept in registers; one
//     block per SM walks (b, head pair, 64 query rows) items with K and V
//     of the pair resident), which is how mode 3 (kv 77, the text
//     cross-attention) runs at D = 40 and 80; above 80 kv and at D = 160 it
//     takes the two-pass body, at most two tiles. The short body divides
//     once per row and multiplies (the others divide every output), so its
//     rows round the output apart from the parent's by at most one ulp.
//   * mode 2: the core's online body, ONE pass with the running (m, l, O) in
//     fp32 registers: alpha = exp2(m_prev - m_next) rescales l and O at every
//     kv tile, l adds the fp32 p. Its kv tile (128 at D <= 80, 64 at D = 160)
//     is not the TPU kernel's block_k (1024 at 9216 kv, 4096 at 16384): the
//     function is the same, only the width over which the running maximum
//     each bf16 p is rounded against moves differs;
//     flash_attention.py::_plain_multiblock with block_k = that tile
//     reproduces the card's rounding step for step.
//
// Bound on the H100 at the main-path shapes (H = 8): per (b, h) the work is
// 4 Lq Lk D flops and Lq Lk exp2. The 9216-token rows (mode 2, D = 40,
// B*H = 192) do 1.63e10 exp2 (3.9 ms at 4.18e12/s) against 2.6 ms of
// tensor-core time, so exp2 binds; one online pass issues one Q.K^T per
// tile against the two-pass modes' two. At D = 160 (576 tokens) the tensor
// cores bind; at kv 77 (the text cross-attention, mode 3) the q and output
// streams bind (126 MB in 0.038 ms at (24, 4096, 8*40)): a block per 128
// query rows spent its time on set-up and latency, a persistent walk over one
// head's rows was issue-bound and cut the packed rows' 32-byte sectors
// (80-byte runs per head); items of two adjacent heads read and write
// whole sectors (attn_sm90.cuh has the measurements).

#include "attn_sm90.cuh"

namespace {

using namespace sdt::sm90;

// The body a launch takes (this library's one decision of it; the wrapper
// asks attn_bhld_tile): mode 2 the online body; the others the persistent
// short body where the row has at most 80 kv at D <= 80, else two passes.
int body_of(int D, int Lk, int mode) {
  if (mode == 2) return kOnline;
  return D <= 80 && Lk <= 80 ? kShort : kTwoPass;
}

template <int D, int SUM>
int launch_body(int body, const void* q, const void* k, const void* v, void* out, int B, int H,
                int Lq, int Lk, const long long* geom, float scale, cudaStream_t s) {
  if constexpr (D <= 80) {
    if (body == kShort) return launch<D, false, kShort, SUM>(q, k, v, out, B, H, Lq, Lk, geom, scale, s);
  }
  if constexpr (SUM == kSumF32) {
    if (body == kOnline) return launch<D, false, kOnline, SUM>(q, k, v, out, B, H, Lq, Lk, geom, scale, s);
  }
  return launch<D, false, kTwoPass, SUM>(q, k, v, out, B, H, Lq, Lk, geom, scale, s);
}

template <int D>
int launch_mode(int mode, const void* q, const void* k, const void* v, void* out, int B, int H,
                int Lq, int Lk, const long long* geom, float scale, cudaStream_t s) {
  const int body = body_of(D, Lk, mode);
  switch (mode) {
    case 0:
    case 2: return launch_body<D, kSumF32>(body, q, k, v, out, B, H, Lq, Lk, geom, scale, s);
    case 1: return launch_body<D, kSumBf16>(body, q, k, v, out, B, H, Lq, Lk, geom, scale, s);
    case 3:
      if (Lk > 128) return static_cast<int>(cudaErrorInvalidValue);
      return launch_body<D, kSumCross>(body, q, k, v, out, B, H, Lq, Lk, geom, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int tile_of(int body) {
  if constexpr (D <= 80) {
    if (body == kShort) return Cfg<D, false, kShort>::BK;
  }
  return body == kOnline ? Cfg<D, false, kOnline>::BK : Cfg<D, false, kTwoPass>::BK;
}

}  // namespace

// Head dims this library is instantiated for (SD-1.x: 320/8, 640/8, 1280/8);
// the wrapper raises on others.
extern "C" int attn_bhld_supports(int D) { return D == 40 || D == 80 || D == 160; }

// The body a launch of `mode` at (D, Lk) takes: 0 two-pass, 1 online, 2
// short (sdt::sm90::Body).
extern "C" int attn_bhld_body(int D, int Lk, int mode) { return body_of(D, Lk, mode); }

// The kv rows per tile of that body: the k and v boxes of the launch's
// geometry table (0 for an unsupported D).
extern "C" int attn_bhld_tile(int D, int Lk, int mode) {
  const int body = body_of(D, Lk, mode);
  switch (D) {
    case 40: return tile_of<40>(body);
    case 80: return tile_of<80>(body);
    case 160: return tile_of<160>(body);
    default: return 0;
  }
}

// mode: 0 single block / fp32 row sum, 1 single block / bf16 row sum, 2
// online softmax over the kv tiles, 3 short kv as _kernel_cross_packed
// (Lk <= 128). Any Lk >= 1. geom: the TMA geometry of q, k, v, out
// (sdt::sm90::kGeomLen values each, flash_attention.py::_tma_geometry, with
// the k and v boxes attn_bhld_tile gives). A refused tensor-map encoding
// returns a negative CUresult.
extern "C" int attn_bhld_launch(const void* q, const void* k, const void* v, void* out,
                                int B, int H, int D, int Lq, int Lk, const long long* geom,
                                float scale, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lq < 1 || Lk < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 40: return launch_mode<40>(mode, q, k, v, out, B, H, Lq, Lk, geom, scale, s);
    case 80: return launch_mode<80>(mode, q, k, v, out, B, H, Lq, Lk, geom, scale, s);
    case 160: return launch_mode<160>(mode, q, k, v, out, B, H, Lq, Lk, geom, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-map cache's hits and misses since load, into out[0..1].
extern "C" void attn_bhld_map_cache_stats(long long* out) { map_cache_stats(out); }
