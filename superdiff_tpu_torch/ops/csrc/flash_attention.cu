// Long-row softmax attention in the d-major layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel superdiff_tpu/ops/pallas/flash_attention.py::
// _make_pvtd_kernel (pvtd1 / pvtd2, called through _flash_eod from
// flash_mha_eod). Layouts as the JAX entry point has them: q, v and the
// output in (B, H, D, L), k in (B, H, L, D) (k may be a strided view with
// unit stride along D). Numerics follow pvtd: q pre-scaled by
// bf16(sm_scale * log2 e) and rounded to bf16, fp32 base-2 scores,
// p = exp2(s - row max) rounded to bf16 and that same bf16 p feeding both
// P.V and the row sum (pvtd's ones row in V^T), fp32 accumulation, one
// divide, bf16 output.
//
// This is the d-major instance of the wgmma + TMA core in attn_sm90.cuh
// (two passes over k, so every p is rounded against the final row max as
// pvtd's whole-row kv block gives it): q is read MN-major and V^T K-major
// straight from their (B, H, D, L) tensors, k K-major from its view, and the
// output is transposed in shared memory and stored d-major by TMA.
//
// Bound on the H100 at the main-path shapes (H = 8): the 4096-token layer
// with D = 40 at B = 24 does 4*24*8*4096^2*40 = 515 GFLOP (0.52 ms at
// 989 TFLOP/s) and 3.2e9 exp2 (0.77 ms on the SFUs), so exp2 binds; the
// 1024-token layer (D = 80, B = 24) is bound by the tensor cores (0.065 ms).

#include "attn_sm90.cuh"

// Head dims this library is instantiated for (SD-1.x: 320/8, 640/8, 1280/8);
// the wrapper raises on others.
extern "C" int attn_eod_supports(int D) { return D == 40 || D == 80 || D == 160; }

// The kv rows per tile (the k box of the geometry table); L must be a
// multiple of it (pvtd's own rule; the kernel clips any tail).
extern "C" int attn_eod_tile() { return sdt::sm90::Cfg<40, true, sdt::sm90::kTwoPass>::BK; }

// geom: the TMA geometry of qt, k, vt and out (sdt::sm90::kGeomLen values
// each, as flash_attention.py::_tma_geometry computes them). Returns a CUDA
// error, or a refused tensor-map encoding as a negative CUresult.
extern "C" int attn_eod_launch(const void* qt, const void* k, const void* vt, void* out,
                               int B, int H, int D, int L, const long long* geom, float scale,
                               void* stream) {
  using namespace sdt::sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch<40, true, kTwoPass, kSumBf16>(qt, k, vt, out, B, H, L, L, geom, scale, s);
    case 80: return launch<80, true, kTwoPass, kSumBf16>(qt, k, vt, out, B, H, L, L, geom, scale, s);
    case 160: return launch<160, true, kTwoPass, kSumBf16>(qt, k, vt, out, B, H, L, L, geom, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-map cache's hits and misses since load, into out[0..1].
extern "C" void attn_eod_map_cache_stats(long long* out) { sdt::sm90::map_cache_stats(out); }
