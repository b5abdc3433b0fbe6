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
// so the launch itself is most of its time.
//
// Design: ONE launch. Each row is split over one thread-block cluster of
// 8 CTAs, so B = 8 rows fill about half of the 132 SMs (clusters of 16, a
// non-portable size, fill them all but run no faster). Each CTA
// streams its chunk of the row with 16-byte loads (D % 4 == 0 and 16-byte
// aligned rows; else one element at a time): the row's first units are
// requested before the scalars and ll they are combined with, and each
// thread's next unit before its current one is combined, so the trips to
// memory overlap. The two partial dot products stay in registers; a CTA
// reduces them through its own shared memory (warp shuffles, then the
// warps in order) and writes its pair into rank 0's shared memory
// (distributed shared memory); rank 0 adds the pairs in rank order and
// writes the new ll and kappa: the same result from run to run, no
// atomics, no scratch tensor, no second launch. Every CTA arrives on a
// cluster barrier when it starts and waits on it before its remote write
// (so rank 0 is running; the wait costs nothing after the loads), and a
// full cluster barrier after the writes makes them visible to rank 0. Only
// rank 0's shared memory is written, so the other CTAs may leave once it
// has passed (rank 0 reading the ranks' pairs instead needs a second full
// barrier, so no CTA leaves while its shared memory is read, and ran
// slower). Timed variants of this source put most of the time above the
// launch floor in the reduction tail (PERF.md).
//
// sigma and dsigma are read from device memory (two fp32 scalars), as the
// TPU kernel takes them by scalar prefetch, so one captured launch serves
// every step of a sampler whose step scalars live on the card. T, logp and
// g are launch constants (fixed for a run).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // CTAs a row

// The cluster barrier split in two: every thread of every CTA arrives when
// its CTA starts and waits just before its first remote write, so that
// write finds the target CTA running at no cost to the loads in between.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float or_kappa(const float* ll, int b, float temperature,
                                          float logp) {
  const float a = temperature * (ll[2 * b] + logp);
  const float c = temperature * ll[2 * b + 1];
  const float m = fmaxf(a, c);
  const float ea = expf(a - m);
  const float eb = expf(c - m);
  return ea / (ea + eb);
}

struct OrScalars {
  float sigma, dsigma, noise, kappa, guidance, ll_obj, ll_bg;
};

// one element: writes x + dx and adds its two Ito terms
__device__ __forceinline__ float or_element(float vo, float vb, float vu, float xv, float ev,
                                            const OrScalars& s, float& s_obj, float& s_bg) {
  const float vf = vu + s.guidance * ((vb - vu) + s.kappa * (vo - vb));
  const float dx = 2.0f * s.dsigma * vf + s.noise * ev;
  s_obj += vo * (dx + s.dsigma * vo);
  s_bg += vb * (dx + s.dsigma * vb);
  return xv + dx;
}

// grid (kCluster, B), clusters of kCluster CTAs along x: one cluster a row
__global__ void __launch_bounds__(kThreads)
sd_or_step_cluster(const float* __restrict__ v_obj, const float* __restrict__ v_bg,
                   const float* __restrict__ v_unc, const float* __restrict__ x,
                   const float* __restrict__ eps, const float* __restrict__ ll,
                   float* __restrict__ new_x, float* __restrict__ new_ll,
                   float* __restrict__ kappa_out, const float* __restrict__ sigma_p,
                   const float* __restrict__ dsigma_p, int D, int vec4, float temperature,
                   float logp, float guidance) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * D;
  // the step scalars, this row's ll and kappa: read after the row's first
  // units are requested, so the two trips to memory overlap
  const auto scalars = [&]() {
    OrScalars s;
    s.sigma = *sigma_p;
    s.dsigma = *dsigma_p;
    s.noise = sqrtf(2.0f * fabsf(s.dsigma) * s.sigma);
    s.ll_obj = ll[2 * b];
    s.ll_bg = ll[2 * b + 1];
    s.kappa = or_kappa(ll, b, temperature, logp);
    s.guidance = guidance;
    return s;
  };
  OrScalars s;
  float s_obj = 0.0f, s_bg = 0.0f;
  if (vec4) {
    // this rank's float4 units of the row, each thread's next unit loaded
    // before its current one is combined
    const int units = D >> 2;
    const int per = (units + kCluster - 1) / kCluster;
    const int lo = rank * per, hi = min(units, lo + per);
    const float4* vo4 = reinterpret_cast<const float4*>(v_obj + row);
    const float4* vb4 = reinterpret_cast<const float4*>(v_bg + row);
    const float4* vu4 = reinterpret_cast<const float4*>(v_unc + row);
    const float4* x4 = reinterpret_cast<const float4*>(x + row);
    const float4* e4 = reinterpret_cast<const float4*>(eps + row);
    float4* o4 = reinterpret_cast<float4*>(new_x + row);
    int i = lo + threadIdx.x;
    float4 vo = {}, vb = {}, vu = {}, xv = {}, ev = {};
    if (i < hi) {
      vo = vo4[i];
      vb = vb4[i];
      vu = vu4[i];
      xv = x4[i];
      ev = e4[i];
    }
    s = scalars();
    while (i < hi) {
      const int next = i + kThreads;
      float4 nvo = {}, nvb = {}, nvu = {}, nxv = {}, nev = {};
      if (next < hi) {
        nvo = vo4[next];
        nvb = vb4[next];
        nvu = vu4[next];
        nxv = x4[next];
        nev = e4[next];
      }
      float4 o;
      o.x = or_element(vo.x, vb.x, vu.x, xv.x, ev.x, s, s_obj, s_bg);
      o.y = or_element(vo.y, vb.y, vu.y, xv.y, ev.y, s, s_obj, s_bg);
      o.z = or_element(vo.z, vb.z, vu.z, xv.z, ev.z, s, s_obj, s_bg);
      o.w = or_element(vo.w, vb.w, vu.w, xv.w, ev.w, s, s_obj, s_bg);
      o4[i] = o;
      vo = nvo;
      vb = nvb;
      vu = nvu;
      xv = nxv;
      ev = nev;
      i = next;
    }
  } else {
    s = scalars();
    const int per = (D + kCluster - 1) / kCluster;
    const int lo = rank * per, hi = min(D, lo + per);
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      const size_t k = row + i;
      new_x[k] = or_element(v_obj[k], v_bg[k], v_unc[k], x[k], eps[k], s, s_obj, s_bg);
    }
  }

  // this CTA's pair: warp shuffles, then thread 0 over the warps in order,
  // written into rank 0's shared memory
  __shared__ float red[2][kWarps];
  __shared__ float pairs[kCluster][2];  // rank 0's: every rank's pair
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
  cluster_wait();  // every CTA of the cluster runs: rank 0 may be written
  if (threadIdx.x == 0) {
    float to = 0.0f, tb = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      to += red[0][w];
      tb += red[1][w];
    }
    float* dst = cluster.map_shared_rank(&pairs[rank][0], 0);
    dst[0] = to;
    dst[1] = tb;
  }
  cluster.sync();  // every rank's pair is in rank 0's shared memory
  if (rank == 0 && threadIdx.x == 0) {
    // the pairs in rank order
    float to = 0.0f, tb = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      to += pairs[r][0];
      tb += pairs[r][1];
    }
    kappa_out[b] = s.kappa;
    new_ll[2 * b] = s.ll_obj - to / s.sigma;
    new_ll[2 * b + 1] = s.ll_bg - tb / s.sigma;
  }
}

cudaLaunchConfig_t cluster_config(cudaLaunchAttribute& attr, int cluster, int B,
                                  cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" int sd_or_step_launch(const void* v_obj, const void* v_bg, const void* v_unc,
                                 const void* x, const void* eps, const void* ll,
                                 void* new_x, void* new_ll, void* kappa, const void* sigma,
                                 const void* dsigma, int B, int D, float temperature,
                                 float logp, float guidance, void* stream) {
  if (B < 1 || B > 65535 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const int vec4 = D % 4 == 0 && aligned(v_obj) && aligned(v_bg) && aligned(v_unc) &&
                   aligned(x) && aligned(eps) && aligned(new_x);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(attr, kCluster, B, static_cast<cudaStream_t>(stream));
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, sd_or_step_cluster, static_cast<const float*>(v_obj),
      static_cast<const float*>(v_bg), static_cast<const float*>(v_unc),
      static_cast<const float*>(x), static_cast<const float*>(eps),
      static_cast<const float*>(ll), static_cast<float*>(new_x), static_cast<float*>(new_ll),
      static_cast<float*>(kappa), static_cast<const float*>(sigma),
      static_cast<const float*>(dsigma), D, vec4, temperature, logp, guidance);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
