// Fused N-model VP-SDE OR step epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel superdiff_tpu/ops/pallas/fused_step.py:36 (_kernel,
// called through fused_sde_step_pallas). Per batch row b, all fp32:
//
//   w        = softmax(T logq[b, :])                       (OR weights)
//   dx       = -dt (da x - 2 beta sum_n w_n s_n) + sqrt(2 sigma beta dt) eps
//   x_new    = x + dx ;  f_next = da x_new ;  v_n = da x - 2 beta s_n
//   logq_n  += sum_D (f_next - v_n)(dt v_n + 2 dx + dt f_next) / (4 sigma beta)
//   logq    -= max_n logq
//
// Bound on the H100: bytes. The pass reads the N score rows, x and eps and
// writes x_new, (N + 3) B D 4 bytes: 6.1 MB at the CIFAR main path (N = 2,
// B = 100, D = 3072), 1.8 us at 3.35 TB/s, so in practice the launch bounds it.
//
// Design: ONE launch; each batch row is split over one thread-block cluster
// of up to kMaxCluster CTAs (`cluster_size`: enough CTAs that each thread
// has one 16-byte unit of the row, so 3 at the main path: 300 CTAs instead
// of 100 latency-bound ones). Threads stride their CTA's chunk in float4 (a
// scalar loop when D % 4 != 0 or a pointer is not 16-byte aligned; any D is
// taken); the row's first units are requested before the logq and the
// scalars they are combined with, and each thread's next unit before its
// current one is combined. Every CTA takes the softmax over N from its
// row's logq; each thread keeps N partial sums in registers (N is a runtime
// argument up to kMaxModels, in a kernel of 2, 4 or 8 model slots: the
// guarded, unrolled model loops keep the accumulators out of local memory,
// and two slots keep the main path's registers low enough for four CTAs on
// an SM, so all 300 CTAs run in one wave). A CTA reduces its N sums in a
// fixed order (warp shuffles, then the warps in order) and writes them into
// rank 0's shared memory (distributed shared memory); rank 0 adds each
// model's sums in rank order and renormalises, so logq is the same from run
// to run (no atomics, no scratch). Every CTA arrives on a cluster barrier
// when it starts and waits on it before its remote write (rank 0 is then
// running), and a full cluster barrier after the writes makes them visible
// to rank 0; only rank 0's shared memory is written, so the others may
// leave once it has passed.
// da, beta, sigma and dt are read from device memory (fp32 scalars), as the
// TPU kernel takes them by scalar prefetch, so one captured launch serves
// every step; T is a launch constant.
// T * logq is rounded before the max is subtracted (no FMA contraction), as
// the reference computes it: at T = 1e6 a contracted product would move the
// OR weights by the rounding error times T.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxModels = 8;

// The cluster barrier split in two: every thread of every CTA arrives when
// its CTA starts and waits just before its first remote write, so that
// write finds the target CTA running at no cost to the loads in between.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One element: the EM update (returns x + dx) and the N Itô numerators; NM
// model slots (a compile-time bound on the runtime N).
template <int NM>
__device__ __forceinline__ float step_element(float xv, float ev, const float (&sv)[NM],
                                              const float (&w)[NM], float (&acc)[NM], int N,
                                              float da, float two_beta, float dt,
                                              float noise) {
  float bal = 0.0f;
#pragma unroll
  for (int n = 0; n < NM; ++n)
    if (n < N) bal += w[n] * sv[n];
  const float dx = -dt * (da * xv - two_beta * bal) + noise * ev;
  const float out = xv + dx;
  const float f_next = da * out;
#pragma unroll
  for (int n = 0; n < NM; ++n) {
    if (n < N) {
      const float v = da * xv - two_beta * sv[n];
      acc[n] += (f_next - v) * (dt * v + 2.0f * dx + dt * f_next);
    }
  }
  return out;
}

// grid (cluster, B), clusters of `cluster` CTAs along x: one cluster a row;
// NM model slots (2, 4 or 8: the fewest that hold N, so the registers of
// the main path's N = 2 leave room for four CTAs on an SM)
template <int NM>
__global__ void __launch_bounds__(kThreads)
fused_sde_step_cluster(const float* __restrict__ s, const float* __restrict__ x,
                       const float* __restrict__ eps, const float* __restrict__ logq,
                       float* __restrict__ new_x, float* __restrict__ new_logq, int N, int B,
                       int D, int vec4, const float* __restrict__ sigma_p,
                       const float* __restrict__ beta_p, const float* __restrict__ da_p,
                       const float* __restrict__ dt_p, float temperature) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * D;
  const size_t model_stride = static_cast<size_t>(B) * D;
  float w[NM], acc[NM], lq[NM];
  float two_beta, noise, da, dt, sigma, beta;
  // the OR weights of this row (softmax over the rounded T * logq) and the
  // step scalars: read after the row's first units are requested, so the
  // two trips to memory overlap
  const auto weights = [&]() {
    sigma = *sigma_p;
    beta = *beta_p;
    da = *da_p;
    dt = *dt_p;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      lq[n] = n < N ? logq[b * N + n] : 0.0f;
      w[n] = n < N ? __fmul_rn(temperature, lq[n]) : -CUDART_INF_F;
      m = fmaxf(m, w[n]);
    }
    float z = 0.0f;
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      w[n] = n < N ? expf(w[n] - m) : 0.0f;
      z += w[n];
    }
#pragma unroll
    for (int n = 0; n < NM; ++n) w[n] = w[n] / z;
    two_beta = 2.0f * beta;
    noise = sqrtf(2.0f * sigma * beta * dt);
  };
#pragma unroll
  for (int n = 0; n < NM; ++n) acc[n] = 0.0f;

  if (vec4) {
    // this rank's float4 units of the row, each thread's next unit loaded
    // before its current one is combined
    const int units = D >> 2;
    const int per = (units + ranks - 1) / ranks;
    const int lo = rank * per, hi = min(units, lo + per);
    const float4* x4 = reinterpret_cast<const float4*>(x + row);
    const float4* e4 = reinterpret_cast<const float4*>(eps + row);
    float4* o4 = reinterpret_cast<float4*>(new_x + row);
    const auto load = [&](int i, float4& xv, float4& ev, float4 (&sv)[NM]) {
      xv = x4[i];
      ev = e4[i];
#pragma unroll
      for (int n = 0; n < NM; ++n)
        if (n < N) sv[n] = reinterpret_cast<const float4*>(s + n * model_stride + row)[i];
    };
    int i = lo + threadIdx.x;
    float4 xv = {}, ev = {}, sv[NM] = {};
    if (i < hi) load(i, xv, ev, sv);
    weights();
    while (i < hi) {
      const int next = i + kThreads;
      float4 nxv = {}, nev = {}, nsv[NM] = {};
      if (next < hi) load(next, nxv, nev, nsv);
      float s0[NM], s1[NM], s2[NM], s3[NM];
#pragma unroll
      for (int n = 0; n < NM; ++n) {
        s0[n] = sv[n].x;
        s1[n] = sv[n].y;
        s2[n] = sv[n].z;
        s3[n] = sv[n].w;
      }
      float4 o;
      o.x = step_element<NM>(xv.x, ev.x, s0, w, acc, N, da, two_beta, dt, noise);
      o.y = step_element<NM>(xv.y, ev.y, s1, w, acc, N, da, two_beta, dt, noise);
      o.z = step_element<NM>(xv.z, ev.z, s2, w, acc, N, da, two_beta, dt, noise);
      o.w = step_element<NM>(xv.w, ev.w, s3, w, acc, N, da, two_beta, dt, noise);
      o4[i] = o;
      xv = nxv;
      ev = nev;
#pragma unroll
      for (int n = 0; n < NM; ++n) sv[n] = nsv[n];
      i = next;
    }
  } else {
    weights();
    const int per = (D + ranks - 1) / ranks;
    const int lo = rank * per, hi = min(D, lo + per);
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      float sv[NM];
#pragma unroll
      for (int n = 0; n < NM; ++n)
        if (n < N) sv[n] = s[n * model_stride + row + i];
      new_x[row + i] =
          step_element<NM>(x[row + i], eps[row + i], sv, w, acc, N, da, two_beta, dt, noise);
    }
  }

  // this CTA's N sums: warp shuffles, then thread 0 over the warps in order,
  // written into rank 0's shared memory
  __shared__ float red[NM][kWarps];
  __shared__ float sums[kMaxCluster][NM];  // rank 0's: every rank's sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < NM; ++n) {
    if (n < N) {
      float v = acc[n];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[n][warp] = v;
    }
  }
  __syncthreads();
  cluster_wait();  // every CTA of the cluster runs: rank 0 may be written
  if (threadIdx.x == 0) {
    float* dst = cluster.map_shared_rank(&sums[rank][0], 0);
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      if (n < N) {
        float total = 0.0f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) total += red[n][k];
        dst[n] = total;
      }
    }
  }
  cluster.sync();  // every rank's sums are in rank 0's shared memory
  if (rank == 0 && threadIdx.x == 0) {
    // each model's sums in rank order, then the max-renormalisation
    const float den = 4.0f * sigma * beta;
    float out[NM];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      float total = 0.0f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < ranks) total += sums[r][n];
      out[n] = n < N ? lq[n] + total / den : -CUDART_INF_F;
      mx = fmaxf(mx, out[n]);
    }
#pragma unroll
    for (int n = 0; n < NM; ++n)
      if (n < N) new_logq[b * N + n] = out[n] - mx;
  }
}

// CTAs a row: one 16-byte unit (or element) per thread, at most kMaxCluster
int cluster_size(int D, int vec4) {
  const int units = vec4 ? D / 4 : D;
  const int n = (units + kThreads - 1) / kThreads;
  return n < 1 ? 1 : n > kMaxCluster ? kMaxCluster : n;
}

bool vec4_ok(int D, const void* sscores, const void* x, const void* eps, const void* new_x) {
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  return D % 4 == 0 && aligned(sscores) && aligned(x) && aligned(eps) && aligned(new_x);
}

}  // namespace

extern "C" int fused_sde_step_max_models() { return kMaxModels; }

// sigma, beta, da, dt: device pointers to fp32 scalars
extern "C" int fused_sde_step_launch(const void* sscores, const void* x, const void* eps,
                                     const void* logq, void* new_x, void* new_logq, int N,
                                     int B, int D, const void* sigma, const void* beta,
                                     const void* da, const void* dt, float temperature,
                                     void* stream) {
  if (N < 1 || N > kMaxModels || B < 1 || B > 65535 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec4 = vec4_ok(D, sscores, x, eps, new_x);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  const int cluster = cluster_size(D, vec4);
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const auto kernel = N <= 2   ? fused_sde_step_cluster<2>
                      : N <= 4 ? fused_sde_step_cluster<4>
                               : fused_sde_step_cluster<kMaxModels>;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(sscores), static_cast<const float*>(x),
      static_cast<const float*>(eps), static_cast<const float*>(logq),
      static_cast<float*>(new_x), static_cast<float*>(new_logq), N, B, D, vec4,
      static_cast<const float*>(sigma), static_cast<const float*>(beta),
      static_cast<const float*>(da), static_cast<const float*>(dt), temperature);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
