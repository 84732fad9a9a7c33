// K2: a whole MaCowUnit inverse in one kernel,
//
//   actnorm2^-1 -> MCF D^-1 (column scan, right to left)
//               -> MCF C^-1 (column scan, left to right) -> actnorm1^-1
//               -> MCF B^-1 (row scan, bottom to top)
//               -> MCF A^-1 (row scan, top to bottom).
//
// Replaces the Pallas kernel ipoke_tpu/ops/pallas/mcf_unit_inverse.py
// (_make_kernel: row_scan / col_scan / kernel, _call,
// macow_unit_inverse_pallas).  Every scan runs in its native orientation with
// the weights as stored: the direction and the axis are index arithmetic, so
// nothing is flipped or transposed.
//
// Grid = B * G CTAs in clusters of G, one cluster per example
// (mcf_cluster_scan.cuh).  Bound on the H100: f32 operations, but the 4 x H
// lines of a unit form one dependent chain, so a launch takes the chain's
// latency.  The design shortens each step of the chain: the hidden and h
// channels are split over the G ranks (G SMs per example), and every weight a
// line reads is in shared memory, staged one MCF ahead by cp.async into a
// ring of two slices while the previous MCF scans.  One cluster barrier per
// line exchanges the partial (mu, logs) through distributed shared memory.
// The kernel is compiled for G in {1, 2, 4, 8}, each with the registry's
// 2 x 3 MCF kernel extent built in and with any other extent read at run time.
#include "mcf_cluster_scan.cuh"

namespace ipoke {

constexpr int kUnitSlices = 2;   // the ring: the MCF that scans and the next one

template <int G, int KSEQ, int KPAR>
__global__ void __launch_bounds__(kClusterThreads, 1)
macow_unit_inverse_kernel(const float* __restrict__ y, const float* __restrict__ h,
                          McfWeights wA, McfWeights wB, McfWeights wC,
                          McfWeights wD, const float* __restrict__ an1,
                          const float* __restrict__ an2, float* __restrict__ out,
                          ClusterDims cd) {
  extern __shared__ float smem[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / G;
  const Dims& d = cd.base;
  const ClusterSmem sm = carve(smem, cd, kUnitSlices);
  unsigned rparts[G];   // every rank's partial block, as seen from this CTA
#pragma unroll
  for (int r = 0; r < G; ++r) rparts[r] = cluster_addr(sm.part, r);

  // MCFs in the order they run; slice m goes to ring[m & 1].  Group 0: the
  // inputs and slice D; group 1: slice C.
  const McfWeights w[4] = {wD, wC, wB, wA};
  const size_t n = (size_t)d.H * d.W * d.C;
  stage_inputs(sm.lat[0], sm.hact, y + b * n,
               h != nullptr ? h + (size_t)b * d.H * d.W * d.hc : nullptr, cd, rank);
  stage_slice(sm.ring[0], w[0], cd, rank);
  cp_async_commit();
  stage_slice(sm.ring[1], w[1], cd, rank);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (h != nullptr) finish_inputs(sm.hact, cd);
  actnorm_inverse(sm.lat[0], an2, d);

  int line = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (m == 2) actnorm_inverse(sm.lat[0], an1, d);   // between MCF C and MCF B
    if (m == 1 || m == 2) cp_async_wait<1>();           // slice m has landed
    if (m == 3) cp_async_wait<0>();
    __syncthreads();
    cluster_scan<G, KSEQ, KPAR>(sm.lat[m & 1], sm.lat[(m + 1) & 1], sm, sm.ring[m & 1], rparts, cd, line,
                 /*col=*/m < 2, /*reverse=*/(m & 1) == 0);
    if (m + 2 < 4) {   // ring[m & 1] is free: stage the MCF after next
      stage_slice(sm.ring[m & 1], w[m + 2], cd, rank);
      cp_async_commit();
    }
  }

  // every rank holds the result; each writes its share
  for (size_t e = (size_t)rank * blockDim.x + threadIdx.x; e < n; e += (size_t)G * blockDim.x) {
    const int c = (int)(e % d.C), pos = (int)(e / d.C);
    out[b * n + e] = sm.lat[0][(pos / d.W) * d.ldr + (pos % d.W) * d.ldc + c];
  }
  // no CTA leaves while another may still read its partials
  cluster_barrier();
}

// One launch of B clusters of G CTAs each, with `bytes` of shared memory per
// CTA; the kernel extent (2, 3) of every registry model is compiled in.
template <int G>
cudaError_t launch_cluster(const ClusterDims& cd, size_t bytes, int B, cudaStream_t stream,
                           const float* y, const float* h, McfWeights wA, McfWeights wB,
                           McfWeights wC, McfWeights wD, const float* an1, const float* an2,
                           float* out) {
  const bool k23 = cd.base.kseq == 2 && cd.base.kpar == 3;
  const auto kernel = k23 ? macow_unit_inverse_kernel<G, 2, 3> : macow_unit_inverse_kernel<G, 0, 0>;
  return launch_clusters(kernel, G, B, bytes, stream, y, h, wA, wB, wC, wD, an1, an2, out, cd);
}

}  // namespace ipoke

// Weights of conv1..conv4 (orders A, B, C, D); an1/an2 are (2, C) stacks of
// [log_scale, bias]; `cluster` is G.  Returns cudaErrorInvalidValue for a G
// that is not a power of two up to 8, does not divide hid and hc, or whose
// shared memory does not fit one CTA; else cudaGetLastError() after the launch.
extern "C" int macow_unit_inverse_launch(
    const float* y, const float* h, const float* wA, const float* w1A,
    const float* bA, const float* wB, const float* w1B, const float* bB,
    const float* wC, const float* w1C, const float* bC, const float* wD,
    const float* w1D, const float* bD, const float* an1, const float* an2,
    float* out, int B, int H, int W, int C, int hid, int hc, int kseq, int kpar,
    float alpha, int act, int cluster, void* stream) {
  using namespace ipoke;
  ClusterDims cd;
  if (!make_cluster_dims(H, W, C, hid, hc, kseq, kpar, alpha, act, cluster, &cd))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = cluster_smem_bytes(cd, kUnitSlices);
  if (bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const McfWeights wA_{wA, w1A, bA}, wB_{wB, w1B, bB}, wC_{wC, w1C, bC}, wD_{wD, w1D, bD};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (cluster) {
    case 1: err = launch_cluster<1>(cd, bytes, B, st, y, h, wA_, wB_, wC_, wD_, an1, an2, out); break;
    case 2: err = launch_cluster<2>(cd, bytes, B, st, y, h, wA_, wB_, wC_, wD_, an1, an2, out); break;
    case 4: err = launch_cluster<4>(cd, bytes, B, st, y, h, wA_, wB_, wC_, wD_, an1, an2, out); break;
    case 8: err = launch_cluster<8>(cd, bytes, B, st, y, h, wA_, wB_, wC_, wD_, an1, an2, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
