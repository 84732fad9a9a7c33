// K1: the inverse of one affine masked-conv flow, in any of the four orders
// (A rows forward, B rows reverse, C columns forward, D columns reverse).
// Replaces the Pallas kernel ipoke_tpu/ops/pallas/mcf_inverse.py
// (_kernel / _call / mcf_inverse_pallas), which takes canonical order A and
// leaves B/C/D to flips and transposes; here every order runs in its native
// orientation on z, h and w_shift as stored, so nothing is copied around it.
//
// Grid = B * G CTAs in clusters of G, one cluster per example
// (mcf_cluster_scan.cuh).  Bound on the H100: f32 operations, but the lines
// of the scan form one dependent chain, so a launch takes the chain's
// latency.  The design shortens each line: the hidden and h channels are
// split over the G ranks (G SMs per example), and the rank's weight slice is
// in shared memory before its first use.  It is staged by cp.async in two
// groups: the inputs and the w_shift rows first, then the w1 columns and b1,
// which land while the first line's context runs.  One cluster barrier per
// line exchanges the partial (mu, logs) through distributed shared memory.
// The kernel is compiled for G in {1, 2, 4, 8}, each with the registry's
// 2 x 3 MCF kernel extent built in and with any other extent read at run time.
#include "mcf_cluster_scan.cuh"

namespace ipoke {

constexpr int kMcfSlices = 1;   // one MCF, one weight slice

template <int G, int KSEQ, int KPAR>
__global__ void __launch_bounds__(kClusterThreads, 1)
mcf_inverse_kernel(const float* __restrict__ z, const float* __restrict__ h, McfWeights wt,
                   float* __restrict__ out, ClusterDims cd, bool col, bool reverse) {
  extern __shared__ float smem[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / G;
  const Dims& d = cd.base;
  const ClusterSmem sm = carve(smem, cd, kMcfSlices);
  unsigned rparts[G];   // every rank's partial block, as seen from this CTA
#pragma unroll
  for (int r = 0; r < G; ++r) rparts[r] = cluster_addr(sm.part, r);

  // group 0: the inputs and the w_shift rows; group 1: the w1 columns and b1,
  // awaited by the scan after the first line's step 1
  const size_t n = (size_t)d.H * d.W * d.C;
  stage_inputs(sm.lat[0], sm.hact, z + b * n,
               h != nullptr ? h + (size_t)b * d.H * d.W * d.hc : nullptr, cd, rank);
  stage_shift(sm.ring[0], wt, cd, rank);
  cp_async_commit();
  stage_conv1x1(sm.ring[0], wt, cd, rank);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (h != nullptr) {
    finish_inputs(sm.hact, cd);
    __syncthreads();
  }

  int line = 0;
  cluster_scan<G, KSEQ, KPAR, /*AWAIT_CONV1X1=*/true>(sm.lat[0], sm.lat[1], sm, sm.ring[0], rparts,
                                                      cd, line, col, reverse);

  // every rank holds the result; each writes its share
  for (size_t e = (size_t)rank * blockDim.x + threadIdx.x; e < n; e += (size_t)G * blockDim.x) {
    const int c = (int)(e % d.C), pos = (int)(e / d.C);
    out[b * n + e] = sm.lat[1][(pos / d.W) * d.ldr + (pos % d.W) * d.ldc + c];
  }
  // no CTA leaves while another may still read its partials
  cluster_barrier();
}

// One launch of B clusters of G CTAs each; the kernel extent (2, 3) of every
// registry model is compiled in.
template <int G>
cudaError_t launch_cluster(const ClusterDims& cd, size_t bytes, int B, cudaStream_t stream,
                           const float* z, const float* h, McfWeights wt, float* out, bool col,
                           bool reverse) {
  const bool k23 = cd.base.kseq == 2 && cd.base.kpar == 3;
  const auto kernel = k23 ? mcf_inverse_kernel<G, 2, 3> : mcf_inverse_kernel<G, 0, 0>;
  return launch_clusters(kernel, G, B, bytes, stream, z, h, wt, out, cd, col, reverse);
}

}  // namespace ipoke

// z, h (or nullptr), out: (B, H, W, C|hc) NHWC; w_shift OIHW as stored,
// (hid, C, kseq, kpar) for row scans (col = 0) and (hid, C, kpar, kseq) for
// column scans (col = 1); w1 (2C, hid + hc); b1 (2C); `reverse` scans from
// the last line; `cluster` is G.  Returns cudaErrorInvalidValue for a G that
// is not a power of two up to 8, does not divide hid and hc, or whose shared
// memory does not fit one CTA; else cudaGetLastError() after the launch.
extern "C" int mcf_inverse_launch(const float* z, const float* h, const float* w_shift,
                                  const float* w1, const float* b1, float* out, int B, int H,
                                  int W, int C, int hid, int hc, int kseq, int kpar, float alpha,
                                  int act, int col, int reverse, int cluster, void* stream) {
  using namespace ipoke;
  ClusterDims cd;
  if (!make_cluster_dims(H, W, C, hid, hc, kseq, kpar, alpha, act, cluster, &cd))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = cluster_smem_bytes(cd, kMcfSlices);
  if (bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const McfWeights wt{w_shift, w1, b1};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool c = col != 0, r = reverse != 0;
  cudaError_t err;
  switch (cluster) {
    case 1: err = launch_cluster<1>(cd, bytes, B, st, z, h, wt, out, c, r); break;
    case 2: err = launch_cluster<2>(cd, bytes, B, st, z, h, wt, out, c, r); break;
    case 4: err = launch_cluster<4>(cd, bytes, B, st, z, h, wt, out, c, r); break;
    case 8: err = launch_cluster<8>(cd, bytes, B, st, z, h, wt, out, c, r); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
