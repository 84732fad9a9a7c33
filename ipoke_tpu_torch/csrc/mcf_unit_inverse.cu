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
// the weights as stored: the direction and the axis are index arithmetic in
// mcf_scan.cuh, so nothing is flipped or transposed.
//
// Grid = B, one block per example.  The six stages pass the latent through
// two shared-memory buffers (ping-pong), so the unit reads y once and writes
// its result once.  Bound on the H100: operations (f32 FMAs), but the 4 x H
// lines form one dependent chain; the design keeps every intermediate on chip
// and reads one MCF's weights at a time from L2/L1 (a unit's f32 weights,
// ~640 KB at C=32, do not fit in shared memory).
#include "mcf_scan.cuh"

namespace ipoke {

__global__ void __launch_bounds__(kThreads)
macow_unit_inverse_kernel(const float* __restrict__ y, const float* __restrict__ h,
                          McfWeights wA, McfWeights wB, McfWeights wC,
                          McfWeights wD, const float* __restrict__ an1,
                          const float* __restrict__ an2, float* __restrict__ out,
                          Dims d) {
  extern __shared__ float smem[];
  float* s0 = smem;
  float* s1 = s0 + d.H * d.ldr;
  float* act_s = s1 + d.H * d.ldr;
  const size_t n = (size_t)d.H * d.W * d.C;
  const float* h_b = h ? h + (size_t)blockIdx.x * d.H * d.W * d.hc : nullptr;

  load_latent(s0, y + blockIdx.x * n, d);
  __syncthreads();
  actnorm_inverse(s0, an2, d);
  __syncthreads();
  mcf_scan(s0, s1, act_s, h_b, wD, d, /*col=*/true, /*reverse=*/true);
  mcf_scan(s1, s0, act_s, h_b, wC, d, /*col=*/true, /*reverse=*/false);
  actnorm_inverse(s0, an1, d);
  __syncthreads();
  mcf_scan(s0, s1, act_s, h_b, wB, d, /*col=*/false, /*reverse=*/true);
  mcf_scan(s1, s0, act_s, h_b, wA, d, /*col=*/false, /*reverse=*/false);
  store_latent(out + blockIdx.x * n, s0, d);
}

}  // namespace ipoke

// Weights of conv1..conv4 (orders A, B, C, D); an1/an2 are (2, C) stacks of
// [log_scale, bias].  Returns cudaGetLastError() after the launch.
extern "C" int macow_unit_inverse_launch(
    const float* y, const float* h, const float* wA, const float* w1A,
    const float* bA, const float* wB, const float* w1B, const float* bB,
    const float* wC, const float* w1C, const float* bC, const float* wD,
    const float* w1D, const float* bD, const float* an1, const float* an2,
    float* out, int B, int H, int W, int C, int hid, int hc, int kseq, int kpar,
    float alpha, int act, void* stream) {
  using namespace ipoke;
  const Dims d = make_dims(H, W, C, hid, hc, kseq, kpar, alpha, act);
  const size_t bytes = smem_bytes(d);
  cudaError_t err = allow_smem(macow_unit_inverse_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  macow_unit_inverse_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      y, h, McfWeights{wA, w1A, bA}, McfWeights{wB, w1B, bB},
      McfWeights{wC, w1C, bC}, McfWeights{wD, w1D, bD}, an1, an2, out, d);
  return (int)cudaGetLastError();
}
