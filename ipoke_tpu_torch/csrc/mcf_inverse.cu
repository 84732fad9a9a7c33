// K1: the inverse of one affine masked-conv flow in canonical order A
// (row scan, top to bottom).  Replaces the Pallas kernel
// ipoke_tpu/ops/pallas/mcf_inverse.py (_kernel / _call / mcf_inverse_pallas);
// orders B/C/D reach it through the flips and transposes of
// ipoke_tpu_torch/flows/mcf.py (_canonicalize).
//
// Grid = B, one block per example; the recurrence over the H rows runs inside
// the block (mcf_scan.cuh).  Bound on the H100: operations (f32 FMAs of the
// context conv and the 1x1 conv), but the H rows form a chain, so the kernel
// runs at the latency of that chain, not at either roofline.  The design keeps
// the latent and the per-row activations in shared memory, so no row goes
// back to device memory between steps, and reads the weights from L2/L1.
#include "mcf_scan.cuh"

namespace ipoke {

__global__ void __launch_bounds__(kThreads)
mcf_inverse_kernel(const float* __restrict__ z, const float* __restrict__ h,
                   McfWeights wt, float* __restrict__ out, Dims d) {
  extern __shared__ float smem[];
  float* in_s = smem;
  float* out_s = in_s + d.H * d.ldr;
  float* act_s = out_s + d.H * d.ldr;
  const size_t n = (size_t)d.H * d.W * d.C;
  const float* h_b = h ? h + (size_t)blockIdx.x * d.H * d.W * d.hc : nullptr;

  load_latent(in_s, z + blockIdx.x * n, d);
  __syncthreads();
  mcf_scan(in_s, out_s, act_s, h_b, wt, d, /*col=*/false, /*reverse=*/false);
  store_latent(out + blockIdx.x * n, out_s, d);
}

}  // namespace ipoke

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mcf_inverse_launch(const float* z, const float* h,
                                  const float* w_shift, const float* w1,
                                  const float* b1, float* out, int B, int H,
                                  int W, int C, int hid, int hc, int kseq,
                                  int kpar, float alpha, int act, void* stream) {
  using namespace ipoke;
  const Dims d = make_dims(H, W, C, hid, hc, kseq, kpar, alpha, act);
  const size_t bytes = smem_bytes(d);
  cudaError_t err = allow_smem(mcf_inverse_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  mcf_inverse_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      z, h, McfWeights{w_shift, w1, b1}, out, d);
  return (int)cudaGetLastError();
}
