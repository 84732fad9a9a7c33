// Device functions shared by the two masked-conv-flow (MCF) inverse kernels:
// mcf_inverse.cu (one MCF, canonical order A) and mcf_unit_inverse.cu (a whole
// MaCowUnit, every MCF in its native orientation).
//
// One thread block owns one batch example and keeps its (H, W, C) latent in
// shared memory.  An MCF inverse is a recurrence along one spatial axis (the
// "sequential" axis: rows for orders A/B, columns for C/D); each step inverts
// one line of P positions along the other ("parallel") axis:
//
//   ctx[p, j] = sum_{r<kseq, s<kpar, c} out[q(r), p+s-cp, c] * w_shift[j, c, .., ..]
//   act[p]    = act_fn(ctx[p, :] ++ h[i, p, :])                 (hid + hc)
//   mu, logs  = act[p] @ w1^T + b1                               (2C)
//   out[i, p] = (in[i, p] - mu) / (1 + alpha * tanh(logs / 2) + 1e-12)
//
// where q(r) = i - kseq + r scanning forward and i + 1 + r scanning in reverse,
// and positions outside the latent are the zero padding of the shifted conv.
// The context is read straight from the output lines already inverted, so no
// window is rolled.  Each step is two phases separated by __syncthreads():
// the context (with the activation fused), then the 1x1 conv fused with the
// affine inverse.
//
// Weights are read in the port's own layouts, from global memory (L2/L1):
//   w_shift  OIHW (hid, C, KH, KW): (kseq, kpar) for row scans, (kpar, kseq)
//            for column scans, exactly as the MCF stores them;
//   w1       (2C, hid + hc), the weight-normed 1x1 conv; b1 (2C).
#pragma once

#include <cuda_runtime.h>

namespace ipoke {

constexpr int kThreads = 256;

// Activation codes; ops/cuda/_build.py ACT_CODES holds the same table.
enum Act { ACT_ELU = 0, ACT_RELU = 1, ACT_LEAKY_RELU = 2 };

__device__ __forceinline__ float activate(float x, int act) {
  if (act == ACT_ELU) return x > 0.f ? x : expm1f(x);
  if (act == ACT_RELU) return fmaxf(x, 0.f);
  return x > 0.f ? x : 0.1f * x;
}

struct Dims {
  int H, W, C;      // latent extent of one example
  int hid, hc;      // shifted-conv output channels, conditioning channels
  int kseq, kpar;   // kernel extent along the sequential / parallel axis
  float alpha;
  int act;
  // shared-memory strides in floats, odd so that the 8 positions of a line
  // fall in distinct banks: per position, per latent row, per activation row
  int ldc, ldr, lda;
};

struct McfWeights {
  const float* w_shift;
  const float* w1;
  const float* b1;
};

inline Dims make_dims(int H, int W, int C, int hid, int hc, int kseq, int kpar,
                      float alpha, int act) {
  Dims d{H, W, C, hid, hc, kseq, kpar, alpha, act, 0, 0, 0};
  d.ldc = C | 1;
  d.ldr = (W * d.ldc) | 1;
  d.lda = (hid + hc) | 1;
  return d;
}

// Two latent buffers and one activation buffer.
inline size_t smem_bytes(const Dims& d) {
  const int p_max = d.H > d.W ? d.H : d.W;
  return sizeof(float) * (2 * (size_t)d.H * d.ldr + (size_t)p_max * d.lda);
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Global NHWC (one example) -> padded shared layout.
__device__ inline void load_latent(float* dst, const float* __restrict__ src,
                                   const Dims& d) {
  const int n = d.H * d.W * d.C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % d.C, pos = e / d.C;
    dst[(pos / d.W) * d.ldr + (pos % d.W) * d.ldc + c] = src[e];
  }
}

__device__ inline void store_latent(float* __restrict__ dst, const float* src,
                                    const Dims& d) {
  const int n = d.H * d.W * d.C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % d.C, pos = e / d.C;
    dst[e] = src[(pos / d.W) * d.ldr + (pos % d.W) * d.ldc + c];
  }
}

// ActNorm inverse in place; an = [log_scale (C), bias (C)].
__device__ inline void actnorm_inverse(float* x, const float* __restrict__ an,
                                       const Dims& d) {
  const int n = d.H * d.W * d.C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % d.C, pos = e / d.C;
    float* v = x + (pos / d.W) * d.ldr + (pos % d.W) * d.ldc + c;
    *v = (*v - an[d.C + c]) / (expf(an[c]) + 1e-8f);
  }
}

// One MCF inverse: in_s -> out_s (both shared, padded layout).  h_g is this
// example's NHWC conditioning in global memory, or nullptr.  Ends synchronised.
__device__ inline void mcf_scan(const float* in_s, float* out_s, float* act_s,
                                const float* __restrict__ h_g, McfWeights wt,
                                const Dims& d, bool col, bool reverse) {
  const int L = col ? d.W : d.H;            // sequential extent
  const int P = col ? d.H : d.W;            // parallel extent
  const int seq_s = col ? d.ldc : d.ldr;    // shared strides
  const int par_s = col ? d.ldr : d.ldc;
  const int hseq = col ? d.hc : d.W * d.hc; // global NHWC strides of h
  const int hpar = col ? d.W * d.hc : d.hc;
  const int ksz = d.kseq * d.kpar;
  const int wseq = col ? 1 : d.kpar;        // OIHW offsets of a tap
  const int wpar = col ? d.kseq : 1;
  const int cp = (d.kpar - 1) / 2;
  const int K = d.hid + d.hc;

  for (int t = 0; t < L; ++t) {
    const int i = reverse ? L - 1 - t : t;
    // phase 1: context conv over the lines already inverted, then act_fn
    for (int o = threadIdx.x; o < P * d.hid; o += blockDim.x) {
      const int p = o % P, j = o / P;
      const float* __restrict__ wj = wt.w_shift + (size_t)j * d.C * ksz;
      float acc = 0.f;
      for (int r = 0; r < d.kseq; ++r) {
        const int q = reverse ? i + 1 + r : i - d.kseq + r;
        if (q < 0 || q >= L) continue;
        for (int s = 0; s < d.kpar; ++s) {
          const int pp = p + s - cp;
          if (pp < 0 || pp >= P) continue;
          const float* src = out_s + q * seq_s + pp * par_s;
          const float* __restrict__ wk = wj + r * wseq + s * wpar;
          for (int c = 0; c < d.C; ++c) acc = fmaf(src[c], wk[c * ksz], acc);
        }
      }
      act_s[p * d.lda + j] = activate(acc, d.act);
    }
    if (h_g != nullptr) {
      for (int o = threadIdx.x; o < P * d.hc; o += blockDim.x) {
        const int p = o / d.hc, k = o % d.hc;
        act_s[p * d.lda + d.hid + k] = activate(h_g[i * hseq + p * hpar + k], d.act);
      }
    }
    __syncthreads();
    // phase 2: 1x1 conv to (mu, logs) and the affine inverse of line i
    for (int o = threadIdx.x; o < P * d.C; o += blockDim.x) {
      const int p = o % P, c = o / P;
      const float* a = act_s + p * d.lda;
      const float* __restrict__ wm = wt.w1 + (size_t)c * K;
      const float* __restrict__ wl = wt.w1 + (size_t)(d.C + c) * K;
      float mu = wt.b1[c], ls = wt.b1[d.C + c];
      for (int k = 0; k < K; ++k) {
        const float ak = a[k];
        mu = fmaf(ak, wm[k], mu);
        ls = fmaf(ak, wl[k], ls);
      }
      const float scale = tanhf(ls * 0.5f) * d.alpha + 1.0f;
      const int idx = i * seq_s + p * par_s + c;
      out_s[idx] = (in_s[idx] - mu) / (scale + 1e-12f);
    }
    __syncthreads();
  }
}

}  // namespace ipoke
