// The inverse of one masked-conv flow (MCF) by a thread-block cluster: G CTAs
// own one batch example together.  Shared by both MCF inverse kernels: K1
// (mcf_inverse.cu, one MCF) and K2 (mcf_unit_inverse.cu, a whole MaCowUnit).
//
// An MCF inverse is a recurrence along one spatial axis (the "sequential"
// axis: rows for orders A/B, columns for C/D); each step inverts one line of
// P positions along the other ("parallel") axis:
//
//   ctx[p, j] = sum_{r<kseq, s<kpar, c} out[q(r), p+s-cp, c] * w_shift[j, c, .., ..]
//   act[p]    = act_fn(ctx[p, :] ++ h[i, p, :])                 (hid + hc)
//   mu, logs  = act[p] @ w1^T + b1                               (2C)
//   out[i, p] = (in[i, p] - mu) / (1 + alpha * tanh(logs / 2) + 1e-12)
//
// where q(r) = i - kseq + r scanning forward and i + 1 + r scanning in reverse,
// and positions outside the latent are the zero padding of the shifted conv.
// Every order runs in its native orientation: the axis and the direction are
// index arithmetic, and the weights are read as stored (w_shift OIHW, with
// (kseq, kpar) for row scans and (kpar, kseq) for column scans; w1 (2C,
// hid + hc), the weight-normed 1x1 conv; b1 (2C)), so nothing is flipped or
// transposed.
//
// Split over the cluster: rank g owns the hidden channels J_g = [g*jg, (g+1)*jg)
// (jg = hid / G) and the h channels [g*kg, (g+1)*kg) (kg = hc / G).  Its shared
// memory holds
//   * both latent buffers (ping-pong), replicated in every rank, at odd
//     strides (make_dims) so that the positions of a line fall in distinct
//     banks;
//   * act_fn(h) of its h channels at all H x W positions, computed once per
//     launch (h is the same for every MCF of a unit);
//   * the activation rows of one line: its jg hidden, then its kg h channels;
//   * a double-buffered block of partial (mu, logs) pairs, P x C float2;
//   * the weight slices, one MCF each: the w_shift rows J_g (tap-major), the
//     w1 columns of J_g and of its h channels, and all of b1.  K1 holds one
//     slice, K2 a ring of two (one MCF ahead), or one where two do not fit.  They are staged with 4-byte
//     cp.async (any alignment, any layout), so no weight is read from global
//     memory inside the line loop.
//
// Each line, on every rank:
//   1. ctx and act of (p, j in J_g) from the lines already inverted, and
//      act_fn(h) of line i copied beside them; __syncthreads.
//   2. the rank's partial (mu, logs) over its hidden and h channels, into
//      part[line & 1].
//   3. one cluster barrier (barrier.cluster arrive.release / wait.acquire).
//   4. every rank reads the G partials through distributed shared memory
//      (ld.shared::cluster, all G in flight at once), sums them in rank order
//      0..G-1, adds b1, and inverts line i of its own latent copy;
//      __syncthreads.
// Every rank sums the same numbers in the same order, so the G latent copies
// stay bitwise equal.  With the partials double-buffered one cluster barrier
// per line is enough: a rank writes part[(line + 1) & 1] only after every rank
// has arrived at line's barrier, and reuses part[line & 1] only after every
// rank has left line's step 4.
//
// Inside a step each reduction is split over a power-of-two group of lanes
// (blocked ranges) and combined by warp shuffles in a fixed order.  Step 1
// keeps one accumulator per kernel tap (the registry's 2 x 3 kernel is
// compiled in), step 2 two per output, so a dependent chain stays near 100
// f32 FMAs or below at the registry's shapes.  Everything stays in f32: a
// line has 8 positions, below wgmma's 64-row tile, and TF32 would not hold
// the 2e-4 tolerance through 800 MCFs.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <utility>

namespace ipoke {

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 256;
constexpr int kMaxCluster = 8;                // portable cluster size on sm_90
constexpr size_t kMaxSmemBytes = 232448;      // shared memory one CTA may use

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
  int ldc, ldr;     // latent strides in floats, per position and per row; odd
};

struct McfWeights {
  const float* w_shift;
  const float* w1;
  const float* b1;
};

inline Dims make_dims(int H, int W, int C, int hid, int hc, int kseq, int kpar,
                      float alpha, int act) {
  Dims d{H, W, C, hid, hc, kseq, kpar, alpha, act, 0, 0};
  d.ldc = C | 1;
  d.ldr = (W * d.ldc) | 1;
  return d;
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ActNorm inverse in place on a latent in shared memory; an = [log_scale (C),
// bias (C)].
__device__ inline void actnorm_inverse(float* x, const float* __restrict__ an,
                                       const Dims& d) {
  const int n = d.H * d.W * d.C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int c = e % d.C, pos = e / d.C;
    float* v = x + (pos / d.W) * d.ldr + (pos % d.W) * d.ldc + c;
    *v = (*v - an[d.C + c]) / (expf(an[c]) + 1e-8f);
  }
}

struct ClusterDims {
  Dims base;        // extents and latent strides
  int G, jg, kg;    // cluster size; hidden and h channels per rank
  int P;            // max(H, W): positions of the longest line
  int lda;          // activation row stride (per position: jg hidden, then kg h), odd
  int kgp, hrs;     // act_fn(h) strides: per position, per latent row; odd
  int wsj, k2p;     // slice strides: per w_shift row j, per w1 row; odd
  int slice;        // floats of one MCF's weight slice
};

// false for a cluster size that is not a power of two in [1, kMaxCluster] or
// does not divide hid and hc.
inline bool make_cluster_dims(int H, int W, int C, int hid, int hc, int kseq, int kpar,
                              float alpha, int act, int G, ClusterDims* cd) {
  if (G < 1 || G > kMaxCluster || (G & (G - 1)) != 0 || hid % G != 0 || hc % G != 0)
    return false;
  cd->base = make_dims(H, W, C, hid, hc, kseq, kpar, alpha, act);
  cd->G = G;
  cd->jg = hid / G;
  cd->kg = hc / G;
  cd->P = H > W ? H : W;
  cd->lda = (cd->jg + cd->kg) | 1;
  cd->kgp = cd->kg | 1;
  cd->hrs = (W * cd->kgp) | 1;
  cd->wsj = (C * kseq * kpar) | 1;
  cd->k2p = (cd->jg + cd->kg) | 1;
  cd->slice = cd->jg * cd->wsj + 2 * C * cd->k2p + 2 * C;
  return true;
}

// Float offsets of the regions of one rank's shared memory, each start
// rounded up to 16 bytes: two latents, act_fn(h), activations, partials
// (2 buffers), `slices` weight slices (K1 1, K2 2 or 1).
struct SmemLayout {
  int lat1, hact, act, part, ring, end;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline SmemLayout smem_layout(const ClusterDims& cd, int slices) {
  const Dims& d = cd.base;
  SmemLayout l;
  l.lat1 = round4(d.H * d.ldr);
  l.hact = l.lat1 + round4(d.H * d.ldr);
  l.act = l.hact + round4(cd.kg ? d.H * cd.hrs : 0);
  l.part = l.act + round4(cd.P * cd.lda);
  l.ring = l.part + round4(2 * cd.P * 2 * d.C);
  l.end = l.ring + slices * round4(cd.slice);
  return l;
}

inline size_t cluster_smem_bytes(const ClusterDims& cd, int slices) {
  return sizeof(float) * (size_t)smem_layout(cd, slices).end;
}

struct ClusterSmem {
  float* lat[2];
  float* hact;
  float* act;
  float* part;      // (mu, logs) of (c, p) at part[buf * 2C * P + 2 * (c * P + p)]
  float* ring[2];   // ring[1] is nullptr with one slice
};

__device__ inline ClusterSmem carve(float* smem, const ClusterDims& cd, int slices) {
  const SmemLayout l = smem_layout(cd, slices);
  float* ring = smem + l.ring;
  return ClusterSmem{{smem, smem + l.lat1}, smem + l.hact, smem + l.act, smem + l.part,
                     {ring, slices > 1 ? ring + round4(cd.slice) : nullptr}};
}

// Launch `kernel` on B clusters of G CTAs of kClusterThreads each, with
// `bytes` of dynamic shared memory per CTA.
template <typename... Params, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), int G, int B, size_t bytes,
                                   cudaStream_t stream, Args&&... args) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * G);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The address of `local` (this CTA's shared memory) in rank's shared memory.
__device__ __forceinline__ unsigned cluster_addr(const void* local, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"((unsigned)__cvta_generic_to_shared(local)), "r"(rank));
  return out;
}

__device__ __forceinline__ float2 ld_cluster_f2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Start (not wait for) the cp.async copies of rank's slice of one MCF, in two
// halves that a kernel may commit as separate groups:
//   stage_shift    [0, jg*wsj)       w_shift rows J_g, each C*kseq*kpar floats,
//                                    tap-major ([tap][c], tap = kh * KW + kw of OIHW)
//   stage_conv1x1  [.., + 2C*k2p)    w1 rows o: columns J_g, then the rank's h columns
//                  [.., + 2C)        b1
__device__ __forceinline__ void stage_shift(float* buf, McfWeights wt, const ClusterDims& cd,
                                            int rank) {
  const int C = cd.base.C, jg = cd.jg, wsj = cd.wsj;
  const int ksz = cd.base.kseq * cd.base.kpar, row = C * ksz;
  const float* __restrict__ ws = wt.w_shift + (size_t)rank * jg * row;
  for (int e = threadIdx.x; e < jg * row; e += blockDim.x) {
    const int j = e / row, ct = e % row;   // OIHW: ct = c * ksz + tap
    cp_async4(buf + j * wsj + (ct % ksz) * C + ct / ksz, ws + e);
  }
}

__device__ __forceinline__ void stage_conv1x1(float* buf, McfWeights wt, const ClusterDims& cd,
                                              int rank) {
  const int C = cd.base.C, jg = cd.jg, k2 = cd.jg + cd.kg, k2p = cd.k2p;
  const int K = cd.base.hid + cd.base.hc;
  float* w1s = buf + jg * cd.wsj;
  const int j0 = rank * jg, h0 = cd.base.hid + rank * cd.kg - jg;
  for (int e = threadIdx.x; e < 2 * C * k2; e += blockDim.x) {
    const int o = e / k2, k = e % k2;
    cp_async4(w1s + o * k2p + k, wt.w1 + (size_t)o * K + (k < jg ? j0 + k : h0 + k));
  }
  float* b1s = w1s + 2 * C * k2p;
  for (int e = threadIdx.x; e < 2 * C; e += blockDim.x) cp_async4(b1s + e, wt.b1 + e);
}

__device__ __forceinline__ void stage_slice(float* buf, McfWeights wt, const ClusterDims& cd,
                                            int rank) {
  stage_shift(buf, wt, cd, rank);
  stage_conv1x1(buf, wt, cd, rank);
}

// Start the cp.async copies of one example's inputs: y_b (NHWC) into the
// padded latent lat, and the rank's h channels of h_b (NHWC, or nullptr) into
// hact, raw; finish_inputs() activates them once they have landed.
__device__ __forceinline__ void stage_inputs(float* lat, float* hact, const float* y_b,
                                             const float* h_b, const ClusterDims& cd, int rank) {
  const int C = cd.base.C, W = cd.base.W, ldc = cd.base.ldc, ldr = cd.base.ldr;
  const int n = cd.base.H * W * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int pos = e / C;
    cp_async4(lat + (pos / W) * ldr + (pos % W) * ldc + e % C, y_b + e);
  }
  if (h_b == nullptr) return;
  const int kg = cd.kg, hc = cd.base.hc, kgp = cd.kgp, hrs = cd.hrs;
  for (int e = threadIdx.x; e < cd.base.H * W * kg; e += blockDim.x) {
    const int pos = e / kg, k = e % kg;
    cp_async4(hact + (pos / W) * hrs + (pos % W) * kgp + k, h_b + (size_t)pos * hc + rank * kg + k);
  }
}

// act_fn on the staged h in place.
__device__ __forceinline__ void finish_inputs(float* hact, const ClusterDims& cd) {
  const int kg = cd.kg, W = cd.base.W, kgp = cd.kgp, hrs = cd.hrs, act = cd.base.act;
  for (int e = threadIdx.x; e < cd.base.H * W * kg; e += blockDim.x) {
    const int pos = e / kg;
    float* v = hact + (pos / W) * hrs + (pos % W) * kgp + e % kg;
    *v = activate(*v, act);
  }
}

// Lanes per output: the largest power of two (at most a warp) with which
// `outputs` groups still fit in one pass of the block.
__device__ __forceinline__ int lanes_for(int outputs) {
  int s = 1;
  while (s < 32 && outputs * s * 2 <= (int)blockDim.x) s *= 2;
  return s;
}

// Sum over a group of s lanes (s a power of two); lane 0 of the group holds
// the result, combined in the same order on every call.
__device__ __forceinline__ float group_sum(float v, int s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < s) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A thread's share of one step: `s` lanes split the reduction of an output;
// the block holds P * s lanes per output column, so a thread owns the
// position p and the columns col0 + u * stride (u < count); every thread
// walks u < per_thread, the most any thread owns, so shuffles stay uniform.
struct StepMap {
  int s, sub, p, col0, stride, count, per_thread;
};

__device__ __forceinline__ StepMap step_map(int P, int cols) {
  StepMap m;
  m.s = lanes_for(P * cols);
  const int group = P * m.s;
  m.stride = blockDim.x / group;
  m.sub = threadIdx.x % m.s;
  m.p = (threadIdx.x / m.s) % P;
  m.col0 = threadIdx.x / group;
  m.count = m.col0 < m.stride ? (cols - m.col0 + m.stride - 1) / m.stride : 0;
  m.per_thread = (cols + m.stride - 1) / m.stride;
  return m;
}

// One MCF inverse on one rank: in_s -> out_s (its own latent copy), with the
// weight slice wbuf already in shared memory.  rparts[r] is the address of
// rank r's partial block in distributed shared memory; `line` counts lines
// over the launch and picks the partial buffer.  KSEQ x KPAR is the kernel
// extent (sequential x parallel) when known at compile time, 0 x 0 to read it
// from cd.  Every index that does not depend on the line is computed once,
// before the line loop.  With AWAIT_CONV1X1 the 1x1-conv half of the slice
// (stage_conv1x1) is this thread's last cp.async group still in flight: the
// first line waits for it after step 1, so that step overlaps the copy (K1,
// which has no earlier MCF to hide its staging behind).  Ends synchronised
// within the CTA.
template <int G, int KSEQ, int KPAR, bool AWAIT_CONV1X1 = false>
__device__ __forceinline__ void cluster_scan(const float* in_s, float* out_s,
                                             const ClusterSmem& sm, const float* wbuf,
                                             const unsigned* rparts, const ClusterDims& cd,
                                             int& line, bool col, bool reverse) {
  const Dims& d = cd.base;
  const int L = col ? d.W : d.H;            // sequential extent
  const int P = col ? d.H : d.W;            // parallel extent
  const int seq_s = col ? d.ldc : d.ldr;    // latent strides
  const int par_s = col ? d.ldr : d.ldc;
  const int hseq = col ? cd.kgp : cd.hrs;   // act_fn(h) strides
  const int hpar = col ? cd.hrs : cd.kgp;
  const int kseq = KSEQ ? KSEQ : d.kseq, kpar = KPAR ? KPAR : d.kpar;
  const int wseq = col ? 1 : kpar;          // OIHW offsets of a tap
  const int wpar = col ? kseq : 1;
  const int cp = (kpar - 1) / 2;
  const int C = d.C, jg = cd.jg, kg = cd.kg, k2 = jg + kg;
  const int wsj = cd.wsj, k2p = cd.k2p, lda = cd.lda, act = d.act;
  const float alpha = d.alpha;
  const float* wsh = wbuf;
  const float* w1s = wbuf + jg * wsj;
  const float* b1s = w1s + 2 * C * k2p;
  float* const act_s = sm.act;
  float* const part_s = sm.part;
  const int part_n = cd.P * 2 * C;          // floats of one partial buffer

  // step 1: lanes split the channels c of (p, hidden channel jl)
  const StepMap m1 = step_map(P, jg);
  const int c_chunk = (C + m1.s - 1) / m1.s;
  const int c_lo = min(C, m1.sub * c_chunk), c_n = min(C, c_lo + c_chunk) - c_lo;
  const int w1_step = m1.stride * wsj;      // to the thread's next hidden channel
  const float* w1_base = wsh + m1.col0 * wsj + c_lo;
  // step 2: lanes split the channels k of the (mu, logs) pair of (p, c)
  const StepMap m2 = step_map(P, C);
  const int k_chunk = (k2 + m2.s - 1) / m2.s;
  const int k_lo = min(k2, m2.sub * k_chunk), k_n = min(k2, k_lo + k_chunk) - k_lo;
  const float* a2 = act_s + m2.p * lda + k_lo;

  for (int t = 0; t < L; ++t, ++line) {
    const int i = reverse ? L - 1 - t : t;
    const int buf = (line & 1) * part_n;
    // 1. context of (p, j in J_g) over the lines already inverted, then
    // act_fn; act_fn(h) of line i joins the same activation rows
    for (int u = 0; u < m1.per_thread; ++u) {
      float acc = 0.f;
      if (u < m1.count) {
        const float* wj = w1_base + u * w1_step;
        if constexpr (KSEQ > 0) {
          // taps unrolled: one accumulator each, one pass over the channels
          constexpr int NT = KSEQ * KPAR;
          const float* src[NT];
          const float* wk[NT];
          bool ok[NT];
#pragma unroll
          for (int r = 0; r < KSEQ; ++r) {
            const int q = reverse ? i + 1 + r : i - KSEQ + r;
#pragma unroll
            for (int s = 0; s < KPAR; ++s) {
              const int pp = m1.p + s - cp, tap = r * KPAR + s;
              ok[tap] = q >= 0 && q < L && pp >= 0 && pp < P;
              src[tap] = out_s + (ok[tap] ? q * seq_s + pp * par_s : 0) + c_lo;
              wk[tap] = wj + (r * wseq + s * wpar) * C;
            }
          }
          float a[NT];
#pragma unroll
          for (int tap = 0; tap < NT; ++tap) a[tap] = 0.f;
          for (int c = 0; c < c_n; ++c) {
#pragma unroll
            for (int tap = 0; tap < NT; ++tap)
              if (ok[tap]) a[tap] = fmaf(src[tap][c], wk[tap][c], a[tap]);
          }
#pragma unroll
          for (int tap = 0; tap < NT; ++tap) acc += a[tap];
        } else {
          for (int r = 0; r < kseq; ++r) {
            const int q = reverse ? i + 1 + r : i - kseq + r;
            if (q < 0 || q >= L) continue;
            for (int s = 0; s < kpar; ++s) {
              const int pp = m1.p + s - cp;
              if (pp < 0 || pp >= P) continue;
              const float* src = out_s + q * seq_s + pp * par_s + c_lo;
              const float* wk = wj + (r * wseq + s * wpar) * C;
              for (int c = 0; c < c_n; ++c) acc = fmaf(src[c], wk[c], acc);
            }
          }
        }
      }
      acc = group_sum(acc, m1.s);
      if (u < m1.count && m1.sub == 0)
        act_s[m1.p * lda + m1.col0 + u * m1.stride] = activate(acc, act);
    }
    const float* hline = sm.hact + i * hseq;
    for (int e = threadIdx.x; e < P * kg; e += blockDim.x) {
      const int p = e / kg, k = e % kg;
      act_s[p * lda + jg + k] = hline[p * hpar + k];
    }
    if (AWAIT_CONV1X1 && t == 0) cp_async_wait<0>();
    __syncthreads();
    // 2. this rank's partial (mu, logs) over its hidden and h channels
    float* part = part_s + buf;
    for (int u = 0; u < m2.per_thread; ++u) {
      float m0 = 0.f, m1_ = 0.f, l0 = 0.f, l1 = 0.f;   // even and odd k
      const int c = m2.col0 + u * m2.stride;
      if (u < m2.count) {
        const float* wm = w1s + c * k2p + k_lo;
        const float* wl = wm + C * k2p;
        int k = 0;
        for (; k + 1 < k_n; k += 2) {
          m0 = fmaf(a2[k], wm[k], m0);
          l0 = fmaf(a2[k], wl[k], l0);
          m1_ = fmaf(a2[k + 1], wm[k + 1], m1_);
          l1 = fmaf(a2[k + 1], wl[k + 1], l1);
        }
        if (k < k_n) {
          m0 = fmaf(a2[k], wm[k], m0);
          l0 = fmaf(a2[k], wl[k], l0);
        }
      }
      const float mu = group_sum(m0 + m1_, m2.s), ls = group_sum(l0 + l1, m2.s);
      if (u < m2.count && m2.sub == 0)
        *reinterpret_cast<float2*>(part + 2 * (c * P + m2.p)) = make_float2(mu, ls);
    }
    // 3. every rank's partials are complete and visible
    cluster_barrier();
    // 4. partials summed in rank order, b1, the affine inverse of line i
    for (int o = threadIdx.x; o < P * C; o += blockDim.x) {
      const int p = o % P, c = o / P;
      const unsigned off = 4u * (buf + 2 * (c * P + p));
      float2 v[G];
#pragma unroll
      for (int r = 0; r < G; ++r) v[r] = ld_cluster_f2(rparts[r] + off);
      float mu = 0.f, ls = 0.f;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        mu += v[r].x;
        ls += v[r].y;
      }
      mu += b1s[c];
      ls += b1s[C + c];
      const float scale = tanhf(ls * 0.5f) * alpha + 1.0f;
      const int idx = i * seq_s + p * par_s + c;
      out_s[idx] = (in_s[idx] - mu) / (scale + 1e-12f);
    }
    __syncthreads();
  }
}

}  // namespace ipoke
