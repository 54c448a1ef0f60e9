// Fused-loss train kernel for Hopper (sm_90a), plain C interface.
//
// K3 (K1 fused_field_fwd, then fused_train_loss + terms_kernel, then K2
// fused_field_bwd; K1 and K2 live in fused_field.cu) replaces
// nerfca_tpu/ops/pallas/fused_train.py::_train_kernel (pallas_call in
// fused_train_loss_and_grads): the whole coarse composite step. K1 runs the
// forward of both fields over the batch's R * S points in point tiles (3xTF32
// on the tensor cores, no per-ray padding) and writes the raw densities,
// 2 x 4 B per point. This file holds the loss phase. One CTA per ray:
//   1. the ray's raw densities into shared memory;
//   2. the loss phase: sigma = 1e-2 act(raw) (times the motion-hull gate on
//      the dynamic field), sd = sigma * dist, the per-ray sums, the pixel
//      term, the blend-ratio entropy, both masked ray entropies, occlusion,
//      L1/L2 and the hull-gated static L1, each a fixed-order block
//      reduction in exact f32 (no atomics, no TF32);
//   3. the hand-derived cotangents dL/draw_s, dL/draw_t of the weighted loss
//      (the TPU kernel runs jax.vjp in-kernel; the same math as tensor ops is
//      nerfca_tpu_torch/ops/cuda/fused_train.py::loss_cotangents_plain),
//      written to HBM, 2 x 4 B per point; the ray's 13 term partials go to
//      an [R, 16] array that terms_kernel sums over rays in order (the two
//      maxima take a max) and combines into the loss.
// K2 then backpropagates the cotangents into every weight gradient and the
// latent-table gradient, deterministically.
//
// What bounds it: a few dozen flops and three transcendentals per sample
// and 16 B of HBM traffic per sample (two raw densities in, two cotangents
// out), a small share of the step next to the forward (K1) and K2. The TPU
// kernel keeps the raw densities in VMEM because of Pallas's grid; here the
// round trip through HBM lets the step run K1's forward code. The forward is
// run twice per step (K1, then inside K2), as on the two-kernel path; what
// goes away is the loss battery's ~100 small launches and its autograd graph.
//
// Clips take JAX's derivative (jnp.clip is maximum-then-minimum): 0.5 when
// the value sits on a bound. The build uses accurate math and -fmad=false
// (no fast-math, no flush-to-zero), so the 1e-19 and 1e-10 guards hold.
//
// The file also holds the eval renderer's composite (composite_kernel),
// launched once per tile of a test view right after that tile's K1: per
// ray the activation, the optional motion-hull gate, the scaled sigmas and
// the three Beer-Lambert sums of nerfca_tpu_torch/ops/render.py (the
// composite, the static image and the dynamic image), with render.py's
// order of products, each sum a fixed-order warp reduction in exact f32.
// It reads the two raw densities and writes the two scaled sigmas, 16 B a
// sample, where the torch renders made ~10 passes over the view. Its
// one-field sibling (static_composite_kernel) renders the static method's
// view after the one-field K1: render_transmission's UNSCALED sigma and
// its image, 8 B a sample.

#include <cuda_runtime.h>
#include <math.h>

#define NTHREADS 256
#define TERMS 16
#define MAX_SAMPLES 1024

enum {
  T_PIX, T_FAVOR, T_S_ENT, T_S_SIG, T_D_ENT, T_D_SIG, T_OCCL, T_L1, T_L2,
  T_BLENDW, T_SMAX, T_DMAX, T_HL1, T_LOSS
};

struct LossArgs {
  const float* pixels;   // [R] ground-truth log intensity
  const float* weights;  // [R] variance weights
  const float* i0;       // [R] initial intensities
  const float* gate;     // [R * S] motion-hull gate, or null (all ones)
  const float* occl;     // [S] occlusion mask
  float lw[5];           // favor, dynamic entropy, occlusion, l1/l2, hull l1
  float skew;            // blend-ratio exponent
  float mask_thre;       // entropy mask threshold on the ray sum
  float var_thre;        // 1 + entro_weighted_thresh
  float clip_thr;        // entropy denominator clip
  float n_rays_total;    // R of the mean normalizations
  float n_samples_total; // R * S
  int activation;        // 0 softplus, 1 sigmoid, 2 clamp
  int use_weighting;
  int has_hull;
};

// derivatives of jnp.clip's two halves: 1 inside, 0.5 on the bound, 0 outside
__device__ __forceinline__ float clip_lo_grad(float x, float lo) {
  return x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
}
__device__ __forceinline__ float clip_hi_grad(float x, float hi) {
  return x < hi ? 1.f : (x == hi ? 0.5f : 0.f);
}

// act(x) and its derivative; softplus as torch.logaddexp(x, 0) computes it
__device__ __forceinline__ float activation(float x, int kind, float* deriv) {
  const float sg = 1.f / (1.f + expf(-x));
  if (kind == 1) {
    *deriv = sg * (1.f - sg);
    return sg;
  }
  const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  if (kind == 0) {
    *deriv = sg;
    return sp;
  }
  *deriv = sg * clip_lo_grad(sp, 0.f) * clip_hi_grad(fmaxf(sp, 0.f), 1.f);
  return fminf(fmaxf(sp, 0.f), 1.f);
}

// Everything the loss needs of sample j, recomputed from the raw densities
// in each pass (cheap next to the MLPs; keeps no per-sample scratch).
struct Sample {
  float dist, gate, occl, da_s, da_t, ss, st, sds, sdt, den, bw, u, b, rev, lb, lr;
};

__device__ __forceinline__ Sample sample_at(const float* z, int S, const LossArgs& la,
                                            const float* raw_s, const float* raw_t, long ray0,
                                            int j) {
  Sample q;
  q.dist = j < S - 1 ? z[j + 1] - z[j] : 1e-10f;
  q.gate = la.gate != nullptr ? la.gate[ray0 + j] : 1.f;
  q.occl = la.occl[j];
  const float a_s = activation(raw_s[j], la.activation, &q.da_s);
  const float a_t = activation(raw_t[j], la.activation, &q.da_t);
  q.ss = a_s * 1e-2f;
  q.st = (a_t * 1e-2f) * q.gate;
  q.sds = q.ss * q.dist;
  q.sdt = q.st * q.dist;
  q.den = (q.ss + q.st) + 1e-10f;
  q.bw = q.st / q.den;
  q.u = powf(q.bw, la.skew);
  q.b = fminf(fmaxf(q.u, 1e-19f), 1.f);  // f32(1 - 1e-19) == 1
  q.rev = fmaxf(1.f - q.b, 1e-19f);
  q.lb = logf(q.b);
  q.lr = logf(q.rev);
  return q;
}

// Fixed-order block reduction of NV values per thread: the first NSUM are
// summed, the rest max-reduced. Every thread gets the results in v.
template <int NV, int NSUM>
__device__ __forceinline__ void block_reduce(float (&v)[NV], float* red) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < NV; ++k) red[k * NTHREADS + tid] = v[k];
  __syncthreads();
  for (int s = NTHREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const float a = red[k * NTHREADS + tid], b = red[k * NTHREADS + tid + s];
        red[k * NTHREADS + tid] = k < NSUM ? a + b : fmaxf(a, b);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = red[k * NTHREADS];
  __syncthreads();
}

// z: the shared [S] depths; raw_s_all, raw_t_all: [R * S] raw densities (K1).
__global__ void __launch_bounds__(NTHREADS)
loss_kernel(const float* z, int S, LossArgs la, const float* raw_s_all, const float* raw_t_all,
            float* g_s, float* g_t, float* partials) {
  extern __shared__ float smem[];
  float* raw_s = smem;
  float* raw_t = raw_s + S;
  float* red = raw_t + S;  // 9 x NTHREADS floats of reduction scratch
  const long ray = blockIdx.x;
  const long ray0 = ray * S;
  const int tid = threadIdx.x;

  // 1. the ray's raw densities
  for (int j = tid; j < S; j += NTHREADS) {
    raw_s[j] = raw_s_all[ray0 + j];
    raw_t[j] = raw_t_all[ray0 + j];
  }
  __syncthreads();

  // 2a. per-ray sums that need no normalization
  float v[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -INFINITY, -INFINITY};
  for (int j = tid; j < S; j += NTHREADS) {
    const Sample q = sample_at(z, S, la, raw_s, raw_t, ray0, j);
    v[0] += q.sds;                                  // sum_s
    v[1] += q.sdt;                                  // sum_t
    v[2] += q.sds * q.sds;                          // l2
    v[3] += q.sdt * q.occl;                         // occlusion
    v[4] += q.sds * q.gate;                         // hull-gated static l1
    v[5] += q.bw;                                   // blend ratio
    v[6] += -(q.b * q.lb + q.rev * q.lr);           // blend entropy
    v[7] = fmaxf(v[7], q.ss);
    v[8] = fmaxf(v[8], q.st);
  }
  block_reduce<9, 7>(v, red);
  const float sum_s = v[0], sum_t = v[1];
  const float d_s = fmaxf(sum_s, la.clip_thr), d_t = fmaxf(sum_t, la.clip_thr);

  // 2b. ray entropies and the dynamic entropy's sum_i q_i p_i
  float e[3] = {0.f, 0.f, 0.f};
  for (int j = tid; j < S; j += NTHREADS) {
    const Sample q = sample_at(z, S, la, raw_s, raw_t, ray0, j);
    const float p_s = q.sds / d_s, p_t = q.sdt / d_t;
    const float pl_s = logf(p_s + 1e-10f), pl_t = logf(p_t + 1e-10f);
    e[0] += -(p_s * pl_s);
    e[1] += -(p_t * pl_t);
    e[2] += -(pl_t + p_t / (p_t + 1e-10f)) * p_t;
  }
  block_reduce<3, 3>(e, red);

  const float R = la.n_rays_total;
  const float w = la.weights[ray];
  const float err = (la.i0[ray] - (sum_s + sum_t)) - la.pixels[ray];
  const float m_s = sum_s >= la.mask_thre ? 1.f : 0.f;
  const float m_t = (sum_t >= la.mask_thre || (la.use_weighting && w > la.var_thre)) ? 1.f : 0.f;
  if (tid == 0) {
    float* part = partials + ray * TERMS;
    part[T_PIX] = w * (err * err);
    part[T_FAVOR] = v[6];
    part[T_S_ENT] = m_s * e[0];
    part[T_S_SIG] = sum_s;
    part[T_D_ENT] = m_t * e[1];
    part[T_D_SIG] = sum_t;
    part[T_OCCL] = v[3];
    part[T_L1] = sum_s;
    part[T_L2] = v[2];
    part[T_BLENDW] = v[5];
    part[T_SMAX] = v[7];
    part[T_DMAX] = v[8];
    part[T_HL1] = la.has_hull ? v[4] : 0.f;
    part[T_LOSS] = part[14] = part[15] = 0.f;
  }

  // 3. cotangents of L = pix + lw0 favor + lw1 d_ent + lw2 occl
  //                      + lw3 (l2 + l1) + lw4 hull_l1
  const float g_pix = (-2.f / R) * w * err;
  const float c_t = la.lw[1] * m_t / R;
  // denominator derivative: clip's, and none on near-empty rays (the
  // double-where guard of ray_entropy_loss)
  const float d_prime = sum_t >= 1e-15f ? clip_lo_grad(sum_t, la.clip_thr) : 0.f;
  const float c_f = la.lw[0] / la.n_samples_total;
  for (int j = tid; j < S; j += NTHREADS) {
    const Sample q = sample_at(z, S, la, raw_s, raw_t, ray0, j);
    const float p_t = q.sdt / d_t;
    const float q_t = -(logf(p_t + 1e-10f) + p_t / (p_t + 1e-10f));
    const float g_sd_t = g_pix + c_t * (q_t - d_prime * e[2]) / d_t + la.lw[2] * q.occl / R;
    float g_sd_s = g_pix + la.lw[3] * (1.f + 2.f * q.sds);
    if (la.has_hull) g_sd_s = g_sd_s + la.lw[4] * q.gate / R;
    const float db = clip_lo_grad(q.u, 1e-19f) * clip_hi_grad(fmaxf(q.u, 1e-19f), 1.f);
    const float drev = -clip_lo_grad(1.f - q.b, 1e-19f);
    const float du = la.skew != 0.f ? la.skew * powf(q.bw, la.skew - 1.f) : 0.f;
    const float g_bw = c_f * (-(q.lb + 1.f) - (q.lr + 1.f) * drev) * db * du;
    const float g_sig_s = g_sd_s * q.dist - g_bw * q.st / (q.den * q.den);
    const float g_sig_t = (g_sd_t * q.dist + g_bw / q.den - g_bw * q.st / (q.den * q.den)) * q.gate;
    g_s[ray0 + j] = g_sig_s * 1e-2f * q.da_s;
    g_t[ray0 + j] = g_sig_t * 1e-2f * q.da_t;
  }
}

// terms[k] = the ray partials of column k summed in ray order (maxima for
// the two sigma maxima), normalized; terms[T_LOSS] = the weighted loss.
__global__ void terms_kernel(const float* partials, int n_rays, LossArgs la, float* terms) {
  __shared__ float t[TERMS];
  const int k = threadIdx.x;
  if (k < TERMS) {
    float s = partials[k];
    for (int r = 1; r < n_rays; ++r) {
      const float x = partials[(long)r * TERMS + k];
      s = (k == T_SMAX || k == T_DMAX) ? fmaxf(s, x) : s + x;
    }
    const float R = la.n_rays_total;
    if (k == T_FAVOR || k == T_BLENDW) {
      s = s / la.n_samples_total;
    } else if (k == T_PIX || k == T_S_ENT || k == T_S_SIG || k == T_D_ENT || k == T_D_SIG ||
               k == T_OCCL || k == T_HL1) {
      s = s / R;
    }
    t[k] = s;
  }
  __syncthreads();
  if (k < TERMS) {
    terms[k] = t[k];
    if (k == T_LOSS) {
      terms[k] = t[T_PIX] + la.lw[0] * t[T_FAVOR] + la.lw[1] * t[T_D_ENT] + la.lw[2] * t[T_OCCL] +
                 la.lw[3] * t[T_L2] + la.lw[3] * t[T_L1] + la.lw[4] * t[T_HL1];
    }
  }
}

// One warp per ray. sig_s = act(raw_s) * 1e-2, sig_t = (act(raw_t) * 1e-2)
// * gate, as render_transmission_composite returns them; the sums are
// pix = i0 - sum (sig_s + sig_t) dist, pix_static = i0 - sum (act(raw_s) *
// dist) * 1e-2, pix_temp = i0 - sum ((act(raw_t) * gate) * dist) * 1e-2
// (the last sample's dist 1e-10). Lane l adds samples l, l + 32, ... in
// order, then the lanes' partials are added in a fixed tree.
#define CW_WARPS 8
#define CW_UNROLL 4

struct CompositeArgs {
  const float* raw_s;  // [R * S] raw densities (K1's output)
  const float* raw_t;
  const float* gate;   // [R * S] motion-hull gate, or null (all ones)
  const float* z;      // the shared [S] depths, or per-ray rows [R, S]
  float* sig_s;        // [R * S] scaled sigmas
  float* sig_t;
  float* dists;        // the [S] deltas (written by ray 0), per-ray rows, or null
  float* pix;          // [R]
  float* pix_s;        // [R], or null
  float* pix_t;        // [R], or null
  float i0;            // the initial intensity
  int n_rays, n_samples;
  int z_stride;        // 0 shared depths, S per-ray rows
  int activation;      // 0 softplus, 1 sigmoid, 2 clamp
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(CW_WARPS * 32) composite_kernel(CompositeArgs a) {
  const int lane = threadIdx.x & 31;
  const long ray = (long)blockIdx.x * CW_WARPS + (threadIdx.x >> 5);
  if (ray >= a.n_rays) return;
  const int S = a.n_samples;
  const long row = ray * S;
  const float* z = a.z + ray * a.z_stride;
  float* dists = (a.dists != nullptr && (a.z_stride != 0 || ray == 0))
                     ? a.dists + ray * a.z_stride : nullptr;
  float acc = 0.f, acc_s = 0.f, acc_t = 0.f;
  // CW_UNROLL samples a lane in flight: their loads first, then their sums
  // in sample order
  for (int j0 = lane; j0 < S; j0 += 32 * CW_UNROLL) {
    float rs[CW_UNROLL], rt[CW_UNROLL], gt[CW_UNROLL], dz[CW_UNROLL];
#pragma unroll
    for (int u = 0; u < CW_UNROLL; ++u) {
      const int j = j0 + 32 * u;
      if (j < S) {
        rs[u] = a.raw_s[row + j];
        rt[u] = a.raw_t[row + j];
        gt[u] = a.gate != nullptr ? a.gate[row + j] : 1.f;
        dz[u] = j < S - 1 ? z[j + 1] - z[j] : 1e-10f;
      }
    }
#pragma unroll
    for (int u = 0; u < CW_UNROLL; ++u) {
      const int j = j0 + 32 * u;
      if (j < S) {
        float unused;
        const float act_s = activation(rs[u], a.activation, &unused);
        const float act_t = activation(rt[u], a.activation, &unused);
        const float ss = act_s * 1e-2f;
        const float st = (act_t * 1e-2f) * gt[u];
        a.sig_s[row + j] = ss;
        a.sig_t[row + j] = st;
        if (dists != nullptr) dists[j] = dz[u];
        acc += (ss + st) * dz[u];
        acc_s += (act_s * dz[u]) * 1e-2f;
        acc_t += ((act_t * gt[u]) * dz[u]) * 1e-2f;
      }
    }
  }
  acc = warp_sum(acc);
  acc_s = warp_sum(acc_s);
  acc_t = warp_sum(acc_t);
  if (lane == 0) {
    a.pix[ray] = a.i0 - acc;
    if (a.pix_s != nullptr) a.pix_s[ray] = a.i0 - acc_s;
    if (a.pix_t != nullptr) a.pix_t[ray] = a.i0 - acc_t;
  }
}

// One warp per ray, as composite_kernel, over one field (the static
// method's): sigma = act(raw), UNSCALED, and pix = i0 - sum (act(raw) *
// dist) * 1e-2, as render_transmission returns them (the last sample's
// dist 1e-10); the same fixed order of additions as composite_kernel's.
struct StaticCompositeArgs {
  const float* raw;    // [R * S] raw densities (the one-field K1's output)
  const float* z;      // the shared [S] depths, or per-ray rows [R, S]
  float* sigma;        // [R * S] unscaled sigma
  float* dists;        // the [S] deltas (written by ray 0), per-ray rows, or null
  float* pix;          // [R]
  float i0;            // the initial intensity
  int n_rays, n_samples;
  int z_stride;        // 0 shared depths, S per-ray rows
  int activation;      // 0 softplus, 1 sigmoid, 2 clamp
};

__global__ void __launch_bounds__(CW_WARPS * 32) static_composite_kernel(StaticCompositeArgs a) {
  const int lane = threadIdx.x & 31;
  const long ray = (long)blockIdx.x * CW_WARPS + (threadIdx.x >> 5);
  if (ray >= a.n_rays) return;
  const int S = a.n_samples;
  const long row = ray * S;
  const float* z = a.z + ray * a.z_stride;
  float* dists = (a.dists != nullptr && (a.z_stride != 0 || ray == 0))
                     ? a.dists + ray * a.z_stride : nullptr;
  float acc = 0.f;
  for (int j0 = lane; j0 < S; j0 += 32 * CW_UNROLL) {
    float rs[CW_UNROLL], dz[CW_UNROLL];
#pragma unroll
    for (int u = 0; u < CW_UNROLL; ++u) {
      const int j = j0 + 32 * u;
      if (j < S) {
        rs[u] = a.raw[row + j];
        dz[u] = j < S - 1 ? z[j + 1] - z[j] : 1e-10f;
      }
    }
#pragma unroll
    for (int u = 0; u < CW_UNROLL; ++u) {
      const int j = j0 + 32 * u;
      if (j < S) {
        float unused;
        const float act = activation(rs[u], a.activation, &unused);
        a.sigma[row + j] = act;
        if (dists != nullptr) dists[j] = dz[u];
        acc += (act * dz[u]) * 1e-2f;
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) a.pix[ray] = a.i0 - acc;
}

extern "C" {

int eval_composite_args_bytes(int) { return (int)sizeof(CompositeArgs); }

int eval_static_args_bytes(int) { return (int)sizeof(StaticCompositeArgs); }

// The static method's render of one tile of rays: see static_composite_kernel.
int eval_static(const StaticCompositeArgs* a, void* stream) {
  if (a->n_samples < 1 || a->n_rays < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (a->n_rays + CW_WARPS - 1) / CW_WARPS;
  static_composite_kernel<<<blocks, CW_WARPS * 32, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// The eval's composite of one tile of rays: see composite_kernel.
int eval_composite(const CompositeArgs* a, void* stream) {
  if (a->n_samples < 1 || a->n_rays < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (a->n_rays + CW_WARPS - 1) / CW_WARPS;
  composite_kernel<<<blocks, CW_WARPS * 32, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int fused_train_terms(int) { return TERMS; }

// Shared memory of one loss-kernel CTA for rays of n_samples samples.
int fused_train_smem_bytes(int n_samples) { return (2 * n_samples + 9 * NTHREADS) * 4; }

// z: the shared [S] depths; raw_s, raw_t: [R * S] raw densities (K1's
// output); g_s, g_t: [R * S] cotangent outputs; partials: [R, TERMS]
// scratch; terms: [TERMS] output.
int fused_train_loss(const LossArgs* la, const float* z, int n_rays, int n_samples,
                     const float* raw_s, const float* raw_t, float* g_s, float* g_t,
                     float* partials, float* terms, void* stream) {
  if (n_samples < 2 || n_samples > MAX_SAMPLES || n_rays < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  loss_kernel<<<n_rays, NTHREADS, fused_train_smem_bytes(n_samples), st>>>(
      z, n_samples, *la, raw_s, raw_t, g_s, g_t, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  terms_kernel<<<1, 32, 0, st>>>(partials, n_rays, *la, terms);
  return (int)cudaGetLastError();
}

}  // extern "C"
