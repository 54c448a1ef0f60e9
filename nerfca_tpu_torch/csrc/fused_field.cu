// Fused encode -> MLP field kernels for Hopper (sm_90a), plain C interface.
//
// K1 (fused_field_fwd) replaces nerfca_tpu/ops/pallas/fused_field.py::_fwd_kernel
// (pallas_call in _fused_core_fwd_impl). K2 (fused_field_bwd + fused_field_reduce)
// replaces ::_bwd_kernel (pallas_call in _fused_core_bwd), the custom VJP of K1.
// The encode and forward device code lives in field_common.cuh, shared with
// the fused-loss kernel in fused_train.cu.
//
// What they compute, per point i = r * S + s of a ray batch:
//   x = o[r] + z[r, s] * d[r]                      (never materialized in HBM)
//   enc = [x, per band b: w[b] * sin(2^b x), w[b] * sin(2^b x + pi/2)]
//   static:   raw_s = wo_s . relu(... relu(W0_s enc + b0_s) ...) + bo_s
//   temporal: raw_t = same with [enc, latents[phase[r]]] as the input
// K2 recomputes that forward per tile, backpropagates the given cotangents
// g_s, g_t and produces every parameter gradient of both fields plus the
// latent-table gradient.
//
// What bounds them on this card: they are compute bound. Both fields cost
// about 151.5k MAC per point (5 layers of 128x128 plus the input layer), so
// a 512,000-point train step is ~155 GFLOP forward and ~3x that backward,
// against a few bytes of HBM traffic per point. This first version runs the
// MACs as f32 FMAs on the CUDA cores (exact f32 like the reference, no TF32)
// and is limited by shared-memory load bandwidth: each warp owns 8 points x
// 128 neurons and reads float4 activations (broadcast) and weight rows per
// k-step. The design keeps every activation of a 64-point tile in shared
// memory (K1) or in a per-CTA scratch that stays in L2 (K2 residuals), so
// HBM only sees ray inputs, weights and outputs. Tensor-core (wgmma) tiles
// are later work.
//
// Determinism: K2 writes per-CTA gradient partials (each CTA owns its slice,
// updated in program order by the same thread every time) and
// fused_field_reduce sums them over CTAs in a fixed order. No atomics, so
// gradients are bitwise identical run to run. The latent-table gradient is
// reduced inside K2 per CTA (per phase, points in order) and then goes
// through the same fixed-order reduction.
//
// Encoding precision: each band is an accurate sinf of the exactly scaled
// coordinate, and cos is sinf(t + f32(pi/2)) with the add rounded to f32,
// which is what the JAX and torch posenc compute; x = o + z*d is formed with
// separate rounded multiply and add (no FMA contraction). The high bands
// amplify any one-ulp difference in their argument by 2^11, so these
// roundings are kept identical to the plain version on purpose.

#include "field_common.cuh"

__global__ void __launch_bounds__(NTHREADS, 2)
fwd_kernel(FieldArgs fs, FieldArgs ft, RayArgs r, float* out_s, float* out_t) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* Ws = H + TP * LDH;
  int* phase_sm = reinterpret_cast<int*>(Ws + KMAX * LDW);
  const long n_pts = (long)r.n_rays * r.n_samples;
  const long tile0 = (long)blockIdx.x * TP;
  float acc[8][4];
  field_forward(fs, r, tile0, H, Ws, phase_sm, acc, nullptr);
  field_output(fs, acc, tile0, n_pts, out_s);
  field_forward(ft, r, tile0, H, Ws, phase_sm, acc, nullptr);
  field_output(ft, acc, tile0, n_pts, out_t);
}

// Offsets (floats) of one field's gradient block inside a CTA partial.
struct GradLayout {
  long w0, b0, wh, bh, wo, bo, lat, size;
};

__host__ __device__ inline GradLayout grad_layout(const FieldArgs& f, int n_phases) {
  GradLayout g;
  g.w0 = 0;
  g.b0 = g.w0 + (long)(f.enc + f.n_lat) * WIDTH;
  g.wh = g.b0 + WIDTH;
  g.bh = g.wh + (long)f.n_hidden * WIDTH * WIDTH;
  g.wo = g.bh + (long)f.n_hidden * WIDTH;
  g.bo = g.wo + WIDTH;
  g.lat = g.bo + 4;  // blocks stay 16-byte aligned for the float4 updates
  g.size = g.lat + (f.n_lat > 0 ? (long)n_phases * f.n_lat : 0);
  g.size = (g.size + 3) & ~3L;
  return g;
}

// part[k][n] += sum_p H[p][k] * D[p][n] for k < k_real; thread (kb, nb) owns
// k = kc + 8kb + 0..7 and n = 4nb + 0..3, 64 + 4nb + 0..3.
__device__ __forceinline__ void accumulate_dw(const float* H, const float* D, int k_real, float* part) {
  const int kb = threadIdx.x >> 4, nb = threadIdx.x & 15;
  for (int kc = 0; kc < round4(k_real); kc += WIDTH) {
    const int k0 = kc + 8 * kb;
    if (k0 >= round4(k_real)) continue;
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
    for (int p = 0; p < TP; ++p) {
      const float* hrow = H + p * LDH + k0;
      const float* drow = D + p * LDW;
      float h[8], d[8];
      const float4 h0 = *reinterpret_cast<const float4*>(hrow);
      // k0 + 4 may run past round4(k_real) only inside the zeroed padding
      const float4 h1 = *reinterpret_cast<const float4*>(hrow + 4);
      const float4 d0 = *reinterpret_cast<const float4*>(drow + 4 * nb);
      const float4 d1 = *reinterpret_cast<const float4*>(drow + 64 + 4 * nb);
      h[0] = h0.x; h[1] = h0.y; h[2] = h0.z; h[3] = h0.w;
      h[4] = h1.x; h[5] = h1.y; h[6] = h1.z; h[7] = h1.w;
      d[0] = d0.x; d[1] = d0.y; d[2] = d0.z; d[3] = d0.w;
      d[4] = d1.x; d[5] = d1.y; d[6] = d1.z; d[7] = d1.w;
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(h[a], d[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int k = k0 + a;
      if (k >= k_real) break;
      float4* dst0 = reinterpret_cast<float4*>(part + (long)k * WIDTH + 4 * nb);
      float4* dst1 = reinterpret_cast<float4*>(part + (long)k * WIDTH + 64 + 4 * nb);
      float4 v0 = *dst0, v1 = *dst1;
      v0.x += acc[a][0]; v0.y += acc[a][1]; v0.z += acc[a][2]; v0.w += acc[a][3];
      v1.x += acc[a][4]; v1.y += acc[a][5]; v1.z += acc[a][6]; v1.w += acc[a][7];
      *dst0 = v0;
      *dst1 = v1;
    }
  }
}

// part[n] += sum_p D[p][n] (points in order).
__device__ __forceinline__ void accumulate_db(const float* D, float* part) {
  if (threadIdx.x < WIDTH) {
    float s = 0.f;
    for (int p = 0; p < TP; ++p) s += D[p * LDW + threadIdx.x];
    part[threadIdx.x] += s;
  }
}

// Backward of one field on one tile (after field_forward with scratch).
// D (row stride LDW) holds the pre-activation cotangent of the current layer.
__device__ __forceinline__ void field_backward(const FieldArgs& f, const float acc_last[8][4],
                               const float* g, long tile0, long n_pts, int n_phases,
                               float* H, float* D, float* Ws, const int* phase_sm,
                               float* g_sm, float* dlat_sm, const float* scratch,
                               float* part, float* lat_acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const GradLayout L = grad_layout(f, n_phases);
  const int k0 = f.enc + f.n_lat;
  __syncthreads();
  for (int t = threadIdx.x; t < TP; t += NTHREADS) {
    const long i = tile0 + t;
    g_sm[t] = i < n_pts ? g[i] : 0.f;
  }
  store_relu(H, LDH, acc_last);  // h_L
  __syncthreads();
  // output layer: dwo[n] = sum_p g[p] h_L[p][n], dbo = sum_p g[p]
  if (threadIdx.x < WIDTH) {
    float s = 0.f;
    for (int p = 0; p < TP; ++p) s = fmaf(g_sm[p], H[p * LDH + threadIdx.x], s);
    part[L.wo + threadIdx.x] += s;
  } else if (threadIdx.x == WIDTH) {
    float s = 0.f;
    for (int p = 0; p < TP; ++p) s += g_sm[p];
    part[L.bo] += s;
  }
  // dpre_L[p][n] = wo[n] g[p] (h_L > 0)
  for (int t = threadIdx.x; t < TP * WIDTH; t += NTHREADS) {
    const int p = t / WIDTH, n = t - p * WIDTH;
    D[p * LDW + n] = H[p * LDH + n] > 0.f ? __fmul_rn(f.wo[n], g_sm[p]) : 0.f;
  }
  for (int l = f.n_hidden; l >= 0; --l) {
    __syncthreads();
    // H <- input of layer l, Ws <- its weight
    const int k_real = l > 0 ? WIDTH : k0;
    const int k_pad = round4(k_real);
    const float* src = l > 0 ? scratch + TP * LDH + (long)(l - 1) * TP * WIDTH : scratch;
    const int ld_src = l > 0 ? WIDTH : LDH;
    for (int t = threadIdx.x; t < TP * (k_pad / 4); t += NTHREADS) {
      const int p = t / (k_pad / 4), q = t - p * (k_pad / 4);
      *reinterpret_cast<float4*>(H + p * LDH + 4 * q) =
          *reinterpret_cast<const float4*>(src + (long)p * ld_src + 4 * q);
    }
    if (l > 0) {
      load_weights(Ws, f.wh + (long)(l - 1) * WIDTH * WIDTH, WIDTH, WIDTH);
    } else {
      load_weights(Ws, f.w0, k0, k_pad);
    }
    __syncthreads();
    accumulate_dw(H, D, k_real,
                  part + (l > 0 ? L.wh + (long)(l - 1) * WIDTH * WIDTH : L.w0));
    accumulate_db(D, part + (l > 0 ? L.bh + (long)(l - 1) * WIDTH : L.b0));
    if (l > 0) {
      // dh[p][k] = sum_n D[p][n] Ws[k][n]; dpre_{l-1} = dh (h_{l-1} > 0)
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      const float* dp = D + (warp * 8) * LDW;
      for (int n = 0; n < WIDTH; n += 4) {
        float4 d[8], w[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = *reinterpret_cast<const float4*>(dp + i * LDW + n);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = *reinterpret_cast<const float4*>(Ws + (lane + 32 * j) * LDW + n);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(d[i].x, w[j].x, acc[i][j]);
            acc[i][j] = fmaf(d[i].y, w[j].y, acc[i][j]);
            acc[i][j] = fmaf(d[i].z, w[j].z, acc[i][j]);
            acc[i][j] = fmaf(d[i].w, w[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!(H[(warp * 8 + i) * LDH + lane + 32 * j] > 0.f)) acc[i][j] = 0.f;
      __syncthreads();  // every read of D is done
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) D[(warp * 8 + i) * LDW + lane + 32 * j] = acc[i][j];
    } else if (f.n_lat > 0) {
      // per-point latent cotangent, then per-phase sums in point order
      for (int t = threadIdx.x; t < TP * f.n_lat; t += NTHREADS) {
        const int p = t / f.n_lat, j = t - p * f.n_lat;
        const float* drow = D + p * LDW;
        const float* wrow = Ws + (f.enc + j) * LDW;
        float s = 0.f;
        for (int n = 0; n < WIDTH; ++n) s = fmaf(drow[n], wrow[n], s);
        dlat_sm[p * MAX_LAT + j] = s;
      }
      __syncthreads();
      if (threadIdx.x < n_phases * f.n_lat) {
        const int ph = threadIdx.x / f.n_lat, j = threadIdx.x - ph * f.n_lat;
        float s = 0.f;
        for (int p = 0; p < TP; ++p)
          if (phase_sm[p] == ph) s += dlat_sm[p * MAX_LAT + j];
        *lat_acc += s;
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
bwd_kernel(FieldArgs fs, FieldArgs ft, RayArgs r, const float* g_s, const float* g_t,
           float* partials, long part_stride, float* scratch_all, long scratch_stride) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* D = H + TP * LDH;
  float* Ws = D + TP * LDW;
  float* g_sm = Ws + KMAX * LDW;
  float* dlat_sm = g_sm + TP;
  int* phase_sm = reinterpret_cast<int*>(dlat_sm + TP * MAX_LAT);
  const long n_pts = (long)r.n_rays * r.n_samples;
  const long n_tiles = (n_pts + TP - 1) / TP;
  float* part = partials + blockIdx.x * part_stride;
  float* scratch = scratch_all + blockIdx.x * scratch_stride;
  const GradLayout Ls = grad_layout(fs, r.n_phases);
  const GradLayout Lt = grad_layout(ft, r.n_phases);
  float lat_acc = 0.f;
  float dummy = 0.f;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long tile0 = tile * TP;
    float acc[8][4];
    field_forward(fs, r, tile0, H, Ws, phase_sm, acc, scratch);
    field_backward(fs, acc, g_s, tile0, n_pts, r.n_phases, H, D, Ws, phase_sm, g_sm,
                   dlat_sm, scratch, part, &dummy);
    field_forward(ft, r, tile0, H, Ws, phase_sm, acc, scratch);
    field_backward(ft, acc, g_t, tile0, n_pts, r.n_phases, H, D, Ws, phase_sm, g_sm,
                   dlat_sm, scratch, part + Ls.size, &lat_acc);
  }
  if (ft.n_lat > 0 && threadIdx.x < r.n_phases * ft.n_lat)
    part[Ls.size + Lt.lat + threadIdx.x] += lat_acc;
}

// out[i] = sum over CTAs b (in order) of partials[b][i].
__global__ void reduce_kernel(const float* partials, long part_stride, int n_parts,
                              long n, float* out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_parts; ++b) s += partials[(long)b * part_stride + i];
  out[i] = s;
}

static const int BWD_SMEM =
    (TP * LDH + TP * LDW + KMAX * LDW + TP + TP * MAX_LAT) * 4 + TP * 4;

extern "C" {

int fused_field_smem_bytes(int which) { return which == 0 ? FWD_SMEM : BWD_SMEM; }

// Floats in one CTA's gradient partial (static block, then temporal block).
long fused_field_grad_size(const FieldArgs* fs, const FieldArgs* ft, int n_phases) {
  return grad_layout(*fs, n_phases).size + grad_layout(*ft, n_phases).size;
}

int fused_field_fwd(const FieldArgs* fs, const FieldArgs* ft, const RayArgs* r,
                    float* out_s, float* out_t, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long n_pts = (long)r->n_rays * r->n_samples;
  const long n_tiles = (n_pts + TP - 1) / TP;
  if (n_tiles == 0) return 0;
  fwd_kernel<<<(unsigned)n_tiles, NTHREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      *fs, *ft, *r, out_s, out_t);
  return (int)cudaGetLastError();
}

// partials: [n_ctas, part_stride] zero-initialized by this call;
// scratch: [n_ctas, scratch_stride]; grads: [grad_size] output.
int fused_field_bwd(const FieldArgs* fs, const FieldArgs* ft, const RayArgs* r,
                    const float* g_s, const float* g_t, int n_ctas, float* partials,
                    long part_stride, float* scratch, long scratch_stride, float* grads,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       BWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long n = fused_field_grad_size(fs, ft, r->n_phases);
  e = cudaMemsetAsync(partials, 0, sizeof(float) * part_stride * n_ctas, st);
  if (e != cudaSuccess) return (int)e;
  bwd_kernel<<<n_ctas, NTHREADS, BWD_SMEM, st>>>(*fs, *ft, *r, g_s, g_t, partials,
                                                 part_stride, scratch, scratch_stride);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(partials, part_stride, n_ctas,
                                                             n, grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
