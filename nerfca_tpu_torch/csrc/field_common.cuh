// Device code shared by the field kernels K1/K2 (fused_field.cu) and the
// fused-loss kernel (fused_train.cu): the argument structs, the encoding of a
// 64-point tile and the forward of one field MLP on it. See fused_field.cu
// for what the kernels compute, what bounds them and why the encoding's
// roundings are kept identical to the plain version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WIDTH 128
#define TP 64          // points per tile
#define NTHREADS 256   // 8 warps; warp w owns points 8w..8w+7
#define KMAX 136       // encoded features (<= 128) + latent dims (<= 8)
#define LDH 140        // activation row stride in floats (KMAX + 4)
#define LDW 132        // weight row stride in floats (bank-conflict padding)
#define MAX_PHASES 16
#define MAX_LAT 8

// shared memory of one field forward on a tile: H [TP][LDH], Ws [KMAX][LDW],
// phase_sm [TP]
static const int FWD_SMEM = (TP * LDH + KMAX * LDW) * 4 + TP * 4;

struct FieldArgs {
  const float* w0;      // [k0, 128] input layer, (in, out) layout
  const float* b0;      // [128]
  const float* wh;      // [n_hidden, 128, 128] (in, out)
  const float* bh;      // [n_hidden, 128]
  const float* wo;      // [128]
  const float* bo;      // [1]
  const float* window;  // [basis] band window
  int basis;            // 0 for pos_enc 'none'
  int enc;              // encoded features: 3 + 6 * basis
  int n_lat;            // latent dims (0 for the static field)
  int n_hidden;
};

struct RayArgs {
  const float* origins;  // [R, 3]
  const float* dirs;     // [R, 3]
  const float* z;        // [R, S] (z_stride = S) or shared [S] (z_stride = 0)
  const int* phases;     // [R]
  const float* latents;  // [P, D]
  int n_rays;
  int n_samples;
  int z_stride;
  int n_phases;
};

__device__ __forceinline__ int round4(int k) { return (k + 3) & ~3; }

// Encoded input of one field for the tile starting at point tile0 into
// H[p][k] (k < round4(enc + n_lat); padding columns zeroed). phase_sm[p]
// receives each point's phase (-1 for points past the end).
__device__ __forceinline__ void encode_tile(const FieldArgs& f, const RayArgs& r, long tile0,
                            float* H, int* phase_sm) {
  const long n_pts = (long)r.n_rays * r.n_samples;
  const int k0 = f.enc + f.n_lat;
  const int k0p = round4(k0);
  // one work item per (point, channel, band); band == basis is the raw row
  const int nb = f.basis + 1;
  for (int t = threadIdx.x; t < TP * 3 * nb; t += NTHREADS) {
    const int p = t / (3 * nb), rem = t - p * 3 * nb;
    const int c = rem / nb, b = rem - c * nb;
    const long i = tile0 + p;
    float x = 0.f;
    if (i < n_pts) {
      const long ray = i / r.n_samples;
      const long s = i - ray * r.n_samples;
      const float zz = r.z[ray * r.z_stride + s];
      x = __fadd_rn(r.origins[ray * 3 + c], __fmul_rn(zz, r.dirs[ray * 3 + c]));
    }
    float* row = H + p * LDH;
    if (b == f.basis) {
      row[c] = x;
    } else {
      const float xb = ldexpf(x, b);
      const float w = f.window[b];
      row[3 + 6 * b + c] = __fmul_rn(w, sinf(xb));
      row[3 + 6 * b + 3 + c] = __fmul_rn(w, sinf(__fadd_rn(xb, 1.57079637f)));
    }
  }
  for (int t = threadIdx.x; t < TP; t += NTHREADS) {
    const long i = tile0 + t;
    int ph = -1;
    if (i < n_pts) {
      ph = r.phases[i / r.n_samples];
      if (ph < 0 || ph >= r.n_phases) ph = -2;  // out of table: zero latent
    }
    phase_sm[t] = ph;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < TP * (k0p - f.enc); t += NTHREADS) {
    const int p = t / (k0p - f.enc), j = t - p * (k0p - f.enc);
    const int ph = phase_sm[p];
    float v = 0.f;
    if (j < f.n_lat && ph >= 0) v = r.latents[ph * f.n_lat + j];
    H[p * LDH + f.enc + j] = v;
  }
}

// Ws[k][n] (row stride LDW) <- w[k][n] for k < k_real, zero rows up to k_pad.
__device__ __forceinline__ void load_weights(float* Ws, const float* w, int k_real, int k_pad) {
  for (int t = threadIdx.x; t < k_pad * (WIDTH / 4); t += NTHREADS) {
    const int k = t / (WIDTH / 4), q = t - k * (WIDTH / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < k_real) v = reinterpret_cast<const float4*>(w + (long)k * WIDTH)[q];
    *reinterpret_cast<float4*>(Ws + k * LDW + 4 * q) = v;
  }
}

// acc[i][j] = bias[n] + sum_k H[p][k] * Ws[k][n], p = 8*warp + i, n = lane + 32*j.
__device__ __forceinline__ void layer_fwd(const float* H, const float* Ws,
                                          const float* bias, int k_pad,
                                          float acc[8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* hp = H + (warp * 8) * LDH;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float b = bias[lane + 32 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][j] = b;
  }
  for (int k = 0; k < k_pad; k += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(hp + i * LDH + k);
    float w[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) w[kk][j] = Ws[(k + kk) * LDW + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, w[0][j], acc[i][j]);
        acc[i][j] = fmaf(a[i].y, w[1][j], acc[i][j]);
        acc[i][j] = fmaf(a[i].z, w[2][j], acc[i][j]);
        acc[i][j] = fmaf(a[i].w, w[3][j], acc[i][j]);
      }
  }
}

__device__ __forceinline__ void store_relu(float* dst, int ld, const float acc[8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[(warp * 8 + i) * ld + lane + 32 * j] = fmaxf(acc[i][j], 0.f);
}

// Forward of one field on one tile; on return acc holds the last hidden
// layer's pre-activations. With scratch != nullptr (K2), the encoded input
// and the post-ReLU input of every hidden layer are stored there:
// scratch = [TP][LDH] input, then n_hidden x [TP][128].
__device__ __forceinline__ void field_forward(const FieldArgs& f, const RayArgs& r, long tile0,
                              float* H, float* Ws, int* phase_sm, float acc[8][4],
                              float* scratch) {
  __syncthreads();  // H / Ws / phase_sm are free
  encode_tile(f, r, tile0, H, phase_sm);
  const int k0 = f.enc + f.n_lat;
  load_weights(Ws, f.w0, k0, round4(k0));
  __syncthreads();
  if (scratch != nullptr) {
    for (int t = threadIdx.x; t < TP * LDH; t += NTHREADS) scratch[t] = H[t];
  }
  layer_fwd(H, Ws, f.b0, round4(k0), acc);
  for (int l = 0; l < f.n_hidden; ++l) {
    __syncthreads();
    store_relu(H, LDH, acc);
    if (scratch != nullptr) store_relu(scratch + TP * LDH + l * TP * WIDTH, WIDTH, acc);
    load_weights(Ws, f.wh + (long)l * WIDTH * WIDTH, WIDTH, WIDTH);
    __syncthreads();
    layer_fwd(H, Ws, f.bh + l * WIDTH, WIDTH, acc);
  }
}

// out[tile0 + p] = bo + sum_n wo[n] relu(acc[p][n]) for tile0 + p < n_pts;
// lane 0 of each warp writes.
__device__ __forceinline__ void field_output(const FieldArgs& f, const float acc[8][4], long tile0,
                             long n_pts, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float wo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wo[j] = f.wo[lane + 32 * j];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) s = fmaf(fmaxf(acc[i][j], 0.f), wo[j], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const long idx = tile0 + warp * 8 + i;
    if (lane == 0 && idx < n_pts) out[idx] = s + f.bo[0];
  }
}
