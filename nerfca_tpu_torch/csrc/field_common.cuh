// Device code of the field kernels K1/K2 (fused_field.cu): the argument
// structs and the encoding of a 64-point tile. See fused_field.cu for what
// the kernels compute, what bounds them and why the encoding's roundings are
// kept identical to the plain version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WIDTH 128
#define TP 64          // points per encode_tile call
#define NTHREADS 256   // 8 warps
#define LDH 140        // activation row stride in floats: encoded (<= 128) + latent (<= 8) + 4
#define LDW 132        // weight row stride in floats (bank-conflict padding)
#define MAX_PHASES 16
#define MAX_LAT 8

struct FieldArgs {
  const float* w0;      // [k0, 128] input layer, (in, out) layout
  const float* b0;      // [128]
  const float* wh;      // [n_hidden, 128, 128] (in, out)
  const float* bh;      // [n_hidden, 128]
  const float* wo;      // [128]
  const float* bo;      // [1]
  union {
    const float* window;  // [basis] band window (windowed and 'none' modes)
    const float* coef;    // [3 * basis] projection ('fourier' mode)
  };
  int basis;            // 0 for pos_enc 'none'
  int enc;              // encoded features: 3 + 6 * basis ('fourier': 6 * basis)
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

// A field in 'fourier' mode: 6 * basis encoded features and no raw rows
// (the other modes have 3 + 6 * basis, or 3).
__host__ __device__ __forceinline__ bool is_fourier(const FieldArgs& f) {
  return f.basis > 0 && f.enc == 6 * f.basis;
}

// Encoded input of one field for the tile starting at point tile0 into
// H[p][k] (k < round4(enc + n_lat); padding columns zeroed). phase_sm[p]
// receives each point's phase (-1 for points past the end). FOURIER
// instantiations also take a field in 'fourier' mode (decided per field at
// run time); the others compile the windowed and 'none' modes alone.
template <bool FOURIER>
__device__ __forceinline__ void encode_tile(const FieldArgs& f, const RayArgs& r, long tile0,
                            float* H, int* phase_sm) {
  const long n_pts = (long)r.n_rays * r.n_samples;
  const int k0 = f.enc + f.n_lat;
  const int k0p = round4(k0);
  if (FOURIER && is_fourier(f)) {
    // one work item per (point, band, channel), j = 3 band + channel:
    // v = (f32(2 pi) x[c]) coef[j], rounded as the plain version rounds it;
    // feature j is sin(v), feature 3 basis + j cos(v) (accurate sinf/cosf:
    // |v| reaches ~40 at sigma 2)
    const int nj = 3 * f.basis;
    for (int t = threadIdx.x; t < TP * nj; t += NTHREADS) {
      const int p = t / nj, j = t - p * nj, c = j % 3;
      const long i = tile0 + p;
      float x = 0.f;
      if (i < n_pts) {
        const long ray = i / r.n_samples;
        const long s = i - ray * r.n_samples;
        const float zz = r.z[ray * r.z_stride + s];
        x = __fadd_rn(r.origins[ray * 3 + c], __fmul_rn(zz, r.dirs[ray * 3 + c]));
      }
      const float v = __fmul_rn(__fmul_rn(6.28318548f, x), f.coef[j]);
      float* row = H + p * LDH;
      row[j] = sinf(v);
      row[nj + j] = cosf(v);
    }
  } else {
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
