// The hash-grid field's forward for Hopper (sm_90a), plain C interface.
//
// NAF's attenuation field (Zha, Zhang, Li, MICCAI 2022): Instant-NGP's
// multiresolution hash encoding (16 levels of 2 features, 2^19 entries a
// level, 16 to 2048 cells a side) feeding a 4-layer MLP of width 32 with a
// skip, LeakyReLU between its layers. One launch a tile of rays: each
// thread takes one point o + z d of the tile's R x S, encodes it, runs the
// whole MLP and writes its raw density, [R * S] f32, which the static
// method's Beer-Lambert kernel (fused_train.cu's static_composite_kernel)
// reads. The encoding's definition is nerfca_tpu_torch/ops/encoding.py's
// (module note); this computes it with the same operations in the same
// order, each rounded once (__fmul_rn / __fadd_rn: no contraction into a
// fused multiply-add), so the encoding is bitwise the plain version's.
//
// What bounds it, per point: 16 levels x 8 corners x 8 B of table reads
// (1 KB, scattered: one 32-byte sector each at the fine levels) and 4,128
// multiply-adds of the MLP. The MLP is exact f32 on the CUDA cores, an
// fmaf chain per output in input order, its weights in shared memory
// (16.9 KB, read as float4 broadcasts: one shared load a 4 FMAs); no
// tensor-core product, no TF32, no bf16. The table is 48.8 MB, about the
// H100's L2; a warp's 32 threads are 32 consecutive samples of one ray, so
// at the coarse levels their corners fall in a few cells and the reads
// coalesce or hit L1, while at the fine levels each sample has cells of its
// own and its reads go to L2. The threads walk the levels in order, so at
// any moment the resident warps read a few levels' entries. No atomics:
// every point is computed alone, in a fixed order; the output does not
// depend on the launch shape.
//
// The CTAs are persistent, at most an occupancy's worth a multiprocessor,
// each loading the weights once and striding over the tile's points.
//
// Measured on an H100 SXM at 700 W (15 rounds of a 40000 x 192 view in 10
// tiles, medians): 4.52 ms a view, against 0.95 ms for the MLP's operations
// at the f32 peak and 0.90 ms for the corner reads at the 8.78 TB/s that
// streaming reads from L2 reached (scripts/l2_read_bandwidth.py); with the
// MLP cut out 2.66 ms, with the gathers replaced by arithmetic 2.99 ms, so
// neither part hides behind the other. 153
// registers, one 256-thread CTA a multiprocessor: capping the registers at
// 128 for two CTAs (a few spills) read 4.74 ms, 128-thread CTAs (three a
// multiprocessor) 4.47, the skip layer fully unrolled 4.94; the MLP's
// shared loads and issue, not the gathers' latency, hold it.

#include <cuda_runtime.h>
#include <stdint.h>

#define HF_LEVELS 16
#define HF_WIDTH 32
#define HF_ENC (2 * HF_LEVELS)
#define HF_LOG2_T 19
#define HF_THREADS 256
// the weights in shared memory, in this order: w0 [32, 32], b0, w1 [32, 32],
// b1, ws [32, 64], bs, wo [32], bo
#define HF_W0 0
#define HF_B0 (HF_W0 + HF_WIDTH * HF_ENC)
#define HF_W1 (HF_B0 + HF_WIDTH)
#define HF_B1 (HF_W1 + HF_WIDTH * HF_WIDTH)
#define HF_WS (HF_B1 + HF_WIDTH)
#define HF_BS (HF_WS + HF_WIDTH * (HF_ENC + HF_WIDTH))
#define HF_WO (HF_BS + HF_WIDTH)
#define HF_BO (HF_WO + HF_WIDTH)
#define HF_FLOATS (HF_BO + 4)

struct HashLevels {
  int res[HF_LEVELS];     // cells a side
  int offset[HF_LEVELS];  // the level's first entry in the table
  int dense[HF_LEVELS];   // 1: indexed densely; 0: hashed
};

struct HashFieldArgs {
  const float* w0; const float* b0;  // [32, 32], [32]: encoding -> h1
  const float* w1; const float* b1;  // [32, 32], [32]: h1 -> h2
  const float* ws; const float* bs;  // [32, 64], [32]: [encoding, h2] -> h3
  const float* wo; const float* bo;  // [1, 32], [1]: h3 -> raw density
  const float2* table;               // [entries, 2]
  const float* origins;              // [R, 3]
  const float* dirs;                 // [R, 3]
  const float* z;                    // [S] shared depths
  float* out;                        // [R * S] raw densities
  float bound;                       // half extent of the encoded cube
  float slope;                       // LeakyReLU's negative slope
  int n_rays;
  int n_samples;
  HashLevels lv;
};

template <int IN>
__device__ __forceinline__ float dot_row(const float* __restrict__ w, const float (&x)[IN],
                                         float acc) {
#pragma unroll
  for (int i = 0; i < IN; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(w + i);
    acc = fmaf(v.x, x[i], acc);
    acc = fmaf(v.y, x[i + 1], acc);
    acc = fmaf(v.z, x[i + 2], acc);
    acc = fmaf(v.w, x[i + 3], acc);
  }
  return acc;
}

__device__ __forceinline__ float leaky(float x, float slope) { return x > 0.f ? x : x * slope; }

__global__ void __launch_bounds__(HF_THREADS)
hash_field_kernel(const HashFieldArgs a) {
  __shared__ __align__(16) float sw[HF_FLOATS];
  {
    const float* src[8] = {a.w0, a.b0, a.w1, a.b1, a.ws, a.bs, a.wo, a.bo};
    const int at[8] = {HF_W0, HF_B0, HF_W1, HF_B1, HF_WS, HF_BS, HF_WO, HF_BO};
    const int n[8] = {HF_WIDTH * HF_ENC, HF_WIDTH, HF_WIDTH * HF_WIDTH, HF_WIDTH,
                      HF_WIDTH * (HF_ENC + HF_WIDTH), HF_WIDTH, HF_WIDTH, 1};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      for (int i = threadIdx.x; i < n[k]; i += HF_THREADS) sw[at[k] + i] = src[k][i];
  }
  __syncthreads();

  const long total = (long)a.n_rays * a.n_samples;
  const float bnd = a.bound;
  const float span = __fadd_rn(bnd, bnd);
  const uint32_t mask = (1u << HF_LOG2_T) - 1u;
  for (long p = (long)blockIdx.x * HF_THREADS + threadIdx.x; p < total;
       p += (long)gridDim.x * HF_THREADS) {
    const int ray = (int)(p / a.n_samples);
    const float zz = a.z[p - (long)ray * a.n_samples];
    float u[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = __fadd_rn(a.origins[ray * 3 + c], __fmul_rn(a.dirs[ray * 3 + c], zz));
      u[c] = fminf(fmaxf(__fdiv_rn(__fadd_rn(x, bnd), span), 0.f), 1.f);
    }

    float enc[HF_ENC];
#pragma unroll
    for (int l = 0; l < HF_LEVELS; ++l) {
      const int n = a.lv.res[l];
      const float2* tab = a.table + a.lv.offset[l];
      const bool dense = a.lv.dense[l] != 0;
      int g[3];
      float f[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float pos = __fmul_rn(u[c], (float)n);
        const float fl = fminf(floorf(pos), (float)(n - 1));
        g[c] = (int)fl;
        f[c] = __fsub_rn(pos, fl);
      }
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        const int k0 = g[0] + (corner & 1), k1 = g[1] + ((corner >> 1) & 1),
                  k2 = g[2] + ((corner >> 2) & 1);
        uint32_t idx;
        if (dense) {
          idx = (uint32_t)(k0 + (n + 1) * (k1 + (n + 1) * k2));
        } else {
          idx = ((uint32_t)k0 ^ ((uint32_t)k1 * 2654435761u) ^ ((uint32_t)k2 * 805459861u)) & mask;
        }
        const float w0 = (corner & 1) ? f[0] : __fsub_rn(1.f, f[0]);
        const float w1 = ((corner >> 1) & 1) ? f[1] : __fsub_rn(1.f, f[1]);
        const float w2 = ((corner >> 2) & 1) ? f[2] : __fsub_rn(1.f, f[2]);
        const float w = __fmul_rn(__fmul_rn(w0, w1), w2);
        const float2 t = __ldg(tab + idx);
        acc0 = __fadd_rn(acc0, __fmul_rn(w, t.x));
        acc1 = __fadd_rn(acc1, __fmul_rn(w, t.y));
      }
      enc[2 * l] = acc0;
      enc[2 * l + 1] = acc1;
    }

    float h1[HF_WIDTH], h2[HF_WIDTH];
#pragma unroll
    for (int j = 0; j < HF_WIDTH; ++j)
      h1[j] = leaky(dot_row<HF_ENC>(sw + HF_W0 + j * HF_ENC, enc, sw[HF_B0 + j]), a.slope);
#pragma unroll
    for (int j = 0; j < HF_WIDTH; ++j)
      h2[j] = leaky(dot_row<HF_WIDTH>(sw + HF_W1 + j * HF_WIDTH, h1, sw[HF_B1 + j]), a.slope);
    float raw = sw[HF_BO];
#pragma unroll 4
    for (int j = 0; j < HF_WIDTH; ++j) {
      const float* row = sw + HF_WS + j * (HF_ENC + HF_WIDTH);
      const float h3 = leaky(dot_row<HF_WIDTH>(row + HF_ENC, h2, dot_row<HF_ENC>(row, enc,
                                                                              sw[HF_BS + j])),
                             a.slope);
      raw = fmaf(sw[HF_WO + j], h3, raw);
    }
    a.out[p] = raw;
  }
}

extern "C" {

int hash_field_args_bytes() { return (int)sizeof(HashFieldArgs); }
int hash_field_levels() { return HF_LEVELS; }

// One tile: every point of a->n_rays x a->n_samples.
int hash_field_fwd(const HashFieldArgs* a, void* stream) {
  if (a->n_rays < 1 || a->n_samples < 1) return (int)cudaErrorInvalidValue;
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_field_kernel, HF_THREADS, 0);
    max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long total = (long)a->n_rays * a->n_samples;
  long blocks = (total + HF_THREADS - 1) / HF_THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  hash_field_kernel<<<(int)blocks, HF_THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
