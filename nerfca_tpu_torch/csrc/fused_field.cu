// Fused encode -> MLP field kernels for Hopper (sm_90a), plain C interface.
//
// K1 (fused_field_fwd) replaces nerfca_tpu/ops/pallas/fused_field.py::_fwd_kernel
// (pallas_call in _fused_core_fwd_impl). K2 (fused_field_bwd + fused_field_reduce)
// replaces ::_bwd_kernel (pallas_call in _fused_core_bwd), the custom VJP of K1.
// K1 in f32 is fwd_kernel_wgmma (k1_wgmma.cuh: wgmma, warp-specialised,
// persistent, with its own note); K2 and K1 in bf16 (fwd_kernel) run their
// matrix products through the same mma.sync device code below (the weight
// ring, mma_layer_fwd, store_relu_frag); the encoding lives in
// field_common.cuh. The fused-loss step (fused_train.cu) takes its forward
// from K1.
//
// Both kernels are templated on the field count NF. NF == 2 is the composite
// pair above; NF == 1 evaluates the static field alone (the field of the
// static 3-D method), on half the CTAs, with the same code per CTA. A C
// entry given ft == NULL launches NF == 1. They are also templated on
// FOURIER: the C entries launch the FOURIER instantiation when a field
// encodes in 'fourier' mode (field_common.cuh: 6 * basis features from a
// fixed projection, no raw rows, decided per field at run time), and the
// other one otherwise, whose code is that of the windowed modes alone.
//
// What they compute, per point i = r * S + s of a ray batch:
//   x = o[r] + z[r, s] * d[r]                      (never materialized in HBM)
//   enc = [x, per band b: w[b] * sin(2^b x), w[b] * sin(2^b x + pi/2)]
//         ('fourier': [sin(v), cos(v)], v[j] = 2 pi x[j % 3] coef[j])
//   static:   raw_s = wo_s . relu(... relu(W0_s enc + b0_s) ...) + bo_s
//   temporal: raw_t = same with [enc, latents[phase[r]]] as the input
// K2 recomputes that forward per tile, backpropagates the given cotangents
// g_s, g_t and produces every parameter gradient of both fields plus the
// latent-table gradient.
//
// What bounds them on this card: they are compute bound. Both fields cost
// about 151.5k MAC per point (5 layers of 128x128 plus the input layer), so
// a 512,000-point train step is ~155 GFLOP forward and ~3x that backward,
// against a few bytes of HBM traffic per point.
//
// Both run their products on the tensor cores in 3xTF32 (field_mma.cuh):
// three TF32 products per f32 product keep near-f32 accuracy. K1's bound is
// then 3 x 155.2 GFLOP at 495 TFLOP/s, ~0.94 ms at the flagship step (2.3
// ms for f32 FMAs on the CUDA cores); K2 runs three products (the forward
// recompute, dX of the hidden layers, dW of every layer), ~2.8 ms against
// ~7 ms for f32 FMAs.
//
// K1 in bf16 (fwd_kernel) gives each CTA one field on one tile of K1_TP =
// 128 points; its weights stream through the same two-chunk cp.async ring
// as K2's in chunks of K1_WCH = 32 rows, so two CTAs fit on an SM and one
// CTA's encoding and weight waits run under the other's products. The
// output layer runs on the CUDA cores.
//
// In K2 the encoding, the output layer, the bias sums and the latent
// cotangent stay on the CUDA cores in exact f32. A tile is 128 points,
// which halves per point what K2 moves besides the MACs: the weights
// (streamed from L2 through a two-chunk cp.async ring that overlaps the
// next 64 rows' copy with the current ones' products) and the
// read-modify-write of the CTA's gradient partial after each
// layer. Residual activations go to a per-CTA scratch in global memory
// (262 KB at the flagship widths), written and read back within one tile,
// so no [points, 128] array per layer is ever stored. What bounds K2 is the
// mma.sync rate: on the H100 a TF32 m16n8k8 issues about every 8 cycles
// per SM sub-partition, half of what wgmma reaches, so the products alone
// take ~6 ms; the encoding and the CUDA-core phases run at low occupancy
// (8 warps per SM). K2 on wgmma is later work.
// The short loop for work on these kernels is chip_smoke.check_kernels()
// on the card (build, errors and times at the flagship shapes);
// scripts/k2_variants.py splits K2's time by phase, scripts/k1_variants.py
// times K1 at two tile sizes and without parts of its work.
//
// bf16 (compute_dtype "bfloat16", the JAX kernel's _dot/_dotg casts): both
// mma.sync kernels take a BF16 template parameter (fwd_kernel is launched
// with BF16 alone; its f32 path remains for the SASS it had). Every matrix product then rounds
// its operands to bf16 (to nearest, ties to even) as it loads them from the
// f32 shared-memory tiles and runs one mma.sync.m16n8k16 product per MAC
// into f32 (field_mma.cuh); k steps are 16 deep, so the input layer pads to
// round16(k0) (96 at the flagship's temporal 83). The output layer, dwo,
// the output layer's dh and the latent cotangent take bf16-rounded
// operands on the CUDA cores; biases, ReLUs and the bias sums stay f32, and
// every gradient leaves in f32. The bound falls to 155 GFLOP at 989
// TFLOP/s, ~0.16 ms for K1 at the flagship step and ~0.47 ms for K2.
// K2 also takes RES_BF16 (bf16 residual storage, launched by K3 alone): its
// scratch holds the hidden inputs as bf16, and the copies of h that stay in
// shared memory are rounded after the last forward product has read them,
// so the forward chain and the loss stay f32. The f32 instantiations
// compile to their earlier code (scripts/sass_diff.py).
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
#include "field_mma.cuh"
#include "k1_wgmma.cuh"

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

// ---------------------------------------------------------------------------
// K2 on the tensor cores. One CTA of 8 warps walks its tiles of BTP points
// for one field (with two, even CTAs the static field and odd ones the
// temporal field);
// per tile it recomputes the forward, storing the residuals in its scratch,
// then backpropagates. The three products run as 3xTF32 mma.sync
// (field_mma.cuh), warp w owning a 32 x 64 block of each:
//   forward  acc[p][n]  = bias[n] + sum_k H[p][k] W[k][n]     (points x outputs)
//   dX       dh[p][k]   = sum_n D[p][n] W[k][n]               (points x inputs)
//   dW       dW[k][n]  += sum_p H[p][k] D[p][n]               (inputs x outputs)
// Each layer's weight streams through a ring of two 64-row chunks (see
// WeightRing), and each layer's input comes back from the scratch with
// cp.async while the layer above runs its dX.
//
// Strides (floats): LDH = 140 (12 mod 32), LDD = LDW = 132 (4 mod 32). The
// fragment loads are then conflict-free except the forward's A (H[p][k],
// k in PAIR order, 2-way): forward B W[k][n] and dW's A H[p][k], B D[p][n]
// read k or p strided and take the PAIR order; dX's A D[p][n] and B W[k][n]
// read n along a row and take the plain order.

#define BTP 128              // K2 points per tile
#define MT (BTP / 64)        // 16-point m-tiles per warp along the points
#define LDD 132              // cotangent row stride in floats
#define WCH 64               // weight rows per streamed chunk

__device__ __forceinline__ int round8(int k) { return (k + 7) & ~7; }
__device__ __forceinline__ int round16(int k) { return (k + 15) & ~15; }

// The weight chunks of one field in the order K2 consumes them: the input
// layer in 64-row chunks (rows past k0 zero), each hidden layer's two halves
// for the forward, then the hidden layers again, last to first, for dX.
// Chunk i lives in buffer i & 1. The forward takes one chunk at a time and
// copies the next while it computes; dX takes a layer's two halves at once,
// and the next layer's pair is copied while dW and db run. K1 streams the
// forward's chunks alone, of C = K1_WCH rows (the ring functions take the
// chunk's rows C as a template argument, WCH unless given).
struct WeightRing {
  float* buf;  // [2][C][LDW]
  int n_in;    // chunks of the input layer
  int total;
  int next;    // chunk to compute next
  int issued;  // chunks whose copy has started
};

// Starts the copy of chunk i into its buffer (not committed).
template <int C = WCH>
__device__ __forceinline__ void ring_copy(const FieldArgs& f, const WeightRing& w, int i) {
  constexpr int per = WIDTH / C;  // chunks of a hidden layer
  const float* src;
  int rows = C;
  if (i < w.n_in) {
    src = f.w0 + (long)C * i * WIDTH;
    rows = min(C, f.enc + f.n_lat - C * i);
  } else {
    const int j = i - w.n_in;
    const int layer = j < per * f.n_hidden ? j / per : 2 * f.n_hidden - 1 - j / per;
    src = f.wh + (long)layer * WIDTH * WIDTH + (long)(j & (per - 1)) * C * WIDTH;
  }
  float* dst = w.buf + (i & 1) * C * LDW;
  for (int q = threadIdx.x; q < C * (WIDTH / 4); q += NTHREADS) {
    const int row = q / (WIDTH / 4), c4 = q - row * (WIDTH / 4);
    float* d = dst + row * LDW + 4 * c4;
    if (row < rows) {
      cp_async16(d, src + (long)row * WIDTH + 4 * c4);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Starts a field's sequence (K1's stops after the hidden layers' forward);
// the ring and every buffer must be free.
template <int C = WCH>
__device__ __forceinline__ WeightRing ring_begin(const FieldArgs& f, float* buf,
                                                 bool backward = true) {
  WeightRing w;
  w.buf = buf;
  w.n_in = (round8(f.enc + f.n_lat) + C - 1) / C;
  w.total = w.n_in + (backward ? 2 : 1) * (WIDTH / C) * f.n_hidden;
  w.next = 0;
  w.issued = 1;
  __syncthreads();
  ring_copy<C>(f, w, 0);
  cp_async_commit();
  return w;
}

// Forward: waits for chunk next (the only copy in flight), starts the copy
// of the one after it into the buffer every warp has just finished with,
// and returns chunk next.
template <int C = WCH>
__device__ __forceinline__ const float* ring_acquire(const FieldArgs& f, WeightRing& w) {
  cp_async_wait<0>();
  __syncthreads();
  const int i = w.next++;
  if (w.issued < w.total) ring_copy<C>(f, w, w.issued++);
  cp_async_commit();
  return w.buf + (i & 1) * C * LDW;
}

// dX: waits for every copy in flight; chunks next and next + 1 (a layer's
// two halves) are then in the buffers. Returns next.
__device__ __forceinline__ int ring_acquire_pair(WeightRing& w) {
  cp_async_wait<0>();
  __syncthreads();
  w.next += 2;
  return w.next - 2;
}

// Starts the copies of chunks next and next + 1 not started yet, as exactly
// two commit groups (empty past the end); every warp must be done with the
// buffers they go to.
__device__ __forceinline__ void ring_top_up(const FieldArgs& f, WeightRing& w) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (w.issued < min(w.next + 2, w.total)) ring_copy(f, w, w.issued++);
    cp_async_commit();
  }
}

// acc = bias + H[:, :k_pad] W for this warp's M x 16 points and 64 outputs
// (a tile of 64 M points: warp w owns points 16 M (w & 3) + 0..16 M - 1 and
// outputs 64 (w >> 2) + 0..63), the weight taken chunk by chunk (C rows)
// from the ring.
// BF16: one bf16 product per MAC (field_mma.cuh) in k steps of 16; k_pad is
// then a multiple of 16, and an upper half-step past the row stride LDH (an
// input layer of more than 128 columns) reads as zero: those columns are
// padding, with zero weight rows.
template <int M, int C = WCH, bool BF16 = false>
__device__ __forceinline__ void mma_layer_fwd(const FieldArgs& f, WeightRing& ring,
                                              const float* H, const float* bias, int k_pad,
                                              float (&acc)[M][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = 16 * M * (warp & 3), col0 = 64 * (warp >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float b0 = bias[col0 + 8 * j + 2 * t], b1 = bias[col0 + 8 * j + 2 * t + 1];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      acc[i][j][0] = b0; acc[i][j][1] = b1; acc[i][j][2] = b0; acc[i][j][3] = b1;
    }
  }
  for (int kc = 0; kc < k_pad; kc += C) {
    const float* W = ring_acquire<C>(f, ring);
    const int kn = min(C, k_pad - kc);
    if (BF16) {
#pragma unroll 2
      for (int kk = 0; kk < kn; kk += 16) {
        const bool hi = kc + kk + 16 <= LDH;
        FragA16 a[M];
        FragB16 b[8];
#pragma unroll
        for (int i = 0; i < M; ++i)
          a[i] = load_a16(H + (row0 + 16 * i) * LDH + kc + kk, LDH, 1, hi);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = load_b16(W + kk * LDW + col0 + 8 * j, LDW, 1);
        mma_bf16_block(acc, a, b);
      }
      continue;
    }
#pragma unroll 2
    for (int kk = 0; kk < kn; kk += 8) {
      FragA a[M];
      FragB b[8];
#pragma unroll
      for (int i = 0; i < M; ++i) a[i] = load_a<true>(H + (row0 + 16 * i) * LDH + kc + kk, LDH, 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = load_b<true>(W + kk * LDW + col0 + 8 * j, LDW, 1);
      mma_3xtf32(acc, a, b);
    }
  }
}

// dst[p][n] = relu(acc) for this warp's block (row stride ld); ROUND: each
// value rounded to bf16 (kept as f32).
template <int M, bool ROUND = false>
__device__ __forceinline__ void store_relu_frag(float* dst, int ld, const float (&acc)[M][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * M * (warp & 3), col0 = 64 * (warp >> 2);
  auto relu = [](float x) { return ROUND ? round_bf16(fmaxf(x, 0.f)) : fmaxf(x, 0.f); };
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* d = dst + (long)(row0 + 16 * i + g) * ld + col0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(d) = make_float2(relu(acc[i][j][0]), relu(acc[i][j][1]));
      *reinterpret_cast<float2*>(d + 8 * ld) =
          make_float2(relu(acc[i][j][2]), relu(acc[i][j][3]));
    }
}

// As store_relu_frag, each value rounded to bf16 and stored as bf16 (dst
// holds bf16 pairs; ld in bf16 elements).
template <int M>
__device__ __forceinline__ void store_relu_frag_bf16(uint32_t* dst, int ld,
                                                     const float (&acc)[M][8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * M * (warp & 3), col0 = 64 * (warp >> 2);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long e = (long)(row0 + 16 * i + g) * ld + col0 + 8 * j + 2 * t;
      dst[e >> 1] = pack_bf16x2(fmaxf(acc[i][j][0], 0.f), fmaxf(acc[i][j][1], 0.f));
      dst[(e + 8 * ld) >> 1] = pack_bf16x2(fmaxf(acc[i][j][2], 0.f), fmaxf(acc[i][j][3], 0.f));
    }
}

// Forward of one field on the tile at tile0. On return D holds h_L, H the
// input of the last layer (for the first backward layer), g_sm the tile's
// cotangents, and the scratch the encoded input ([BTP][LDH]) and the input
// of every hidden layer but the last ((n_hidden - 1) x [BTP][WIDTH]).
// BF16: the products in bf16 (mma_layer_fwd). RES_BF16 (bf16 residual
// storage, f32 products): the hidden inputs go to the scratch as bf16, and
// D and H are rounded to bf16 too, H only after the last layer's product
// has read it, so the forward chain stays f32 and only what the backward
// reads is rounded. The encoded input is not a residual and stays f32.
template <bool FOURIER, bool BF16 = false, bool RES_BF16 = false>
__device__ __forceinline__ void k2_forward(const FieldArgs& f, const RayArgs& r, const float* g,
                                           long tile0, WeightRing& ring, float* H, float* D,
                                           int* phase_sm, float* g_sm, float* scratch) {
  const long n_pts = (long)r.n_rays * r.n_samples;
  for (int p = threadIdx.x; p < BTP; p += NTHREADS) {
    const long i = tile0 + p;
    g_sm[p] = i < n_pts ? g[i] : 0.f;
  }
  encode_tile<FOURIER>(f, r, tile0, H, phase_sm);
  encode_tile<FOURIER>(f, r, tile0 + TP, H + TP * LDH, phase_sm + TP);
  const int k0 = f.enc + f.n_lat, k4 = round4(k0), k_pad = round8(k0);
  // the mma steps are 8 deep (16 in bf16): zero the columns encode_tile leaves
  const int k_zero = BF16 ? min(round16(k0), LDH) : k_pad;
  for (int t = threadIdx.x; t < BTP * (k_zero - k4); t += NTHREADS) {
    const int p = t / (k_zero - k4);
    H[p * LDH + k4 + t - p * (k_zero - k4)] = 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < BTP * (k_pad / 4); t += NTHREADS) {
    const int p = t / (k_pad / 4), q = t - p * (k_pad / 4);
    *reinterpret_cast<float4*>(scratch + p * LDH + 4 * q) =
        *reinterpret_cast<const float4*>(H + p * LDH + 4 * q);
  }
  float acc[MT][8][4];
  mma_layer_fwd<MT, WCH, BF16>(f, ring, H, f.b0, BF16 ? round16(k0) : k_pad, acc);
  for (int l = 0; l < f.n_hidden; ++l) {
    __syncthreads();  // every read of H is done
    store_relu_frag(H, LDH, acc);
    if (l + 1 < f.n_hidden) {  // the last hidden layer's input stays in H
      if (RES_BF16)
        store_relu_frag_bf16(reinterpret_cast<uint32_t*>(scratch + BTP * LDH) +
                                 (long)l * BTP * WIDTH / 2, WIDTH, acc);
      else
        store_relu_frag(scratch + BTP * LDH + (long)l * BTP * WIDTH, WIDTH, acc);
    }
    mma_layer_fwd<MT, WCH, BF16>(f, ring, H, f.bh + l * WIDTH, WIDTH, acc);
  }
  if (RES_BF16) {
    store_relu_frag<MT, true>(D, LDD, acc);
    if (f.n_hidden > 0) {
      __syncthreads();  // the last product has read H
      for (int q = threadIdx.x; q < BTP * WIDTH; q += NTHREADS) {
        float* h = H + (q / WIDTH) * LDH + (q & (WIDTH - 1));
        *h = round_bf16(*h);
      }
    }
    return;
  }
  store_relu_frag(D, LDD, acc);  // D's last reader was behind a barrier
}

// part[k][n] += sum_p H[p][k] D[p][n] for k < k_real (k_pad rounds k_real
// up to 8); warp w owns k in kc + 32 (w & 3) + 0..31, n in 64 (w >> 2) + 0..63.
// The partial is loaded into the accumulators before the products, so its
// round trip overlaps them. BF16: bf16 products, 16 points a step.
template <bool BF16 = false>
__device__ __forceinline__ void mma_accumulate_dw(const float* H, const float* D, int k_real,
                                                  int k_pad, float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col0 = 64 * (warp >> 2);
  for (int kc = 0; kc < k_pad; kc += WIDTH) {
    const int m0 = kc + 32 * (warp & 3);
    if (m0 >= k_pad) continue;
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = m0 + 16 * i + 8 * h + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float2 v = make_float2(0.f, 0.f);
          if (k < k_real)
            v = *reinterpret_cast<const float2*>(part + (long)k * WIDTH + col0 + 8 * j + 2 * t);
          acc[i][j][2 * h] = v.x;
          acc[i][j][2 * h + 1] = v.y;
        }
      }
    if (BF16) {
#pragma unroll 2
      for (int p = 0; p < BTP; p += 16) {
        FragA16 a[2];
        FragB16 b[8];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = load_a16(H + p * LDH + m0 + 16 * i, 1, LDH);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = load_b16(D + p * LDD + col0 + 8 * j, LDD, 1);
        mma_bf16_block(acc, a, b);
      }
    } else {
#pragma unroll 2
      for (int p = 0; p < BTP; p += 8) {
        // rows of the second m-tile past k_pad read other columns of H (or
        // the start of D); their sums are never stored
        FragA a[2];
        FragB b[8];
#pragma unroll
        for (int i = 0; i < 2; ++i) a[i] = load_a<true>(H + p * LDH + m0 + 16 * i, 1, LDH);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = load_b<true>(D + p * LDD + col0 + 8 * j, LDD, 1);
        mma_3xtf32(acc, a, b);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = m0 + 16 * i + 8 * h + g;
        if (k >= k_real) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(part + (long)k * WIDTH + col0 + 8 * j + 2 * t) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  }
}

// part[n] += sum_p D[p][n], as four interleaved partial sums in point order
// (a fixed order; four chains instead of one long one).
__device__ __forceinline__ void accumulate_db(const float* D, float* part) {
  if (threadIdx.x < WIDTH) {
    const float old = part[threadIdx.x];
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int p = 0; p < BTP; ++p) s[p & 3] += D[p * LDD + threadIdx.x];
    part[threadIdx.x] = old + ((s[0] + s[1]) + (s[2] + s[3]));
  }
}

// acc = D W^T for this warp's MT x 16 points and the 64 inputs of W, the
// layer's half that holds them (64 (w >> 2) + 0..63). BF16: bf16 products.
template <bool BF16 = false>
__device__ __forceinline__ void mma_dx(const float* D, const float* W, float (&acc)[MT][8][4]) {
  const int row0 = (BTP / 4) * ((threadIdx.x >> 5) & 3);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  if (BF16) {
#pragma unroll 2
    for (int n = 0; n < WIDTH; n += 16) {
      FragA16 a[MT];
      FragB16 b[8];
#pragma unroll
      for (int i = 0; i < MT; ++i) a[i] = load_a16(D + (row0 + 16 * i) * LDD + n, LDD, 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = load_b16(W + 8 * j * LDW + n, 1, LDW);
      mma_bf16_block(acc, a, b);
    }
    return;
  }
#pragma unroll 2
  for (int n = 0; n < WIDTH; n += 8) {
    FragA a[MT];
    FragB b[8];
#pragma unroll
    for (int i = 0; i < MT; ++i) a[i] = load_a<false>(D + (row0 + 16 * i) * LDD + n, LDD, 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = load_b<false>(W + 8 * j * LDW + n, 1, LDW);
    mma_3xtf32(acc, a, b);
  }
}

// H <- the input of layer l from the scratch, with cp.async (committed, not
// waited for). RES_BF16: a hidden input (l > 0) is bf16 in the scratch and
// is converted into H with plain loads and stores (an empty group is
// committed, so the group count stays that of the cp.async route).
template <bool RES_BF16 = false>
__device__ __forceinline__ void prefetch_layer_input(const FieldArgs& f, const float* scratch,
                                                     int l, float* H) {
  if (RES_BF16 && l > 0) {
    const uint4* src = reinterpret_cast<const uint4*>(scratch + BTP * LDH) +
                       (long)(l - 1) * BTP * WIDTH / 8;
    for (int q = threadIdx.x; q < BTP * WIDTH / 8; q += NTHREADS) {
      const int p = q / (WIDTH / 8), c = q - p * (WIDTH / 8);
      const uint4 v = src[q];
      float* d = H + p * LDH + 8 * c;
      *reinterpret_cast<float4*>(d) =
          make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                      __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
      *reinterpret_cast<float4*>(d + 4) =
          make_float4(__uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
                      __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
    }
    cp_async_commit();
    return;
  }
  const int k_pad = l > 0 ? WIDTH : round8(f.enc + f.n_lat);
  const float* src = l > 0 ? scratch + BTP * LDH + (long)(l - 1) * BTP * WIDTH : scratch;
  const int ld_src = l > 0 ? WIDTH : LDH;
  for (int q = threadIdx.x; q < BTP * (k_pad / 4); q += NTHREADS) {
    const int p = q / (k_pad / 4), c = q - p * (k_pad / 4);
    cp_async16(H + p * LDH + 4 * c, src + (long)p * ld_src + 4 * c);
  }
  cp_async_commit();
}

// Backward of one field on one tile, after k2_forward. Layer l's input is
// in H when its step starts: the forward leaves the last layer's there, and
// each dX step copies the next one in while its products run. BF16: the
// products in bf16, and the CUDA-core products (dwo, the output layer's
// dh, the latent cotangent) of bf16-rounded operands, as the JAX kernel's
// _field_bwd casts them; the bias sums stay f32 sums of the uncast values.
template <bool BF16 = false, bool RES_BF16 = false>
__device__ __forceinline__ void k2_backward(const FieldArgs& f, WeightRing& ring, int n_phases,
                                            float* H, float* D, const int* phase_sm,
                                            const float* g_sm, float* dlat_sm,
                                            const float* scratch, float* part, float* lat_acc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gi = lane >> 2, t = lane & 3;
  const GradLayout L = grad_layout(f, n_phases);
  const int k0 = f.enc + f.n_lat;
  __syncthreads();
  ring_top_up(f, ring);  // the last layer's second half
  // output layer on the CUDA cores: dwo[n] = sum_p g[p] h_L[p][n], dbo = sum_p g[p]
  // (each partial is read before its loop, so the load overlaps the sums)
  if (threadIdx.x < WIDTH) {
    const float old = part[L.wo + threadIdx.x];
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int p = 0; p < BTP; ++p)
      s[p & 3] = BF16 ? fmaf(round_bf16(g_sm[p]), round_bf16(D[p * LDD + threadIdx.x]), s[p & 3])
                      : fmaf(g_sm[p], D[p * LDD + threadIdx.x], s[p & 3]);
    part[L.wo + threadIdx.x] = old + ((s[0] + s[1]) + (s[2] + s[3]));
  } else if (threadIdx.x == WIDTH) {
    const float old = part[L.bo];
    float s = 0.f;
    for (int p = 0; p < BTP; ++p) s += g_sm[p];
    part[L.bo] = old + s;
  }
  __syncthreads();
  {
    // dpre_L[p][n] = wo[n] g[p] (h_L > 0), in place; a thread keeps one n
    const int n = threadIdx.x & (WIDTH - 1);
    const float wo = BF16 ? round_bf16(f.wo[n]) : f.wo[n];
#pragma unroll 8
    for (int p = threadIdx.x / WIDTH; p < BTP; p += NTHREADS / WIDTH) {
      float* d = D + p * LDD + n;
      *d = *d > 0.f ? __fmul_rn(wo, BF16 ? round_bf16(g_sm[p]) : g_sm[p]) : 0.f;
    }
  }
  float* lat_w = ring.buf;  // the latent rows of w0 (row stride LDW), staged once the ring is idle
  for (int l = f.n_hidden; l >= 0; --l) {
    cp_async_wait<2>();  // H's copy; the next layer's weight may still be in flight
    __syncthreads();
    if (l == 0 && f.n_lat > 0) {
      for (int q = threadIdx.x; q < f.n_lat * (WIDTH / 4); q += NTHREADS)
        cp_async16(lat_w + (q / (WIDTH / 4)) * LDW + 4 * (q % (WIDTH / 4)),
                   f.w0 + (long)f.enc * WIDTH + 4 * q);
      cp_async_commit();
    }
    mma_accumulate_dw<BF16>(H, D, l > 0 ? WIDTH : k0, l > 0 ? WIDTH : round8(k0),
                      part + (l > 0 ? L.wh + (long)(l - 1) * WIDTH * WIDTH : L.w0));
    accumulate_db(D, part + (l > 0 ? L.bh + (long)(l - 1) * WIDTH : L.b0));
    if (l > 0) {
      // dh = D W_l^T; dpre_{l-1} = dh (h_{l-1} > 0). The ReLU mask is read
      // before H takes the next layer's input.
      const int row0 = (BTP / 4) * (warp & 3), col0 = WCH * (warp >> 2);
      uint32_t mask[MT] = {};
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = row0 + 16 * i + 8 * h + gi, k = col0 + 8 * j + 2 * t;
            const float2 hv = *reinterpret_cast<const float2*>(H + p * LDH + k);
            const int bit = 2 * (2 * j + h);
            mask[i] |= (hv.x > 0.f ? 1u : 0u) << bit;
            mask[i] |= (hv.y > 0.f ? 1u : 0u) << (bit + 1);
          }
      const int c = ring_acquire_pair(ring);  // after its barrier H is free
      prefetch_layer_input<RES_BF16>(f, scratch, l - 1, H);
      float acc[MT][8][4];
      mma_dx<BF16>(D, ring.buf + ((c + (warp >> 2)) & 1) * WCH * LDW, acc);
      __syncthreads();  // every read of D and of the ring is done
      ring_top_up(f, ring);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = row0 + 16 * i + 8 * h + gi, k = col0 + 8 * j + 2 * t;
            const int bit = 2 * (2 * j + h);
            *reinterpret_cast<float2*>(D + p * LDD + k) =
                make_float2((mask[i] >> bit) & 1u ? acc[i][j][2 * h] : 0.f,
                            (mask[i] >> (bit + 1)) & 1u ? acc[i][j][2 * h + 1] : 0.f);
          }
    } else if (f.n_lat > 0) {
      // per-point latent cotangent on the CUDA cores, each a sum over n in
      // order; a thread runs four points at once. Then per-phase sums in
      // point order.
      cp_async_wait<0>();
      __syncthreads();
      const int n_items = BTP * f.n_lat;
      for (int q0 = threadIdx.x; q0 < n_items; q0 += 4 * NTHREADS) {
        int p[4], j[4];
        float s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = min(q0 + u * NTHREADS, n_items - 1);
          p[u] = q / f.n_lat;
          j[u] = q - p[u] * f.n_lat;
          s[u] = 0.f;
        }
#pragma unroll 4
        for (int n = 0; n < WIDTH; ++n)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            s[u] = BF16 ? fmaf(round_bf16(D[p[u] * LDD + n]), round_bf16(lat_w[j[u] * LDW + n]),
                               s[u])
                        : fmaf(D[p[u] * LDD + n], lat_w[j[u] * LDW + n], s[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (q0 + u * NTHREADS < n_items) dlat_sm[p[u] * MAX_LAT + j[u]] = s[u];
      }
      __syncthreads();
      if (threadIdx.x < n_phases * f.n_lat) {
        const int ph = threadIdx.x / f.n_lat, jj = threadIdx.x - ph * f.n_lat;
        float s = 0.f;
        for (int pp = 0; pp < BTP; ++pp)
          if (phase_sm[pp] == ph) s += dlat_sm[pp * MAX_LAT + jj];
        *lat_acc += s;
      }
    }
  }
}

template <int NF, bool FOURIER, bool BF16, bool RES_BF16>
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_kernel(FieldArgs fs, FieldArgs ft, RayArgs r, const float* g_s, const float* g_t,
           float* partials, long part_stride, float* scratch_all, long scratch_stride) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* D = H + BTP * LDH;
  float* ring_buf = D + BTP * LDD;
  float* g_sm = ring_buf + 2 * WCH * LDW;
  float* dlat_sm = g_sm + BTP;
  int* phase_sm = reinterpret_cast<int*>(dlat_sm + BTP * MAX_LAT);
  const long n_pts = (long)r.n_rays * r.n_samples;
  const long n_tiles = (n_pts + BTP - 1) / BTP;
  float* part = partials + blockIdx.x * part_stride;
  float* scratch = scratch_all + blockIdx.x * scratch_stride;
  // two fields (NF == 2): even CTAs take the static field, odd ones the
  // temporal field, so a CTA's live gradient partial is one field's
  // (~300 KB at the flagship widths, ~40 MB over 132 CTAs, against the
  // 50 MB L2); one field (NF == 1): every CTA takes fs, and ft is unused
  const bool temporal = NF == 2 && (blockIdx.x & 1);
  const FieldArgs& f = temporal ? ft : fs;
  const float* g = temporal ? g_t : g_s;
  float* fpart = part + (temporal ? grad_layout(fs, r.n_phases).size : 0);
  const long first = NF == 2 ? blockIdx.x >> 1 : blockIdx.x;
  const long stride = NF == 2 ? gridDim.x >> 1 : gridDim.x;
  float lat_acc = 0.f;
  for (long tile = first; tile < n_tiles; tile += stride) {
    WeightRing ring = ring_begin(f, ring_buf);
    k2_forward<FOURIER, BF16, RES_BF16>(f, r, g, tile * BTP, ring, H, D, phase_sm, g_sm,
                                        scratch);
    k2_backward<BF16, RES_BF16>(f, ring, r.n_phases, H, D, phase_sm, g_sm, dlat_sm, scratch,
                                fpart, &lat_acc);
  }
  if (f.n_lat > 0 && threadIdx.x < r.n_phases * f.n_lat)
    fpart[grad_layout(f, r.n_phases).lat + threadIdx.x] += lat_acc;
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

// ---------------------------------------------------------------------------
// K1 in bf16 on mma.sync: K2's forward without the residual stores. With
// two fields (NF == 2) CTA 2t runs the static field and CTA 2t + 1 the
// temporal field on the tile of K1_TP points at t * K1_TP; with one
// (NF == 1) CTA t runs fs on tile t and writes out_s alone. Each CTA:
// encode, the input and hidden layers as 3xTF32 mma.sync (mma_layer_fwd,
// weights through the ring in chunks of K1_WCH rows), then the output layer
// out[i] = bo + sum_n wo[n] relu(h_L[i][n]) on the CUDA cores in f32, a
// warp per point, for the points that exist.

#define K1_TP 128            // K1 points per tile
#define K1_WCH 32            // weight rows per K1 ring chunk

// shared memory of a K1 CTA: H, the weight ring, phase_sm
constexpr int k1_smem(int np, int c) { return (np * LDH + 2 * c * LDW) * 4 + np * 4; }

// two CTAs per SM where their shared memory fits (1 KB of each is reserved)
template <int M, int C, int NF, bool FOURIER, bool BF16>
__global__ void __launch_bounds__(NTHREADS, 2 * (k1_smem(64 * M, C) + 1024) <= 233472 ? 2 : 1)
fwd_kernel(FieldArgs fs, FieldArgs ft, RayArgs r, float* out_s, float* out_t) {
  constexpr int NP = 64 * M;
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);
  float* ring_buf = H + NP * LDH;
  int* phase_sm = reinterpret_cast<int*>(ring_buf + 2 * C * LDW);
  const bool temporal = NF == 2 && (blockIdx.x & 1);
  const FieldArgs& f = temporal ? ft : fs;
  const long n_pts = (long)r.n_rays * r.n_samples;
  const long tile0 = (long)(NF == 2 ? blockIdx.x >> 1 : blockIdx.x) * NP;
  WeightRing ring = ring_begin<C>(f, ring_buf, false);
#pragma unroll
  for (int h = 0; h < M; ++h)
    encode_tile<FOURIER>(f, r, tile0 + h * TP, H + h * TP * LDH, phase_sm + h * TP);
  const int k0 = f.enc + f.n_lat, k4 = round4(k0);
  const int k_pad = BF16 ? round16(k0) : round8(k0);
  // the mma steps are 8 deep (16 in bf16): zero the columns encode_tile leaves
  const int k_zero = BF16 ? min(k_pad, LDH) : k_pad;
  for (int t = threadIdx.x; t < NP * (k_zero - k4); t += NTHREADS) {
    const int p = t / (k_zero - k4);
    H[p * LDH + k4 + t - p * (k_zero - k4)] = 0.f;
  }
  float acc[M][8][4];
  mma_layer_fwd<M, C, BF16>(f, ring, H, f.b0, k_pad, acc);  // its first barrier publishes H
  for (int l = 0; l < f.n_hidden; ++l) {
    __syncthreads();  // every read of H is done
    store_relu_frag(H, LDH, acc);
    mma_layer_fwd<M, C, BF16>(f, ring, H, f.bh + l * WIDTH, WIDTH, acc);
  }
  __syncthreads();
  store_relu_frag(H, LDH, acc);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float wo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wo[j] = BF16 ? round_bf16(f.wo[lane + 32 * j]) : f.wo[lane + 32 * j];
  const float bo = f.bo[0];
  float* out = temporal ? out_t : out_s;
  for (int p = warp; p < NP; p += NTHREADS / 32) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s = fmaf(BF16 ? round_bf16(H[p * LDH + lane + 32 * j]) : H[p * LDH + lane + 32 * j], wo[j], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && tile0 + p < n_pts) out[tile0 + p] = s + bo;
  }
}

// K1 in bf16: 105,984 bytes, two CTAs per SM (K1 in f32: K1W_SMEM); K2: H, D, the weight ring, g_sm,
// dlat_sm, phase_sm (211,968 of the 232,448 bytes a block may use)
static const int FWD_SMEM = k1_smem(K1_TP, K1_WCH);
static const int BWD_SMEM =
    (BTP * LDH + BTP * LDD + 2 * WCH * LDW + BTP + BTP * MAX_LAT) * 4 + BTP * 4;

// The launches of one instantiation (NF fields, FOURIER, BF16 and, for K2,
// RES_BF16; the C entries pick them). K1 in f32 is launch_fwd_wgmma.
template <int NF, bool FOURIER, bool BF16>
static int launch_fwd(const FieldArgs& fs, const FieldArgs& ft, const RayArgs& r, float* out_s,
                      float* out_t, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(fwd_kernel<K1_TP / 64, K1_WCH, NF, FOURIER, BF16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long n_pts = (long)r.n_rays * r.n_samples;
  const long n_tiles = (n_pts + K1_TP - 1) / K1_TP;
  if (n_tiles == 0) return 0;
  fwd_kernel<K1_TP / 64, K1_WCH, NF, FOURIER, BF16>
      <<<(unsigned)(NF * n_tiles), NTHREADS, FWD_SMEM, st>>>(fs, ft, r, out_s, out_t);
  return (int)cudaGetLastError();
}

template <int NF, bool FOURIER, bool BF16, bool RES_BF16>
static cudaError_t launch_bwd(const FieldArgs& fs, const FieldArgs& ft, const RayArgs& r,
                              const float* g_s, const float* g_t, int n_ctas, float* partials,
                              long part_stride, float* scratch, long scratch_stride,
                              cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(bwd_kernel<NF, FOURIER, BF16, RES_BF16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(partials, 0, sizeof(float) * part_stride * n_ctas, st);
  if (e != cudaSuccess) return e;
  bwd_kernel<NF, FOURIER, BF16, RES_BF16><<<n_ctas, NTHREADS, BWD_SMEM, st>>>(
      fs, ft, r, g_s, g_t, partials, part_stride, scratch, scratch_stride);
  return cudaGetLastError();
}

// K2's instantiation for one field (ft NULL) or two, FOURIER and BF16.
template <bool FOURIER, bool BF16>
static cudaError_t launch_bwd_nf(const FieldArgs* fs, const FieldArgs* ft, const RayArgs& r,
                                 const float* g_s, const float* g_t, int n_ctas, float* partials,
                                 long part_stride, float* scratch, long scratch_stride,
                                 cudaStream_t st) {
  return ft ? launch_bwd<2, FOURIER, BF16, false>(*fs, *ft, r, g_s, g_t, n_ctas, partials,
                                                  part_stride, scratch, scratch_stride, st)
            : launch_bwd<1, FOURIER, BF16, false>(*fs, *fs, r, g_s, g_t, n_ctas, partials,
                                                  part_stride, scratch, scratch_stride, st);
}

template <bool FOURIER, bool BF16>
static int launch_fwd_nf(const FieldArgs* fs, const FieldArgs* ft, const RayArgs& r,
                         float* out_s, float* out_t, cudaStream_t st) {
  return ft ? launch_fwd<2, FOURIER, BF16>(*fs, *ft, r, out_s, out_t, st)
            : launch_fwd<1, FOURIER, BF16>(*fs, *fs, r, out_s, out_t, st);
}

// The weight planes of K1 in f32 (fwd_kernel_wsplit), both fields' when ft
// is given.
static int launch_wsplit(const FieldArgs* fs, const FieldArgs* ft, float* planes,
                         cudaStream_t st) {
  const long n = ((long)k1w_ksteps(*fs) + (ft ? k1w_ksteps(*ft) : 0)) * 1024;
  fwd_kernel_wsplit<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(*fs, ft ? *ft : *fs,
                                                                 ft ? 2 : 1, planes);
  return (int)cudaGetLastError();
}

// Clusters of two that the card holds at once with K1's shared memory (the
// persistent grid), or a negative CUDA error. setmaxnreg moves registers
// within a CTA's allocation, so a build whose allocation cannot hold what
// the warpgroups ask for is refused here: its consumers would wait forever.
template <int NF, bool FOURIER>
static int k1w_clusters() {
  static int clusters = 0;
  if (clusters > 0) return clusters;
  auto* kern = fwd_kernel_wgmma<NF, FOURIER>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K1W_SMEM);
  if (e != cudaSuccess) return -(int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return -(int)e;
  if (K1W_PRODUCER_REGS * (K1W_THREADS - 256) + K1W_CONSUMER_REGS * 256 >
      ((fa.numRegs + 7) & ~7) * K1W_THREADS)
    return -(int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 2;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(K1W_THREADS);
  cfg.dynamicSmemBytes = K1W_SMEM;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  if (e != cudaSuccess) return -(int)e;
  clusters = n > 0 ? n : 1;
  return clusters;
}

// K1 in f32: the weight planes (into planes, fused_field_fwd_planes_floats
// of them), then the persistent kernel over units of (field, tile pair).
template <int NF, bool FOURIER>
static int launch_fwd_wgmma(const FieldArgs& fs, const FieldArgs& ft, const RayArgs& r,
                            float* out_s, float* out_t, float* planes, cudaStream_t st) {
  const int clusters = k1w_clusters<NF, FOURIER>();
  if (clusters < 0) return -clusters;
  auto* kern = fwd_kernel_wgmma<NF, FOURIER>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K1W_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long n_pts = (long)r.n_rays * r.n_samples;
  const long units = NF * ((n_pts + 2 * K1W_TP - 1) / (2 * K1W_TP));
  if (units == 0) return 0;
  const int err = launch_wsplit(&fs, NF == 2 ? &ft : nullptr, planes, st);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 2;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(2 * (units < clusters ? units : clusters)));
  cfg.blockDim = dim3(K1W_THREADS);
  cfg.dynamicSmemBytes = K1W_SMEM;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, fs, ft, r, (const float*)planes, out_s, out_t);
}

template <bool FOURIER>
static int launch_fwd_wgmma_nf(const FieldArgs* fs, const FieldArgs* ft, const RayArgs& r,
                               float* out_s, float* out_t, float* planes, cudaStream_t st) {
  return ft ? launch_fwd_wgmma<2, FOURIER>(*fs, *ft, r, out_s, out_t, planes, st)
            : launch_fwd_wgmma<1, FOURIER>(*fs, *fs, r, out_s, out_t, planes, st);
}

extern "C" {

// Shared memory of a CTA: 0 K1 in f32, 1 K2, 2 K1 in bf16.
int fused_field_smem_bytes(int which) {
  return which == 0 ? K1W_SMEM : which == 1 ? BWD_SMEM : FWD_SMEM;
}

// Points per K2 tile (the wrapper sizes the residual scratch with it).
int fused_field_bwd_tile_points() { return BTP; }

// Every entry takes ft == NULL for one field: fs alone (the static field
// of the static method), its block alone in the gradient.

// Floats in one CTA's gradient partial (static block, then temporal block).
long fused_field_grad_size(const FieldArgs* fs, const FieldArgs* ft, int n_phases) {
  return grad_layout(*fs, n_phases).size + (ft ? grad_layout(*ft, n_phases).size : 0);
}

// The modes of the C entries: f32 products (3xTF32), bf16 products, and
// (K2 with two fields only) f32 products over bf16 residuals.
enum { MODE_F32 = 0, MODE_BF16 = 1, MODE_RES_BF16 = 2 };

// Floats of K1's weight planes in f32 (static field, then temporal).
long fused_field_fwd_planes_floats(const FieldArgs* fs, const FieldArgs* ft) {
  return ((long)k1w_ksteps(*fs) + (ft ? k1w_ksteps(*ft) : 0)) * K1W_KSTEP_FLOATS;
}

// The weight planes alone (what fused_field_fwd writes into planes first).
int fused_field_fwd_split(const FieldArgs* fs, const FieldArgs* ft, float* planes,
                          void* stream) {
  return launch_wsplit(fs, ft, planes, (cudaStream_t)stream);
}

// Clusters of two CTAs that a K1 launch in f32 may take (its persistent
// grid), or a negative CUDA error.
int fused_field_fwd_clusters() { return k1w_clusters<2, false>(); }

// out_t is unused with one field; mode MODE_F32 (fwd_kernel_wgmma, after
// the weight planes into planes: fused_field_fwd_planes_floats floats) or
// MODE_BF16 (fwd_kernel on mma.sync; planes unused).
int fused_field_fwd(const FieldArgs* fs, const FieldArgs* ft, const RayArgs* r,
                    float* out_s, float* out_t, int mode, float* planes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode != MODE_F32 && mode != MODE_BF16) return (int)cudaErrorInvalidValue;
  const bool fourier = is_fourier(*fs) || (ft && is_fourier(*ft));
  if (mode == MODE_F32)
    return fourier ? launch_fwd_wgmma_nf<true>(fs, ft, *r, out_s, out_t, planes, st)
                   : launch_fwd_wgmma_nf<false>(fs, ft, *r, out_s, out_t, planes, st);
  return fourier ? launch_fwd_nf<true, true>(fs, ft, *r, out_s, out_t, st)
                 : launch_fwd_nf<false, true>(fs, ft, *r, out_s, out_t, st);
}

// partials: [n_ctas, part_stride] zero-initialized by this call;
// scratch: [n_ctas, scratch_stride] (MODE_RES_BF16: the hidden inputs as
// bf16, half the floats); grads: [grad_size] output. Two fields need an
// even n_ctas; g_t is unused with one field; MODE_RES_BF16 needs two.
int fused_field_bwd(const FieldArgs* fs, const FieldArgs* ft, const RayArgs* r,
                    const float* g_s, const float* g_t, int n_ctas, float* partials,
                    long part_stride, float* scratch, long scratch_stride, float* grads,
                    int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long n = fused_field_grad_size(fs, ft, r->n_phases);
  if (mode < MODE_F32 || mode > MODE_RES_BF16 || (mode == MODE_RES_BF16 && !ft))
    return (int)cudaErrorInvalidValue;
  const bool fourier = is_fourier(*fs) || (ft && is_fourier(*ft));
  cudaError_t e;
  if (mode == MODE_RES_BF16)
    e = fourier ? launch_bwd<2, true, false, true>(*fs, *ft, *r, g_s, g_t, n_ctas, partials,
                                                   part_stride, scratch, scratch_stride, st)
                : launch_bwd<2, false, false, true>(*fs, *ft, *r, g_s, g_t, n_ctas, partials,
                                                    part_stride, scratch, scratch_stride, st);
  else if (mode == MODE_BF16)
    e = fourier ? launch_bwd_nf<true, true>(fs, ft, *r, g_s, g_t, n_ctas, partials,
                                            part_stride, scratch, scratch_stride, st)
                : launch_bwd_nf<false, true>(fs, ft, *r, g_s, g_t, n_ctas, partials,
                                             part_stride, scratch, scratch_stride, st);
  else
    e = fourier ? launch_bwd_nf<true, false>(fs, ft, *r, g_s, g_t, n_ctas, partials,
                                             part_stride, scratch, scratch_stride, st)
                : launch_bwd_nf<false, false>(fs, ft, *r, g_s, g_t, n_ctas, partials,
                                              part_stride, scratch, scratch_stride, st);
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(partials, part_stride, n_ctas,
                                                             n, grads);
  return (int)cudaGetLastError();
}

}  // extern "C"
