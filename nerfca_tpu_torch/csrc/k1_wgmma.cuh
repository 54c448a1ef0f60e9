// K1 in f32 on Hopper's wgmma: the forward of every f32 instantiation of
// fused_field_fwd (fused_field.cu's C entry), warp-specialised and
// persistent. It replaces nerfca_tpu/ops/pallas/fused_field.py::_fwd_kernel
// (pallas_call in _fused_core_fwd_impl), as the mma.sync fwd_kernel did
// before it. The bf16 instantiations still take that mma.sync kernel
// (fused_field.cu, unchanged), and so does nothing else: K2 (bwd_kernel,
// reduce_kernel) and its helpers are untouched.
//
// What it computes is fwd_kernel's (fused_field.cu's note): per point the
// accurate encoding, the input and hidden layers as 3xTF32 products (each
// f32 product small*big + big*small + big*big of TF32 parts rounded to
// nearest, ties away, tf32_rna) accumulated in f32 on top of the bias, the
// ReLUs, and the output layer in f32 on the CUDA cores.
//
// Bound on the H100: 3 TF32 products per f32 MAC, ~151.5k MAC a point for
// both fields: 3 x 155 GFLOP at 495 TFLOP/s = 0.94 ms at 1024 rays x 500
// samples, and 36.7 ms for a render view (40,000 rays x 500), so the share
// of the single-product roofline (portbench's k1_roofline) can reach 33.3%.
// Measured at 1024 x 500: 1.26 ms (the mma.sync kernel 3.04); without the
// products 0.51, with one product instead of three 0.76, without the
// encoding 1.16 (scripts/k1_variants.py).
//
// Design, one CTA of 512 threads per SM, clusters of two CTAs:
//   - warpgroups 0 and 3 give registers away (setmaxnreg 56): warp 0 is
//     the producer, one thread issuing the weight chunks into a ring of
//     K1W_STAGES = 5 stages of 16 KB with cp.async.bulk and mbarriers
//     (full: the bytes have landed; empty: every consumer warp of both CTAs
//     is done); warps 1-3 and 12-15 are the encoders, filling the next
//     tile's encoded input (two buffers of K1W_TP rows) while the consumers
//     run the current one. An accurate sinf is a long dependent chain, so
//     the encoding needs these seven warps and two chains a thread to hide
//     under the products (three warps of one chain held K1 at 1.4 ms).
//   - warpgroups 1 and 2 are the consumers (setmaxnreg 200), 64 points
//     each: wgmma.m64n128k8 with A (the activations) in registers and B
//     (the weights) from the ring. A layer's accumulators become the next
//     layer's A fragments in registers, as FlashAttention-3 passes P: the
//     accumulator's column pair (2t, 2t + 1) of a k-step lands in A's k
//     slots t and t + 4, and the weight rows are permuted to match
//     (k1w_slot_input). Only the input layer's A comes from shared memory.
//     A commit group is two chunks (four k-steps, twelve products), and it
//     completes before its warp writes the next group's fragments (see the
//     consumers' loop); the other warpgroup's group keeps the pipe busy.
//   - persistent: a grid of as many clusters as the card holds walks over
//     units of (field, pair of 128-point tiles); the two CTAs of a cluster
//     take the two tiles of a pair, with the same field's weights.
//   - weights: fwd_kernel_wsplit splits every weight once per launch into
//     its TF32 big and small planes, in the ring's byte image (k-steps of
//     8 k x 128 n, no swizzle, K-major: nn.Linear's [out, in] order),
//     1.19 MB for the flagship pair. Each chunk (two k-steps, 16 KB) is
//     multicast to both CTAs of the cluster, each CTA loading one half,
//     so a pass over one field's weights (~600 KB of planes) feeds 256
//     points: ~2.4 KB of L2 reads a point and field, what the mma.sync
//     kernel read from f32 weights per 128-point tile. A render view
//     (20 M points, both fields) reads ~95 GB of weight planes from L2.
//   - shared memory: the two encoded-input buffers (2 x 128 x 136 floats,
//     139,264 bytes), the ring (5 x 16 KB), the barriers: 221,296 bytes.
// The products of one point and one output are summed in the same order
// as in the mma.sync kernel (per k-step small*big, big*small, big*big, k-steps
// in order, on top of the bias); only the output layer's sum is in another
// (fixed) order, so a raw density is bitwise the same from run to run.

#pragma once

#include "field_common.cuh"
#include "field_mma.cuh"

#define K1W_TP 128             // points per CTA tile: two consumer warpgroups of 64
#define K1W_THREADS 512        // warpgroup 0: producer + encoders; 1, 2: consumers; 3: encoders
#define K1W_ENCODERS 224       // warps 1-3 and 12-15
#define K1W_CONSUMER_WARPS 8
#define K1W_STAGES 5           // ring stages of one chunk
#define K1W_ENC_BUFS 2         // encoded-input buffers
#define K1W_KSTEP_FLOATS 2048  // one k-step of B: big plane, then small plane (1024 each)
#define K1W_LDE 136            // encoded-input row stride (floats; 8 mod 32 banks)
#define K1W_PRODUCER_REGS 56   // warpgroups 0 and 3 (the encoders' sinf fits)
#define K1W_CONSUMER_REGS 200  // 56 x 256 + 200 x 256 = the 128 x 512 of the launch
#define K1W_SPIN_LIMIT (1u << 26)  // barrier polls before a wait is taken for a hang

// B's descriptor (no swizzle, K-major): core matrices of 8 n x 4 k (128
// contiguous bytes), the two k halves of a k-step 128 bytes apart (leading
// byte offset), n groups of 8 rows 256 bytes apart (stride byte offset)
#define K1W_LBO 128
#define K1W_SBO 256

constexpr int K1W_CHUNK_BYTES = 2 * K1W_KSTEP_FLOATS * 4;  // two k-steps
constexpr int K1W_ENC_FLOATS = K1W_TP * K1W_LDE;
constexpr int K1W_SMEM = K1W_ENC_BUFS * K1W_ENC_FLOATS * 4 + K1W_STAGES * K1W_CHUNK_BYTES +
                         (2 * K1W_STAGES + 2 * K1W_ENC_BUFS) * 8;

// k-steps of a field's weights: the input layer padded to 8 rows, then 16
// per hidden layer
__host__ __device__ __forceinline__ int k1w_nk0(const FieldArgs& f) {
  return (f.enc + f.n_lat + 7) / 8;
}
__host__ __device__ __forceinline__ int k1w_ksteps(const FieldArgs& f) {
  return k1w_nk0(f) + (WIDTH / 8) * f.n_hidden;
}

// The input (row of W's [in, out] layout) that k slot s of a k-step holds:
// A's slot t is the accumulator's column 2t, slot t + 4 its column 2t + 1.
__host__ __device__ __forceinline__ int k1w_slot_input(int s) { return s < 4 ? 2 * s : 2 * s - 7; }

// ---------------------------------------------------------------------------
// The weight planes, once per launch: for k-step b of a field (the input
// layer's, then each hidden layer's 16) and element e of its 1024,
//   n = 8 (e >> 6) + ((e >> 2) & 7),  slot s = 4 ((e >> 5) & 1) + (e & 3)
// holds w = W[8 kk + k1w_slot_input(s)][n] (zero past the input layer's
// rows), as big = tf32_rna(w) at planes[2048 b + e] and small =
// tf32_rna(w - big) at planes[2048 b + 1024 + e]. The second field's planes
// follow the first's.
__global__ void fwd_kernel_wsplit(FieldArgs fs, FieldArgs ft, int nf, float* planes) {
  const long n_s = (long)k1w_ksteps(fs) * 1024;
  const long n = n_s + (nf == 2 ? (long)k1w_ksteps(ft) * 1024 : 0);
  for (long q = (long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += (long)gridDim.x * blockDim.x) {
    const bool second = q >= n_s;
    const FieldArgs f = second ? ft : fs;
    const long qf = second ? q - n_s : q;
    const int blk = (int)(qf >> 10), e = (int)(qf & 1023);
    const int col = 8 * (e >> 6) + ((e >> 2) & 7);
    const int s = 4 * ((e >> 5) & 1) + (e & 3);
    const int nk0 = k1w_nk0(f);
    float w;
    if (blk < nk0) {
      const int k = 8 * blk + k1w_slot_input(s);
      w = k < f.enc + f.n_lat ? f.w0[(long)k * WIDTH + col] : 0.f;
    } else {
      const int l = (blk - nk0) / 16, k = 8 * ((blk - nk0) % 16) + k1w_slot_input(s);
      w = f.wh[((long)l * WIDTH + k) * WIDTH + col];
    }
    uint32_t big, small;
    split_tf32(w, big, small);
    float* dst = planes + (second ? 2 * n_s : 0) + (long)blk * K1W_KSTEP_FLOATS + e;
    dst[0] = __uint_as_float(big);
    dst[1024] = __uint_as_float(small);
  }
}

// ---------------------------------------------------------------------------
// Barriers, bulk copies, clusters, wgmma (PTX for sm_90a)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrives on the barrier at bar's offset in CTA rank of the cluster. The
// default release at CTA scope: an arrival orders only reads of this CTA's
// own shared memory that have completed (wgmma_wait), and a release at
// cluster scope costs a fence each time (it held K1 at 3.2 ms, against 1.4).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to complete. A wait that never
// ends traps (a launch error) instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (n == K1W_SPIN_LIMIT) __trap();
  }
}

// Copies bytes from global memory to dst in every CTA of mask (the same
// offset in each), completing bytes on bar (the same offset in each).
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of r across the wgmma fences and waits.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint64_t k1w_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(K1W_LBO >> 4) << 16) |
         ((uint64_t)(K1W_SBO >> 4) << 32);
}

// d += A B over one k-step (m64 n128 k8, TF32 operands, f32 accumulators):
// A the warpgroup's 64 x 8 tile in registers (a: rows g and g + 8 of the
// warp's 16, slots t and t + 4), B from the descriptor.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// The consumers' side

// A k-step's A fragment split into its TF32 parts, from the values of rows
// g and g + 8 at the k-step's inputs 2t (slot t) and 2t + 1 (slot t + 4).
struct K1wFrag {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ K1wFrag k1w_frag(float g_lo, float g8_lo, float g_hi, float g8_hi) {
  K1wFrag a;
  split_tf32(g_lo, a.big[0], a.small[0]);
  split_tf32(g8_lo, a.big[1], a.small[1]);
  split_tf32(g_hi, a.big[2], a.small[2]);
  split_tf32(g8_hi, a.big[3], a.small[3]);
  return a;
}

// From the encoded input: e points at row g, input 2t of the k-step.
__device__ __forceinline__ K1wFrag k1w_frag_smem(const float* e) {
  const float2 lo = *reinterpret_cast<const float2*>(e);
  const float2 hi = *reinterpret_cast<const float2*>(e + 8 * K1W_LDE);
  return k1w_frag(lo.x, hi.x, lo.y, hi.y);
}

// Keeps a fragment's writes ahead of the wgmma.fence that precedes its products.
__device__ __forceinline__ void fence_frag(K1wFrag& a) {
  fence_regs(a.big);
  fence_regs(a.small);
}

// acc += A B over one k-step in 3xTF32, B's big plane at shared address b
// and its small plane 4 KB above it.
__device__ __forceinline__ void k1w_kstep(float (&acc)[64], const K1wFrag& a, uint32_t b) {
  wgmma_tf32(acc, a.small, k1w_desc(b));
  wgmma_tf32(acc, a.big, k1w_desc(b + 4096));
  wgmma_tf32(acc, a.big, k1w_desc(b));
}

// acc = the layer's bias, by the accumulator layout: acc[4j + q] is row
// g (q < 2) or g + 8, column 8j + 2t + (q & 1).
__device__ __forceinline__ void k1w_bias(float (&acc)[64], const float* bias, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float b0 = __ldg(bias + 8 * j + 2 * t), b1 = __ldg(bias + 8 * j + 2 * t + 1);
    acc[4 * j] = b0;
    acc[4 * j + 1] = b1;
    acc[4 * j + 2] = b0;
    acc[4 * j + 3] = b1;
  }
}

// Ring position, shared by the producer's and the consumers' walks.
struct K1wRing {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == K1W_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// A field's weight chunks: the input layer's k-steps in pairs (the last may
// be one), then 8 pairs per hidden layer.
__device__ __forceinline__ int k1w_chunks(const FieldArgs& f) {
  return (k1w_nk0(f) + 1) / 2 + 8 * f.n_hidden;
}

// ---------------------------------------------------------------------------
// The encoders' side: the encoded input of the 128 points at tile0 into E
// (row stride K1W_LDE), columns up to the input layer's 8-row padding, by
// encoder et of K1W_ENCODERS. Each coordinate and each encoded feature
// takes the roundings of field_common.cuh's encode_tile.
// Coordinate c of the point at i (zero past the end).
__device__ __forceinline__ float k1w_coord(const RayArgs& r, long i, int c, long n_pts) {
  if (i >= n_pts) return 0.f;
  const int ray = (int)i / r.n_samples, s = (int)i - ray * r.n_samples;
  const float zz = r.z[(long)ray * r.z_stride + s];
  return __fadd_rn(r.origins[ray * 3 + c], __fmul_rn(zz, r.dirs[ray * 3 + c]));
}

template <bool FOURIER>
__device__ __forceinline__ void k1w_encode(const FieldArgs& f, const RayArgs& r, long tile0,
                                           float* E, int et) {
  const long n_pts = (long)r.n_rays * r.n_samples;
  // two (point, channel) items at once: an accurate sinf is a long chain
  // of dependent instructions, and a warp of one chain at a time leaves the
  // encoding latency-bound behind the products (the second item repeats
  // the first past the end of the list)
  for (int q0 = et; q0 < K1W_TP * 3; q0 += 2 * K1W_ENCODERS) {
    const int q1 = min(q0 + K1W_ENCODERS, K1W_TP * 3 - 1);
    const int p0 = q0 / 3, c0 = q0 - 3 * p0, p1 = q1 / 3, c1 = q1 - 3 * p1;
    const float x0 = k1w_coord(r, tile0 + p0, c0, n_pts);
    const float x1 = k1w_coord(r, tile0 + p1, c1, n_pts);
    float* row0 = E + p0 * K1W_LDE;
    float* row1 = E + p1 * K1W_LDE;
    if (FOURIER && is_fourier(f)) {
      const int nj = 3 * f.basis;
      const float xs0 = __fmul_rn(6.28318548f, x0), xs1 = __fmul_rn(6.28318548f, x1);
      for (int b = 0; b < f.basis; ++b) {
        const float v0 = __fmul_rn(xs0, f.coef[3 * b + c0]);
        const float v1 = __fmul_rn(xs1, f.coef[3 * b + c1]);
        const float s0 = sinf(v0), k0 = cosf(v0), s1 = sinf(v1), k1 = cosf(v1);
        row0[3 * b + c0] = s0;
        row0[nj + 3 * b + c0] = k0;
        row1[3 * b + c1] = s1;
        row1[nj + 3 * b + c1] = k1;
      }
    } else {
      row0[c0] = x0;
      row1[c1] = x1;
#pragma unroll 2
      for (int b = 0; b < f.basis; ++b) {
        const float w = f.window[b];
        const float xb0 = ldexpf(x0, b), xb1 = ldexpf(x1, b);
        const float s0 = sinf(xb0), k0 = sinf(__fadd_rn(xb0, 1.57079637f));
        const float s1 = sinf(xb1), k1 = sinf(__fadd_rn(xb1, 1.57079637f));
        row0[3 + 6 * b + c0] = __fmul_rn(w, s0);
        row0[3 + 6 * b + 3 + c0] = __fmul_rn(w, k0);
        row1[3 + 6 * b + c1] = __fmul_rn(w, s1);
        row1[3 + 6 * b + 3 + c1] = __fmul_rn(w, k1);
      }
    }
  }
  // the latents of each point's phase (zero past the end or the table),
  // then zeros up to the 8-row padding
  const int nl = 8 * k1w_nk0(f) - f.enc;
  for (int q = et; q < K1W_TP * nl; q += K1W_ENCODERS) {
    const int p = q / nl, j = q - p * nl;
    const long i = tile0 + p;
    float v = 0.f;
    if (j < f.n_lat && i < n_pts) {
      const int ph = r.phases[(int)i / r.n_samples];
      if (ph >= 0 && ph < r.n_phases) v = r.latents[ph * f.n_lat + j];
    }
    E[p * K1W_LDE + f.enc + j] = v;
  }
}

// ---------------------------------------------------------------------------
// The kernel. NF == 2: units alternate static and temporal field over the
// tile pairs; NF == 1: fs alone, out_s alone. planes: fwd_kernel_wsplit's.
template <int NF, bool FOURIER>
__global__ void __launch_bounds__(K1W_THREADS, 1)
fwd_kernel_wgmma(FieldArgs fs, FieldArgs ft, RayArgs r, const float* planes, float* out_s,
                 float* out_t) {
  extern __shared__ float4 smem4[];
  float* enc = reinterpret_cast<float*>(smem4);  // [K1W_ENC_BUFS][K1W_TP][K1W_LDE]
  uint8_t* ring = reinterpret_cast<uint8_t*>(enc + K1W_ENC_BUFS * K1W_ENC_FLOATS);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + K1W_STAGES * K1W_CHUNK_BYTES);
  uint64_t* empty = full + K1W_STAGES;
  uint64_t* enc_full = empty + K1W_STAGES;
  uint64_t* enc_empty = enc_full + K1W_ENC_BUFS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < K1W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * K1W_CONSUMER_WARPS);  // the consumer warps of both CTAs
    }
    for (int b = 0; b < K1W_ENC_BUFS; ++b) {
      mbar_init(&enc_full[b], K1W_ENCODERS);
      mbar_init(&enc_empty[b], 32 * K1W_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // the other CTA's barriers exist before anything lands there

  const long n_pts = (long)r.n_rays * r.n_samples;
  const long units = NF * ((n_pts + 2 * K1W_TP - 1) / (2 * K1W_TP));
  const uint32_t rank = cluster_ctarank();
  const long first = cluster_index(), stride = cluster_count();
  const long planes_t = (long)k1w_ksteps(fs) * K1W_KSTEP_FLOATS;  // the temporal field's planes
  // unit u: its field (temporal or not) and the first point of this CTA's tile
  auto temporal_of = [](long u) { return NF == 2 && (u & 1); };
  auto tile_of = [rank](long u) { return (2 * (NF == 2 ? u >> 1 : u) + rank) * K1W_TP; };

  if (warp < 4 || warp >= 12) {
    setmaxnreg_dec<K1W_PRODUCER_REGS>();
    if (warp == 0) {
      if (lane == 0) {
        K1wRing ring_pos;
        for (long u = first; u < units; u += stride) {
          const bool temporal = temporal_of(u);
          const FieldArgs f = temporal ? ft : fs;
          const char* src = reinterpret_cast<const char*>(planes + (temporal ? planes_t : 0));
          const int nk0 = k1w_nk0(f), nc0 = (nk0 + 1) / 2, nc = k1w_chunks(f);
          for (int c = 0; c < nc; ++c) {
            const int k = c < nc0 ? 2 * c : nk0 + 2 * (c - nc0);  // the chunk's first k-step
            const int kn = c < nc0 ? min(2, nk0 - 2 * c) : 2;
            const uint32_t bytes = kn * K1W_KSTEP_FLOATS * 4, half = bytes / 2;
            mbar_wait(&empty[ring_pos.stage], ring_pos.phase ^ 1);
            mbar_expect_tx(&full[ring_pos.stage], bytes);
            bulk_copy_multicast(ring + ring_pos.stage * K1W_CHUNK_BYTES + rank * half,
                                src + (long)k * K1W_KSTEP_FLOATS * 4 + rank * half, half,
                                &full[ring_pos.stage], 0x3);
            ring_pos.next();
          }
        }
        // every stage released by both CTAs: no arrival from the other CTA
        // lands here after this CTA has exited
        for (int s = 0; s < K1W_STAGES; ++s) {
          mbar_wait(&empty[ring_pos.stage], ring_pos.phase ^ 1);
          ring_pos.next();
        }
      }
    } else {
      const int et = warp < 4 ? threadIdx.x - 32 : threadIdx.x - 384 + 96;
      int eb = 0;
      uint32_t ephase = 0;
      for (long u = first; u < units; u += stride) {
        const FieldArgs f = temporal_of(u) ? ft : fs;
        mbar_wait(&enc_empty[eb], ephase ^ 1);
        k1w_encode<FOURIER>(f, r, tile_of(u), enc + eb * K1W_ENC_FLOATS, et);
        mbar_arrive(&enc_full[eb]);
        if (++eb == K1W_ENC_BUFS) {
          eb = 0;
          ephase ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<K1W_CONSUMER_REGS>();
  const int wg = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * (warp & 3) + g;  // this thread's rows: row0, row0 + 8
  const uint32_t ring_addr = smem_u32(ring);
  K1wRing ring_pos;
  int eb = 0;
  uint32_t ephase = 0;
  // A group's products complete (wgmma_wait<0>) before the warp writes the
  // next group's fragments: the four warps of a warpgroup issue a product
  // at different times, and its A registers are read only once the last
  // of them has, so a warp must not run ahead and rewrite them (the
  // compiler is free to reuse an operand's registers after the
  // instruction). The other consumer warpgroup's group keeps the tensor
  // pipe busy meanwhile. A group is two ring chunks (four k-steps, twelve
  // products), which halves the waits and arrivals per product against
  // one chunk. Then each stage goes back to the producers of both CTAs,
  // one arrival per warp.
  auto take = [&](int ahead) {  // shared address of chunk ahead (0, 1), once it has landed
    int stage = ring_pos.stage + ahead;
    uint32_t phase = ring_pos.phase;
    if (stage >= K1W_STAGES) {
      stage -= K1W_STAGES;
      phase ^= 1;
    }
    mbar_wait(&full[stage], phase);
    return ring_addr + stage * K1W_CHUNK_BYTES;
  };
  auto give_back = [&](int chunks) {
    wgmma_commit();
    wgmma_wait<0>();
    for (int i = 0; i < chunks; ++i) {
      if (lane == 0) {
        mbar_arrive_cluster(&empty[ring_pos.stage], 0);
        mbar_arrive_cluster(&empty[ring_pos.stage], 1);
      }
      ring_pos.next();
    }
  };
  float acc[64], prev[64];
  for (long u = first; u < units; u += stride) {
    const bool temporal = temporal_of(u);
    const FieldArgs f = temporal ? ft : fs;
    const long tile0 = tile_of(u);
    const int nk0 = k1w_nk0(f);
    k1w_bias(acc, f.b0, t);
    fence_regs(acc);
    mbar_wait(&enc_full[eb], ephase);
    const float* E = enc + eb * K1W_ENC_FLOATS + row0 * K1W_LDE + 2 * t;
    // the input layer, A from the encoded input: groups of up to four
    // k-steps (its last chunk may hold one)
    for (int k = 0; k < nk0; k += 4) {
      const int kn = min(4, nk0 - k);
      K1wFrag a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = k1w_frag_smem(E + 8 * min(k + i, nk0 - 1));
        fence_frag(a[i]);
      }
      const uint32_t b0 = take(0), b1 = kn > 2 ? take(1) : b0;
      wgmma_fence();
      k1w_kstep(acc, a[0], b0);
      if (kn > 1) k1w_kstep(acc, a[1], b0 + K1W_KSTEP_FLOATS * 4);
      if (kn > 2) k1w_kstep(acc, a[2], b1);
      if (kn > 3) k1w_kstep(acc, a[3], b1 + K1W_KSTEP_FLOATS * 4);
      give_back(kn > 2 ? 2 : 1);
    }
    mbar_arrive(&enc_empty[eb]);  // every read of the encoded input is done
    if (++eb == K1W_ENC_BUFS) {
      eb = 0;
      ephase ^= 1;
    }
    // the hidden layers, A from the layer below's accumulators
    for (int l = 0; l < f.n_hidden; ++l) {
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) prev[i] = fmaxf(acc[i], 0.f);
      k1w_bias(acc, f.bh + l * WIDTH, t);
      fence_regs(acc);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // k-steps 4c .. 4c + 3: accumulator columns 32c .. 32c + 31
        K1wFrag a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* p = prev + 16 * c + 4 * i;
          a[i] = k1w_frag(p[0], p[2], p[1], p[3]);
          fence_frag(a[i]);
        }
        const uint32_t b0 = take(0), b1 = take(1);
        wgmma_fence();
        k1w_kstep(acc, a[0], b0);
        k1w_kstep(acc, a[1], b0 + K1W_KSTEP_FLOATS * 4);
        k1w_kstep(acc, a[2], b1);
        k1w_kstep(acc, a[3], b1 + K1W_KSTEP_FLOATS * 4);
        give_back(2);
      }
    }
    fence_regs(acc);
    // the output layer in f32: each thread's 32 columns of rows row0 and
    // row0 + 8 in order, then the four threads of a row
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float w0 = __ldg(f.wo + 8 * j + 2 * t), w1 = __ldg(f.wo + 8 * j + 2 * t + 1);
      s0 = fmaf(fmaxf(acc[4 * j], 0.f), w0, s0);
      s0 = fmaf(fmaxf(acc[4 * j + 1], 0.f), w1, s0);
      s1 = fmaf(fmaxf(acc[4 * j + 2], 0.f), w0, s1);
      s1 = fmaf(fmaxf(acc[4 * j + 3], 0.f), w1, s1);
    }
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (t == 0) {
      float* out = temporal ? out_t : out_s;
      const float bo = __ldg(f.bo);
      const long p = tile0 + row0;
      if (p < n_pts) out[p] = s0 + bo;
      if (p + 8 < n_pts) out[p + 8] = s1 + bo;
    }
  }
}
