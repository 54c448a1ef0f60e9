// Tensor-core helpers of K1/K2 (fused_field.cu): 3xTF32 products on
// mma.sync.m16n8k8, bf16 products on mma.sync.m16n8k16 (the BF16
// instantiations), and the cp.async copies of the weight ring.
//
// 3xTF32: each f32 operand x is split into big = tf32(x) and small =
// tf32(x - big), both rounded to nearest, ties away from zero (an mma fed
// raw f32 would truncate the low 13 bits instead, and small would not be
// what big left out), and a product is accumulated in f32 as
// small*big + big*small + big*big. Each TF32 product of two 11-bit
// significands is exact in f32, so the result keeps about 21-22 bits of the
// f32 product; the dropped small*small term is below 2^-22 of it.
//
// Fragments of mma.m16n8k8 (g = lane / 4, t = lane % 4): A (16x8) holds
// (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (8x8, k x n) holds (t, g),
// (t+4, g); C (16x8) holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). The
// k index inside a step may be renumbered as long as A and B agree: PAIR
// gives thread t the k pair (2t, 2t+1) instead of (t, t+4), which moves the
// strided loads onto other banks (see the stride note in fused_field.cu).

#pragma once

#include <stdint.h>

// cvt.rna.tf32.f32 in two integer ops: add half a TF32 ulp to the bit
// pattern (a carry rounds the magnitude up, so ties go away from zero) and
// clear the 13 low bits. The same bits as cvt.rna for every finite input,
// without the range checks ptxas emits around cvt.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand fragment split into its TF32 parts.
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

// acc[i][j] += a[i] * b[j] in 3xTF32 for an M x N block of tiles. Each pass
// runs over the whole block, so the three products into one accumulator are
// M * N mma apart; every accumulator sees small*big, big*small, big*big in
// that order (deterministic).
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[M][N][4], const FragA (&a)[M],
                                           const FragB (&b)[N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(acc[i][j], a[i].small, b[j].big);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(acc[i][j], a[i].big, b[j].small);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(acc[i][j], a[i].big, b[j].big);
}

// A fragment of the 16x8 tile whose element (m, k) is p[m * ms + k * ks].
template <bool PAIR>
__device__ __forceinline__ FragA load_a(const float* p, int ms, int ks) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = PAIR ? 2 * t : t, k1 = PAIR ? 2 * t + 1 : t + 4;
  const float v[4] = {p[g * ms + k0 * ks], p[(g + 8) * ms + k0 * ks], p[g * ms + k1 * ks],
                      p[(g + 8) * ms + k1 * ks]};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(v[i], f.big[i], f.small[i]);
  return f;
}

// B fragment of the 8x8 tile whose element (k, n) is p[k * ks + n * ns].
template <bool PAIR>
__device__ __forceinline__ FragB load_b(const float* p, int ks, int ns) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k0 = PAIR ? 2 * t : t, k1 = PAIR ? 2 * t + 1 : t + 4;
  const float v[2] = {p[k0 * ks + g * ns], p[k1 * ks + g * ns]};
  FragB f;
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(v[i], f.big[i], f.small[i]);
  return f;
}

// ---------------------------------------------------------------------------
// bf16 route (compute_dtype "bfloat16"): each operand rounded to bf16 with
// round to nearest, ties to even (cvt.rn, what astype does; not tf32_rna
// above, which rounds ties away from zero), one m16n8k16 product per MAC
// accumulated in f32. Each product of two 8-bit significands is exact in
// f32, so only the operand roundings and the f32 sums remain.
//
// Fragments of mma.m16n8k16 with bf16 operands (g = lane / 4, t = lane % 4;
// each register holds two bf16, the lower k in the lower half): A (16x16)
// holds rows (g, g+8) x k pairs (2t, 2t+1) and (2t+8, 2t+9) as
// {(g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}; B (16x8, k x n)
// holds k pairs (2t, 2t+1) and (2t+8, 2t+9) of column g. C is the m16n8k8
// layout above, so the accumulators are stored by the same code.

// Two floats as one register of two bf16, lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// x rounded to bf16 (to nearest, ties to even) and back to f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float(pack_bf16x2(0.f, x) & 0xffff0000u);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct FragA16 {
  uint32_t x[4];
};
struct FragB16 {
  uint32_t x[2];
};

// acc[i][j] += a[i] * b[j], one bf16 product per accumulator.
template <int M, int N>
__device__ __forceinline__ void mma_bf16_block(float (&acc)[M][N][4], const FragA16 (&a)[M],
                                               const FragB16 (&b)[N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_bf16(acc[i][j], a[i].x, b[j].x);
}

// A fragment of the 16x16 tile whose element (m, k) is p[m * ms + k * ks];
// with hi false the k columns 8..15 read as zero and are not loaded.
__device__ __forceinline__ FragA16 load_a16(const float* p, int ms, int ks, bool hi = true) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* r0 = p + g * ms + 2 * t * ks;
  const float* r1 = r0 + 8 * ms;
  FragA16 f;
  f.x[0] = pack_bf16x2(r0[0], r0[ks]);
  f.x[1] = pack_bf16x2(r1[0], r1[ks]);
  f.x[2] = hi ? pack_bf16x2(r0[8 * ks], r0[9 * ks]) : 0u;
  f.x[3] = hi ? pack_bf16x2(r1[8 * ks], r1[9 * ks]) : 0u;
  return f;
}

// B fragment of the 16x8 tile whose element (k, n) is p[k * ks + n * ns].
__device__ __forceinline__ FragB16 load_b16(const float* p, int ks, int ns) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* c = p + 2 * t * ks + g * ns;
  FragB16 f;
  f.x[0] = pack_bf16x2(c[0], c[ks]);
  f.x[1] = pack_bf16x2(c[8 * ks], c[9 * ks]);
  return f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
