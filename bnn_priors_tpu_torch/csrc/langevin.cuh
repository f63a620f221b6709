// Shared by the port's two CUDA kernels (`fused_update.cu`, the packed
// (T,) and (K, T) forms, and `fused_update_segments.cu`, the segmented and
// hybrid states): the noise (Philox4x32-10 and Box–Muller, in the JAX
// kernel's form), the update of one element, and the block's fixed-order
// sums. One definition, so an element's ξ, θ', m' and v' come out of both
// kernels from the same code.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bnn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

constexpr float kInv2To24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoPi = 6.28318530717958647692f;

// Philox4x32-10 (Salmon et al., SC'11) on counter (c0, c1, 0, 0).
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Two normals from two words, in the JAX kernel's form: u1 in (0, 1] and
// u2 in [0, 1) from the top 24 bits, both exact in float32.
__device__ __forceinline__ float2 box_muller(uint32_t a, uint32_t b) {
  const float u1 = 1.0f - __uint2float_rn(a >> 8) * kInv2To24;
  const float u2 = __uint2float_rn(b >> 8) * kInv2To24;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(kTwoPi * u2, &s, &c);
  return make_float2(r * c, r * s);
}

struct Coeffs {
  float sigma, mom_decay, grad_lr, pos_c, alpha;
};

// One element: its θ', m', v', and its terms of the three sums. Every
// multiply and fused multiply-add is spelled out with its rounding
// (__fmul_rn, __fmaf_rn), so the compiler contracts nothing on its own:
// an element's θ', m', v' come out bit for bit the same in every kernel
// that calls this, whatever the code around it.
__device__ __forceinline__ void update_one(bool valid, float th, float m,
                                           float v, float g, float M, float xi,
                                           const Coeffs& c, float& o_th,
                                           float& o_m, float& o_v,
                                           float3& acc) {
  const float Mg = valid ? __fmul_rn(M, g) : 0.0f;
  const float m_old = valid ? m : 0.0f;
  const float new_m = __fmaf_rn(
      c.mom_decay, m_old, __fmaf_rn(c.grad_lr, Mg, __fmul_rn(c.sigma, xi)));
  o_m = new_m;
  o_th = valid ? __fmaf_rn(c.pos_c, __fmul_rn(M, new_m), th) : 0.0f;
  o_v = valid ? __fmaf_rn(c.alpha, v, __fmul_rn(__fmul_rn(1.0f - c.alpha, g),
                                                g))
              : 0.0f;
  acc.x = __fmaf_rn(Mg, m_old, acc.x);
  acc.y = __fmaf_rn(Mg, new_m, acc.y);
  acc.z = __fmaf_rn(Mg, Mg, acc.z);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// The block's three sums, in thread 0, in a fixed order.
__device__ __forceinline__ float3 block_sum(float3 s, float3* warp_part) {
  s.x = warp_sum(s.x);
  s.y = warp_sum(s.y);
  s.z = warp_sum(s.z);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  float3 t = make_float3(0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      t.x += warp_part[w].x;
      t.y += warp_part[w].y;
      t.z += warp_part[w].z;
    }
  }
  __syncthreads();
  return t;
}

// This block's three sums become row (k, blockIdx.x) of `rows`; the block
// then takes a ticket on chain k's counter, and the block with the last
// ticket sums the chain's nb rows in index order into partials[3k .. 3k+2]
// and resets the counter. No float atomics: the partials are the same run
// to run. Every thread of the block calls it.
__device__ __forceinline__ void finish_partials(
    float3 acc, float* __restrict__ rows, unsigned int* __restrict__ tickets,
    float* __restrict__ partials, int k, unsigned int nb) {
  __shared__ float3 warp_part[kWarps];
  __shared__ bool is_last;
  float3 s = block_sum(acc, warp_part);
  if (threadIdx.x == 0) {
    float* r = rows + (static_cast<int64_t>(k) * nb + blockIdx.x) * 3;
    r[0] = s.x;
    r[1] = s.y;
    r[2] = s.z;
    __threadfence();
    is_last = atomicAdd(tickets + k, 1u) == nb - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // the last block of chain k: every row of the chain is written
  __threadfence();
  const float* r = rows + static_cast<int64_t>(k) * nb * 3;
  acc = make_float3(0.0f, 0.0f, 0.0f);
  for (unsigned int b = threadIdx.x; b < nb; b += kThreads) {
    acc.x += __ldcg(r + 3 * b + 0);
    acc.y += __ldcg(r + 3 * b + 1);
    acc.z += __ldcg(r + 3 * b + 2);
  }
  s = block_sum(acc, warp_part);
  if (threadIdx.x == 0) {
    partials[3 * k + 0] = s.x;
    partials[3 * k + 1] = s.y;
    partials[3 * k + 2] = s.z;
    tickets[k] = 0;
  }
}

// The standard normal of element e of a chain's FLAT packed order: word
// e & 3 of Philox at counter e >> 2, the pair's cosine or sine — the value
// the packed kernel gives element e. Both Box–Muller outputs are computed
// and one is selected at run time, so the code is the packed kernel's.
__device__ __forceinline__ float normal_at(int64_t e, uint32_t k0,
                                           uint32_t k1) {
  const uint64_t q = static_cast<uint64_t>(e) >> 2;
  const uint4 w = philox4x32_10(static_cast<uint32_t>(q),
                                static_cast<uint32_t>(q >> 32), k0, k1);
  const int r = static_cast<int>(e & 3);
  const float2 n = r < 2 ? box_muller(w.x, w.y) : box_muller(w.z, w.w);
  return (r & 1) ? n.y : n.x;
}

}  // namespace bnn
