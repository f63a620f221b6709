// Fused Langevin/GGMC update for Hopper (sm_90a): one launch a call, for
// one chain's (T,) state (K = 1) and for K chains' (K, T) bank alike.
//
// Replaces the Pallas TPU kernel bnn_priors_tpu/ops/fused_update.py
// (`_update_kernel`, wrapper `fused_langevin_update`) and its `jax.vmap`
// over chains. One pass over the packed state (reads θ, m, v, g, M; writes
// θ', m', v' in place) computes, per chain k,
//
//   ξ   ~ N(0, I)            Philox4x32-10 + Box–Muller, in registers
//   m'  = σ_k·ξ + grad_lr·(M·g) + mom_decay·m
//   θ'  = θ + pos_c·(M·m')
//   v'  = alpha·v + (1-alpha)·g²
//   partials[k] = [Σ (M·g)·m, Σ (M·g)·m', Σ (M·g)²]
//
// Elements at index ≥ total (the packer's padding tail) get ξ = 0, are
// written as 0 and add nothing to the partials.
//
// Bound: 32 bytes an element (5 f32 reads, 3 f32 writes), so the memory
// rate. The design keeps every byte to one pass:
// - grid (blocks_per_chain, K), a small multiple of the SM count in all,
//   with a grid-stride loop inside a chain; each step of a thread issues
//   its five 16-byte loads before any arithmetic;
// - the noise is never stored: one Philox call gives the four words of one
//   float4 (counter = element index / 4 within the chain, key = the 64-bit
//   seed), so the draw depends neither on the grid nor on K, and row k of a
//   (K, T) launch is bit for bit the (T,) launch with chain k's seed and σ;
// - the partials are finished in the same launch: each block writes one
//   row of three sums (fixed-order warp shuffles, then shared memory),
//   fences, and takes a ticket on its chain's counter; the block with the
//   last ticket sums the chain's rows in index order and resets the
//   counter. No float atomics, so the partials are the same run to run.
//
// Tensor cores, TMA and wgmma have no role: no product, no data reuse.
// Built without --use_fast_math: the plain PyTorch version reproduces
// logf, sqrtf, sinf and cosf to a few ulps.

#include <cstdint>
#include <cuda_runtime.h>

#include "langevin.cuh"

namespace {

using namespace bnn;

// One chain's rows, as float4s.
struct Rows {
  float4* th;
  float4* m;
  float4* v;
  const float4* g;
  const float4* M;
};

// The five float4s of one step, all loaded before any arithmetic.
struct Step {
  float4 th, m, v, g, M;
};

__device__ __forceinline__ Step load_step(const Rows& p, int64_t q) {
  return Step{p.th[q], p.m[q], p.v[q], p.g[q], p.M[q]};
}

// Elements 4q .. 4q+3 of a chain: noise from Philox counter q, the update,
// the stores, and the sums.
__device__ __forceinline__ void update_step(const Rows& p, const Step& a,
                                            int64_t q, int64_t total,
                                            uint32_t k0, uint32_t k1,
                                            const Coeffs& c, float3& acc) {
  const int64_t i = q << 2;
  float4 xi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < total) {
    const uint4 w = philox4x32_10(static_cast<uint32_t>(q),
                                  static_cast<uint32_t>(q >> 32), k0, k1);
    const float2 n01 = box_muller(w.x, w.y), n23 = box_muller(w.z, w.w);
    xi = make_float4(i + 0 < total ? n01.x : 0.0f,
                     i + 1 < total ? n01.y : 0.0f,
                     i + 2 < total ? n23.x : 0.0f,
                     i + 3 < total ? n23.y : 0.0f);
  }
  float4 o_th, o_m, o_v;
  update_one(i + 0 < total, a.th.x, a.m.x, a.v.x, a.g.x, a.M.x, xi.x, c,
             o_th.x, o_m.x, o_v.x, acc);
  update_one(i + 1 < total, a.th.y, a.m.y, a.v.y, a.g.y, a.M.y, xi.y, c,
             o_th.y, o_m.y, o_v.y, acc);
  update_one(i + 2 < total, a.th.z, a.m.z, a.v.z, a.g.z, a.M.z, xi.z, c,
             o_th.z, o_m.z, o_v.z, acc);
  update_one(i + 3 < total, a.th.w, a.m.w, a.v.w, a.g.w, a.M.w, xi.w, c,
             o_th.w, o_m.w, o_v.w, acc);
  p.th[q] = o_th;
  p.m[q] = o_m;
  p.v[q] = o_v;
}

// grid (blocks_per_chain, K); block (kThreads,). Chain k's seed and σ come
// from seeds[k] and sigmas[k] when those are given, else from the scalars.
__global__ void __launch_bounds__(kThreads) fused_langevin_update_kernel(
    float* __restrict__ th, float* __restrict__ m, float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ M,
    float* __restrict__ rows, unsigned int* __restrict__ tickets,
    float* __restrict__ partials, const int64_t* __restrict__ seeds,
    const float* __restrict__ sigmas, int64_t seed, float sigma,
    int64_t seed_offset, int64_t T, int64_t total, float mom_decay,
    float grad_lr, float pos_c, float alpha) {
  const int k = blockIdx.y;
  const unsigned int nb = gridDim.x;
  const int64_t row = static_cast<int64_t>(k) * T;
  if (seeds != nullptr) seed = seeds[k];
  if (sigmas != nullptr) sigma = sigmas[k];
  const uint64_t key = static_cast<uint64_t>(seed + seed_offset);
  const uint32_t k0 = static_cast<uint32_t>(key);
  const uint32_t k1 = static_cast<uint32_t>(key >> 32);
  const Coeffs c{sigma, mom_decay, grad_lr, pos_c, alpha};

  const Rows p{reinterpret_cast<float4*>(th + row),
               reinterpret_cast<float4*>(m + row),
               reinterpret_cast<float4*>(v + row),
               reinterpret_cast<const float4*>(g + row),
               reinterpret_cast<const float4*>(M + row)};

  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  const int64_t n4 = T >> 2;
  const int64_t stride = static_cast<int64_t>(nb) * kThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       q < n4; q += stride)
    update_step(p, load_step(p, q), q, total, k0, k1, c, acc);

  finish_partials(acc, rows, tickets, partials, k, nb);
}

}  // namespace

extern "C" {

int bnn_fused_update_threads() { return kThreads; }

const char* bnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch on `stream` of `device`, which must be the current device;
// returns cudaGetLastError() after it (0: launched). th, m, v, g, M: K rows
// of T floats, 16-byte aligned. rows: K·blocks·3 floats of scratch;
// tickets: K zeroed counters, left zeroed; partials: K·3 floats out. seeds
// (K int64) and sigmas (K floats) may be null, and then `seed` and `sigma`
// serve every chain.
int bnn_fused_langevin_update(float* th, float* m, float* v, const float* g,
                              const float* M, float* rows,
                              unsigned int* tickets, float* partials,
                              const int64_t* seeds, const float* sigmas,
                              int64_t seed, float sigma, int64_t seed_offset,
                              int64_t K, int64_t T, int64_t total,
                              int64_t blocks_per_chain, float mom_decay,
                              float grad_lr, float pos_c, float alpha,
                              int device, void* stream) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) return static_cast<int>(cudaErrorInvalidDevice);
  const dim3 grid(static_cast<unsigned int>(blocks_per_chain),
                  static_cast<unsigned int>(K));
  fused_langevin_update_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      th, m, v, g, M, rows, tickets, partials, seeds, sigmas, seed, sigma,
      seed_offset, T, total, mom_decay, grad_lr, pos_c, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
