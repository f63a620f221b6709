// Fused Langevin/GGMC update over a segmented or hybrid chain state, for
// Hopper (sm_90a): one launch a call, for any number of segments and any
// number of chains K.
//
// Replaces, for the segmented and hybrid states, the XLA update that the
// JAX package runs over a list of segments
// (bnn_priors_tpu/mcmc/sgld.py:179-186, mcmc/verlet_sgld.py:126-136; its
// Pallas kernel `ops/fused_update.py::_update_kernel` is off for those
// states, sgld.py:76-79). Per chain k and element, the same transition as
// the packed kernel (`fused_update.cu`):
//
//   m'  = σ_k·ξ + grad_lr·(M·g) + mom_decay·m
//   θ'  = θ + pos_c·(M·m')
//   v'  = alpha·v + (1-alpha)·g²
//   partials[k] = [Σ (M·g)·m, Σ (M·g)·m', Σ (M·g)²]
//
// where M is a per-leaf scalar for a native segment and a vector over the
// hybrid state's small segment.
//
// Layout. Each state vector is ONE buffer; segment s is a contiguous
// (K, size_s) block at x_off[s] (chain stride size_s), its preconditioner a
// (K,) scalar block or a (K, size_s) block at p_off[s]. The table (`segs`,
// one row of kSegCols int64 a segment; `runs`, one row of kRunCols a run of
// elements that are consecutive in the flat packing) holds offsets from the
// buffers' addresses, not pointers, so it depends on the packer and K only:
// the wrapper builds it once and a step passes five base addresses.
//
// Grid (blocks, K): block b of chain k takes chunk b − first_block[s] of
// the segment s whose first_block is the largest ≤ b (binary search over the
// table); each of its threads walks kItems elements of the chunk, strided by
// the block, loading all of them before any arithmetic. The addressing is
// per element (4-byte loads): a hybrid state's small leaves are not aligned
// to 4 elements (the dense bias has 10).
//
// Noise. Element p of segment s has flat index e = flat_start(run) + p −
// start(run), found by a binary search over the segment's runs (one run
// for a native segment), and draws `normal_at(e)`: the packed kernel's
// value for element e. So a segmented or hybrid launch draws, element for
// element, the noise of a packed launch with the same seed.
//
// Partials are finished in the launch by the packed kernel's fixed-order
// ticket scheme (`finish_partials`), one counter a chain: no float atomics.
//
// Bound: 32 bytes an element (θ, m, v, g read and θ', m', v' written in
// f32; M is a scalar a native leaf), the memory rate: ResNet-20's 272,474
// elements move 8.72 MB, about 2.6 µs at 3.35 TB/s a chain.

#include <cstdint>
#include <cuda_runtime.h>

#include "langevin.cuh"

namespace {

using namespace bnn;

constexpr int kItems = 4;  // elements a thread, so a block's chunk is
constexpr int64_t kChunk = static_cast<int64_t>(kThreads) * kItems;

// a segment's row: its offsets in the state's and in the preconditioner's
// buffer, its size (= its chain stride), the preconditioner's chain and
// element strides (element stride 0: one scalar a chain), its first block,
// and its runs
constexpr int kSegCols = 9;
enum SegCol { kXOff, kXStride, kSize, kPOff, kPStride, kPElem, kFirstBlock,
              kFirstRun, kNRuns };
// a run's row: its start in the segment, its start in the flat packing
constexpr int kRunCols = 2;

__global__ void __launch_bounds__(kThreads)
fused_langevin_update_segments_kernel(
    float* __restrict__ th, float* __restrict__ m, float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ M,
    const int64_t* __restrict__ segs, int n_segs,
    const int64_t* __restrict__ runs, float* __restrict__ rows,
    unsigned int* __restrict__ tickets, float* __restrict__ partials,
    const int64_t* __restrict__ seeds, const float* __restrict__ sigmas,
    int64_t seed, float sigma, int64_t seed_offset, float mom_decay,
    float grad_lr, float pos_c, float alpha) {
  __shared__ int64_t seg[kSegCols];

  const int k = blockIdx.y;
  const unsigned int nb = gridDim.x;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_segs - 1;  // the last segment starting at or before b
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (segs[mid * kSegCols + kFirstBlock] <= blockIdx.x) lo = mid;
      else hi = mid - 1;
    }
#pragma unroll
    for (int c = 0; c < kSegCols; ++c) seg[c] = segs[lo * kSegCols + c];
  }
  __syncthreads();
  if (seeds != nullptr) seed = seeds[k];
  if (sigmas != nullptr) sigma = sigmas[k];
  const uint64_t key = static_cast<uint64_t>(seed + seed_offset);
  const uint32_t k0 = static_cast<uint32_t>(key);
  const uint32_t k1 = static_cast<uint32_t>(key >> 32);
  const Coeffs c{sigma, mom_decay, grad_lr, pos_c, alpha};

  const int64_t size = seg[kSize];
  const int64_t x0 = seg[kXOff] + k * seg[kXStride];
  const int64_t p0 = seg[kPOff] + k * seg[kPStride];
  const int64_t p_elem = seg[kPElem];
  const int64_t first_run = seg[kFirstRun];
  const int n_runs = static_cast<int>(seg[kNRuns]);
  const int64_t chunk0 = (blockIdx.x - seg[kFirstBlock]) * kChunk;

  float a_th[kItems], a_m[kItems], a_v[kItems], a_g[kItems], a_M[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = chunk0 + i * kThreads + threadIdx.x;
    if (p < size) {
      a_th[i] = th[x0 + p];
      a_m[i] = m[x0 + p];
      a_v[i] = v[x0 + p];
      a_g[i] = g[x0 + p];
      a_M[i] = M[p0 + p * p_elem];
    }
  }
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = chunk0 + i * kThreads + threadIdx.x;
    if (p >= size) continue;
    float xi = 0.0f;
    if (c.sigma != 0.0f) {
      int lo = 0, hi = n_runs - 1;  // the run holding p
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (runs[(first_run + mid) * kRunCols] <= p) lo = mid;
        else hi = mid - 1;
      }
      const int64_t* run = runs + (first_run + lo) * kRunCols;
      xi = normal_at(run[1] + p - run[0], k0, k1);
    }
    float o_th, o_m, o_v;
    update_one(true, a_th[i], a_m[i], a_v[i], a_g[i], a_M[i], xi, c, o_th,
               o_m, o_v, acc);
    th[x0 + p] = o_th;
    m[x0 + p] = o_m;
    v[x0 + p] = o_v;
  }
  finish_partials(acc, rows, tickets, partials, k, nb);
}

}  // namespace

extern "C" {

int bnn_segments_threads() { return kThreads; }

int bnn_segments_chunk() { return static_cast<int>(kChunk); }

const char* bnn_segments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch on `stream` of `device`, which must be the current device;
// returns cudaGetLastError() after it (0: launched). th, m, v, g: the state
// buffers; M: the preconditioner's; segs (n_segs × 9) and runs (× 2): the
// table, int64, on the device; blocks_per_chain: the table's block count.
// rows: K·blocks·3 floats of scratch; tickets: K zeroed counters, left
// zeroed; partials: K·3 floats out. seeds (K int64) and sigmas (K floats)
// may be null, and then `seed` and `sigma` serve every chain.
int bnn_fused_langevin_update_segments(
    float* th, float* m, float* v, const float* g, const float* M,
    const int64_t* segs, int64_t n_segs, const int64_t* runs,
    int64_t blocks_per_chain, float* rows, unsigned int* tickets,
    float* partials, const int64_t* seeds, const float* sigmas, int64_t seed,
    float sigma, int64_t seed_offset, int64_t K, float mom_decay,
    float grad_lr, float pos_c, float alpha, int device, void* stream) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) return static_cast<int>(cudaErrorInvalidDevice);
  const dim3 grid(static_cast<unsigned int>(blocks_per_chain),
                  static_cast<unsigned int>(K));
  fused_langevin_update_segments_kernel<<<grid, kThreads, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      th, m, v, g, M, segs, static_cast<int>(n_segs), runs, rows, tickets,
      partials, seeds, sigmas, seed, sigma, seed_offset, mom_decay, grad_lr,
      pos_c, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
