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
// (K, size_s) block (chain stride size_s), its preconditioner a (K,) scalar
// block or a (K, size_s) block. The work is cut, in the FLAT packing's
// order, into pieces: a piece is the part of one run of elements (a leaf:
// consecutive in the flat packing and in its segment) that lies in one
// chunk of kChunk flat elements. The table (`pieces`, one row of
// kPieceCols int64 a piece, in flat order) gives a piece's flat start and
// count and, for chain 0, the buffer positions of its first element and
// the chain strides; it depends on the packer and K only, so the wrapper
// builds it once and a step passes five base addresses.
//
// Grid. Thread t of a piece in chunk c takes the flat quad q = c·kThreads
// + t, elements 4q .. 4q+3, those of them in the piece: a row read at the
// loop's index places every element, with no search, and the next piece's
// row loads while this one is worked. The pieces are dealt into n_groups
// groups (group gi: pieces gi, gi + n_groups, ...), n_groups fixed by the
// table and the card alone; grid (blocks, K), block b of chain k takes
// groups b, b + blocks, ... The blocks are the flat kernel's, about four a
// multiprocessor over all K chains: one group a block on one chain, several
// at K=8.
//
// Noise. One Philox4x32-10 call at counter q gives the four words of the
// quad, and Box–Muller the four normals of elements 4q .. 4q+3: the packed
// kernel's draw for those flat indices, bit for bit, at its cost (a quad
// cut by a run's edge is drawn once for each of its pieces).
//
// Accesses. Within a piece, a quad's buffer position is ≡ x − flat start
// (mod 4): one class a piece and chain. Class 0 loads and stores each
// stream as one float4, class 2 as two float2s, odd classes and a piece's
// edge quads element by element. The values are the same whichever way
// they are read, so the class changes no result. Built without
// --use_fast_math, as the packed kernel.
//
// Partials. A group's sums are each warp's shuffle sums added in warp
// order, a row of `rows` a group; the block with a chain's last ticket
// adds the chain's rows in index order (the packed kernel's fixed-order
// ticket scheme, `finish_partials`, with a row a group): no float atomics.
// A chain's groups and quads are the same at any K, so row k of a K-chain
// launch is bit for bit a one-chain launch with chain k's seed and σ,
// partials included, whatever the blocks.
//
// Bound: 28 bytes an element (θ, m, v, g read and θ', m', v' written in
// f32) and M (a scalar a native leaf): ResNet-20's hybrid state moves
// 7.64 MB, about 2.28 µs at 3.35 TB/s a chain.

#include <cstdint>
#include <cuda_runtime.h>

#include "langevin.cuh"

namespace {

using namespace bnn;

constexpr int64_t kChunk = static_cast<int64_t>(kThreads) * 4;  // a quad a thread
constexpr int kSlots = 16;  // groups a block takes at most
// blocks a multiprocessor the grid asks for (the wrapper's WAVES): the
// launch bounds hold a thread to 64 registers, so that four blocks fit
constexpr int kMinBlocks = 4;

// a piece's row: its start in the flat packing and its count; the buffer
// position of its first element in the state's buffers and that of its M
// (the scalar, or its first element), each for chain 0, with their chain
// strides; M's element stride (0: one scalar a chain); and its leaf (not
// read here: the row's 64 bytes)
constexpr int kPieceCols = 8;
enum PieceCol { kFlat, kCount, kX, kXStride, kP, kPStride, kPElem, kLeaf };

struct Piece {
  int64_t flat, count, x, x_stride, p, p_stride, p_elem;
};

__device__ __forceinline__ Piece load_piece(const int64_t* __restrict__ pieces,
                                            int64_t i) {
  const longlong2* r =
      reinterpret_cast<const longlong2*>(pieces + i * kPieceCols);
  const longlong2 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2),
                  d = __ldg(r + 3);
  return Piece{a.x, a.y, b.x, b.y, c.x, c.y, d.x};
}

// the quad's elements lo .. hi-1 of `p` (element 0 at p[0]), whose
// address class is `cls`; the others read as 0
__device__ __forceinline__ float4 load4(const float* p, int cls, int lo,
                                        int hi) {
  if (lo == 0 && hi == 4) {
    if (cls == 0) return *reinterpret_cast<const float4*>(p);
    if (cls == 2) {
      const float2 a = reinterpret_cast<const float2*>(p)[0];
      const float2 b = reinterpret_cast<const float2*>(p + 2)[0];
      return make_float4(a.x, a.y, b.x, b.y);
    }
    return make_float4(p[0], p[1], p[2], p[3]);
  }
  return make_float4(lo <= 0 && 0 < hi ? p[0] : 0.0f,
                     lo <= 1 && 1 < hi ? p[1] : 0.0f,
                     lo <= 2 && 2 < hi ? p[2] : 0.0f,
                     lo <= 3 && 3 < hi ? p[3] : 0.0f);
}

__device__ __forceinline__ void store4(float* p, int cls, int lo, int hi,
                                       float4 x) {
  if (lo == 0 && hi == 4) {
    if (cls == 0) {
      *reinterpret_cast<float4*>(p) = x;
      return;
    }
    if (cls == 2) {
      reinterpret_cast<float2*>(p)[0] = make_float2(x.x, x.y);
      reinterpret_cast<float2*>(p + 2)[0] = make_float2(x.z, x.w);
      return;
    }
  }
  if (lo <= 0 && 0 < hi) p[0] = x.x;
  if (lo <= 1 && 1 < hi) p[1] = x.y;
  if (lo <= 2 && 2 < hi) p[2] = x.z;
  if (lo <= 3 && 3 < hi) p[3] = x.w;
}

// One piece of chain k: thread t's quad of the chunk, its noise, the
// update, the stores and the sums; every load of the quad before any
// arithmetic. `aligned`: bit 0 the state buffers, bit 1 M's buffer start
// 16-byte aligned (else every access is element by element).
__device__ __forceinline__ void update_piece(
    float* __restrict__ th, float* __restrict__ m, float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ M,
    const Piece& pc, int k, int aligned, uint32_t k0, uint32_t k1,
    const Coeffs& c, float3& acc) {
  const int64_t x0 = pc.x + k * pc.x_stride;
  const int64_t p0 = pc.p + k * pc.p_stride;
  const int cls = (aligned & 1) ? static_cast<int>((x0 - pc.flat) & 3) : 1;
  const int pcls = (aligned & 2) ? static_cast<int>((p0 - pc.flat) & 3) : 1;
  const int64_t q = (pc.flat / kChunk) * kThreads + threadIdx.x;
  const int64_t e0 = q << 2;  // the quad's first flat index
  const int lo = static_cast<int>(max(pc.flat - e0, int64_t{0}));
  const int hi = static_cast<int>(min(pc.flat + pc.count - e0, int64_t{4}));
  const int rel = static_cast<int>(e0 - pc.flat);  // ≥ -3
  if (lo >= hi) return;  // the quad holds none of the piece
  const float4 a_th = load4(th + x0 + rel, cls, lo, hi);
  const float4 a_m = load4(m + x0 + rel, cls, lo, hi);
  const float4 a_v = load4(v + x0 + rel, cls, lo, hi);
  const float4 a_g = load4(g + x0 + rel, cls, lo, hi);
  float4 a_M;
  if (pc.p_elem == 0) {
    const float s = M[p0];
    a_M = make_float4(s, s, s, s);
  } else {
    a_M = load4(M + p0 + rel, pcls, lo, hi);
  }
  float4 xi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (c.sigma != 0.0f) {
    const uint4 w = philox4x32_10(static_cast<uint32_t>(q),
                                  static_cast<uint32_t>(q >> 32), k0, k1);
    const float2 n01 = box_muller(w.x, w.y), n23 = box_muller(w.z, w.w);
    xi = make_float4(n01.x, n01.y, n23.x, n23.y);
  }
  float4 o_th, o_m, o_v;
  update_one(lo <= 0 && 0 < hi, a_th.x, a_m.x, a_v.x, a_g.x, a_M.x, xi.x, c,
             o_th.x, o_m.x, o_v.x, acc);
  update_one(lo <= 1 && 1 < hi, a_th.y, a_m.y, a_v.y, a_g.y, a_M.y, xi.y, c,
             o_th.y, o_m.y, o_v.y, acc);
  update_one(lo <= 2 && 2 < hi, a_th.z, a_m.z, a_v.z, a_g.z, a_M.z, xi.z, c,
             o_th.z, o_m.z, o_v.z, acc);
  update_one(lo <= 3 && 3 < hi, a_th.w, a_m.w, a_v.w, a_g.w, a_M.w, xi.w, c,
             o_th.w, o_m.w, o_v.w, acc);
  store4(th + x0 + rel, cls, lo, hi, o_th);
  store4(m + x0 + rel, cls, lo, hi, o_m);
  store4(v + x0 + rel, cls, lo, hi, o_v);
}

// The block's groups' sums become rows (k, g) of `rows` (thread 0 writes
// them, each the fixed-order sum of its warps' sums); the block then takes
// a ticket on chain k's counter, and the block with the last ticket sums
// the chain's n_groups rows in index order into partials[3k .. 3k+2] and
// resets the counter: `finish_partials` with a row a group, not a block.
__device__ __forceinline__ void finish_groups(
    const float3 (*slot_sum)[kWarps], int slots, float* __restrict__ rows,
    unsigned int* __restrict__ tickets, float* __restrict__ partials, int k,
    unsigned int nb, int64_t n_groups) {
  __shared__ float3 warp_part[kWarps];
  __shared__ bool is_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      float3 t = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        t.x += slot_sum[s][w].x;
        t.y += slot_sum[s][w].y;
        t.z += slot_sum[s][w].z;
      }
      float* r = rows + (k * n_groups + blockIdx.x + s * int64_t{nb}) * 3;
      r[0] = t.x;
      r[1] = t.y;
      r[2] = t.z;
    }
    __threadfence();
    is_last = atomicAdd(tickets + k, 1u) == nb - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // the last block of chain k: every row of the chain is written
  __threadfence();
  const float* r = rows + k * n_groups * 3;
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
  for (int64_t b = threadIdx.x; b < n_groups; b += kThreads) {
    acc.x += __ldcg(r + 3 * b + 0);
    acc.y += __ldcg(r + 3 * b + 1);
    acc.z += __ldcg(r + 3 * b + 2);
  }
  const float3 s = block_sum(acc, warp_part);
  if (threadIdx.x == 0) {
    partials[3 * k + 0] = s.x;
    partials[3 * k + 1] = s.y;
    partials[3 * k + 2] = s.z;
    tickets[k] = 0;
  }
}

// grid (blocks, K), blocks ≥ n_groups / kSlots. Block b of chain k takes
// groups b, b + blocks, ...; group gi is pieces gi, gi + n_groups, ..., so
// the blocks at work at any time walk neighbouring pieces. Chain k's seed
// and σ come from seeds[k] and sigmas[k] when those are given, else from
// the scalars.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_langevin_update_segments_kernel(
    float* __restrict__ th, float* __restrict__ m, float* __restrict__ v,
    const float* __restrict__ g, const float* __restrict__ M,
    const int64_t* __restrict__ pieces, int64_t n_pieces, int64_t n_groups,
    int aligned, float* __restrict__ rows, unsigned int* __restrict__ tickets,
    float* __restrict__ partials, const int64_t* __restrict__ seeds,
    const float* __restrict__ sigmas, int64_t seed, float sigma,
    int64_t seed_offset, float mom_decay, float grad_lr, float pos_c,
    float alpha) {
  __shared__ float3 slot_sum[kSlots][kWarps];
  const int k = blockIdx.y;
  const unsigned int nb = gridDim.x;
  if (seeds != nullptr) seed = seeds[k];
  if (sigmas != nullptr) sigma = sigmas[k];
  const uint64_t key = static_cast<uint64_t>(seed + seed_offset);
  const uint32_t k0 = static_cast<uint32_t>(key);
  const uint32_t k1 = static_cast<uint32_t>(key >> 32);
  const Coeffs c{sigma, mom_decay, grad_lr, pos_c, alpha};

  int slots = 0;
  for (int64_t gi = blockIdx.x; gi < n_groups; gi += nb, ++slots) {
    float3 acc = make_float3(0.0f, 0.0f, 0.0f);
    if (gi < n_pieces) {  // the next piece's row loads while this one works
      int64_t i = gi;
      Piece pc = load_piece(pieces, i);
      for (;;) {
        const int64_t next = i + n_groups;
        Piece pn = pc;
        if (next < n_pieces) pn = load_piece(pieces, next);
        update_piece(th, m, v, g, M, pc, k, aligned, k0, k1, c, acc);
        if (next >= n_pieces) break;
        i = next;
        pc = pn;
      }
    }
    acc.x = warp_sum(acc.x);
    acc.y = warp_sum(acc.y);
    acc.z = warp_sum(acc.z);
    if ((threadIdx.x & 31) == 0) slot_sum[slots][threadIdx.x >> 5] = acc;
  }
  finish_groups(slot_sum, slots, rows, tickets, partials, k, nb, n_groups);
}

}  // namespace

extern "C" {

int bnn_segments_threads() { return kThreads; }

int bnn_segments_chunk() { return static_cast<int>(kChunk); }

int bnn_segments_piece_cols() { return kPieceCols; }

int bnn_segments_slots() { return kSlots; }

const char* bnn_segments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch on `stream` of `device`, which must be the current device;
// returns cudaGetLastError() after it (0: launched). th, m, v, g: the state
// buffers; M: the preconditioner's; pieces (n_pieces × kPieceCols int64,
// 16-byte aligned, on the device): the table, dealt into n_groups groups;
// blocks_per_chain ≥ n_groups / kSlots; aligned: bit 0 th, m, v, g and
// bit 1 M start 16-byte aligned. rows: K·n_groups·3 floats of scratch;
// tickets: K zeroed counters, left zeroed; partials: K·3 floats out. seeds
// (K int64) and sigmas (K floats) may be null, and then `seed` and `sigma`
// serve every chain.
int bnn_fused_langevin_update_segments(
    float* th, float* m, float* v, const float* g, const float* M,
    const int64_t* pieces, int64_t n_pieces, int64_t n_groups,
    int64_t blocks_per_chain, int aligned, float* rows,
    unsigned int* tickets, float* partials, const int64_t* seeds,
    const float* sigmas, int64_t seed, float sigma, int64_t seed_offset,
    int64_t K, float mom_decay, float grad_lr, float pos_c, float alpha,
    int device, void* stream) {
  if (n_groups < 1 || blocks_per_chain < 1
      || blocks_per_chain * kSlots < n_groups)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) return static_cast<int>(cudaErrorInvalidDevice);
  const dim3 grid(static_cast<unsigned int>(blocks_per_chain),
                  static_cast<unsigned int>(K));
  fused_langevin_update_segments_kernel<<<grid, kThreads, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      th, m, v, g, M, pieces, n_pieces, n_groups, aligned, rows, tickets,
      partials, seeds, sigmas, seed, sigma, seed_offset, mom_decay, grad_lr,
      pos_c, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
