// Split of a float32 operand into bf16- (or f16-) exact float32 parts, for
// Hopper (sm_90a): one launch a call.
//
// Replaces no TPU kernel. On the TPU the MXU runs the split-bf16 dot
// algorithms (BF16_BF16_F32_X3, _X6) itself; on the card the product runs
// in TF32, which is exact on bf16 and f16 values, so an operand is first
// cut into parts that hold such values. Part 0 is x rounded to nearest
// even, part k the residual the first k leave, rounded likewise:
//
//   r = x;  for k < n:  part[k] = round(r);  r = r - part[k]
//
// The residuals are exact in float32 (round to nearest leaves at most the
// bits below the part's), so the kernel's parts are bit for bit those of
// the plain PyTorch version (`.bfloat16().float()` and subtraction).
//
// Layout. x is read as `rows` rows of M floats; the output is `rows` rows
// of P blocks of M floats, block p holding part `select[p]` (4 bits each
// of `select`, P ≤ 6), so that one library product sums a mode's pairs:
// the parts of one operand stand side by side along the product's
// contraction axis (input channels within a group, K of a dense product,
// or the batch of a wgrad).
//
// Bound: a pure elementwise pass, 4 bytes read and 4·P written an element,
// so the memory rate. Each thread reads its element once, computes every
// part in registers and writes its P floats; neighbouring threads take
// neighbouring elements, so every load and store is coalesced. Grid
// (blocks over M, rows), with grid-stride loops on both axes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSelect = 6;
constexpr unsigned int kMaxBlocksX = 4096;
constexpr unsigned int kMaxBlocksY = 65535;

template <bool kHalf>
__device__ __forceinline__ float round_part(float r) {
  if constexpr (kHalf) {
    return __half2float(__float2half_rn(r));
  } else {
    return __bfloat162float(__float2bfloat16_rn(r));
  }
}

template <bool kHalf>
__global__ void __launch_bounds__(kThreads) split_operand_kernel(
    const float* __restrict__ x, float* __restrict__ out, int64_t rows,
    int64_t M, int n, int P, unsigned int select) {
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* xr = x + r * M;
    float* orow = out + r * P * M;
    for (int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
         m < M; m += static_cast<int64_t>(gridDim.x) * kThreads) {
      float res = xr[m];
      const float p0 = round_part<kHalf>(res);
      res = __fsub_rn(res, p0);
      const float p1 = n > 1 ? round_part<kHalf>(res) : 0.0f;
      res = __fsub_rn(res, p1);
      const float p2 = n > 2 ? round_part<kHalf>(res) : 0.0f;
#pragma unroll
      for (int p = 0; p < kMaxSelect; ++p) {
        if (p < P) {
          const unsigned int s = (select >> (4 * p)) & 0xFu;
          orow[p * M + m] = s == 0 ? p0 : (s == 1 ? p1 : p2);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int bnn_split_threads() { return kThreads; }

int bnn_split_max_select() { return kMaxSelect; }

const char* bnn_split_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch on `stream` of `device`, which must be the current device;
// returns cudaGetLastError() after it (0: launched). x: rows·M floats;
// out: rows·P·M floats; n ∈ {1, 2, 3} parts; select: P part indices < n,
// 4 bits each, P ∈ [1, 6]; half: 0 for bf16 parts, 1 for f16.
int bnn_split_operand(const float* x, float* out, int64_t rows, int64_t M,
                      int n, int P, unsigned int select, int half,
                      int device, void* stream) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) return static_cast<int>(cudaErrorInvalidDevice);
  if (n < 1 || n > 3 || P < 1 || P > kMaxSelect || rows < 1 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bx = (M + kThreads - 1) / kThreads;
  const dim3 grid(
      static_cast<unsigned int>(bx < kMaxBlocksX ? bx : kMaxBlocksX),
      static_cast<unsigned int>(rows < kMaxBlocksY ? rows : kMaxBlocksY));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half) {
    split_operand_kernel<true><<<grid, kThreads, 0, s>>>(x, out, rows, M, n,
                                                         P, select);
  } else {
    split_operand_kernel<false><<<grid, kThreads, 0, s>>>(x, out, rows, M,
                                                          n, P, select);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
