// Split of float32 operands into bf16- (or f16-) exact float32 parts, for
// Hopper (sm_90a): one launch for a table of operands.
//
// Replaces no TPU kernel. On the TPU the MXU runs the split-bf16 dot
// algorithms (BF16_BF16_F32_X3, _X6) itself
// (bnn_priors_tpu/inference/runner.py:214); on the card the product runs
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
// Layout. An operand is read as `rows` rows of M floats; its parts are
// `rows` rows of P blocks of M floats, block p holding part `select[p]`
// (4 bits each of `select`, P ≤ 6), so that one library product sums a
// mode's pairs: the parts of one operand stand side by side along the
// product's contraction axis (input channels within a group, K of a dense
// product, or the batch of a wgrad). With P = 1 every layout is the
// operand's own, and it is split as one row.
//
// A launch takes a table of operands: each entry is an offset into one
// source buffer (a model's flat position, or an activation), its rows and
// M, and an offset into one destination buffer; all share one layout
// (n, P, select). A one-operand call is a one-entry table. The table goes
// by value in the kernel's parameters (a __grid_constant__ struct, read
// through the constant cache), not through device memory: it then needs
// no copy to the card, no lifetime of its own, and a position whose
// address changes is no hazard. 64 entries (3 KB) stay inside the 4 KB
// of parameters that every toolkit takes; a larger table is split over
// several launches, each counted. A model's weights at X3 or X6 take two
// entries a multiplying layer (the forward's and the dgrad's layout):
// 44 for ResNet-20, 42 for resnet18, so one launch.
//
// Work. The entries' items are laid end to end in one flat index space
// of chunks of kThreads items. The grid is a chunk a block up to
// kMaxBlocksPerSm blocks an SM (a multiple of the SMs), and strides over
// the chunks past that, so rows never sit on blockIdx.y. An item is 4
// consecutive floats of a row where the entry's parts can be stored as
// float4 (the destination 16-byte aligned, and M a multiple of 4 when
// P > 1): one float4 load where the source is 16-byte aligned too, else
// four scalar loads of the same line, then P float4 stores; the last item
// of a row that is not a multiple of 4 long stores its remainder one
// float at a time. Other entries (M = 27 at P > 1: the first
// convolution's weight rows) go one float an item. A chunk lies in one
// entry, so the path taken is uniform across a block. The parts are
// stored with the streaming hint (st.global.cs, evict first): the parts
// are P times the operand, and on an H100 the hint took X6's launch at
// ResNet-20's widest activation from 31 to 18.5 µs and at resnet18's from
// 114 to 87 µs; a chunk a block, against 8 resident blocks an SM striding
// over the chunks, took resnet18's X3 from 51 to 47 µs.
//
// The layout (part type, n, P, select) is a template parameter where that
// was faster on an H100 (in turns, over rings of operands larger than
// L2): one part (8.1 µs read at run time against 7.4-7.7 at ResNet-20's
// widest activation, 26.0 against 24.5 µs at resnet18's; 49.6 against
// 32.1 µs on resnet18's weight table), X3's two sides (resnet18's X3
// table 146 against 119 µs) and X6's right side (ResNet-20's X6 table 7.75
// against 7.25 µs). Any other layout runs the same kernel with the layout
// read at run time: X6's left side (as fast either way), and the plain
// n = 2, 3 ones that no mode uses. A one-operand call is a table of 64
// entries like any other: a one-entry table type of its own took the same
// time.
//
// Bound: a pure elementwise pass, 4 bytes read and 4·P written an
// element, so the memory rate.
//
// What the design answers: a launch an operand made a ResNet-20 step 22
// weight launches of 432 to 36,864 elements, each pure latency, repeated
// in every batch of an exact pass although the position does not change;
// the table makes them one launch an evaluation (models/layers.py::
// split_weights). One float a thread with the layout read in the inner
// loop took 30.0 µs at resnet18's widest activation at one part (67% of
// the bound); float4 items, the layout as a template parameter and the
// streaming stores take 24.2 µs (83%), and 84-85% at X3 and X6 (H100).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSelect = 6;
constexpr int kMaxBlocksPerSm = 64;  // 8 resident at a time, the rest queued
constexpr int kTableCap = 64;     // entries of a table launch
constexpr int kMaxDevices = 64;
constexpr int64_t kMaxItems = 0x7fffffff;  // items of one entry (uint32 math)

// one operand of a launch (48 bytes)
struct Entry {
  int64_t src;      // its first element, from the source buffer
  int64_t dst;      // its parts' first element, from the destination
  int64_t ld;       // M: a row's elements, and a part block's stride
  int64_t chunk0;   // its first chunk in the launch's index space
  int32_t rows;     // rows of this entry
  int32_t per_row;  // items a row: ceil(M / 4) float4 items, or M floats
  int32_t vec;      // bit 0: float4 items and stores; bit 1: float4 loads
  int32_t pad;
};

struct Table {
  Entry e[kTableCap];
  int64_t chunks;   // chunks over all entries
  int32_t count;    // entries
  int32_t n;        // the layout, for the run-time instantiation
  int32_t P;
  uint32_t select;
};

template <bool kHalf>
__device__ __forceinline__ float round_part(float r) {
  if constexpr (kHalf) {
    return __half2float(__float2half_rn(r));
  } else {
    return __bfloat162float(__float2bfloat16_rn(r));
  }
}

// the n parts of x (p1, p2 zero past n)
template <bool kHalf>
__device__ __forceinline__ void parts_of(float x, int n, float& p0,
                                         float& p1, float& p2) {
  p0 = round_part<kHalf>(x);
  float res = __fsub_rn(x, p0);
  p1 = n > 1 ? round_part<kHalf>(res) : 0.0f;
  res = __fsub_rn(res, p1);
  p2 = n > 2 ? round_part<kHalf>(res) : 0.0f;
}

__device__ __forceinline__ float pick(unsigned int s, float p0, float p1,
                                      float p2) {
  return s == 0 ? p0 : (s == 1 ? p1 : p2);
}

__device__ __forceinline__ float4 pick4(unsigned int s, const float4& p0,
                                        const float4& p1, const float4& p2) {
  return s == 0 ? p0 : (s == 1 ? p1 : p2);
}

// kP = 0: the layout (n, P, select) is read from the table at run time
template <bool kHalf, int kN, int kP, unsigned int kSel>
__global__ void __launch_bounds__(kThreads) split_table_kernel(
    const float* __restrict__ src, float* __restrict__ dst,
    const __grid_constant__ Table t) {
  const int n = kP ? kN : t.n;
  const int P = kP ? kP : t.P;
  const unsigned int sel = kP ? kSel : t.select;
  int e = 0;
  for (int64_t c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    while (e + 1 < t.count && c >= t.e[e + 1].chunk0) ++e;
    const Entry& en = t.e[e];
    const uint32_t item = static_cast<uint32_t>(
        (c - en.chunk0) * kThreads + threadIdx.x);
    const uint32_t per_row = static_cast<uint32_t>(en.per_row);
    if (item >= static_cast<uint32_t>(en.rows) * per_row) continue;
    uint32_t r = 0, j = item;
    if (en.rows > 1) {
      r = item / per_row;
      j = item - r * per_row;
    }
    const int64_t M = en.ld;
    const float* s = src + en.src + static_cast<int64_t>(r) * M;
    float* d = dst + en.dst + static_cast<int64_t>(r) * P * M;
    if (en.vec & 1) {
      const int64_t m = 4 * static_cast<int64_t>(j);
      if (m + 4 <= M) {
        const float4 x = (en.vec & 2)
            ? *reinterpret_cast<const float4*>(s + m)
            : make_float4(s[m], s[m + 1], s[m + 2], s[m + 3]);
        float4 q0, q1, q2;
        parts_of<kHalf>(x.x, n, q0.x, q1.x, q2.x);
        parts_of<kHalf>(x.y, n, q0.y, q1.y, q2.y);
        parts_of<kHalf>(x.z, n, q0.z, q1.z, q2.z);
        parts_of<kHalf>(x.w, n, q0.w, q1.w, q2.w);
#pragma unroll
        for (int p = 0; p < kMaxSelect; ++p) {
          if (p < P) {
            __stcs(reinterpret_cast<float4*>(d + p * M + m),
                   pick4((sel >> (4 * p)) & 0xFu, q0, q1, q2));
          }
        }
      } else {  // a row's last, short item
        for (int64_t k = m; k < M; ++k) {
          float p0, p1, p2;
          parts_of<kHalf>(s[k], n, p0, p1, p2);
#pragma unroll
          for (int p = 0; p < kMaxSelect; ++p) {
            if (p < P) {
              __stcs(d + p * M + k, pick((sel >> (4 * p)) & 0xFu, p0, p1, p2));
            }
          }
        }
      }
    } else {
      float p0, p1, p2;
      parts_of<kHalf>(s[j], n, p0, p1, p2);
#pragma unroll
      for (int p = 0; p < kMaxSelect; ++p) {
        if (p < P) {
          __stcs(d + p * M + j, pick((sel >> (4 * p)) & 0xFu, p0, p1, p2));
        }
      }
    }
  }
}

#define BNN_SPLIT_LAYOUT(N, PP, SEL)                                        \
  if (t.n == (N) && t.P == (PP) && t.select == (SEL)) {                     \
    split_table_kernel<kHalf, (N), (PP), (SEL)>                             \
        <<<grid, kThreads, 0, stream>>>(src, dst, t);                       \
    return;                                                                 \
  }

// one launch of the instantiation of t's layout
template <bool kHalf>
void launch(const float* src, float* dst, const Table& t, unsigned int grid,
            cudaStream_t stream) {
  BNN_SPLIT_LAYOUT(1, 1, 0x0u)          // one part: bfloat16, F16_F16_F32
  BNN_SPLIT_LAYOUT(2, 3, 0x100u)        // X3, the left operand: 0 0 1
  BNN_SPLIT_LAYOUT(2, 3, 0x010u)        // X3, the right operand: 0 1 0
  BNN_SPLIT_LAYOUT(3, 6, 0x021010u)     // X6, right: 0 1 0 1 2 0
  split_table_kernel<kHalf, 0, 0, 0u>
      <<<grid, kThreads, 0, stream>>>(src, dst, t);
}

#undef BNN_SPLIT_LAYOUT

int sm_count(int device) {
  static int counts[kMaxDevices] = {0};
  if (device < 0 || device >= kMaxDevices) return 132;
  if (counts[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        v < 1)
      return 132;
    counts[device] = v;
  }
  return counts[device];
}

// Builds and launches tables of at most kTableCap entries over `ops` (4
// int64 each: src offset, dst offset, rows, M); returns the launches made,
// or -(CUDA error).
int run(const float* src, float* dst, const int64_t* ops, int64_t count,
        int n, int P, unsigned int select, int half, int device,
        cudaStream_t stream) {
  Table t;
  t.count = 0;
  t.chunks = 0;
  t.n = n;
  t.P = P;
  t.select = select;
  const int64_t max_grid = static_cast<int64_t>(sm_count(device)) *
                           kMaxBlocksPerSm;
  int launched = 0;
  auto flush = [&]() -> int {
    if (t.count == 0) return 0;
    const unsigned int grid = static_cast<unsigned int>(
        t.chunks < max_grid ? t.chunks : max_grid);
    if (half) {
      launch<true>(src, dst, t, grid, stream);
    } else {
      launch<false>(src, dst, t, grid, stream);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    ++launched;
    t.count = 0;
    t.chunks = 0;
    return 0;
  };
  for (int64_t i = 0; i < count; ++i) {
    const int64_t s0 = ops[4 * i], d0 = ops[4 * i + 1];
    int64_t rows = ops[4 * i + 2], M = ops[4 * i + 3];
    if (s0 < 0 || d0 < 0 || rows < 0 || M < 0)
      return -static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0 || M == 0) continue;
    if (P == 1) {  // every layout is the operand's own: one row
      M *= rows;
      rows = 1;
    }
    const uintptr_t sa = reinterpret_cast<uintptr_t>(src + s0);
    const uintptr_t da = reinterpret_cast<uintptr_t>(dst + d0);
    const bool vstore = da % 16 == 0 && (P == 1 || M % 4 == 0);
    const bool vload = vstore && sa % 16 == 0;
    const int64_t per_row = vstore ? (M + 3) / 4 : M;
    if (per_row > kMaxItems) return -static_cast<int>(cudaErrorInvalidValue);
    const int64_t rows_per_entry = kMaxItems / per_row;
    for (int64_t r0 = 0; r0 < rows; r0 += rows_per_entry) {
      if (t.count == kTableCap) {
        const int rc = flush();
        if (rc < 0) return rc;
      }
      const int64_t rr = rows - r0 < rows_per_entry ? rows - r0
                                                     : rows_per_entry;
      Entry& en = t.e[t.count++];
      en.src = s0 + r0 * M;
      en.dst = d0 + r0 * P * M;
      en.ld = M;
      en.chunk0 = t.chunks;
      en.rows = static_cast<int32_t>(rr);
      en.per_row = static_cast<int32_t>(per_row);
      en.vec = (vstore ? 1 : 0) | (vload ? 2 : 0);
      en.pad = 0;
      t.chunks += (rr * per_row + kThreads - 1) / kThreads;
    }
  }
  const int rc = flush();
  return rc < 0 ? rc : launched;
}

int check_args(int n, int P, int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (current != device) return -static_cast<int>(cudaErrorInvalidDevice);
  if (n < 1 || n > 3 || P < 1 || P > kMaxSelect)
    return -static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

int bnn_split_threads() { return kThreads; }

int bnn_split_max_select() { return kMaxSelect; }

int bnn_split_max_entries() { return kTableCap; }

const char* bnn_split_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One operand on `stream` of `device`, which must be the current device:
// x holds rows·M floats, out rows·P·M; n ∈ {1, 2, 3} parts; select: P part
// indices < n, 4 bits each, P ∈ [1, 6]; half: 0 for bf16 parts, 1 for f16.
// Returns the kernel launches made (1; 0 for an empty x), or -(CUDA error).
int bnn_split_operand(const float* x, float* out, int64_t rows, int64_t M,
                      int n, int P, unsigned int select, int half,
                      int device, void* stream) {
  const int rc = check_args(n, P, device);
  if (rc < 0) return rc;
  const int64_t op[4] = {0, 0, rows, M};
  return run(x, out, op, 1, n, P, select, half, device,
             static_cast<cudaStream_t>(stream));
}

// A table of `count` operands of `src`, one launch for up to
// bnn_split_max_entries() of them: ops holds 4 int64 an operand (its
// offset in src, its parts' offset in dst, rows, M), in elements. Layout
// and return value as bnn_split_operand's.
int bnn_split_table(const float* src, float* dst, const int64_t* ops,
                    int64_t count, int n, int P, unsigned int select,
                    int half, int device, void* stream) {
  const int rc = check_args(n, P, device);
  if (rc < 0) return rc;
  return run(src, dst, ops, count, n, P, select, half, device,
             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
