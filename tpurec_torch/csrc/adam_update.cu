// The optimizer chain of tpurec/train/trainer.py:167-286 (optax's
// clip_by_global_norm, the coupled L2 terms, then adam | adamw | sgd) over a
// whole list of fp32 tensors for Hopper (sm_90a), in one pass and one launch:
//
//   g' = keep ? g : (g / norm) * clip         norm: a device scalar, or no clip
//   g' = g' + l2 * p;  g' = g' + coef[row] * p
//   m = b1 * m + (1 - b1) * g';  v = b2 * v + (1 - b2) * g'^2
//   u = (m / bc1) / (sqrt(v / bc2) + eps)  (+ wd * p for adamw)
//     (m / bc1 and v / bc2 as products with the reciprocals 1 / bc1, 1 / bc2)
//   p = p - lr * u                            (sgd: p = p - lr * g')
//
// Replaces no TPU kernel: the JAX package's adam_update
// (tpurec/ops/pallas/embedding_update.py:119) is one elementwise expression
// that XLA fuses into one pass. Run as ten foreach ops, PyTorch makes about
// 24 passes over the data, so this kernel brings the pass back.
//
// What bounds it on an H100: bytes. Adam reads p, g, m and v and writes p, m
// and v, 28 bytes a parameter (sgd 12), and does ~40 fp32 operations on them:
// DeepFM's 371.8M parameters move 10.41 GB, 3.11 ms at 3.35 TB/s. So the
// design moves each byte once and keeps the card's memory busy:
// - one launch takes up to kMaxTensors tensors, their descriptors in the
//   kernel's parameters (under 4 KB); a block takes a slice of kSlice
//   elements of one tensor, so a 337M-element table gets ~20k blocks and a
//   bias of 80 one, and the block finds its tensor in the descriptors;
// - 16-byte loads and stores where p, g, m and v sit at the same offset from
//   a 16-byte boundary (the first block takes the elements before it, the
//   last the elements after the last whole vector), 4-byte ones otherwise;
// - streaming cache hints on every load and store: each byte is touched
//   once, and a step's working set is hundreds of times the 50 MB L2.
// Rounding: every operation is an explicit round-to-nearest intrinsic, in
// the order of the foreach chain it replaces (ChainOptimizer's plain twin,
// tpurec_torch/ops/kernels.py:adam_update_plain): the products that chain
// adds with an alpha (the moments' new terms, adamw's term and the step)
// are single fused multiply-adds, as PyTorch's foreach kernels compute
// them; PyTorch's foreach division by a scalar is a product with the
// reciprocal (taken in double, rounded to fp32: PyTorch 2.11 on an H100), so
// the bias corrections come as reciprocals (ibc1, ibc2); every other
// product, quotient, root and sum is rounded on its own. So the two give the
// same bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;    // a block
constexpr int kSlice = 16384;    // elements a block takes of its tensor
constexpr int kMaxTensors = 48;  // tensors a launch

enum Mode { kAdam = 0, kAdamW = 1, kSgd = 2 };

}  // namespace

// One tensor of the list, as the host lays it out (kernels.py's
// _ADAM_TENSOR mirrors it field by field).
struct AdamTensor {
  float* p;
  const float* g;
  float* m;  // null under sgd
  float* v;
  const float* coef;  // (rows,) row coefficients, or null
  long long n;        // elements
  long long width;    // elements a row: coef[e / width] is element e's
  float l2;           // the coupled L2 coefficient, where has_l2
  int has_l2;
};

namespace {

struct Hyper {
  float neg_lr, b1, b2, a1, a2, ibc1, ibc2, eps, wd, clip;
  const float* norm;  // the gradients' global norm on the device, or null: no clip
};

struct Launch {
  Hyper h;
  int count;
  int first_block[kMaxTensors + 1];  // tensor t takes blocks [first_block[t], first_block[t + 1])
  AdamTensor t[kMaxTensors];
};
static_assert(sizeof(Launch) <= 4096, "a launch's descriptors must fit the kernel parameters");

struct Terms {  // what a block applies to its tensor's gradient
  bool scale;
  float norm;
  bool l2;
  float lam;
};

template <int MODE>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float coef, bool rows,
                                       const Terms& k, const Hyper& h) {
  if (k.scale) g = __fmul_rn(__fdiv_rn(g, k.norm), h.clip);
  if (k.l2) g = __fadd_rn(g, __fmul_rn(k.lam, p));
  if (rows) g = __fadd_rn(g, __fmul_rn(coef, p));
  if constexpr (MODE == kSgd) {
    p = __fmaf_rn(h.neg_lr, g, p);
  } else {
    m = __fmaf_rn(h.a1, g, __fmul_rn(m, h.b1));
    v = __fmaf_rn(h.a2, __fmul_rn(g, g), __fmul_rn(v, h.b2));
    float u = __fdiv_rn(__fmul_rn(m, h.ibc1), __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.ibc2)), h.eps));
    if constexpr (MODE == kAdamW) u = __fmaf_rn(h.wd, p, u);
    p = __fmaf_rn(h.neg_lr, u, p);
  }
}

template <int MODE>
__device__ __forceinline__ void update_one(const AdamTensor& t, long long e, const Terms& k,
                                           const Hyper& h) {
  float p = __ldcs(t.p + e);
  const float g = __ldcs(t.g + e);
  float m = 0.f, v = 0.f;
  if constexpr (MODE != kSgd) {
    m = __ldcs(t.m + e);
    v = __ldcs(t.v + e);
  }
  const bool rows = t.coef != nullptr;
  update<MODE>(p, g, m, v, rows ? __ldg(t.coef + e / t.width) : 0.f, rows, k, h);
  __stcs(t.p + e, p);
  if constexpr (MODE != kSgd) {
    __stcs(t.m + e, m);
    __stcs(t.v + e, v);
  }
}

// Elements e .. e + 3, e a multiple of 4 past the 16-byte boundary.
template <int MODE>
__device__ __forceinline__ void update_four(const AdamTensor& t, long long e, const Terms& k,
                                            const Hyper& h) {
  float4 p = __ldcs(reinterpret_cast<const float4*>(t.p + e));
  const float4 g = __ldcs(reinterpret_cast<const float4*>(t.g + e));
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f), v = m;
  if constexpr (MODE != kSgd) {
    m = __ldcs(reinterpret_cast<const float4*>(t.m + e));
    v = __ldcs(reinterpret_cast<const float4*>(t.v + e));
  }
  const bool rows = t.coef != nullptr;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  if (rows) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = __ldg(t.coef + (e + i) / t.width);
  }
  update<MODE>(p.x, g.x, m.x, v.x, c[0], rows, k, h);
  update<MODE>(p.y, g.y, m.y, v.y, c[1], rows, k, h);
  update<MODE>(p.z, g.z, m.z, v.z, c[2], rows, k, h);
  update<MODE>(p.w, g.w, m.w, v.w, c[3], rows, k, h);
  __stcs(reinterpret_cast<float4*>(t.p + e), p);
  if constexpr (MODE != kSgd) {
    __stcs(reinterpret_cast<float4*>(t.m + e), m);
    __stcs(reinterpret_cast<float4*>(t.v + e), v);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) adam_kernel(const __grid_constant__ Launch L) {
  const int b = static_cast<int>(blockIdx.x);
  int ti = 0;
  while (ti + 1 < L.count && b >= L.first_block[ti + 1]) ++ti;
  const AdamTensor& t = L.t[ti];
  const Hyper& h = L.h;
  const long long slice = b - L.first_block[ti];
  const bool last = b + 1 == L.first_block[ti + 1];
  Terms k{false, 0.f, t.has_l2 != 0, t.l2};
  if (h.norm != nullptr) {
    k.norm = __ldg(h.norm);
    k.scale = !(k.norm < h.clip);
  }
  const uintptr_t off = reinterpret_cast<uintptr_t>(t.p) & 15;
  bool vec = (reinterpret_cast<uintptr_t>(t.g) & 15) == off;
  if constexpr (MODE != kSgd) {
    vec = vec && (reinterpret_cast<uintptr_t>(t.m) & 15) == off &&
          (reinterpret_cast<uintptr_t>(t.v) & 15) == off;
  }
  if (!vec) {
    const long long end = min(t.n, (slice + 1) * kSlice);
    for (long long e = slice * kSlice + threadIdx.x; e < end; e += kThreads) update_one<MODE>(t, e, k, h);
    return;
  }
  const long long head = min(t.n, static_cast<long long>(((16 - off) & 15) >> 2));
  const long long vectors = (t.n - head) >> 2;
  const long long end = min(vectors, (slice + 1) * (kSlice / 4));
  for (long long j = slice * (kSlice / 4) + threadIdx.x; j < end; j += kThreads) {
    update_four<MODE>(t, head + 4 * j, k, h);
  }
  if (slice == 0) {
    for (long long e = threadIdx.x; e < head; e += kThreads) update_one<MODE>(t, e, k, h);
  }
  if (last) {
    for (long long e = head + 4 * vectors + threadIdx.x; e < t.n; e += kThreads) {
      update_one<MODE>(t, e, k, h);
    }
  }
}

}  // namespace

extern "C" {

// Tensors one launch takes; the wrapper cuts longer lists into launches of
// this many.
int adam_update_max_tensors() { return kMaxTensors; }

// One step of the chain over tensors[0 .. count), each of n >= 1 contiguous
// fp32 elements on the current device, in place: mode 0 adam, 1 adamw, 2 sgd
// (m and v unread). lr, b1, b2, a1 = 1 - b1, a2 = 1 - b2, the reciprocals
// of the bias corrections ibc1 = 1 / bc1 and ibc2 = 1 / bc2, eps, wd and
// clip as the chain's scalars round to fp32; norm a device scalar, or null
// for no clip. Returns a cudaError_t (0 = launched).
int adam_update_launch(const AdamTensor* tensors, int count, int mode, float lr, float b1, float b2,
                       float a1, float a2, float ibc1, float ibc2, float eps, float wd,
                       const float* norm, float clip, void* stream) {
  if (count < 1 || count > kMaxTensors || mode < kAdam || mode > kSgd) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch L;
  L.h = Hyper{-lr, b1, b2, a1, a2, ibc1, ibc2, eps, wd, clip, norm};
  L.count = count;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const AdamTensor& t = tensors[i];
    if (t.n < 1 || t.p == nullptr || t.g == nullptr || (t.coef != nullptr && t.width < 1) ||
        (mode != kSgd && (t.m == nullptr || t.v == nullptr))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    L.t[i] = t;
    L.first_block[i] = static_cast<int>(blocks);
    blocks += (t.n + kSlice - 1) / kSlice;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  L.first_block[count] = static_cast<int>(blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (mode == kAdam) {
    adam_kernel<kAdam><<<grid, kThreads, 0, st>>>(L);
  } else if (mode == kAdamW) {
    adam_kernel<kAdamW><<<grid, kThreads, 0, st>>>(L);
  } else {
    adam_kernel<kSgd><<<grid, kThreads, 0, st>>>(L);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
