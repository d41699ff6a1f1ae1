// FM second-order cross term for Hopper (sm_90a), fp32 in and out:
//
//   out[b] = 0.5 * sum_d [ (sum_f e[b, f, d])^2 - sum_f e[b, f, d]^2 ]      e (B, F, D)
//
// Replaces the Pallas TPU kernel tpurec/ops/pallas/kernels.py:
// fm_second_order_fused (_fm_kernel). Same function as
// fm_second_order_reference.
//
// What bounds it on an H100: bytes. Each element is read once and takes
// three flops, so the least time is 4 * (B*F*D + B) bytes over 3.35 TB/s:
// 8.1 us at B=8192, F=26, D=32 (27 MB). The rank path calls it at B=8..256
// (the server's power-of-two buckets), where the bytes take well under a
// microsecond and the launch and one row's load latency are the time.
//
// Design: a warp takes one row, so a row never waits on a block barrier and
// the rank shapes spread their rows over as many SMs as there are rows.
// - A lane owns fixed columns. The row's F*D values are read unpadded, in
//   16-byte loads where D % 4 == 0 and the input starts on a 16-byte
//   boundary (every row then does too), else in 4-byte loads. With
//   U = D / 4 (or D) column units a field, U a power of two up to 32, the
//   warp is cut into G = 32 / U field groups: lane l takes unit l % U of fields l / U,
//   l / U + G, ... At D = 32 that is float4 column block l % 8 of fields
//   l / 8, l / 8 + 4, ...: 7 loads at F = 26, all in flight before the
//   first add (up to kLoads a lane at once; see sum_fields and fm_kernel
//   for what that takes from the compiler: sent one to four at a time, the
//   loads made the rank shapes slower than the Triton kernel this replaces).
// - Each lane keeps sum_f e and sum_f e^2 for its columns. A butterfly over
//   the groups folds the lanes that share columns; then each of the U lanes
//   forms 0.5 * (s^2 - q) over its columns and a fixed butterfly over the
//   warp sums them; lane 0 writes.
// - Other rows (U above 32, or not a power of two) take a lane's columns in
//   passes of 32 units (lane l takes units l, l + 32, ...), each unit's
//   fields summed by its lane alone.
// Blocks: a warp a block while B is at most 4 rows an SM, so small batches
// reach the most SMs; kWarps warps a block above that (at B=8192, 2,048
// blocks that all fit on the card at once). The caller passes the card's SM
// count (found once a device), so a launch makes no device query. Every sum
// runs in a fixed order and nothing is atomic: the same bits on every call.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;  // warps a block above 4 rows an SM
constexpr int kLoads = 8;  // loads a lane has in flight before its first add

template <int VW>
__device__ __forceinline__ void load(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// s += e, q += e^2 over fields f0, f0 + step, ... < F of the column unit at
// p (field f at p + f*D), kLoads loads in flight before the adds. Neither
// the loads nor their uses are conditional: a field past F reloads field
// F - 1 (lines already on their way) and is selected to 0, since a load
// used only under a condition is moved into it and waits there. Offsets
// are 32-bit (F*D is at most FM_MAX_TILE), which keeps each address to a
// few instructions.
template <int VW>
__device__ __forceinline__ void sum_fields(const float* p, int D, int f0, int step, int F,
                                           float (&s)[VW], float (&q)[VW]) {
  const int last = (F - 1) * D;
  const int stride = step * D;
  for (int f = f0; f < F; f += kLoads * step) {
    float v[kLoads][VW];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) load<VW>(p + min(f * D + k * stride, last), v[k]);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const bool live = f + k * step < F;
#pragma unroll
      for (int c = 0; c < VW; ++c) {
        const float e = live ? v[k][c] : 0.f;
        s[c] += e;
        q[c] = fmaf(e, e, q[c]);
      }
    }
  }
}

template <int VW>
__device__ __forceinline__ float cross(const float (&s)[VW], const float (&q)[VW]) {
  float t = 0.f;
#pragma unroll
  for (int c = 0; c < VW; ++c) t += 0.5f * (s[c] * s[c] - q[c]);
  return t;
}

// How a row's column units map to lanes: U a power of two up to 32, in
// 32 / U field groups folded by a butterfly; or any other U, in passes of 32
// units. Each is its own kernel, so the path a launch runs is straight-line
// code.
enum Layout { kGroupsPow2 = 0, kPasses = 1 };

// At least one block an SM (__launch_bounds__'s second argument) lets
// ptxas give a lane the registers to hold all kLoads loads at once; without
// it ptxas keeps fewer registers and sends them one to four at a time.
template <int VW, int LAYOUT>
__global__ void __launch_bounds__(kWarps * 32, 1) fm_kernel(const float* __restrict__ emb,
                                                         float* __restrict__ out, int B, int F,
                                                         int D) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp
  const float* e = emb + static_cast<size_t>(row) * F * D;
  const int U = D / VW;
  float t = 0.f;
  if constexpr (LAYOUT == kPasses) {
    for (int col = lane; col < U; col += 32) {
      float s[VW], q[VW];
#pragma unroll
      for (int c = 0; c < VW; ++c) s[c] = q[c] = 0.f;
      sum_fields<VW>(e + col * VW, D, 0, 1, F, s, q);
      t += cross<VW>(s, q);
    }
  } else {
    const int G = 32 / U;
    const int col = lane % U;
    const int grp = lane / U;
    float s[VW], q[VW];
#pragma unroll
    for (int c = 0; c < VW; ++c) s[c] = q[c] = 0.f;
    if (grp < G) sum_fields<VW>(e + col * VW, D, grp, G, F, s, q);
    for (int off = U; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < VW; ++c) {
        s[c] += __shfl_xor_sync(kFull, s[c], off);
        q[c] += __shfl_xor_sync(kFull, q[c], off);
      }
    }
    if (lane < U) t = cross<VW>(s, q);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
  if (lane == 0) out[row] = t;
}

template <int VW>
void launch(int layout, int blocks, int threads, cudaStream_t st, const float* emb, float* out,
            int B, int F, int D) {
  if (layout == kGroupsPow2) {
    fm_kernel<VW, kGroupsPow2><<<blocks, threads, 0, st>>>(emb, out, B, F, D);
  } else {
    fm_kernel<VW, kPasses><<<blocks, threads, 0, st>>>(emb, out, B, F, D);
  }
}

}  // namespace

extern "C" {

// Warps a block at batch size B on a card of sms SMs: one while B is at
// most 4 rows an SM, else kWarps.
int fm_second_order_warps(int B, int sms) { return B <= 4 * sms ? 1 : kWarps; }

// out (B,) = the FM cross term of emb (B, F, D), both contiguous fp32 device
// arrays, on the current device, which has sms SMs. Returns a cudaError_t
// (0 = launched).
int fm_second_order_forward(const float* emb, float* out, int B, int F, int D, int sms,
                            void* stream) {
  if (B < 1 || F < 0 || D < 0 || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0 || D == 0) {  // an empty sum: every row is 0
    F = 0;
    D = 1;
  }
  const int warps = fm_second_order_warps(B, sms);
  const int blocks = (B + warps - 1) / warps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  const int U = vec4 ? D / 4 : D;
  const int layout = U <= 32 && (U & (U - 1)) == 0 ? kGroupsPow2 : kPasses;
  if (vec4) {
    launch<4>(layout, blocks, warps * 32, st, emb, out, B, F, D);
  } else {
    launch<1>(layout, blocks, warps * 32, st, emb, out, B, F, D);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tpurec_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
