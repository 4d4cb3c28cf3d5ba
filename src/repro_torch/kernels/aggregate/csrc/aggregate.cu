// Client-aggregation kernels of the FedChain server round, for Hopper (sm_90a).
//
//   chain_aggregate:    out[d] = x[d] − lr·(Σ_s w[s]·(g[s,d] − c_i[s,d]) + c[d])
//   mean_over_clients:  out[d] = (Σ_s t[s,d]) / S
//
// They replace the Pallas kernels chain_aggregate and mean_over_clients of
// src/repro/kernels/aggregate/aggregate.py (defined at lines 36 and 143).
//
// Bound on an H100: both are column reductions over a short client axis
// (S ≤ 64 on the main path) with about one fused multiply-add per element
// read, far below the card's ~20 operations per byte for float32, so memory
// bounds them. chain_aggregate moves (2S + 3)·D elements, mean_over_clients
// (S + 1)·D; at S = 64, D = 2^22, float32 that is 2.2 GB and 1.09 GB, or
// 0.66 ms and 0.33 ms at 3.35 TB/s.
//
// Design: the Pallas kernels walk D in VMEM blocks on one core; here every
// thread owns VEC neighbouring columns (16 bytes: 4 float32 or 8 bfloat16)
// and loops over the S rows, so a warp reads 512 contiguous bytes of each row
// per step and each input byte is read once. Accumulation is in float32,
// the weights and lr are operands, and the ragged edge of D is masked here
// rather than padded. A D that is not a multiple of VEC, or a pointer that is
// not 16-byte aligned, takes the same loop one column per thread.
//
// The interface is plain C for ctypes: every function launches on the given
// stream, does not synchronise, and returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements of T moved as one load or store of sizeof(T)·VEC bytes.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(pk.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
chain_aggregate_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const T* __restrict__ ci, const T* __restrict__ c,
                       const float* __restrict__ w, T* __restrict__ out,
                       int64_t S, int64_t D, float lr) {
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (col >= D) return;  // D is a multiple of VEC, so a live pack is whole
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll 4
  for (int64_t s = 0; s < S; ++s) {
    const float ws = __ldg(w + s);
    float gv[VEC], cv[VEC];
    load<T, VEC>(g + s * D + col, gv);
    load<T, VEC>(ci + s * D + col, cv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(ws, gv[i] - cv[i], acc[i]);
  }
  float xv[VEC], cc[VEC], o[VEC];
  load<T, VEC>(x + col, xv);
  load<T, VEC>(c + col, cc);
#pragma unroll
  for (int i = 0; i < VEC; ++i) o[i] = xv[i] - lr * (acc[i] + cc[i]);
  store<T, VEC>(out + col, o);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
mean_over_clients_kernel(const T* __restrict__ t, T* __restrict__ out,
                         int64_t S, int64_t D) {
  const int64_t col = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (col >= D) return;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll 4
  for (int64_t s = 0; s < S; ++s) {
    float tv[VEC];
    load<T, VEC>(t + s * D + col, tv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += tv[i];
  }
  const float n = static_cast<float>(S);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = acc[i] / n;
  store<T, VEC>(out + col, acc);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

unsigned int blocks_for(int64_t columns) {
  return static_cast<unsigned int>((columns + kThreads - 1) / kThreads);
}

template <typename T>
int launch_chain_aggregate(const void* x, const void* g, const void* ci, const void* c,
                           const void* w, void* out, int64_t S, int64_t D, float lr,
                           void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const auto st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const T* cip = static_cast<const T*>(ci);
  const T* cp = static_cast<const T*>(c);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  if (D % VEC == 0 && aligned16(x) && aligned16(g) && aligned16(ci) && aligned16(c) &&
      aligned16(out)) {
    chain_aggregate_kernel<T, VEC><<<blocks_for(D / VEC), kThreads, 0, st>>>(
        xp, gp, cip, cp, wp, op, S, D, lr);
  } else {
    chain_aggregate_kernel<T, 1><<<blocks_for(D), kThreads, 0, st>>>(
        xp, gp, cip, cp, wp, op, S, D, lr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mean_over_clients(const void* t, void* out, int64_t S, int64_t D, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const auto st = static_cast<cudaStream_t>(stream);
  const T* tp = static_cast<const T*>(t);
  T* op = static_cast<T*>(out);
  if (D % VEC == 0 && aligned16(t) && aligned16(out)) {
    mean_over_clients_kernel<T, VEC><<<blocks_for(D / VEC), kThreads, 0, st>>>(tp, op, S, D);
  } else {
    mean_over_clients_kernel<T, 1><<<blocks_for(D), kThreads, 0, st>>>(tp, op, S, D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int chain_aggregate_f32(const void* x, const void* g, const void* ci, const void* c,
                        const void* w, void* out, int64_t S, int64_t D, float lr,
                        void* stream) {
  return launch_chain_aggregate<float>(x, g, ci, c, w, out, S, D, lr, stream);
}

int chain_aggregate_bf16(const void* x, const void* g, const void* ci, const void* c,
                         const void* w, void* out, int64_t S, int64_t D, float lr,
                         void* stream) {
  return launch_chain_aggregate<__nv_bfloat16>(x, g, ci, c, w, out, S, D, lr, stream);
}

int mean_over_clients_f32(const void* t, void* out, int64_t S, int64_t D, void* stream) {
  return launch_mean_over_clients<float>(t, out, S, D, stream);
}

int mean_over_clients_bf16(const void* t, void* out, int64_t S, int64_t D, void* stream) {
  return launch_mean_over_clients<__nv_bfloat16>(t, out, S, D, stream);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
