// Kernel K2 of the port: the compressed (sparsified) gossip mix on a stacked
// node state.
//
//   out[i, m] = w_self[i] * z[i, m]
//             + sum_{j<k} w_edge[i, j] * (msg * mask)[S_in[i, j], m]
//
// Replaces the TPU kernel `compress_mix_weighted` (src/repro/kernels/
// compress_mix.py:47, its pallas_call at :67) together with the two gathers
// in front of it in `compress_mix_impl` (src/repro/kernels/ops.py:115-152).
// On the TPU the caller gathered a (k, n, M) stack of messages AND a
// (k, n, M) stack of masks (ops.py:145-148) because BlockSpecs cannot
// gather; here each thread reads the k neighbor rows of msg and of mask
// directly through S_in, in one pass, so neither stack is ever built. The
// mask stays 0/1 in the message dtype, as in the reference interface: each
// node's own z is mixed exactly, only the received messages are masked.
//
// Bound: pure data movement. A call must read z, msg and mask and write
// out, 4*n*M*bytes, plus S_in (n*k*8), w_self (n*4) and w_edge (n*k*4),
// when the neighbor re-reads hit the 50 MB L2 (msg and mask of 4 MB each at
// the main path's n=256, M=4096, fp32 do). At that call it is
// 16,790,528 bytes, 5.01 us at 3.35 TB/s. The arithmetic, (3k+1)*n*M
// flops (a mask multiply and an FMA per neighbor, one multiply for the
// self term), is two orders of magnitude below the fp32 peak. The design
// is K1's (gossip_mix.cu): each block owns one node row i and a span of
// M, loads S_in[i, :k], w_self[i] and w_edge[i, :k] once per thread,
// reads z and the k neighbor rows of msg and mask with 16-byte loads
// (float4 for fp32, 8 x bf16) when M and the pointers allow it,
// accumulates in fp32 with fmaf and stores once in z's dtype. With an
// all-ones mask it computes exactly what K1 computes with `msg`
// (msg * 1 is exact), bit for bit. Ragged M takes the scalar
// instantiation.
//
// Indices are range-checked on the device: an S_in entry outside [0, n)
// stops the kernel with a device-side assert, which the next synchronizing
// call raises, as PyTorch's own CUDA index ops do.
//
// Plain C interface, loaded with ctypes (src/repro_torch/kernels/
// compress_mix.py). Each entry point returns cudaGetLastError() after the
// launch.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// V elements of T starting at p, widened to fp32. V * sizeof(T) is either
// sizeof(T) (scalar) or 16 bytes (one vector load of an aligned packet).
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f32(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "packets are 16 bytes");
    alignas(16) T elems[V];
    *reinterpret_cast<uint4*>(elems) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = to_f32(elems[e]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    from_f32(f[0], p);
  } else {
    alignas(16) T elems[V];
#pragma unroll
    for (int e = 0; e < V; ++e) from_f32(f[e], &elems[e]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(elems);
  }
}

// grid.x spans M in packets of V elements, grid.y walks node rows.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    compress_mix_kernel(const T* __restrict__ z, const T* __restrict__ msg,
                        const T* __restrict__ mask,
                        const int64_t* __restrict__ s_in,
                        const float* __restrict__ w_self,
                        const float* __restrict__ w_edge,
                        T* __restrict__ out, int n, int k, int M) {
  const int64_t m =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (m >= M) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const int64_t row = static_cast<int64_t>(i) * M;
    float acc[V], buf[V], keep[V];
    const float ws = w_self[i];
    load<T, V>(z + row + m, buf);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = ws * buf[e];
    for (int j = 0; j < k; ++j) {
      const int64_t src = s_in[static_cast<int64_t>(i) * k + j];
      assert(src >= 0 && src < n);
      const float we = w_edge[static_cast<int64_t>(i) * k + j];
      load<T, V>(msg + src * M + m, buf);
      load<T, V>(mask + src * M + m, keep);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(we, buf[e] * keep[e], acc[e]);
    }
    store<T, V>(out + row + m, acc);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* z, const void* msg, const void* mask,
           const void* s_in, const void* w_self, const void* w_edge,
           void* out, int n, int k, int M, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const bool packed = M % V == 0 && aligned16(z) && aligned16(msg) &&
                      aligned16(mask) && aligned16(out);
  const int per_block = kThreads * (packed ? V : 1);
  const dim3 grid((M + per_block - 1) / per_block, n < kMaxGridY ? n : kMaxGridY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* zt = static_cast<const T*>(z);
  const T* mt = static_cast<const T*>(msg);
  const T* kt = static_cast<const T*>(mask);
  const int64_t* st = static_cast<const int64_t*>(s_in);
  const float* ws = static_cast<const float*>(w_self);
  const float* we = static_cast<const float*>(w_edge);
  T* ot = static_cast<T*>(out);
  if (packed) {
    compress_mix_kernel<T, V><<<grid, kThreads, 0, s>>>(zt, mt, kt, st, ws, we,
                                                        ot, n, k, M);
  } else {
    compress_mix_kernel<T, 1><<<grid, kThreads, 0, s>>>(zt, mt, kt, st, ws, we,
                                                        ot, n, k, M);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int compress_mix_f32(const void* z, const void* msg,
                                const void* mask, const void* s_in,
                                const void* w_self, const void* w_edge,
                                void* out, int n, int k, int M, void* stream) {
  return launch<float>(z, msg, mask, s_in, w_self, w_edge, out, n, k, M,
                       stream);
}

extern "C" int compress_mix_bf16(const void* z, const void* msg,
                                 const void* mask, const void* s_in,
                                 const void* w_self, const void* w_edge,
                                 void* out, int n, int k, int M,
                                 void* stream) {
  return launch<__nv_bfloat16>(z, msg, mask, s_in, w_self, w_edge, out, n, k,
                               M, stream);
}
