// Kernel K1 of the port: the weighted gossip mix on a stacked node state.
//
//   out[i, m] = w_self[i] * z[i, m] + sum_{j<k} w_edge[i, j] * msg[S_in[i, j], m]
//
// Replaces the TPU kernel `gossip_mix_weighted` (src/repro/kernels/
// gossip_mix.py:88, its pallas_call at :107) together with the gather in
// front of it in `gossip_gather_mix_impl` (src/repro/kernels/ops.py:65-112).
// On the TPU the caller gathered a (k, n, M) neighbor stack (ops.py:107)
// because BlockSpecs cannot gather; here each thread reads the k neighbor
// rows directly through S_in, so that stack is never materialized.
//
// Bound: pure data movement. A call must read z (and msg, when it is a
// separate tensor) and write out: at least 2*n*M*bytes of HBM traffic when
// the neighbor re-reads hit the 50 MB L2 (z of 4 MB at n=256, M=4096, fp32
// does), else (k+2)*n*M*bytes, at 3.35 TB/s. The arithmetic, (2k+1)*n*M
// flops, is two orders of magnitude below the fp32 peak. The design does
// one pass with no intermediate: each block owns one node row i and a span
// of M, loads S_in[i, :k], w_self[i] and w_edge[i, :k] once per thread
// (broadcast loads, shared by the warp), reads z and the k neighbor rows
// with 16-byte loads (float4 for fp32, 8 x bf16) when M and the pointers
// allow it, accumulates in fp32 and stores once in z's dtype. Ragged M (not
// a multiple of the 16-byte packet) takes the scalar instantiation.
//
// Indices are range-checked on the device: an S_in entry outside [0, n)
// stops the kernel with a device-side assert, which the next synchronizing
// call raises, as PyTorch's own CUDA index ops do.
//
// Kernel K3, in this file too: the flat per-node mix with scalar weights,
//
//   out[m] = sw * self[m] + ew * sum_{j<k} nbr[j, m],
//
// over one node's flattened (M,) buffer and the (k, M) stack of buffers it
// received. Replaces the TPU kernel `gossip_mix` (src/repro/kernels/
// gossip_mix.py:46, its pallas_call at :59) and the padding of its front
// door `ops.gossip_mix` (src/repro/kernels/ops.py:50-62), which cut M into
// whole (8, 1024) tiles: a grid-stride loop needs no padding. Bound: data
// movement, (k + 2) * M * bytes (k neighbor rows and self read once, out
// written once) at 3.35 TB/s; (k + 2) * M flops are far below the fp32
// peak. Each thread walks packets of 16 bytes (float4, 8 x bf16) when M and
// the pointers allow it, sums the k neighbor packets in fp32 in slot
// order, as the plain version's sum does, and stores
// fmaf(ew, sum, sw * self) once in the input dtype.
//
// Plain C interface, loaded with ctypes (src/repro_torch/kernels/
// gossip_mix.py). Each entry point returns cudaGetLastError() after the
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
    gossip_mix_kernel(const T* __restrict__ z, const T* __restrict__ msg,
                      const int64_t* __restrict__ s_in,
                      const float* __restrict__ w_self,
                      const float* __restrict__ w_edge, T* __restrict__ out,
                      int n, int k, int M) {
  const int64_t m =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (m >= M) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const int64_t row = static_cast<int64_t>(i) * M;
    float acc[V], buf[V];
    const float ws = w_self[i];
    load<T, V>(z + row + m, buf);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = ws * buf[e];
    for (int j = 0; j < k; ++j) {
      const int64_t src = s_in[static_cast<int64_t>(i) * k + j];
      assert(src >= 0 && src < n);
      const float we = w_edge[static_cast<int64_t>(i) * k + j];
      load<T, V>(msg + src * M + m, buf);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(we, buf[e], acc[e]);
    }
    store<T, V>(out + row + m, acc);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* z, const void* msg, const void* s_in,
           const void* w_self, const void* w_edge, void* out, int n, int k,
           int M, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const bool packed =
      M % V == 0 && aligned16(z) && aligned16(msg) && aligned16(out);
  const int per_block = kThreads * (packed ? V : 1);
  const dim3 grid((M + per_block - 1) / per_block, n < kMaxGridY ? n : kMaxGridY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* zt = static_cast<const T*>(z);
  const T* mt = static_cast<const T*>(msg);
  const int64_t* st = static_cast<const int64_t*>(s_in);
  const float* ws = static_cast<const float*>(w_self);
  const float* we = static_cast<const float*>(w_edge);
  T* ot = static_cast<T*>(out);
  if (packed) {
    gossip_mix_kernel<T, V><<<grid, kThreads, 0, s>>>(zt, mt, st, ws, we, ot,
                                                      n, k, M);
  } else {
    gossip_mix_kernel<T, 1><<<grid, kThreads, 0, s>>>(zt, mt, st, ws, we, ot,
                                                      n, k, M);
  }
  return static_cast<int>(cudaGetLastError());
}

// grid-stride over M in packets of V elements
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gossip_mix_flat_kernel(const T* __restrict__ self_buf,
                           const T* __restrict__ nbrs, T* __restrict__ out,
                           int k, int64_t M, float sw, float ew) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * V;
  for (int64_t m = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x)
                   * V;
       m < M; m += step) {
    float sum[V], buf[V];
    load<T, V>(nbrs + m, sum);
    for (int j = 1; j < k; ++j) {
      load<T, V>(nbrs + static_cast<int64_t>(j) * M + m, buf);
#pragma unroll
      for (int e = 0; e < V; ++e) sum[e] += buf[e];
    }
    load<T, V>(self_buf + m, buf);
#pragma unroll
    for (int e = 0; e < V; ++e) sum[e] = fmaf(ew, sum[e], sw * buf[e]);
    store<T, V>(out + m, sum);
  }
}

template <typename T>
int launch_flat(const void* self_buf, const void* nbrs, void* out, int k,
                int64_t M, float sw, float ew, void* stream) {
  constexpr int V = 16 / sizeof(T);
  constexpr int64_t kMaxBlocks = 132 * 32;  // enough to fill 132 SMs
  const bool packed = M % V == 0 && aligned16(self_buf) && aligned16(nbrs) &&
                      aligned16(out);
  const int64_t per_block = kThreads * (packed ? V : 1);
  int64_t blocks = (M + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* st = static_cast<const T*>(self_buf);
  const T* nt = static_cast<const T*>(nbrs);
  T* ot = static_cast<T*>(out);
  if (packed) {
    gossip_mix_flat_kernel<T, V><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        st, nt, ot, k, M, sw, ew);
  } else {
    gossip_mix_flat_kernel<T, 1><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        st, nt, ot, k, M, sw, ew);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gossip_mix_flat_f32(const void* self_buf, const void* nbrs,
                                   void* out, int k, int64_t M, float sw,
                                   float ew, void* stream) {
  return launch_flat<float>(self_buf, nbrs, out, k, M, sw, ew, stream);
}

extern "C" int gossip_mix_flat_bf16(const void* self_buf, const void* nbrs,
                                    void* out, int k, int64_t M, float sw,
                                    float ew, void* stream) {
  return launch_flat<__nv_bfloat16>(self_buf, nbrs, out, k, M, sw, ew,
                                    stream);
}

extern "C" int gossip_mix_f32(const void* z, const void* msg,
                              const void* s_in, const void* w_self,
                              const void* w_edge, void* out, int n, int k,
                              int M, void* stream) {
  return launch<float>(z, msg, s_in, w_self, w_edge, out, n, k, M, stream);
}

extern "C" int gossip_mix_bf16(const void* z, const void* msg,
                               const void* s_in, const void* w_self,
                               const void* w_edge, void* out, int n, int k,
                               int M, void* stream) {
  return launch<__nv_bfloat16>(z, msg, s_in, w_self, w_edge, out, n, k, M,
                               stream);
}
