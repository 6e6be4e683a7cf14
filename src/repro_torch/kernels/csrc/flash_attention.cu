// Kernel K4 of the port: flash attention, forward.
//
//   out[b, h] = softmax(q[b, h] k[b, h / G]^T * sm_scale + mask) v[b, h / G]
//
// q: (B, H, Sq, D); k, v: (B, KH, Sk, D) with G = H / KH (GQA, MQA at
// KH = 1); the causal mask is top-left aligned (query row r sees key
// columns c <= r), as the TPU kernel's `rows >= cols`; fp32 or bf16 in,
// fp32 arithmetic, out in q's dtype.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py:79, its pallas_call at :99). The TPU grid walked the
// kv blocks in order per core with the running softmax state (m, l, acc)
// in VMEM scratch, and predicated the blocks above the diagonal off but
// still loaded them. Here one block of 256 threads owns one (b, h, tile of
// kBQ query rows), keeps (m, l, acc) in registers in fp32, and loops over
// the key tiles from 0 up to the diagonal: the tiles above it are neither
// loaded nor computed. Masked scores are -1e30, as the TPU kernel's
// NEG_INF (flash_attention.py:26, :58); a row whose l is 0 divides by 1
// (:75).
//
// Bound: arithmetic, 4 * D flops per unmasked (row, column) pair, against
// one read of q, k and v and one write of out. The TPU kernel computed in
// fp32 (it upcasts q, k and v, :47-49), and so does this one, on the CUDA
// cores (67 TFLOP/s), not the tensor cores (989 TFLOP/s in bf16): wgmma and
// TMA are the next step. The design: q's tile, then each key tile and value
// tile, are staged in shared memory as fp32; each thread owns 4 query rows
// (ty + 16 i) and computes their scores against BK / 16 key columns
// (tx + 16 j) from float4 reads (rows padded by 4 floats so a warp's reads
// fall in distinct banks), the row max and sum by shuffles over the 16
// threads of a row, then P V into DP / 16 output columns (tx + 16 j). D is
// padded to DP, the next of 32, 64, 80, 96, 128, 160, 192, 256, with zero
// columns; tiles of 64 key columns while DP <= 64, of 32 above it, to keep
// two or more blocks on an SM.
//
// Plain C interface, loaded with ctypes (src/repro_torch/kernels/
// flash_attention.py). Each entry point returns cudaGetLastError() after
// the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <int DP>
__host__ __device__ constexpr int key_tile() { return DP <= 64 ? 64 : 32; }

template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int BK = key_tile<DP>();
  return 4 * (kBQ * (DP + 4) + BK * (DP + 4) + BK * DP + kBQ * (BK + 4));
}

// rows [row0, row0 + R) of a (nrows, D) matrix into dst[R][ld] as fp32,
// zero past nrows and past D
template <typename T, int DP, int R>
__device__ __forceinline__ void stage(const T* __restrict__ src, int64_t row0,
                                      int64_t nrows, int D, float* dst,
                                      int ld) {
  for (int e = threadIdx.x; e < R * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    const bool in = row0 + r < nrows && c < D;
    dst[r * ld + c] = in ? to_f32(src[(row0 + r) * D + c]) : 0.f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int H, int KH, int Sq, int Sk, int D, int causal,
                           float sm_scale) {
  constexpr int BK = key_tile<DP>();
  constexpr int NI = kBQ / 16;  // query rows per thread
  constexpr int NJ = BK / 16;   // key columns per thread
  constexpr int ND = DP / 16;   // output columns per thread
  constexpr int LQ = DP + 4, LK = DP + 4, LP = BK + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LQ;
  float* Vs = Ks + BK * LK;
  float* Ps = Vs + BK * DP;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const T* qb = q + (static_cast<int64_t>(b) * H + h) * Sq * D;
  const T* kb = k + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  const T* vb = v + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  T* ob = out + (static_cast<int64_t>(b) * H + h) * Sq * D;

  stage<T, DP, kBQ>(qb, q0, Sq, D, Qs, LQ);

  float m[NI], l[NI], acc[NI][ND];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) acc[i][jd] = 0.f;
  }

  int tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int last = (q0 + kBQ - 1) / BK + 1;  // tiles up to the diagonal
    tiles = tiles < last ? tiles : last;
  }
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P V is done with Ks, Vs, Ps
    stage<T, DP, BK>(kb, k0, Sk, D, Ks, LK);
    stage<T, DP, BK>(vb, k0, Sk, D, Vs, DP);
    __syncthreads();

    float s[NI][NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[NI], kv[NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LQ + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LK + d);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] *= sm_scale;
        if (col >= Sk || (causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[ND];
#pragma unroll
        for (int jd = 0; jd < ND; ++jd) vv[jd] = Vs[(c + cc) * DP + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float p = cc == 0 ? pv[i].x
                          : cc == 1 ? pv[i].y
                          : cc == 2 ? pv[i].z
                                    : pv[i].w;
#pragma unroll
          for (int jd = 0; jd < ND; ++jd) acc[i][jd] = fmaf(p, vv[jd], acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jd = 0; jd < ND; ++jd) {
      const int col = tx + 16 * jd;
      if (col < D) from_f32(acc[i][jd] / li, &ob[static_cast<int64_t>(row) * D + col]);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KH, int Sq, int Sk, int D, int causal, float sm_scale,
           cudaStream_t s) {
  constexpr int bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DP><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KH, Sq, Sk, D,
      causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int KH, int Sq, int Sk, int D, int causal, float sm_scale,
             void* stream) {
  if (D < 1 || KH < 1 || H % KH != 0 || H > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_DP(DP)                                                   \
  if (D <= DP)                                                               \
    return launch<T, DP>(q, k, v, out, B, H, KH, Sq, Sk, D, causal, sm_scale, \
                         s);
  REPRO_FLASH_DP(32)
  REPRO_FLASH_DP(64)
  REPRO_FLASH_DP(80)
  REPRO_FLASH_DP(96)
  REPRO_FLASH_DP(128)
  REPRO_FLASH_DP(160)
  REPRO_FLASH_DP(192)
  REPRO_FLASH_DP(256)
#undef REPRO_FLASH_DP
  return static_cast<int>(cudaErrorInvalidValue);  // D > 256 (MAX_D in
                                                   // flash_attention.py)
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int H,
                                   int KH, int Sq, int Sk, int D, int causal,
                                   float sm_scale, void* stream) {
  return dispatch<float>(q, k, v, out, B, H, KH, Sq, Sk, D, causal, sm_scale,
                         stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int H,
                                    int KH, int Sq, int Sk, int D, int causal,
                                    float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, B, H, KH, Sq, Sk, D, causal,
                                 sm_scale, stream);
}
