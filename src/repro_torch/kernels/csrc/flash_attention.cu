// Kernel K4 of the port, its "tf32x3" route: flash attention, forward, in
// 3xTF32 on the tensor cores (mma.sync), for fp32 inputs at any head dim
// and bf16 inputs whose head dim is not a multiple of 8.
//
//   out[b, h] = softmax(q[b, h] k[b, h / G]^T * sm_scale + mask) v[b, h / G]
//
// q: (B, H, Sq, D); k, v: (B, KH, Sk, D) with G = H / KH (GQA, MQA at
// KH = 1), D from 1 to 256; the causal mask is top-left aligned (query row
// r sees key columns c <= r), as the TPU kernel's `rows >= cols`; fp32
// arithmetic, out in q's dtype. bf16 inputs with D a multiple of 8 take the
// wgmma kernel of flash_attention_sm90.cu instead.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py:79, its pallas_call at :99). The TPU kernel upcast q, k
// and v to fp32 (:47-49) and walked the kv blocks in order per core with the
// running softmax state (m, l, acc) in VMEM scratch; it predicated the
// blocks above the diagonal off but still loaded them. Masked scores are
// -1e30, its NEG_INF (:26, :58); a row whose l is 0 divides by 1 (:75).
//
// Bound: operations. The reference's work is 4 D flops a kept (row, column)
// pair: at the llama3-8b shape 0.278 ms at 495 TFLOP/s TF32 on the tensor
// cores, and 2.05 ms in fp32 on the CUDA cores (67 TFLOP/s), which the
// kernel this one replaced reached to 30%. Single-pass TF32 keeps 10
// mantissa bits and misses the fp32 tolerance (atol 2e-5, rtol 2e-4);
// 3xTF32 (tf32x3.cuh) keeps fp32 accuracy at three products for each, so
// this design cannot go below 3 x 4 D flops a pair at 495 TFLOP/s, 0.833
// ms there. The design:
//   - One block of 4 warps owns 64 query rows of one (b, h), 16 rows a
//     warp. Q is staged once, as fp32, and split into its TF32 parts at
//     every fragment read (4 integer and float instructions a value):
//     keeping both parts in shared memory doubles Q's share of the
//     shared-memory reads and leaves one block an SM at D = 128, and was
//     slower on the H100; held in registers they would take 128 a thread.
//   - K and V tiles of BK keys stream through a 2-stage ring with cp.async
//     (async_copy.cuh: rows past Sk and columns past D arrive as zeros, and
//     rows that are not a multiple of 16 bytes go 4 bytes a copy); bf16
//     inputs are converted to fp32 while staged, with plain loads.
//   - S = Q K^T: the contraction over D may run in any order, so the lane
//     with t = lane % 4 takes columns 4t .. 4t + 3 of each 16 columns of
//     D, the k = t and k = t + 4 slots of two m16n8k8 steps: Q and K
//     fragments are 16-byte loads. Rows of Q and K are LQ words apart,
//     LQ % 32 == 16, so the 8 lanes of a quarter warp hit 32 banks. The
//     three terms go to three partial sums, (small big + big small) + big
//     big at the end, so that 3 BK / 8 mma chains are in flight a warp.
//   - The online softmax stays in fp32 registers: the running max in the
//     log2 domain, one FMA and one exp2 a score, each lane's share of the
//     row sum reduced over its quad at the end.
//   - P V: the accumulator of S holds row g, keys 2t and 2t + 1 of each
//     8-key group (c0, c1) and row g + 8 (c2, c3); the A fragment wants
//     keys t and t + 4. P V sums over keys, so its k slots are permuted:
//     slot k = t is key 2t, slot k = t + 4 is key 2t + 1. Then
//     A = (c0, c2, c1, c3) straight from S's registers, with no shuffle and
//     no trip through shared memory, and V's B fragment reads keys 2t and
//     2t + 1 (b0, b1). Its n slot g is column 2g + j of a 16-column group
//     for the two n-blocks j = 0, 1, so b0 and b1 of both come from two
//     8-byte loads; each lane's output row then holds 4 contiguous columns
//     of each group, stored 16 bytes at a time. Rows of V are LV words
//     apart, LV % 16 == 4: the rows 2t of a half warp fall 8 banks apart.
//   - Tiles: BK = 64 keys to DP = 32 and 32 above: two blocks (8 warps)
//     share an SM up to DP = 128 (107.5 KB at DP = 128), which the time
//     follows more than the tile (16 keys or one block an SM were slower),
//     and D = 256 fits one block's 227 KB with two stages. D is padded with
//     zero columns to DP in {16, 32, 64, 80, 96, 128, 160, 192, 256}.
//   - Causal: key tiles above the diagonal are neither loaded nor computed;
//     a warp whose 16 rows lie above a tile skips its products; only tiles
//     that straddle the diagonal or Sk are masked. The grid walks the query
//     tiles longest rows first.
//
// Plain C interface, loaded with ctypes (src/repro_torch/kernels/
// flash_attention.py). Each entry point returns cudaGetLastError() after
// the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kBQ = 64;            // query rows a block
constexpr int kThreads = 128;      // 4 warps of 16 rows
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

template <int DP>
struct Tiles {
  static constexpr int BK = DP <= 32 ? 64 : 32;
  static constexpr int LQ = DP % 32 == 0 ? DP + 16 : DP;  // Q and K rows
  static constexpr int LV = DP + 4;                       // V rows
  static constexpr int Q_WORDS = kBQ * LQ;
  static constexpr int K_WORDS = BK * LQ;
  static constexpr int STAGE = K_WORDS + BK * LV;
  static constexpr int BYTES = 4 * (Q_WORDS + 2 * STAGE);
  static_assert(DP % 16 == 0 && LQ % 32 == 16 && LV % 16 == 4, "layout");
  static_assert(BYTES <= 232448, "shared memory");
};

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// rows [0, rows) x columns [0, cols) of a (., D) matrix at `src` into
// dst[rows][ld] as fp32, zero at rows >= vrows and columns >= D; fp32 by
// cp.async (committed by the caller), bf16 by plain loads
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int D, int rows, int cols, int vrows,
                                      bool vec) {
  if constexpr (std::is_same_v<T, float>) {
    stage_tile<kThreads>(dst, ld, src, D, rows, cols, vrows, D, vec);
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      dst[r * ld + c] = r < vrows && c < D
                            ? __bfloat162float(src[static_cast<int64_t>(r) * D + c])
                            : 0.f;
    }
  }
}

// output n-blocks a P V pass: the largest even divisor of NO up to 12, so
// that V's B fragments take at most 48 registers
__host__ __device__ constexpr int pv_pass(int NO) {
  int c = 12;
  while (NO % c) c -= 2;
  return c;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_tf32x3_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v, T* __restrict__ out,
                                  int H, int KH, int Sq, int Sk, int D,
                                  int causal, float scale_log2, bool vec) {
  using L = Tiles<DP>;
  constexpr int BK = L::BK;
  constexpr int NB = BK / 8;   // 8-key n-blocks of S, k-steps of P V
  constexpr int NO = DP / 8;   // 8-column n-blocks of the output
  constexpr int CH = pv_pass(NO);  // output n-blocks a P V pass
  constexpr int LQ = L::LQ, LV = L::LV;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ring = qs + L::Q_WORDS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's rows in the tile
  const T* qb = q + ((static_cast<int64_t>(b) * H + h) * Sq + q0) * D;
  const T* kb = k + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  const T* vb = v + (static_cast<int64_t>(b) * KH + kh) * Sk * D;
  T* ob = out + (static_cast<int64_t>(b) * H + h) * Sq * D;

  int tiles = (Sk + BK - 1) / BK;
  if (causal) tiles = min(tiles, (q0 + kBQ - 1) / BK + 1);
  auto stage_kv = [&](int kt) {
    float* ks = ring + (kt & 1) * L::STAGE;
    const int64_t off = static_cast<int64_t>(kt) * BK * D;
    const int vrows = min(BK, Sk - kt * BK);
    stage<T>(ks, LQ, kb + off, D, BK, DP, vrows, vec);
    stage<T>(ks + L::K_WORDS, LV, vb + off, D, BK, DP, vrows, vec);
  };

  stage<T>(qs, LQ, qb, D, kBQ, DP,
           min(kBQ, Sq - q0), vec);
  stage_kv(0);
  cp_async_commit();

  float o[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const int row = q0 + r0 + g;  // and row + 8

  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) stage_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and, at kt = 0, Q) visible
    const int k0 = kt * BK;
    const float* ks = ring + (kt & 1) * L::STAGE;
    const float* vs = ks + L::K_WORDS;
    if (!causal || k0 <= q0 + r0 + 15) {  // the warp sees some key here
      // S = Q K^T, two k-steps (16 columns of D) at a time, each of the
      // three terms into its own partial sum, so that three times as many
      // mma chains are in flight
      float sp[3][NB][4];
#pragma unroll
      for (int x = 0; x < 3; ++x)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          sp[x][j][0] = sp[x][j][1] = sp[x][j][2] = sp[x][j][3] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < DP; d0 += 16) {
        const float* qrow = qs + (r0 + g) * LQ + d0 + 4 * t;
        const float4 x0 = *reinterpret_cast<const float4*>(qrow);
        const float4 x8 = *reinterpret_cast<const float4*>(qrow + 8 * LQ);
        const FragA a0 = frag_a(x0.x, x8.x, x0.y, x8.y);
        const FragA a1 = frag_a(x0.z, x8.z, x0.w, x8.w);
        FragB f0[NB], f1[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(
              ks + (8 * j + g) * LQ + d0 + 4 * t);
          f0[j] = frag_b(kv.x, kv.y);
          f1[j] = frag_b(kv.z, kv.w);
        }
        mma3_terms(sp, a0, f0);
        mma3_terms(sp, a1, f1);
      }
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = (sp[0][j][e] + sp[1][j][e]) + sp[2][j][e];

      // the online softmax in the log2 domain; s[j][e] is row row + 8 (e /
      // 2), key k0 + 8 j + 2 t + e % 2
      if (k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + r0)) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = k0 + 8 * j + 2 * t + e % 2;
            if (c >= Sk || (causal && c > row + 8 * (e / 2))) s[j][e] = kNegInf;
          }
      }
      float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f}, corr[2];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a quad shares a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        corr[r] = sm90::ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = sm90::ex2(fmaf(s[j][e], scale_log2, -m[e / 2]));
          sum[e / 2] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= corr[0];
        o[j][1] *= corr[0];
        o[j][2] *= corr[1];
        o[j][3] *= corr[1];
      }

      // O += P V, 8 keys (one n-block of S) a k-step, key slots permuted
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const FragA pa = frag_a(s[j][0], s[j][2], s[j][1], s[j][3]);
        const float* v0 = vs + (8 * j + 2 * t) * LV + 2 * g;
#pragma unroll
        for (int n0 = 0; n0 < NO; n0 += CH) {
          FragB fv[CH];
#pragma unroll
          for (int c = 0; c < CH; c += 2) {
            const float2 e0 = *reinterpret_cast<const float2*>(v0 + 8 * (n0 + c));
            const float2 e1 =
                *reinterpret_cast<const float2*>(v0 + LV + 8 * (n0 + c));
            fv[c] = frag_b(e0.x, e1.x);
            fv[c + 1] = frag_b(e0.y, e1.y);
          }
          mma3_span(o, n0, pa, fv);
        }
      }
    }
    __syncthreads();  // done with tile kt's stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
  }
  // n-blocks 2c and 2c + 1 hold columns 16 c + 4 t + (0, 1) in c0 (c2 for
  // row + 8) and 16 c + 4 t + (2, 3) in c1 (c3)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= Sq) continue;
    T* orow = ob + static_cast<int64_t>(rr) * D;
#pragma unroll
    for (int c = 0; c < NO; c += 2) {
      const int col = 8 * c + 4 * t;
      const float vals[4] = {o[c][2 * r] / l[r], o[c + 1][2 * r] / l[r],
                             o[c][2 * r + 1] / l[r],
                             o[c + 1][2 * r + 1] / l[r]};
      if constexpr (std::is_same_v<T, float>) {
        if (vec && col < D) {
          *reinterpret_cast<float4*>(orow + col) =
              make_float4(vals[0], vals[1], vals[2], vals[3]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < D) store(vals[e], orow + col + e);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KH, int Sq, int Sk, int D, int causal, float sm_scale,
           cudaStream_t s) {
  constexpr int bytes = Tiles<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tf32x3_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec =
      D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
      aligned16(out);
  const float scale_log2 = static_cast<float>(sm_scale * 1.4426950408889634);
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_tf32x3_kernel<T, DP><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KH, Sq, Sk, D,
      causal, scale_log2, vec);
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
  REPRO_FLASH_DP(16)
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
