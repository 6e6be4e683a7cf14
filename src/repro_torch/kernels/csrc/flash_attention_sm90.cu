// Kernel K4 of the port on Hopper's tensor cores: flash attention, forward,
// bf16 in, fp32 arithmetic, out in bf16 (or fp32, a verification entry).
//
//   out[b, h] = softmax(q[b, h] k[b, h / G]^T * sm_scale + mask) v[b, h / G]
//
// q: (B, H, Sq, D); k, v: (B, KH, Sk, D) with G = H / KH (GQA, MQA at
// KH = 1), bf16, D a multiple of 8 up to 256; the causal mask is top-left
// aligned (query row r sees key columns c <= r), as the TPU kernel's
// `rows >= cols`.
//
// Replaces the TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py:79, its pallas_call at :99) for bf16 inputs; fp32
// inputs take the 3xTF32 kernel of flash_attention.cu. The TPU kernel
// upcast q, k and v to fp32 (:47-49) and computed S = Q K^T and P V on fp32
// operands. Here:
//   - S = Q K^T runs on the bf16 tensor cores (wgmma m64nBNk16, both
//     operands from shared memory) with fp32 accumulation: a bf16 x bf16
//     product is exact in fp32, so this is the reference's S up to the
//     order of the sum.
//   - The online softmax (running max m, sum l, rescaled accumulator) stays
//     in fp32 registers, with log2(e) folded into the scale (one FMA and
//     one exp2 a score).
//   - P V with P rounded to bf16 would not be the reference's function
//     (each term off by about 2^-9). So P is split: P_hi = bf16(P), P_lo =
//     bf16(P - P_hi) (the subtraction is exact in fp32), and two wgmmas (A
//     = P from registers, B = V from shared memory, transposed) accumulate
//     into one fp32 output. P then carries about 16 bits and the result
//     matches the fp32 reference to within summation order.
//   - Masked scores are -1e30, as the TPU kernel's NEG_INF; a row whose l
//     is 0 divides by 1 (flash_attention.py:75).
//
// Bound: operations. The reference's work is 4 D flops a kept (row, column)
// pair on the bf16 tensor cores (989 TFLOP/s); the split does 6 D (Q K^T,
// and P V twice). Each input read once and the output written once is far
// less: at the llama3-8b shape about 1,640 flops a byte, against the 295 at
// which the tensor cores and not HBM set the pace. The design feeds the
// tensor cores:
//   - One block owns 128 query rows of one (b, h): two consumer warpgroups
//     of 64 rows each and one producer warpgroup, of which one thread issues
//     every copy. `setmaxnreg` gives the producer's registers (24 a thread)
//     to the consumers (240), which hold the fp32 output accumulator (D / 2
//     registers a thread), S (BN / 2) and P's two halves (BN / 2).
//   - TMA copies with 3-D tensor maps, (B H, Sq, D) for q and out and
//     (B KH, Sk, D) for k and v: a tile that runs past Sq or Sk reads zeros
//     and writes nothing, never the next head's rows. Loads use the 128-byte
//     swizzle that the wgmma descriptors name. Q is loaded once; K and V go
//     through a ring of kStages stages with full and empty mbarriers.
//   - Each consumer warpgroup overlaps its softmax with its products: step
//     t issues S_t = Q K_t^T, then P_{t-1} V_{t-1}, and computes the
//     softmax of S_t on the CUDA cores while P_{t-1} V_{t-1} is on the
//     tensor cores; P V is one wgmma over all of D (m64nDPk16) a half. The
//     two warpgroups interleave on their own (making them take turns, as
//     FlashAttention-3's ping-pong, was slower at D = 128).
//   - Key tiles of BN = 128 columns for D <= 128 and 64 above, by the
//     register budget (the D = 256 accumulator alone is 128 registers; S,
//     P's halves and the accumulator are live together).
//     D is padded with zero columns to DP in {64, 128, 256}.
//   - Causal: the key tiles above the diagonal are neither loaded nor
//     computed; only the tiles that straddle it, and a ragged last tile
//     (whose rows past Sk hold zeros), are masked. The grid walks the
//     longest query tiles of every head first.
//   - Epilogue: acc / l in fp32, rounded once to the output type, written
//     to shared memory (over the warpgroup's own Q rows) and stored by TMA.
//
// Plain C interface, loaded with ctypes (src/repro_torch/kernels/
// flash_attention.py). Each entry point returns 0, a CUDA error code, or
// kEncodeError + the CUresult when a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBM = 128;           // query rows a block
constexpr int kConsumers = 2;      // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;         // K, V ring
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr double kLog2e = 1.4426950408889634;
constexpr int kChunk = 64 * 64 * 2;  // 64 rows of one 64-column chunk, bytes
constexpr int kEncodeError = 100000;

template <int DP>
struct Tile {
  static constexpr int BN = DP <= 128 ? 128 : 64;  // key columns a tile
  static constexpr int NC = DP / 64;               // 64-column chunks
  static constexpr int Q_BYTES = kBM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;  // K or V, one stage
  static constexpr int BAR_BYTES = 8 * (1 + 3 * kStages);
  static constexpr int USED = Q_BYTES + 2 * kStages * KV_BYTES + BAR_BYTES;
  // 1024 bytes of slack to align the swizzled tiles; never less than half
  // an SM's shared memory, so that no two blocks (each claiming 240
  // registers a consumer thread) share an SM
  static constexpr int SMEM =
      1024 + USED > 120 * 1024 ? 1024 + USED : 120 * 1024;
};

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// One key tile's raw scores S (this thread's BN / 2 accumulator registers,
// rows `row` and `row + 8`, columns k0 + 8 (i / 4) + col + i % 2) become
// probabilities in place: masked to -1e30 where asked, then the online
// softmax in the log2 domain (m the running max of S * scale_log2, l this
// thread's share of the running sum). `corr` is the factor by which each
// row's output accumulator must be rescaled.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0,
                                             int row, int col, int Sk,
                                             int causal, bool masked,
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int c = k0 + 8 * (i / 4) + col + i % 2;
      if (c >= Sk || (causal && c > row + 8 * ((i / 2) % 2))) s[i] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four threads of a quad share a row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    corr[r] = sm90::ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float p = sm90::ex2(fmaf(s[i], scale_log2, -m[(i / 2) % 2]));
    sum[(i / 2) % 2] += p;
    s[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// P = P_hi + P_lo as bf16 A fragments of the P V product: the accumulator's
// columns 16 kk .. 16 kk + 15 are registers 8 kk .. 8 kk + 7, already in the
// order of the A fragment's four 32-bit registers. P - P_hi is exact.
template <int BN>
__device__ __forceinline__ void split_p(const float (&s)[BN / 2],
                                        uint32_t (&hi)[BN / 16][4],
                                        uint32_t (&lo)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = s[8 * kk + 2 * j], b = s[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][j] = pack_bf16(h);
      lo[kk][j] = pack_bf16(__floats2bfloat162_rn(a - hf.x, b - hf.y));
    }
}

template <typename TO, int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_o,
                                int H, int KH, int Sk, int causal,
                                float scale_log2) {
  using T = Tile<DP>;
  constexpr int BN = T::BN, NC = T::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = sm90::smem_addr(base);
  const uint32_t sKV = sQ + T::Q_BYTES;  // stage s: K at + 2 s KV, V after
  const uint32_t bar_q = sKV + 2 * kStages * T::KV_BYTES;
  // barriers: Q, then K full, V full and empty by stage, tile t in t % S
  auto full_k = [&](int t) { return bar_q + 8 * (1 + t % kStages); };
  auto full_v = [&](int t) {
    return bar_q + 8 * (1 + kStages + t % kStages);
  };
  auto empty = [&](int t) {
    return bar_q + 8 * (1 + 2 * kStages + t % kStages);
  };
  auto parity = [](int t) { return static_cast<uint32_t>(t / kStages) & 1; };
  auto stage_k = [&](int t) { return sKV + (t % kStages) * 2 * T::KV_BYTES; };

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest rows first
  const int bh = blockIdx.z * H + h;
  const int bkh = blockIdx.z * KH + h / (H / KH);
  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) {
    const int last = (q0 + kBM - 1) / BN + 1;  // tiles up to the diagonal
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full_k(s), 1);
      sm90::mbar_init(full_v(s), 1);
      sm90::mbar_init(empty(s), kConsumers * 128);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every copy ---------------------------
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == kConsumers * 128) {
      sm90::mbar_arrive_expect_tx(bar_q, T::Q_BYTES);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < NC; ++c)
          sm90::tma_load_3d(sQ + (w * NC + c) * kChunk, &tm_q, bar_q, 64 * c,
                            q0 + 64 * w, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const uint32_t sK = stage_k(t), sV = sK + T::KV_BYTES;
        sm90::mbar_wait(empty(t), parity(t) ^ 1);
        sm90::mbar_arrive_expect_tx(full_k(t), T::KV_BYTES);
        for (int c = 0; c < NC; ++c)
          sm90::tma_load_3d(sK + c * BN * 128, &tm_k, full_k(t), 64 * c,
                            t * BN, bkh);
        sm90::mbar_arrive_expect_tx(full_v(t), T::KV_BYTES);
        for (int c = 0; c < NC; ++c)
          sm90::tma_load_3d(sV + c * BN * 128, &tm_v, full_v(t), 64 * c,
                            t * BN, bkh);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------
    sm90::setmaxnreg_inc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + 64 * wg;  // this warpgroup's first row
    // accumulator fragments (wgmma m64nN): register i of a thread holds
    // row 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
    // 2 (lane % 4) + i % 2 of the warpgroup's 64-row tile
    const int my_row = row0 + 16 * warp + lane / 4;  // and my_row + 8
    const int my_col = 2 * (lane % 4);
    const uint32_t sQw = sQ + wg * NC * kChunk;
    // the tiles holding a column that my rows see; the rest of the block's
    // tiles are released unread
    int n_mine = n_tiles;
    if (causal) {
      const int last = (row0 + 63) / BN + 1;
      n_mine = n_mine < last ? n_mine : last;
    }

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float s_acc[BN / 2];
    uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];

    // S = Q K_t^T over DP / 16 steps of 16 (both K-major)
    auto issue_qk = [&](int t) {
      const uint32_t sK = stage_k(t);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da =
              sm90::desc_sw128(sQw + c * kChunk + 32 * kk, 16, 1024);
          const uint64_t db =
              sm90::desc_sw128(sK + c * BN * 128 + 32 * kk, 16, 1024);
          if (c == 0 && kk == 0)
            sm90::wgmma_ss<BN, true>(s_acc, da, db);
          else
            sm90::wgmma_ss<BN, false>(s_acc, da, db);
        }
      sm90::wgmma_commit();
    };
    // O += P_hi V_t + P_lo V_t, V MN-major: 16 keys are two 1024-byte
    // atoms, the 64-column chunks BN 128 bytes apart
    auto issue_pv = [&](int t) {
      const uint32_t sV = stage_k(t) + T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv =
            sm90::desc_sw128(sV + 2048 * kk, BN * 128, 1024);
        sm90::wgmma_rs_tb<DP>(o, p_hi[kk], dv);
        sm90::wgmma_rs_tb<DP>(o, p_lo[kk], dv);
      }
      sm90::wgmma_commit();
    };
    auto masked = [&](int t) {
      return (causal && t * BN + BN - 1 > row0) || t * BN + BN > Sk;
    };

    // tile 0; then step t issues S_t and P_{t-1} V_{t-1} together and runs
    // the softmax of S_t while P_{t-1} V_{t-1} is on the tensor cores. No
    // wgmma is issued under a branch: ptxas would serialize them all.
    sm90::mbar_wait(bar_q, 0);
    sm90::mbar_wait(full_k(0), parity(0));
    sm90::wgmma_fence();
    issue_qk(0);
    sm90::wgmma_wait<0>();
    sm90::fence_registers(s_acc);
    softmax_tile<BN>(s_acc, m, l, corr, 0, my_row, my_col, Sk, causal,
                     masked(0), scale_log2);
    split_p<BN>(s_acc, p_hi, p_lo);
    for (int t = 1; t < n_mine; ++t) {
      sm90::mbar_wait(full_k(t), parity(t));
      sm90::wgmma_fence();
      issue_qk(t);
      sm90::mbar_wait(full_v(t - 1), parity(t - 1));
      issue_pv(t - 1);
      sm90::wgmma_wait<1>();  // S_t
      sm90::fence_registers(s_acc);
      softmax_tile<BN>(s_acc, m, l, corr, t * BN, my_row, my_col, Sk, causal,
                       masked(t), scale_log2);
      sm90::wgmma_wait<0>();  // P_{t-1} V_{t-1}
      sm90::fence_registers(o);
      sm90::fence_registers(p_hi);
      sm90::fence_registers(p_lo);
      sm90::mbar_arrive(empty(t - 1));
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i / 2) % 2];
      split_p<BN>(s_acc, p_hi, p_lo);
    }
    sm90::mbar_wait(full_v(n_mine - 1), parity(n_mine - 1));
    sm90::wgmma_fence();
    issue_pv(n_mine - 1);
    sm90::wgmma_wait<0>();
    sm90::fence_registers(o);
    sm90::mbar_arrive(empty(n_mine - 1));
    for (int t = n_mine; t < n_tiles; ++t) {
      // tile t lies above all my rows: released once it has landed, so
      // that no arrival of mine counts towards a later phase of its stage
      sm90::mbar_wait(full_v(t), parity(t));
      sm90::mbar_arrive(empty(t));
    }

    // ---- epilogue: acc / l, rounded once, through shared memory ----------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (l[r] == 0.f) l[r] = 1.f;
    }
    // the warpgroup's Q rows are free once all its products are done
    sm90::named_barrier(1 + wg, 128);
    constexpr int PARTS = sizeof(TO) / 2;  // stores: 1 (bf16), 2 (fp32)
    constexpr int W = DP / PARTS;          // columns a store covers
    TO* sO = reinterpret_cast<TO*>(base + wg * NC * kChunk);
#pragma unroll
    for (int part = 0; part < PARTS; ++part) {
      if (part > 0) sm90::named_barrier(1 + wg, 128);  // last store read
#pragma unroll
      for (int i = 0; i < DP / 2; i += 2) {
        const int cb = 8 * (i / 4);
        if (cb / W != part) continue;
        const int r = (i / 2) % 2;
        const int row = 16 * warp + lane / 4 + 8 * r;
        store_pair(sO + row * W + cb - part * W + my_col, o[i] / l[r],
                   o[i + 1] / l[r]);
      }
      sm90::fence_proxy_async();
      sm90::named_barrier(1 + wg, 128);
      if (tid == 0) {
        sm90::tma_store_3d(&tm_o, sm90::smem_addr(sO), part * W, row0, bh);
        sm90::tma_store_commit();
        sm90::tma_store_wait_read();
      }
    }
    if (tid == 0) sm90::tma_store_wait();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime (no libcuda link)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D map over a row-major (planes, rows, cols) tensor of `esize`-byte
// elements, boxes of (1, box_rows, box_cols)
int encode(CUtensorMap* map, CUtensorMapDataType type, int esize,
           const void* ptr, int cols, int rows, int planes, int box_cols,
           int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * esize,
      static_cast<cuuint64_t>(cols) * rows * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = fn(map, type, 3, const_cast<void*>(ptr), dims, strides,
                          box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

template <typename TO, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KH, int Sq, int Sk, int D, int causal, float sm_scale,
           cudaStream_t stream) {
  using T = Tile<DP>;
  constexpr CUtensorMapDataType out_type =
      sizeof(TO) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr int out_cols = DP * 2 / static_cast<int>(sizeof(TO));
  CUtensorMap tq, tk, tv, to;
  int err = encode(&tq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, D, Sq, B * H,
                   64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, D, Sk, B * KH,
                 64, T::BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, v, D, Sk, B * KH,
                 64, T::BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode(&to, out_type, static_cast<int>(sizeof(TO)), out, D, Sq,
                 B * H, out_cols, 64, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<TO, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, (Sq + kBM - 1) / kBM, B);
  flash_attention_sm90_kernel<TO, DP><<<grid, kThreads, T::SMEM, stream>>>(
      tq, tk, tv, to, H, KH, Sk, causal,
      static_cast<float>(sm_scale * kLog2e));
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int KH, int Sq, int Sk, int D, int causal, float sm_scale,
             void* stream) {
  if (D < 8 || D % 8 != 0 || D > 256 || KH < 1 || H % KH != 0 || B < 1 ||
      B > 65535 || Sq < 1 || Sk < 1 || (Sq + kBM - 1) / kBM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<TO, 64>(q, k, v, out, B, H, KH, Sq, Sk, D, causal, sm_scale,
                          s);
  if (D <= 128)
    return launch<TO, 128>(q, k, v, out, B, H, KH, Sq, Sk, D, causal,
                           sm_scale, s);
  return launch<TO, 256>(q, k, v, out, B, H, KH, Sq, Sk, D, causal, sm_scale,
                         s);
}

}  // namespace

extern "C" int flash_attention_sm90_bf16(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int H, int KH, int Sq, int Sk, int D,
                                         int causal, float sm_scale,
                                         void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, B, H, KH, Sq, Sk, D, causal,
                                 sm_scale, stream);
}

// the verification entry: the same kernel with an fp32 output
extern "C" int flash_attention_sm90_bf16_f32out(const void* q, const void* k,
                                                const void* v, void* out,
                                                int B, int H, int KH, int Sq,
                                                int Sk, int D, int causal,
                                                float sm_scale, void* stream) {
  return dispatch<float>(q, k, v, out, B, H, KH, Sq, Sk, D, causal, sm_scale,
                         stream);
}
