// Kernel K5 of the port: the Mamba-2 SSD scan in its chunked matmul form.
//
// The recurrence, per batch b and head h, with a (P, N) state:
//
//   h_t = exp(dt_t * A_h) h_{t-1} + (dt_t x_t) B_t^T      y_t = h_t C_t
//
// x: (Bt, S, H, P); dt: (Bt, S, H); A: (H,); B, C: (Bt, S, N); y fp32, no D
// skip. Over a chunk of Q tokens with cum = cumsum(dt * A) (SSD, the state
// space duality):
//
//   y     = ((C B^T) o L) (dt o x) + exp(cum) o (C h0^T)   L[s,t] = exp(cum_s - cum_t), s >= t
//   h_new = exp(total) h0 + (exp(total - cum) o dt o x)^T B
//
// which equals the recurrence for any Q; every exponent is <= 0 (A < 0,
// dt >= 0), so nothing overflows.
//
// Replaces the TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py:69, its
// pallas_call at :79), whose grid ran the chunk axis in order on one core
// and kept the (P, N) state in VMEM scratch. Here one block of 256 threads
// owns one (b, h, p-tile of kPT rows of P) and loops over the chunks in
// order with its slice of the state in shared memory: the P rows of the
// state evolve independently given (dt, A, B, C), so P splits across blocks
// and at zamba2-2.7b's width (H = 80, P = 64) the grid has 160 blocks, not
// 80, for 132 SMs.
//
// Bound: arithmetic. Per chunk and block the three products are Q*Q*N
// (C B^T, lower triangle only), Q*Q*kPT (W (dt o x), lower triangle),
// Q*N*kPT (C h0^T) and Q*kPT*N (the state update) multiply-adds in fp32
// on the CUDA cores, against reads of x, dt, B, C and one write of y
// (C B^T is recomputed by each p-tile's block). The design: each thread
// computes a 4 x 4 tile of C B^T (4 x 2 of y and of the state) from
// float4/float2 reads of shared memory laid out so a warp's reads are
// broadcasts or consecutive (B and C are stored transposed, [n][t], beside
// B's [t][n]); tiles above the diagonal are skipped. The cumulative sum
// over the chunk runs on one thread, in token order.
//
// Plain C interface, loaded with ctypes (src/repro_torch/kernels/
// ssd_scan.py). The entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;         // chunk length, tokens
constexpr int kQP = kQ + 4;    // padded row of the [.][t] layouts
constexpr int kPT = 32;        // rows of P per block
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__host__ __device__ constexpr int padded_n(int N) { return (N + 3) / 4 * 4; }

// floats of shared memory a block uses for state size N
__host__ __device__ constexpr int smem_floats(int N) {
  return kQ * padded_n(N)          // bs   [t][n]
         + 2 * padded_n(N) * kQP   // bT, cT [n][t]
         + kQ * kPT                // xd   [t][p]   dt * x
         + kQ * kQP                // wT   [t][s]   (C B^T o L) transposed
         + padded_n(N) * kPT       // hT   [n][p]   the state
         + 4 * kQ;                 // dts, cum, ecum, decay
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, float* __restrict__ y,
                    int S, int H, int P, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NP = padded_n(N);
  float* bs = smem;
  float* bT = bs + kQ * NP;
  float* cT = bT + NP * kQP;
  float* xd = cT + NP * kQP;
  float* wT = xd + kQ * kPT;
  float* hT = wT + kQ * kQP;
  float* dts = hT + NP * kPT;
  float* cum = dts + kQ;
  float* ecum = cum + kQ;
  float* decay = ecum + kQ;

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float a = A[h];
  const int64_t tok0 = static_cast<int64_t>(b) * S;

  for (int e = tid; e < NP * kPT; e += kThreads) hT[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kQ) {
    // stage the chunk; tokens past S enter as zeros (dt = 0: no decay, no
    // input) and their y is not stored
    for (int e = tid; e < kQ * NP; e += kThreads) {
      const int t = e / NP, n = e % NP;
      const bool in = t0 + t < S && n < N;
      const int64_t at = (tok0 + t0 + t) * N + n;
      const float bv = in ? Bm[at] : 0.f;
      bs[t * NP + n] = bv;
      bT[n * kQP + t] = bv;
      cT[n * kQP + t] = in ? Cm[at] : 0.f;
    }
    for (int e = tid; e < kQ * kPT; e += kThreads) {
      const int t = e / kPT, p = e % kPT;
      const bool in = t0 + t < S && p0 + p < P;
      const int64_t tok = tok0 + t0 + t;
      xd[e] = in ? x[(tok * H + h) * P + p0 + p] * dt[tok * H + h] : 0.f;
    }
    if (tid < kQ) {
      dts[tid] = t0 + tid < S ? dt[(tok0 + t0 + tid) * H + h] : 0.f;
    }
    __syncthreads();

    if (tid == 0) {  // cumsum of the log decays, in token order
      float run = 0.f;
      for (int t = 0; t < kQ; ++t) {
        run += dts[t] * a;
        cum[t] = run;
      }
    }
    __syncthreads();
    const float total = cum[kQ - 1];
    if (tid < kQ) {
      ecum[tid] = expf(cum[tid]);
      decay[tid] = expf(total - cum[tid]);
    }

    // W = (C B^T) o L, stored transposed: wT[t][s]; 4 x 4 tiles, the
    // tiles above the diagonal skipped (the y loop below never reads them)
    {
      const int ts = tid / 16, tt = tid % 16;
      if (tt <= ts) {
        float acc[4][4] = {};
        for (int n = 0; n < NP; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(
              cT + n * kQP + 4 * ts);
          const float4 bv = *reinterpret_cast<const float4*>(
              bT + n * kQP + 4 * tt);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(c4[i], b4[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = 4 * ts + i, t = 4 * tt + j;
            wT[t * kQP + s] = t <= s ? acc[i][j] * expf(cum[s] - cum[t]) : 0.f;
          }
      }
    }
    __syncthreads();

    // y = W (dt o x) + exp(cum) o (C h0^T): rows 4sy..4sy+3, p = 2py, 2py+1
    {
      const int sy = tid / 16, py = tid % 16;
      float yi[4][2] = {}, ye[4][2] = {};
      for (int t = 0; t < 4 * sy + 4; ++t) {
        const float4 wv = *reinterpret_cast<const float4*>(wT + t * kQP + 4 * sy);
        const float2 xv = *reinterpret_cast<const float2*>(xd + t * kPT + 2 * py);
        const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          yi[i][0] = fmaf(w4[i], xv.x, yi[i][0]);
          yi[i][1] = fmaf(w4[i], xv.y, yi[i][1]);
        }
      }
      for (int n = 0; n < NP; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(cT + n * kQP + 4 * sy);
        const float2 hv = *reinterpret_cast<const float2*>(hT + n * kPT + 2 * py);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ye[i][0] = fmaf(c4[i], hv.x, ye[i][0]);
          ye[i][1] = fmaf(c4[i], hv.y, ye[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 4 * sy + i;
        if (t0 + s >= S) continue;
        float* yrow = y + ((tok0 + t0 + s) * H + h) * P + p0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = 2 * py + j;
          if (p0 + p < P) yrow[p] = yi[i][j] + ecum[s] * ye[i][j];
        }
      }
    }
    __syncthreads();

    // h = exp(total) h0 + (decay o dt o x)^T B: n = 4ng..4ng+3, p = 2hp, 2hp+1
    {
      const int hn = tid / 16, hp = tid % 16;
      const float etot = expf(total);
      for (int ng = hn; 4 * ng < NP; ng += 16) {
        float acc[4][2] = {};
        for (int t = 0; t < kQ; ++t) {
          const float4 bv = *reinterpret_cast<const float4*>(bs + t * NP + 4 * ng);
          const float2 xv = *reinterpret_cast<const float2*>(xd + t * kPT + 2 * hp);
          const float x0 = xv.x * decay[t], x1 = xv.y * decay[t];
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(b4[i], x0, acc[i][0]);
            acc[i][1] = fmaf(b4[i], x1, acc[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* hrow = hT + (4 * ng + i) * kPT + 2 * hp;
          hrow[0] = etot * hrow[0] + acc[i][0];
          hrow[1] = etot * hrow[1] + acc[i][1];
        }
      }
    }
    __syncthreads();  // the next chunk's staging overwrites bs, xd, ...
  }
}

}  // namespace

// Returns cudaErrorInvalidValue for an N whose chunk does not fit kMaxSmem
// (N > 220, MAX_N in ssd_scan.py) or a grid the card cannot hold.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, void* y, int Bt,
                            int S, int H, int P, int N, void* stream) {
  const int bytes = smem_floats(N) * 4;
  if (N < 1 || bytes > kMaxSmem || H > 65535 || Bt > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + kPT - 1) / kPT, H, Bt);
  ssd_scan_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
