// Kernel K6 of the port: the Mamba-1 selective scan.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      h: (d, N) per batch
//   y_t = h_t C_t + D * x_t
//
// with x, dt: (Bt, S, d); A: (d, N); B, C: (Bt, S, N); D: (d,); y fp32.
//
// Replaces the TPU kernel `selective_scan` (src/repro/kernels/
// selective_scan.py:54, its pallas_call at :80), which ran the sequence
// chunks of its grid in order on one core and carried the (d_block, N)
// state in VMEM scratch. Here the state lives in registers and the
// sequence is walked inside the block.
//
// Bound: bytes. x, dt and y are S * d floats each per batch row, against
// A, B, C and D, which are small: 403,734,528 bytes, 0.1205 ms at 3.35 TB/s
// for falcon-mamba-7b's mixer (Bt=1, S=4096, d=8192, N=16). The exp of
// every (token, channel, state), 536,870,912 there, needs about 0.13 ms a
// pass on the SFU at 16 a clock per SM, so a design that walks the
// sequence twice pays that twice.
//
// The recurrence's dependency chain is one FMA a token; the exps and loads
// are off it. What held a simple design back is latency with too few
// chains in flight. The design:
//
//   - L = 4, 8 or 16 lanes per channel, each holding two states (N / L;
//     one for N <= 4, three or four for N > 32; the five (L, states) pairs
//     of `selective_scan_f32` are built) and A's row for them in registers;
//     32 channels a block. y's sum over the states is a transposed shuffle
//     reduction over the channel's lanes: for L tokens at a time, L - 1
//     shuffles a lane leave lane g with the sum of token g, about one
//     shuffle a token instead of log2(L).
//   - x, dt, B and C arrive in chunks of 32 tokens through a cp.async
//     double buffer, the next chunk in flight while this one is walked; y
//     goes out through shared memory in coalesced rows.
//   - Where Bt * d * L threads fill less than about 16 warps an SM, the
//     sequence is split into `npieces` pieces (the wrapper picks it):
//     pass 1 computes each piece's end state from zero and its decay
//     exp(A * sum dt) into a (Bt, npieces, d, N) workspace, pass 2 carries
//     the states across pieces in order, and pass 3 re-runs each piece from
//     its true initial state and writes y. With one piece, one launch does
//     it all and no exp is paid twice: falcon-mamba-7b's full width (8192
//     channels x 8 lanes, 15.5 warps an SM on 132 SMs) takes one piece.
//   - exp(dt A) as 2^(dt A log2(e)) on the SFU (ex2.approx.ftz, with A
//     scaled once): one instruction instead of expf's range reduction,
//     within the error cap against the plain version (chip_smoke.py).
//
// Plain C interface, loaded with ctypes (src/repro_torch/kernels/
// selective_scan.py, which picks L and the pieces and allocates the
// workspace). The entry point returns the first launch's error, if any.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kCB = 32;      // channels per block
constexpr int kT = 32;       // tokens per staged chunk
constexpr int kMaxN = 64;
constexpr float kLog2e = 1.4426950408889634f;

template <int L, int NPT>
__host__ __device__ constexpr int smem_floats() {
  // two buffers of x, dt [kT][kCB] and B, C [kT][L * NPT], then y
  return 2 * kT * (2 * kCB + 2 * L * NPT) + kT * (kCB + 32 / L);
}

// 2^x on the SFU (ex2.approx.ftz, about 2 ulp); a result below 2^-126
// flushes to 0, where a decay is 0 to fp32's last bit anyway
__device__ __forceinline__ float exp2_sfu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// After it, lane g of each group of L lanes holds in v[0] the sum over the
// group's lanes of their v[g]: a reduce-scatter by halves, L - 1 shuffles.
// Step K exchanges the halves of v[0 .. 2K) with lane g ^ K; written as a
// recursion so that every index into v is a constant and v stays in
// registers.
template <int L, int K>
struct TransposeReduce {
  static __device__ __forceinline__ void run(float (&v)[L], int g) {
    const bool upper = (g & K) != 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float send = upper ? v[i] : v[i + K];
      const float keep = upper ? v[i + K] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, K);
    }
    TransposeReduce<L, K / 2>::run(v, g);
  }
};
template <int L>
struct TransposeReduce<L, 0> {
  static __device__ __forceinline__ void run(float (&)[L], int) {}
};

// grid (ceil(d / kCB), pieces, Bt). kOut: walk piece blockIdx.y from the
// state the carry left in `state` (zero for piece 0) and write y; else
// walk it from zero and write its end state and decay to `state`, `decay`.
template <int L, int NPT, bool kOut>
__global__ void __launch_bounds__(32 * L, 1024 / (32 * L))
    selective_scan_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ Dk,
                          float* __restrict__ y, float* __restrict__ state,
                          float* __restrict__ decay, int S, int d, int N,
                          int piece, int npieces, bool vec_xd, bool vec_bc) {
  constexpr int kThreads = 32 * L;
  constexpr int NB = L * NPT;
  constexpr int kBuf = kT * (2 * kCB + 2 * NB);
  constexpr int kYld = kCB + 32 / L;  // lanes of a warp write distinct banks
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ys = smem + 2 * kBuf;

  const int tid = threadIdx.x;
  const int lc = tid / L, g = tid % L;
  const int c0 = blockIdx.x * kCB;
  const int ch = c0 + lc;
  const bool live = ch < d;
  const int j = blockIdx.y, b = blockIdx.z;
  const int s0 = j * piece;
  const int len = min(piece, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int64_t at = ((static_cast<int64_t>(b) * npieces + j) * d + ch) * N;

  float a[NPT], h[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int n = g * NPT + i;
    const bool in = live && n < N;
    a[i] = in ? A[static_cast<int64_t>(ch) * N + n] * kLog2e : 0.f;
    h[i] = (kOut && j > 0 && in) ? state[at + n] : 0.f;
  }
  const float dskip = (kOut && live) ? Dk[ch] : 0.f;
  float dtsum = 0.f;

  auto stage = [&](int k, float* buf) {
    const int t0 = k * kT;
    const int vrows = min(kT, len - t0);
    const int vc = min(kCB, d - c0);
    const int64_t r = row0 + t0;
    stage_tile<kThreads>(buf, kCB, x + r * d + c0, d, kT, kCB, vrows, vc,
                         vec_xd);
    stage_tile<kThreads>(buf + kT * kCB, kCB, dt + r * d + c0, d, kT, kCB,
                         vrows, vc, vec_xd);
    stage_tile<kThreads>(buf + 2 * kT * kCB, NB, Bm + r * N, N, kT, NB,
                         vrows, N, vec_bc);
    if (kOut) {
      stage_tile<kThreads>(buf + 2 * kT * kCB + kT * NB, NB, Cm + r * N, N,
                           kT, NB, vrows, N, vec_bc);
    }
  };

  const int nchunks = (len + kT - 1) / kT;
  stage(0, smem);
  cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    const float* cur = smem + (k & 1) * kBuf;
    if (k + 1 < nchunks) {
      stage(k + 1, smem + ((k + 1) & 1) * kBuf);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = cur;
    const float* dts = xs + kT * kCB;
    const float* bs = dts + kT * kCB;
    const float* cs = bs + kT * NB;

#pragma unroll
    for (int tg = 0; tg < kT; tg += L) {
      float part[L];
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const int t = tg + u;
        const float xt = xs[t * kCB + lc];
        const float dtt = dts[t * kCB + lc];
        const float dtx = dtt * xt;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NPT; ++i) {
          const int n = g * NPT + i;
          const float dA = exp2_sfu(dtt * a[i]);
          h[i] = fmaf(dA, h[i], dtx * bs[t * NB + n]);
          if (kOut) acc = fmaf(h[i], cs[t * NB + n], acc);
        }
        part[u] = acc;
        if (!kOut) dtsum += dtt;
      }
      if (kOut) {
        TransposeReduce<L, L / 2>::run(part, g);
        const int t = tg + g;
        ys[t * kYld + lc] = part[0] + xs[t * kCB + lc] * dskip;
      }
    }
    __syncthreads();  // the chunk's buffer is staged again next; ys is read
    if (kOut) {
      for (int e = tid; e < kT * kCB; e += kThreads) {
        const int t = e / kCB, c = e % kCB;
        if (k * kT + t < len && c0 + c < d) {
          y[(row0 + k * kT + t) * d + c0 + c] = ys[t * kYld + c];
        }
      }
    }
  }

  if (!kOut) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int n = g * NPT + i;
      if (live && n < N) {
        state[at + n] = h[i];
        decay[at + n] = exp2_sfu(a[i] * dtsum);
      }
    }
  }
}

// one thread per (b, channel, n): state[j] becomes the state entering
// piece j, h_0 = 0, h_{j+1} = decay_j h_j + end_j
__global__ void __launch_bounds__(256)
    selective_scan_carry(float* __restrict__ state,
                         const float* __restrict__ decay, int64_t Bt,
                         int npieces, int64_t dN) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= Bt * dN) return;
  const int64_t b = i / dN, e = i % dN;
  float* st = state + b * npieces * dN + e;
  const float* dc = decay + b * npieces * dN + e;
  float hcur = 0.f;
  for (int j0 = 0; j0 < npieces - 1; j0 += 8) {
    float sv[8], dv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      sv[u] = j0 + u < npieces - 1 ? st[(j0 + u) * dN] : 0.f;
      dv[u] = j0 + u < npieces - 1 ? dc[(j0 + u) * dN] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (j0 + u < npieces - 1) {
        st[(j0 + u) * dN] = hcur;
        hcur = dv[u] * hcur + sv[u];
      }
    }
  }
  st[(npieces - 1) * dN] = hcur;
}

template <int L, int NPT>
int launch(const float* x, const float* dt, const float* A, const float* B,
           const float* C, const float* D, float* y, float* state,
           float* decay, int Bt, int S, int d, int N, int piece, int npieces,
           cudaStream_t stream, int* launched) {
  constexpr int bytes = smem_floats<L, NPT>() * 4;
  const bool vec_xd = vec_ok(x, d, d) && vec_ok(dt, d, d);
  const bool vec_bc = vec_ok(B, N, N) && vec_ok(C, N, N);
  const unsigned cblocks = (d + kCB - 1) / kCB;
  cudaError_t err;
  if (npieces > 1) {
    err = cudaFuncSetAttribute(selective_scan_kernel<L, NPT, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    selective_scan_kernel<L, NPT, false>
        <<<dim3(cblocks, npieces - 1, Bt), 32 * L, bytes, stream>>>(
            x, dt, A, B, C, D, y, state, decay, S, d, N, piece, npieces,
            vec_xd, vec_bc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
    const int64_t dN = static_cast<int64_t>(d) * N;
    selective_scan_carry<<<static_cast<unsigned>((Bt * dN + 255) / 256), 256,
                           0, stream>>>(state, decay, Bt, npieces, dN);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  err = cudaFuncSetAttribute(selective_scan_kernel<L, NPT, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  selective_scan_kernel<L, NPT, true>
      <<<dim3(cblocks, npieces, Bt), 32 * L, bytes, stream>>>(
          x, dt, A, B, C, D, y, state, decay, S, d, N, piece, npieces,
          vec_xd, vec_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  return 0;
}

}  // namespace

// One launch (npieces == 1) or three (pieces, carry, outputs) on `stream`,
// with L lanes per channel and pieces of `piece` tokens, npieces =
// ceil(S / piece); state and decay are (Bt, npieces, d, N) when npieces >
// 1 (unread otherwise). Adds to *launched one for each kernel launched
// without an error. Returns cudaErrorInvalidValue for N outside [1, kMaxN],
// an (L, states a lane) pair the kernel is not built for, or a grid the
// card cannot hold, else the first launch's error.
extern "C" int selective_scan_f32(const void* x, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  const void* D, void* y, void* state,
                                  void* decay, int Bt, int S, int d, int N,
                                  int L, int piece, void* stream,
                                  int* launched) {
  if (N < 1 || N > kMaxN || Bt > 65535 || piece < 1 || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int npieces = (S + piece - 1) / piece;
  if (npieces > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int npt = (N + L - 1) / L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  const float* Cf = static_cast<const float*>(C);
  const float* Df = static_cast<const float*>(D);
  float* yf = static_cast<float*>(y);
  float* stf = static_cast<float*>(state);
  float* dcf = static_cast<float*>(decay);
  using Launch = int (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*, float*,
                        float*, float*, int, int, int, int, int, int,
                        cudaStream_t, int*);
  // the pairs lanes(N) in selective_scan.py takes: (lanes, states a lane)
  // (4, 1) and (4, 2) to N = 8, (8, 2) to 16, (16, 2) to 32, (16, 4) to 64
  Launch run = nullptr;
  if (L == 4 && npt == 1) run = launch<4, 1>;
  if (L == 4 && npt == 2) run = launch<4, 2>;
  if (L == 8 && npt == 2) run = launch<8, 2>;
  if (L == 16 && npt == 2) run = launch<16, 2>;
  if (L == 16 && (npt == 3 || npt == 4)) run = launch<16, 4>;
  if (run != nullptr) {
    return run(xf, dtf, Af, Bf, Cf, Df, yf, stf, dcf, Bt, S, d, N, piece,
               npieces, s, launched);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
