// Kernel K6 of the port: the Mamba-1 selective scan.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      h: (d, N) per batch
//   y_t = h_t C_t + D * x_t
//
// with x, dt: (Bt, S, d); A: (d, N); B, C: (Bt, S, N); D: (d,); y fp32.
//
// Replaces the TPU kernel `selective_scan` (src/repro/kernels/
// selective_scan.py:54, its pallas_call at :80). The TPU kernel ran the
// sequence-chunk axis of its grid in order on one core and carried the
// (d_block, N) state in VMEM scratch from one chunk to the next; here the
// chunk loop runs inside the block and the state lives in registers.
//
// Bound: data movement. x, dt and y are S * d floats each per batch row,
// against A, B, C and D, which are small; about 7 flops and one exp per
// (token, channel, state) stay under the bytes' time at N = 16. What holds
// a simple design back is latency: the recurrence is sequential in S, so
// the parallelism is Bt * d channels. The design: four threads per
// channel, each holding ceil(N / 4) of its states and of A's row in
// registers (four times the threads one thread per channel would give),
// 32 channels per block of 128 threads. A block stages a chunk of kChunk
// tokens of x and dt (coalesced rows of 32 channels) and of B and C (read
// by every channel of the block, so loaded once) in shared memory, walks
// the chunk from there, sums y over its four threads with shuffles and
// writes the chunk's y back in coalesced rows. expf, not __expf: the
// tolerance against the plain version is tight.
//
// Plain C interface, loaded with ctypes (src/repro_torch/kernels/
// selective_scan.py). The entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;       // threads per channel
constexpr int kChannels = 32;   // channels per block
constexpr int kThreads = kLanes * kChannels;
constexpr int kChunk = 32;      // tokens staged in shared memory at a time
constexpr int kMaxN = 64;

// NPT states per thread; thread g of a channel holds n = g * NPT + i.
template <int NPT>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ Dk,
                          float* __restrict__ y, int S, int d, int N) {
  __shared__ float xs[kChunk][kChannels];
  __shared__ float dts[kChunk][kChannels];
  __shared__ float ys[kChunk][kChannels];
  __shared__ float bs[kChunk][kLanes * NPT];
  __shared__ float cs[kChunk][kLanes * NPT];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int lc = threadIdx.x / kLanes;  // channel within the block
  const int g = threadIdx.x % kLanes;   // which quarter of the states
  const int ch = c0 + lc;
  const bool live = ch < d;

  float a[NPT], h[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) {
    const int n = g * NPT + i;
    a[i] = (live && n < N) ? A[static_cast<int64_t>(ch) * N + n] : 0.f;
    h[i] = 0.f;
  }
  const float dskip = live ? Dk[ch] : 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * S;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    // stage the chunk: x and dt rows of this block's channels, B and C rows
    for (int e = threadIdx.x; e < kChunk * kChannels; e += kThreads) {
      const int t = e / kChannels, c = e % kChannels;
      const bool in = t0 + t < S && c0 + c < d;
      const int64_t at = (row0 + t0 + t) * d + c0 + c;
      xs[t][c] = in ? x[at] : 0.f;
      dts[t][c] = in ? dt[at] : 0.f;
    }
    for (int e = threadIdx.x; e < kChunk * kLanes * NPT; e += kThreads) {
      const int t = e / (kLanes * NPT), n = e % (kLanes * NPT);
      const bool in = t0 + t < S && n < N;
      const int64_t at = (row0 + t0 + t) * N + n;
      bs[t][n] = in ? Bm[at] : 0.f;
      cs[t][n] = in ? Cm[at] : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < kChunk; ++t) {
      const float xt = xs[t][lc];
      const float dtt = dts[t][lc];
      const float dtx = dtt * xt;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int n = g * NPT + i;
        const float dA = expf(dtt * a[i]);
        h[i] = dA * h[i] + dtx * bs[t][n];
        acc = fmaf(h[i], cs[t][n], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) ys[t][lc] = acc + xt * dskip;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < kChunk * kChannels; e += kThreads) {
      const int t = e / kChannels, c = e % kChannels;
      if (t0 + t < S && c0 + c < d) y[(row0 + t0 + t) * d + c0 + c] = ys[t][c];
    }
    // the next chunk's staging writes xs, dts, bs and cs, which the store
    // above does not read; ys is written again only after the next barrier
  }
}

template <int NPT>
void launch(const float* x, const float* dt, const float* A, const float* B,
            const float* C, const float* D, float* y, int Bt, int S, int d,
            int N, cudaStream_t s) {
  const dim3 grid((d + kChannels - 1) / kChannels, Bt);
  selective_scan_kernel<NPT><<<grid, kThreads, 0, s>>>(x, dt, A, B, C, D, y,
                                                       S, d, N);
}

}  // namespace

// Returns cudaErrorInvalidValue for N outside [1, kMaxN] or a batch count
// the grid cannot hold.
extern "C" int selective_scan_f32(const void* x, const void* dt,
                                  const void* A, const void* B, const void* C,
                                  const void* D, void* y, int Bt, int S,
                                  int d, int N, void* stream) {
  if (N < 1 || N > kMaxN || Bt > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(B);
  const float* Cf = static_cast<const float*>(C);
  const float* Df = static_cast<const float*>(D);
  float* yf = static_cast<float*>(y);
  const int npt = (N + kLanes - 1) / kLanes;
  if (npt <= 1) {
    launch<1>(xf, dtf, Af, Bf, Cf, Df, yf, Bt, S, d, N, s);
  } else if (npt <= 2) {
    launch<2>(xf, dtf, Af, Bf, Cf, Df, yf, Bt, S, d, N, s);
  } else if (npt <= 4) {
    launch<4>(xf, dtf, Af, Bf, Cf, Df, yf, Bt, S, d, N, s);
  } else if (npt <= 8) {
    launch<8>(xf, dtf, Af, Bf, Cf, Df, yf, Bt, S, d, N, s);
  } else {
    launch<16>(xf, dtf, Af, Bf, Cf, Df, yf, Bt, S, d, N, s);
  }
  return static_cast<int>(cudaGetLastError());
}
