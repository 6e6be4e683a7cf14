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
// separate tensor) and write out: 2*n*M*bytes of HBM traffic (3 with msg)
// at 3.35 TB/s, 2.508 us at the main path's call (n=256, M=4096, k=4,
// fp32). The arithmetic, (2k+1)*n*M flops, is two orders of magnitude below
// the fp32 peak. Both kernels below accumulate in fp32 in the same order,
// acc = w_self[i] * z[i], then acc = fmaf(w_edge[i, j], msg[S_in[i, j]],
// acc) for j = 0 .. k-1, and round once to z's dtype: they give the same
// bits.
//
//   - The slab kernel, launched whenever it takes the call and n (k + 1)
//     >= kSlabMinReads (below): a block owns a
//     slab of columns of all n rows of msg in shared memory (128 bytes a
//     row, less at large n), staged once by cp.async, with S_in and the
//     weights of all rows, which it checks once; each element of msg then
//     leaves L2 once a call, not k + 1 times. At n=1024, M=65536 that is
//     what keeps it near the HBM bytes (the register kernel reads every
//     neighbor row again from L2 or HBM). Staging the slab by Hopper's 1-D
//     bulk copies (TMA), one a row, was 2.4x slower on the H100 (PERF.md).
//     A slab round stages n x 128 bytes a block, too few at small n to
//     keep HBM busy (at n = 2, 16 of 256 threads copy), while the register
//     kernel reads k + 1 rows for each row it writes. Timed against each
//     other on the H100 (scripts/profile_torch_k1_forms.py, PERF.md),
//     the slab kernel was faster at LM leaves (M from 16.8M to 525M bf16)
//     where the n (k + 1) row reads a column come to 60 or more and slower
//     below (7.7x at the LM pod mix, n = 2, k = 1); at M of 4096 to 16384
//     fp32 both take 2-15 us, the register kernel faster by under 1 us
//     up to n = 128, the two even at the dense main path's n = 256, k = 4.
//   - The register kernel, for what the slab kernel does not take: ragged
//     M and unaligned views (one element a thread), k > 8, n (k + 1) below
//     kSlabMinReads, and n too large for the slab's shared memory. A
//     block owns one node row i and a span
//     of M in 16-byte packets (float4, 8 x bf16); each thread loads its
//     slots' indices and weights (broadcast loads), checks them, then
//     issues all k + 1 row loads of its 2 packets before the first FMA, so
//     that no row load waits on the one before.
//
// The entry points report the kernel they launched through `form` (0 the
// register kernel, 1 the slab kernel), which gossip_mix.py counts.
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

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kPackets = 2;         // K1 register kernel: packets a thread
constexpr int kMaxSlots = 8;        // and slots a pass above k = 8
constexpr int kStages = 1;          // K1 slab kernel: slabs a block holds
constexpr int kSlabBytes = 65536;   // and bytes of slabs in them
constexpr int kSlabMinReads = 60;   // and the fewest n (k + 1) it takes
constexpr int kMaxSmem = 232448;    // shared memory a block may use
constexpr int kSmemPerSM = 233472;  // and an SM holds
constexpr int kSmemUnasked = 49152;  // dynamic shared memory without opt-in
constexpr int kMaxDevices = 64;
constexpr int kRegs = 0, kSlab = 1;  // the `form` an entry point reports

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

// ---- K1, register kernel ----------------------------------------------------

// grid.x spans M, kPackets packets of V elements a thread, grid.y walks node
// rows. Slots go in passes of S (S = K when k is a template constant, else
// kMaxSlots and the last pass short): a pass loads its S indices and
// weights, checks the indices, then issues all its row loads before the
// first FMA, so a thread has S * kPackets loads in flight.
template <typename T, int V, int K>
__global__ void __launch_bounds__(kThreads)
    gossip_mix_regs(const T* __restrict__ z, const T* __restrict__ msg,
                    const int64_t* __restrict__ s_in,
                    const float* __restrict__ w_self,
                    const float* __restrict__ w_edge, T* __restrict__ out,
                    int n, int k, int M) {
  constexpr int S = K ? K : kMaxSlots;
  int64_t m[kPackets];
  bool in[kPackets];
#pragma unroll
  for (int p = 0; p < kPackets; ++p) {
    m[p] = (static_cast<int64_t>(blockIdx.x) * kPackets + p) * kThreads * V +
           threadIdx.x * V;
    in[p] = m[p] < M;
  }
  if (!in[0]) return;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const int64_t row = static_cast<int64_t>(i) * M;
    float acc[kPackets][V], buf[kPackets][V];
    const float ws = w_self[i];
#pragma unroll
    for (int p = 0; p < kPackets; ++p)
      if (in[p]) load<T, V>(z + row + m[p], buf[p]);
#pragma unroll
    for (int p = 0; p < kPackets; ++p)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[p][e] = ws * buf[p][e];
    for (int j0 = 0; j0 < k; j0 += S) {
      const int cnt = K ? K : min(S, k - j0);
      const int64_t* srow = s_in + static_cast<int64_t>(i) * k + j0;
      const float* wrow = w_edge + static_cast<int64_t>(i) * k + j0;
      int64_t src[S];
      float we[S], nb[S][kPackets][V];
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (j < cnt) {
          src[j] = srow[j];
          we[j] = wrow[j];
        }
#pragma unroll
      for (int j = 0; j < S; ++j)
        if (j < cnt) assert(src[j] >= 0 && src[j] < n);
#pragma unroll
      for (int j = 0; j < S; ++j)
#pragma unroll
        for (int p = 0; p < kPackets; ++p)
          if (j < cnt && in[p]) load<T, V>(msg + src[j] * M + m[p], nb[j][p]);
#pragma unroll
      for (int j = 0; j < S; ++j)
#pragma unroll
        for (int p = 0; p < kPackets; ++p)
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (j < cnt) acc[p][e] = fmaf(we[j], nb[j][p][e], acc[p][e]);
    }
#pragma unroll
    for (int p = 0; p < kPackets; ++p)
      if (in[p]) store<T, V>(out + row + m[p], acc[p]);
  }
}

template <typename T, int V>
void launch_regs(const T* z, const T* msg, const int64_t* s_in,
                 const float* w_self, const float* w_edge, T* out, int n,
                 int k, int M, cudaStream_t s) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kPackets * V;
  const dim3 grid(static_cast<unsigned>((M + per_block - 1) / per_block),
                  n < kMaxGridY ? n : kMaxGridY);
#define REPRO_K1_REGS(KK)                                          \
  gossip_mix_regs<T, V, KK><<<grid, kThreads, 0, s>>>(z, msg, s_in, \
                                                      w_self, w_edge, out, \
                                                      n, k, M)
  switch (k) {
    case 1: REPRO_K1_REGS(1); break;
    case 2: REPRO_K1_REGS(2); break;
    case 3: REPRO_K1_REGS(3); break;
    case 4: REPRO_K1_REGS(4); break;
    case 5: REPRO_K1_REGS(5); break;
    case 6: REPRO_K1_REGS(6); break;
    case 7: REPRO_K1_REGS(7); break;
    case 8: REPRO_K1_REGS(8); break;
    default: REPRO_K1_REGS(0);
  }
#undef REPRO_K1_REGS
}

// ---- K1, slab kernel --------------------------------------------------------

// A block owns a slab of cw columns of all n rows of msg in shared memory,
// so each element of msg leaves L2 (or HBM) once a call, not once for each
// row that reads it as in the register kernel. The slab arrives by
// cp.async, 16 bytes a thread-copy from all threads. S_in (as int32),
// w_edge and w_self, n (8k + 4) bytes, are loaded into shared memory and
// checked once per block while the first slab's copies are in flight. A
// persistent grid walks the slabs, kStages of them in flight a block: one,
// so that more blocks share an SM and slabs are wider at large n (two were
// slower at n = 1024 on the H100); the blocks of an SM overlap one's
// copies with another's combine. Thread t combines packet t % np of rows
// t / np, t / np + 256 / np, ... of the slab (np = cw / V packets a row, a
// power of two): self from the slab when msg is z, else from z, then the k
// slots in order, and stores 16 bytes.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    gossip_mix_slab(const T* __restrict__ z, const T* __restrict__ msg,
                    const int64_t* __restrict__ s_in,
                    const float* __restrict__ w_self,
                    const float* __restrict__ w_edge, T* __restrict__ out,
                    int n, int M, int cw, int nslabs, int meta,
                    int stage_bytes) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  int* sidx = reinterpret_cast<int*>(smem + 128);
  float* swe = reinterpret_cast<float*>(sidx + n * K);
  float* sws = swe + n * K;
  unsigned char* stages = smem + meta;
  auto columns = [&](int slab) {  // columns of slab `slab` (the last short)
    const int64_t left = M - static_cast<int64_t>(slab) * cw;
    return static_cast<int>(left < cw ? left : cw);
  };
  // slab r of this block into stage r % kStages by every thread with
  // cp.async, one commit group a slab (empty past the last)
  auto issue = [&](int r) {
    const int slab = blockIdx.x + r * gridDim.x;
    unsigned char* dst = stages + (r % kStages) * stage_bytes;
    const T* src = msg + static_cast<int64_t>(slab) * cw;
    if (slab < nslabs) {
      const int cpr = cw * static_cast<int>(sizeof(T)) / 16;
      const int used = columns(slab) * static_cast<int>(sizeof(T)) / 16;
      for (int e = threadIdx.x; e < n * cpr; e += kThreads) {
        const int i = e / cpr, c = e % cpr;
        if (c < used)
          cp_async16(reinterpret_cast<float*>(dst + e * 16),
                     reinterpret_cast<const float*>(
                         src + static_cast<int64_t>(i) * M + c * V),
                     true);
      }
    }
    cp_async_commit();
  };
  for (int r = 0; r < kStages; ++r) issue(r);
  for (int e = threadIdx.x; e < n * K; e += kThreads) {
    const int64_t src = s_in[e];
    swe[e] = w_edge[e];
    assert(src >= 0 && src < n);
    sidx[e] = static_cast<int>(src);
  }
  for (int i = threadIdx.x; i < n; i += kThreads) sws[i] = w_self[i];
  __syncthreads();

  const int np = cw / V;
  const int p = threadIdx.x % np;
  const bool self_in_slab = z == msg;
  for (int r = 0;; ++r) {
    const int slab = blockIdx.x + r * gridDim.x;
    if (slab >= nslabs) break;
    const int st = r % kStages;
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* rows = reinterpret_cast<const T*>(stages + st * stage_bytes);
    const int64_t c0 = static_cast<int64_t>(slab) * cw + p * V;
    if (p * V < columns(slab)) {
      for (int i = threadIdx.x / np; i < n; i += kThreads / np) {
        float acc[V], buf[V], nb[K][V];
        if (self_in_slab) {
          load<T, V>(rows + i * cw + p * V, buf);
        } else {
          load<T, V>(z + static_cast<int64_t>(i) * M + c0, buf);
        }
#pragma unroll
        for (int j = 0; j < K; ++j)
          load<T, V>(rows + sidx[i * K + j] * cw + p * V, nb[j]);
        const float ws = sws[i];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = ws * buf[e];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float we = swe[i * K + j];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fmaf(we, nb[j][e], acc[e]);
        }
        store<T, V>(out + static_cast<int64_t>(i) * M + c0, acc);
      }
    }
    __syncthreads();  // every thread is done with stage st
    issue(r + kStages);
  }
}

// the slab kernel for k = K with `b` bytes of shared memory; the opt-in
// above 48 KB is asked once per device and size, so that a call below it
// (the main path's: n = 256, k = 4, 42 KB) makes no host call but its
// launch
template <typename T, int K>
void run_slab(const T* z, const T* msg, const int64_t* s_in,
              const float* w_self, const float* w_edge, T* out, int n, int M,
              int cw, int nslabs, int meta, int stage_bytes, int b,
              int blocks, cudaStream_t s) {
  static int opted[kMaxDevices] = {};
  if (b > kSmemUnasked) {
    int device = 0;
    cudaGetDevice(&device);
    if (device >= kMaxDevices || b > opted[device]) {
      cudaFuncSetAttribute(gossip_mix_slab<T, K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, b);
      if (device < kMaxDevices) opted[device] = b;
    }
  }
  gossip_mix_slab<T, K><<<blocks, kThreads, b, s>>>(
      z, msg, s_in, w_self, w_edge, out, n, M, cw, nslabs, meta,
      stage_bytes);
}

// the slab kernel for k <= kMaxSlots and n (k + 1) >= min_reads while its
// shared memory fits, on a card of `sms` SMs; returns false (nothing
// launched) otherwise
template <typename T>
bool launch_slab(const T* z, const T* msg, const int64_t* s_in,
                 const float* w_self, const float* w_edge, T* out, int n,
                 int k, int M, int sms, int min_reads, cudaStream_t s) {
  if (k > kMaxSlots || static_cast<int64_t>(n) * (k + 1) < min_reads) {
    return false;
  }
  // slabs of 128 bytes a row while kStages slabs of n rows fit kSlabBytes,
  // narrower down to 16, and no wider than a row
  const int64_t row_bytes = static_cast<int64_t>(M) * sizeof(T);
  int cb = 128;
  while (cb > 16 && (kStages * n * cb > kSlabBytes || cb > row_bytes)) cb /= 2;
  const int cw = cb / static_cast<int>(sizeof(T));
  const int nslabs = static_cast<int>((M + cw - 1) / cw);
  const int64_t meta = (128 + static_cast<int64_t>(n) * (8 * k + 4) + 127) /
                       128 * 128;
  const int64_t stage_bytes = static_cast<int64_t>(n) * cb;
  const int64_t bytes = meta + kStages * stage_bytes;
  if (bytes > kMaxSmem) return false;
  int per_sm = static_cast<int>(kSmemPerSM / (bytes + 1024));
  if (per_sm > 2048 / kThreads) per_sm = 2048 / kThreads;
  if (per_sm < 1) per_sm = 1;
  const int blocks = nslabs < sms * per_sm ? nslabs : sms * per_sm;
#define REPRO_K1_SLAB(KK)                                                  \
  case KK:                                                                 \
    run_slab<T, KK>(z, msg, s_in, w_self, w_edge, out, n, M, cw, nslabs,   \
                    static_cast<int>(meta), static_cast<int>(stage_bytes), \
                    static_cast<int>(bytes), blocks, s);                   \
    break;
  switch (k) {
    REPRO_K1_SLAB(1)
    REPRO_K1_SLAB(2)
    REPRO_K1_SLAB(3)
    REPRO_K1_SLAB(4)
    REPRO_K1_SLAB(5)
    REPRO_K1_SLAB(6)
    REPRO_K1_SLAB(7)
    REPRO_K1_SLAB(8)
  }
#undef REPRO_K1_SLAB
  return true;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// K1: the slab kernel when M and the pointers allow 16-byte packets, k <=
// kMaxSlots, n (k + 1) >= kSlabMinReads and its shared memory fits, else
// the register kernel (in packets, or one element at a time). *form asks
// on entry: kRegs for the register kernel, kSlab for the slab kernel at
// any n (k + 1) (to time the two against each other), anything else for
// the choice above; the one launched goes to *form
template <typename T>
int launch(const void* z, const void* msg, const void* s_in,
           const void* w_self, const void* w_edge, void* out, int n, int k,
           int M, int sms, int* form, void* stream) {
  const int asked = *form;
  constexpr int V = 16 / sizeof(T);
  const bool packed =
      M % V == 0 && aligned16(z) && aligned16(msg) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* zt = static_cast<const T*>(z);
  const T* mt = static_cast<const T*>(msg);
  const int64_t* st = static_cast<const int64_t*>(s_in);
  const float* ws = static_cast<const float*>(w_self);
  const float* we = static_cast<const float*>(w_edge);
  T* ot = static_cast<T*>(out);
  if (!packed) {
    launch_regs<T, 1>(zt, mt, st, ws, we, ot, n, k, M, s);
    *form = kRegs;
  } else if (asked != kRegs &&
             launch_slab<T>(zt, mt, st, ws, we, ot, n, k, M, sms,
                            asked == kSlab ? 0 : kSlabMinReads, s)) {
    *form = kSlab;
  } else {
    launch_regs<T, V>(zt, mt, st, ws, we, ot, n, k, M, s);
    *form = kRegs;
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

// kSlabMinReads, for the checks that mirror the choice of kernel
extern "C" int gossip_mix_slab_min_reads() { return kSlabMinReads; }

extern "C" int gossip_mix_f32(const void* z, const void* msg,
                              const void* s_in, const void* w_self,
                              const void* w_edge, void* out, int n, int k,
                              int M, int sms, int* form, void* stream) {
  return launch<float>(z, msg, s_in, w_self, w_edge, out, n, k, M, sms, form,
                       stream);
}

extern "C" int gossip_mix_bf16(const void* z, const void* msg,
                               const void* s_in, const void* w_self,
                               const void* w_edge, void* out, int n, int k,
                               int M, int sms, int* form, void* stream) {
  return launch<__nv_bfloat16>(z, msg, s_in, w_self, w_edge, out, n, k, M,
                               sms, form, stream);
}
