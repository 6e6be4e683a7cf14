// Asynchronous staging of row-major float tiles from device memory into
// shared memory with `cp.async` (sm_80 and later), shared by the scan
// kernels ssd_scan.cu and selective_scan.cu.
//
// `stage_tile` issues the copies of one tile and returns at once; the
// caller groups them with `cp_async_commit` and waits with
// `cp_async_wait<n>` (at most n groups still in flight) and a barrier
// before it reads the tile. Elements outside the valid rows and columns
// arrive as 0 (the copy's source size is 0), so a ragged edge needs no
// branch in the code that reads the tile.
//
// Header only; included by the .cu files (build.py hashes it with them).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros when `in` is false (the source is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes, or a zero when `in` is false
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy a rows x cols tile into shared memory at `dst` (row stride `ld`
// floats; cols and ld multiples of 4) from `src` (row stride `gstride`
// floats). Row r and column c are copied when r < vrows and c < vcols,
// else 0 is written. With `vec` the copies are 16 bytes wide; the caller
// sets it only when `src` and `gstride` keep every row 16-byte aligned and
// vcols % 4 == 0 (vec_ok). All kThreads threads of the block call it with
// the same arguments.
template <int kThreads>
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const float* src, int64_t gstride,
                                           int rows, int cols, int vrows,
                                           int vcols, bool vec) {
  // element e = r * width + c of the tile, r and c stepped without a
  // division in the loop
  const int width = vec ? cols / 4 : cols;
  const int step = vec ? 4 : 1;
  const int dr = kThreads / width, dc = kThreads % width;
  int r = threadIdx.x / width, c = threadIdx.x % width;
  for (; r < rows; r += dr, c += dc) {
    if (c >= width) {
      c -= width;
      ++r;
      if (r >= rows) break;
    }
    const int col = c * step;
    const bool in = r < vrows && col < vcols;
    const float* from = in ? src + r * gstride + col : src;
    if (vec) {
      cp_async16(dst + r * ld + col, from, in);
    } else {
      cp_async4(dst + r * ld + col, from, in);
    }
  }
}

// Whether a tile of rows `gstride` floats apart starting at `src` can be
// copied 16 bytes at a time (see stage_tile).
__host__ __device__ inline bool vec_ok(const float* src, int64_t gstride,
                                       int vcols) {
  return (reinterpret_cast<uintptr_t>(src) & 15) == 0 && gstride % 4 == 0 &&
         vcols % 4 == 0;
}
