// Shared pieces of the port's kernels (sm_90a, plain C ABI): the dtype
// helpers and the error string of every kernel library, and the group-
// aggregation kernels' schedule contract.
//
// Schedule contract (built by repro_torch.core.partition and
// repro_torch.kernels.ops.DeviceSchedule):
//   feat            (n_src_pad, d_pad)   f32 | bf16 | f16, row-major
//   nbrs            (T, gpt, gs) int32   global source ids; padded slots
//                                        point at their tile's window base
//   ev              (T, gpt, gs) f32     edge values, 0 on padded slots
//   local_node      (T, gpt) int32       row inside the node block (< ont)
//   tile_node_block (T,) int32           output node block of each tile
//   tile_window     (T,) int32           feature window of each tile
//   run_start       (R+1,) int32         tile bounds of the R maximal runs
//                                        of tiles sharing a node block
//   out             (out_rows, d_pad) f32
// One thread block owns one run (one node block) and one column slice, so
// every output row is written by exactly one block, once: the paper's
// leader-node scheme, with no atomics in device memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kThreads = 256;

enum FeatDtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Dynamic shared memory above the default 48 KB needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

}  // namespace repro_torch

// Each kernel library is one translation unit, so this definition is unique
// per shared object.  The Python wrapper raises with this text.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
