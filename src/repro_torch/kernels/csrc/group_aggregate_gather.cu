// group_aggregate_gather: the `direct` gather variant of group aggregation.
//
// Replaces the TPU body `_direct_kernel` (src/repro/kernels/group_aggregate.py:117,
// launched by `group_aggregate_pallas` at :446).  Computes
//   out[nb*ont + local_node[t,g], c] = sum_t,g sum_s ev[t,g,s] * feat[nbrs[t,g,s], c]
// over the group schedule.
//
// Mapping (the paper's own GPU mapping): one thread block per (run of tiles
// sharing a node block, dim tile of `dt` columns).  The block's threads
// stride over the flattened (group, column) items of each tile: consecutive
// threads take consecutive columns of one group's neighbor rows (the
// paper's dimWorker, coalesced), and successive thread groups take the
// next groups (partSize).  Each item sums its group's `gs` slots in a
// register (f32, loads in the feature dtype), then adds it into an
// ont x dt f32 accumulator in shared memory.  The accumulator is zeroed at
// the run's start and flushed once at its end: one writer per output row,
// no atomics in device memory.
//
// What bounds it: device-memory bytes.  Each slot reads one `dt`-wide row
// slice of `feat` (4 or 2 bytes per element) for 2 FLOP per element, far
// below the card's operations-per-byte balance point.  The design keeps
// every other byte out of device memory (indices are read once per item
// through the read-only path, the accumulator lives in shared memory) and
// relies on L2 to absorb rows that several groups of a window share.
// Double-buffered window staging (cp.async / TMA) is a later step.
#include "common.cuh"

namespace repro_torch {

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ feat, const int* __restrict__ nbrs,
              const float* __restrict__ ev, const int* __restrict__ local_node,
              const int* __restrict__ tile_node_block,
              const int* __restrict__ run_start, float* __restrict__ out,
              int gs, int gpt, int ont, int d_pad, int dt) {
  extern __shared__ float acc[];  // ont * dt
  const int t0 = run_start[blockIdx.x];
  const int t1 = run_start[blockIdx.x + 1];
  const int col0 = blockIdx.y * dt;
  const int width = min(dt, d_pad - col0);

  for (int i = threadIdx.x; i < ont * dt; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int items = gpt * width;
  for (int t = t0; t < t1; ++t) {
    const int64_t slot0 = (int64_t)t * gpt * gs;
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int g = it / width;
      const int c = it - g * width;
      const int64_t s0 = slot0 + (int64_t)g * gs;
      const T* col = feat + col0 + c;
      float sum = 0.f;
      for (int s = 0; s < gs; ++s) {
        const float w = __ldg(ev + s0 + s);
        const int64_t row = __ldg(nbrs + s0 + s);
        sum = fmaf(w, to_f32(col[row * d_pad]), sum);
      }
      const int ln = __ldg(local_node + (int64_t)t * gpt + g);
      // several groups of one tile may share a target row: shared-memory
      // atomics resolve that inside the block
      atomicAdd(&acc[ln * dt + c], sum);
    }
  }
  __syncthreads();

  const int64_t row0 = (int64_t)tile_node_block[t0] * ont;
  for (int i = threadIdx.x; i < ont * width; i += blockDim.x) {
    const int r = i / width;
    const int c = i - r * width;
    out[(row0 + r) * d_pad + col0 + c] = acc[r * dt + c];
  }
}

template <typename T>
static int launch(const void* feat, const int* nbrs, const float* ev,
                  const int* local_node, const int* tile_node_block,
                  const int* run_start, float* out, int num_runs, int gs,
                  int gpt, int ont, int d_pad, int dt, int smem_bytes,
                  cudaStream_t stream) {
  auto kernel = gather_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(num_runs, (d_pad + dt - 1) / dt);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(feat), nbrs, ev, local_node, tile_node_block,
      run_start, out, gs, gpt, ont, d_pad, dt);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int repro_group_aggregate_gather(
    int dtype, const void* feat, const int* nbrs, const float* ev,
    const int* local_node, const int* tile_node_block, const int* run_start,
    float* out, int num_runs, int gs, int gpt, int ont, int d_pad, int dt,
    int smem_bytes, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(feat, nbrs, ev, local_node, tile_node_block,
                           run_start, out, num_runs, gs, gpt, ont, d_pad, dt,
                           smem_bytes, s);
    case kBF16:
      return launch<__nv_bfloat16>(feat, nbrs, ev, local_node,
                                   tile_node_block, run_start, out, num_runs,
                                   gs, gpt, ont, d_pad, dt, smem_bytes, s);
    case kF16:
      return launch<__half>(feat, nbrs, ev, local_node, tile_node_block,
                            run_start, out, num_runs, gs, gpt, ont, d_pad, dt,
                            smem_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
