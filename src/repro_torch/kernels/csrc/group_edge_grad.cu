// group_edge_grad: the edge-value cotangent of group aggregation, two kernels.
//
// Replaces the TPU bodies of `group_edge_grad_pallas`
// (src/repro/kernels/group_aggregate.py:289, `pl.pallas_call` at :351):
//   block  <- `_edge_grad_kernel` :183         (variants folded, slot_onehot)
//   gather <- `_direct_edge_grad_kernel` :224  (variant direct)
// Both compute, for every slot (t, g, s) of the forward group schedule,
//   out[t,g,s] = sum_c grad[tile_node_block[t]*ont + local_node[t,g], c]
//                      * feat[nbrs[t,g,s], c]
// over all d_pad columns: the gradient of aggregation with respect to the
// slot's edge value.  Loads are in the feature dtype (grad and feat share
// it), products and sums in f32.  Padded slots point at their window's base
// row and padded groups at row 0 of the node block, so every read is in
// bounds; their results are don't-care (the caller reads only real slots).
//
// Operands (row-major, contiguous):
//   grad            (out_rows, d_pad)  f32 | bf16 | f16
//   feat            (n_src_pad, d_pad) same dtype
//   nbrs            (T, gpt, gs) int32
//   local_node      (T, gpt) int32
//   tile_node_block (T,) int32
//   run_start       (R+1,) int32   tile bounds of the live runs
//   out             (T, gpt, gs) f32; slots of tiles past run_start[R]
//                                  (pad tiles) are left unwritten
//
// What bounds both: device-memory bytes.  Each slot reads one feature row
// (d_pad elements) for 2 FLOP per element; the cotangent rows are shared by
// all slots of a group (gather) or of a whole node block (block), so they
// are read once from device memory and reused from registers or shared
// memory.  Each output is written exactly once, with no atomics: the TPU
// kernel's revisits of the output block over the sequential dim-tile grid
// axis become a loop over column chunks inside one thread block, with the
// per-slot partial sums carried in registers.
#include "common.cuh"

namespace repro_torch {

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// block: one thread block per run of tiles sharing a node block (the
// forward kernels' leader-node mapping, `DeviceSchedule.run_start`).  The
// run's slots are contiguous in memory; the block walks them in chunks of
// kThreads slots, lane l of warp w owning slot chunk0 + 32 w + l and its f32
// partial sum in a register.  For each column chunk of `dc` columns the
// block stages the node block's ont x dc cotangent rows in shared memory
// (converted to f32); each warp then takes its 32 slots one after another,
// lanes over the chunk's columns reading the neighbor's feature row from
// device memory and the cotangent row from shared memory, and a shuffle
// reduction hands the slot's chunk sum to its owning lane.  After the last
// column chunk every lane stores its slot once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_grad_block_kernel(const T* __restrict__ grad, const T* __restrict__ feat,
                       const int* __restrict__ nbrs,
                       const int* __restrict__ local_node,
                       const int* __restrict__ tile_node_block,
                       const int* __restrict__ run_start,
                       float* __restrict__ out, int gs, int gpt, int ont,
                       int d_pad, int dc) {
  extern __shared__ float gsm[];  // ont * dc staged cotangent rows
  const int t0 = run_start[blockIdx.x];
  const int t1 = run_start[blockIdx.x + 1];
  const int64_t q_begin = (int64_t)t0 * gpt * gs;
  const int64_t q_end = (int64_t)t1 * gpt * gs;
  const int64_t row0 = (int64_t)tile_node_block[t0] * ont;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int64_t chunk = q_begin; chunk < q_end; chunk += kThreads) {
    // this lane's slot: its neighbor row and its row in the node block
    const int64_t q = chunk + warp * 32 + lane;
    const bool live = q < q_end;
    const int my_nbr = live ? __ldg(nbrs + q) : 0;
    const int my_ln = live ? __ldg(local_node + q / gs) : 0;
    float acc = 0.f;
    for (int c0 = 0; c0 < d_pad; c0 += dc) {
      const int width = min(dc, d_pad - c0);
      __syncthreads();  // previous chunk's readers are done with gsm
      for (int i = threadIdx.x; i < ont * width; i += blockDim.x) {
        const int r = i / width;
        const int c = i - r * width;
        gsm[r * dc + c] = to_f32(grad[(row0 + r) * d_pad + c0 + c]);
      }
      __syncthreads();  // cotangent chunk staged
      const int64_t rest = q_end - (chunk + warp * 32);
      const int n_live = rest < 32 ? (int)rest : 32;
      for (int j = 0; j < n_live; ++j) {  // warp-uniform bound
        const int64_t nbr = __shfl_sync(0xffffffffu, my_nbr, j);
        const int ln = __shfl_sync(0xffffffffu, my_ln, j);
        const T* frow = feat + nbr * d_pad + c0;
        const float* grow = gsm + ln * dc;
        float part = 0.f;
        for (int c = lane; c < width; c += 32)
          part = fmaf(grow[c], to_f32(frow[c]), part);
        part = warp_sum(part);
        if (lane == j) acc += part;
      }
    }
    if (live) out[q] = acc;
  }
}

// gather: one warp per group, over the live tiles' groups.  For each chunk
// of 32 columns every lane loads one cotangent element of the group's row
// (the row is read once), then for each slot one feature element; a
// shuffle reduction gives the slot's chunk sum, which lane s % 32 adds to
// its register (two registers per lane cover gs <= 64, the search space's
// largest group).  Lane s stores slot s once at the end.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_grad_gather_kernel(const T* __restrict__ grad, const T* __restrict__ feat,
                        const int* __restrict__ nbrs,
                        const int* __restrict__ local_node,
                        const int* __restrict__ tile_node_block,
                        const int* __restrict__ run_start,
                        float* __restrict__ out, int num_runs, int gs, int gpt,
                        int ont, int d_pad) {
  const int64_t group = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int64_t live_groups = (int64_t)run_start[num_runs] * gpt;
  if (group >= live_groups) return;  // warp-uniform: pad tiles stay unwritten
  const int t = (int)(group / gpt);
  const int64_t row =
      (int64_t)tile_node_block[t] * ont + __ldg(local_node + group);
  const int* slot_nbr = nbrs + group * gs;
  const T* grow = grad + row * d_pad;

  float acc_lo = 0.f, acc_hi = 0.f;  // slots lane and 32 + lane
  for (int c0 = 0; c0 < d_pad; c0 += 32) {
    const int c = c0 + lane;
    const bool in = c < d_pad;
    const float gv = in ? to_f32(grow[c]) : 0.f;
    for (int s = 0; s < gs; ++s) {
      const int64_t nbr = __ldg(slot_nbr + s);
      float part = in ? gv * to_f32(feat[nbr * d_pad + c]) : 0.f;
      part = warp_sum(part);
      if (lane == (s & 31)) {
        if (s < 32) acc_lo += part;
        else acc_hi += part;
      }
    }
  }
  float* o = out + group * gs;
  if (lane < gs) o[lane] = acc_lo;
  if (32 + lane < gs) o[32 + lane] = acc_hi;
}

template <typename T>
static int launch_block(const void* grad, const void* feat, const int* nbrs,
                        const int* local_node, const int* tile_node_block,
                        const int* run_start, float* out, int num_runs, int gs,
                        int gpt, int ont, int d_pad, int dc, int smem_bytes,
                        cudaStream_t stream) {
  auto kernel = edge_grad_block_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<num_runs, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(feat), nbrs,
      local_node, tile_node_block, run_start, out, gs, gpt, ont, d_pad, dc);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_gather(const void* grad, const void* feat, const int* nbrs,
                         const int* local_node, const int* tile_node_block,
                         const int* run_start, float* out, int num_runs,
                         int num_tiles, int gs, int gpt, int ont, int d_pad,
                         cudaStream_t stream) {
  const int64_t groups = (int64_t)num_tiles * gpt;
  const int blocks = (int)((groups + kWarps - 1) / kWarps);
  edge_grad_gather_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(feat), nbrs,
      local_node, tile_node_block, run_start, out, num_runs, gs, gpt, ont,
      d_pad);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int repro_group_edge_grad_block(
    int dtype, const void* grad, const void* feat, const int* nbrs,
    const int* local_node, const int* tile_node_block, const int* run_start,
    float* out, int num_runs, int gs, int gpt, int ont, int d_pad, int dc,
    int smem_bytes, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_block<float>(grad, feat, nbrs, local_node,
                                 tile_node_block, run_start, out, num_runs, gs,
                                 gpt, ont, d_pad, dc, smem_bytes, s);
    case kBF16:
      return launch_block<__nv_bfloat16>(grad, feat, nbrs, local_node,
                                         tile_node_block, run_start, out,
                                         num_runs, gs, gpt, ont, d_pad, dc,
                                         smem_bytes, s);
    case kF16:
      return launch_block<__half>(grad, feat, nbrs, local_node,
                                  tile_node_block, run_start, out, num_runs,
                                  gs, gpt, ont, d_pad, dc, smem_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int repro_group_edge_grad_gather(
    int dtype, const void* grad, const void* feat, const int* nbrs,
    const int* local_node, const int* tile_node_block, const int* run_start,
    float* out, int num_runs, int num_tiles, int gs, int gpt, int ont,
    int d_pad, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_gather<float>(grad, feat, nbrs, local_node,
                                  tile_node_block, run_start, out, num_runs,
                                  num_tiles, gs, gpt, ont, d_pad, s);
    case kBF16:
      return launch_gather<__nv_bfloat16>(grad, feat, nbrs, local_node,
                                          tile_node_block, run_start, out,
                                          num_runs, num_tiles, gs, gpt, ont,
                                          d_pad, s);
    case kF16:
      return launch_gather<__half>(grad, feat, nbrs, local_node,
                                   tile_node_block, run_start, out, num_runs,
                                   num_tiles, gs, gpt, ont, d_pad, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
