// group_edge_grad: the edge-value cotangent of group aggregation.
//
// Replaces both TPU bodies of `group_edge_grad_pallas`
// (src/repro/kernels/group_aggregate.py:289, `pl.pallas_call` at :351):
// `_edge_grad_kernel` :183 (variants folded, slot_onehot) and
// `_direct_edge_grad_kernel` :224 (variant direct).  One kernel serves
// every variant, because it reads only the real edges' slots: for every
// real slot (t, g, s) of the forward group schedule,
//   out[t,g,s] = sum_c grad[tile_node_block[t]*ont + local_node[t,g], c]
//                      * feat[nbrs[t,g,s], c]
// over all d_pad columns: the gradient of aggregation with respect to the
// slot's edge value.  Loads are in the feature dtype (grad and feat share
// it), products and sums in f32.  Every real slot is written exactly once,
// with no atomics; padded slots are left unwritten (the caller reads only
// real slots).
//
// Operands (row-major, contiguous):
//   grad            (out_rows, d_pad)  f32 | bf16 | f16
//   feat            (n_src_pad, d_pad) same dtype
//   nbrs            (T, gpt, gs) int32
//   local_node      (T, gpt) int32
//   tile_node_block (T,) int32
//   slot_of_edge    (E,) int32     the flat slot (edge_slot * gs +
//                                  edge_pos) of each real edge
//   out             (T, gpt, gs) f32
//
// What bounds it on the H100: latency, then L2 bytes.  At the GAT training
// shape (pubmed replica, 146,214 edges in 2,956,000 slots, D 16, f32) the
// real work is 146,214 x (64 B feature row + 64 B cotangent row), about
// 19 MB, mostly from L2: 0.001 ms at device-memory rates.  Each edge is a
// chain of three dependent round trips (its slot, the slot's neighbour id
// and group row, the two rows), so the time is those round trips over one
// wave of warps.  The earlier designs walked slots: the block kernel every
// slot of a run (95% of them padding) on one block, the direct one every
// slot of the live tiles, a warp per group with a shuffle reduction per
// slot and chunk of 32 columns, and lanes that held at most 64 slots of a
// group.  This one never looks at a padded slot and takes the real slots
// from the schedule (`slot_of_edge`), so its work follows the edges, no run
// is walked serially, and neither the layout nor the group size limits it.
//
// No tensor cores: each edge is one dot product of two rows that no other
// edge shares as a pair, so there is no matrix product to tile.
#include "common.cuh"

namespace repro_torch {

constexpr int kWarps = kThreads / 32;

constexpr int kEdgeUnroll = 4;  // edges per lane group with loads in flight

// lanes per edge in the block kernel: 16-byte pieces of a row, to a power of
// two, at most 32 (wider rows loop)
__host__ __device__ __forceinline__ int edge_lanes(int d_pad, int vec) {
  int lw = 1;
  while (lw < 32 && lw * vec < d_pad) lw <<= 1;
  return lw;
}

// 16-byte pieces of two rows: the f32 dot product of their elements
__device__ __forceinline__ float dot16(float, const uint4& a, const uint4& b) {
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w),
              fmaf(__uint_as_float(a.z), __uint_as_float(b.z),
                   fmaf(__uint_as_float(a.y), __uint_as_float(b.y),
                        __uint_as_float(a.x) * __uint_as_float(b.x))));
}
__device__ __forceinline__ float dot16(__nv_bfloat16, const uint4& a,
                                       const uint4& b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // element 2k is the low half of word k
    s = fmaf(__uint_as_float(wa[k] << 16), __uint_as_float(wb[k] << 16), s);
    s = fmaf(__uint_as_float(wa[k] & 0xffff0000u),
             __uint_as_float(wb[k] & 0xffff0000u), s);
  }
  return s;
}
__device__ __forceinline__ float half_at(uint32_t w, int h) {
  return __half2float(__ushort_as_half((unsigned short)(w >> (16 * h))));
}
__device__ __forceinline__ float dot16(__half, const uint4& a,
                                       const uint4& b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    s = fmaf(half_at(wa[k >> 1], k & 1), half_at(wb[k >> 1], k & 1), s);
  return s;
}

// One lane group of lw lanes per real edge (lw = the row's 16-byte
// pieces up to 32; 32 / lw edges a warp at once, so at D 16 f32 a warp
// works on 8 edges), kEdgeUnroll edges a lane group.  A lane group reads
// its edge's flat slot, then the slot's neighbour id and the group's
// output row, then both rows in 16-byte pieces (lane l on pieces l, l + lw,
// ...), all kEdgeUnroll edges' loads in flight together; each lane sums its
// pieces in column order and a log2(lw)-step butterfly over the lane group
// gives the dot product: a fixed order, so two calls are bit-identical.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_grad_block_kernel(const T* __restrict__ grad, const T* __restrict__ feat,
                       const int* __restrict__ nbrs,
                       const int* __restrict__ local_node,
                       const int* __restrict__ tile_node_block,
                       const int* __restrict__ slot_of_edge,
                       float* __restrict__ out, int num_edges, int gs,
                       int gpt, int ont, int d_pad, int lw) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / lw;
  const int sub = lane / lw;
  const int cl = lane - sub * lw;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t e0 = warp * per_warp * kEdgeUnroll + sub;

  int q[kEdgeUnroll];
  int64_t frow[kEdgeUnroll], grow[kEdgeUnroll];
#pragma unroll
  for (int u = 0; u < kEdgeUnroll; ++u) {
    const int64_t e = e0 + u * per_warp;
    q[u] = e < num_edges ? __ldg(slot_of_edge + e) : -1;
  }
#pragma unroll
  for (int u = 0; u < kEdgeUnroll; ++u) {
    frow[u] = grow[u] = 0;
    if (q[u] >= 0) {
      const int g = q[u] / gs;
      frow[u] = (int64_t)__ldg(nbrs + q[u]) * d_pad;
      grow[u] = ((int64_t)__ldg(tile_node_block + g / gpt) * ont +
                 __ldg(local_node + g)) * d_pad;
    }
  }
  float acc[kEdgeUnroll];
#pragma unroll
  for (int u = 0; u < kEdgeUnroll; ++u) acc[u] = 0.f;
  for (int c = kVec * cl; c < d_pad; c += kVec * lw) {
    uint4 a[kEdgeUnroll], b[kEdgeUnroll];
#pragma unroll
    for (int u = 0; u < kEdgeUnroll; ++u) {
      a[u] = b[u] = make_uint4(0u, 0u, 0u, 0u);
      if (q[u] >= 0) {
        a[u] = __ldg(reinterpret_cast<const uint4*>(grad + grow[u] + c));
        b[u] = __ldg(reinterpret_cast<const uint4*>(feat + frow[u] + c));
      }
    }
#pragma unroll
    for (int u = 0; u < kEdgeUnroll; ++u) acc[u] += dot16(T(), a[u], b[u]);
  }
#pragma unroll
  for (int u = 0; u < kEdgeUnroll; ++u) {
    for (int o = lw >> 1; o > 0; o >>= 1)  // lanes of one group only
      acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
    if (cl == 0 && q[u] >= 0) out[q[u]] = acc[u];
  }
}

template <typename T>
static int launch_block(const void* grad, const void* feat, const int* nbrs,
                        const int* local_node, const int* tile_node_block,
                        const int* slot_of_edge, float* out, int num_edges,
                        int gs, int gpt, int ont, int d_pad,
                        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (num_edges <= 0 || d_pad % kVec) return (int)cudaErrorInvalidValue;
  const int lw = edge_lanes(d_pad, kVec);
  const int64_t per_block = (int64_t)kWarps * (32 / lw) * kEdgeUnroll;
  const int64_t blocks = (num_edges + per_block - 1) / per_block;
  edge_grad_block_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(feat), nbrs,
      local_node, tile_node_block, slot_of_edge, out, num_edges, gs, gpt, ont,
      d_pad, lw);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int repro_group_edge_grad_block(
    int dtype, const void* grad, const void* feat, const int* nbrs,
    const int* local_node, const int* tile_node_block, const int* slot_of_edge,
    float* out, int num_edges, int gs, int gpt, int ont, int d_pad,
    void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_block<float>(grad, feat, nbrs, local_node,
                                 tile_node_block, slot_of_edge, out, num_edges,
                                 gs, gpt, ont, d_pad, s);
    case kBF16:
      return launch_block<__nv_bfloat16>(grad, feat, nbrs, local_node,
                                         tile_node_block, slot_of_edge, out,
                                         num_edges, gs, gpt, ont, d_pad, s);
    case kF16:
      return launch_block<__half>(grad, feat, nbrs, local_node,
                                  tile_node_block, slot_of_edge, out,
                                  num_edges, gs, gpt, ont, d_pad, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
