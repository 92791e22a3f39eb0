// group_aggregate_onehot: the `folded` and `slot_onehot` gather variants of
// group aggregation, one template with a compile-time switch.
//
// Replaces the TPU body `_kernel` (src/repro/kernels/group_aggregate.py:67,
// launched by `group_aggregate_pallas` at :446).  Same function as the
// gather kernel; the gather is a dense product against the tile's feature
// window through a one-hot gather matrix:
//   folded: W[g, r] = sum_s ev[g,s] * 1[local[g,s] == r];  per_group = W @ window
//   slot:   W[g*gs+s, r] = ev[g,s] * 1[local[g,s] == r];   per_group = sum_s (W @ window)
// then per_group rows scatter into the node block: acc[local_node[g]] += per_group[g].
//
// Mapping: one thread block per (run of tiles sharing a node block, column
// slice of `dc` columns).  Shared memory never holds a whole window: per
// tile, groups go in chunks of `gc` and window rows in chunks of `ch`; for
// each (group chunk, row chunk) the block builds the W chunk (gc or gc*gs
// rows x ch) and stages the feature chunk (ch x dc, converted to f32) in
// shared memory, multiplies with plain FMA into a gc x dc per-group
// accumulator, and after the last row chunk scatters the group rows into
// the ont x dc node-block accumulator.  The node-block accumulator is zeroed
// at the run's start and flushed once: one writer per output row, no
// atomics anywhere.  The chunk sizes come from
// repro_torch.kernels.group_aggregate.launch_geometry, which the tuner's
// shared-memory bound (core/model.py, Eq. 4) prices, so every config the
// tuner accepts launches.
//
// What bounds it: operations.  The dense product costs 2*rows*src_win*dc
// FLOP per tile and column slice (rows = gc or gc*gs per chunk) where the
// function needs 2*gs*dc per group; the W build is a compare per slot and
// window row.  Row chunks that no slot of the group chunk hits are skipped
// after the W build (one block-wide vote), which removes most of the dense
// work on sparse windows without changing the result.  A tensor-core
// (wgmma) product is a later step.
#include "common.cuh"

namespace repro_torch {

template <typename T, bool kFolded>
__global__ void __launch_bounds__(kThreads)
onehot_kernel(const T* __restrict__ feat, const int* __restrict__ nbrs,
              const float* __restrict__ ev, const int* __restrict__ local_node,
              const int* __restrict__ tile_node_block,
              const int* __restrict__ tile_window,
              const int* __restrict__ run_start, float* __restrict__ out,
              int gs, int gpt, int ont, int src_win, int d_pad, int gc, int ch,
              int dc) {
  extern __shared__ float smem[];
  const int wrows = kFolded ? gc : gc * gs;
  float* acc = smem;            // ont * dc   node-block accumulator
  float* pg = acc + ont * dc;   // gc * dc    per-group accumulator
  float* fch = pg + gc * dc;    // ch * dc    staged feature chunk (f32)
  float* w = fch + ch * dc;     // wrows * ch gather-matrix chunk

  const int t0 = run_start[blockIdx.x];
  const int t1 = run_start[blockIdx.x + 1];
  const int col0 = blockIdx.y * dc;
  const int width = min(dc, d_pad - col0);

  for (int i = threadIdx.x; i < ont * dc; i += blockDim.x) acc[i] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int base = tile_window[t] * src_win;
    const int64_t slot0 = (int64_t)t * gpt * gs;
    for (int g0 = 0; g0 < gpt; g0 += gc) {
      const int ng = min(gc, gpt - g0);
      for (int i = threadIdx.x; i < gc * dc; i += blockDim.x) pg[i] = 0.f;
      for (int r0 = 0; r0 < src_win; r0 += ch) {
        const int nr = min(ch, src_win - r0);
        for (int i = threadIdx.x; i < wrows * ch; i += blockDim.x) w[i] = 0.f;
        __syncthreads();  // W zeroed (and pg zeroed, previous reads done)

        int hit = 0;
        if (kFolded) {
          // one thread owns one group's W row: the intra-group sum of
          // duplicate neighbors needs no atomics
          for (int g = threadIdx.x; g < ng; g += blockDim.x) {
            const int64_t s0 = slot0 + (int64_t)(g0 + g) * gs;
            for (int s = 0; s < gs; ++s) {
              const int loc = __ldg(nbrs + s0 + s) - base - r0;
              if (loc >= 0 && loc < nr) {
                w[g * ch + loc] += __ldg(ev + s0 + s);
                hit = 1;
              }
            }
          }
        } else {
          const int64_t s0 = slot0 + (int64_t)g0 * gs;
          for (int q = threadIdx.x; q < ng * gs; q += blockDim.x) {
            const int loc = __ldg(nbrs + s0 + q) - base - r0;
            if (loc >= 0 && loc < nr) {
              w[q * ch + loc] = __ldg(ev + s0 + q);
              hit = 1;
            }
          }
        }
        if (!__syncthreads_or(hit)) continue;  // no slot in this row chunk

        for (int i = threadIdx.x; i < nr * width; i += blockDim.x) {
          const int r = i / width;
          const int c = i - r * width;
          fch[r * dc + c] =
              to_f32(feat[(int64_t)(base + r0 + r) * d_pad + col0 + c]);
        }
        __syncthreads();  // feature chunk staged

        for (int i = threadIdx.x; i < ng * width; i += blockDim.x) {
          const int g = i / width;
          const int c = i - g * width;
          float sum = 0.f;
          if (kFolded) {
            const float* wr = w + g * ch;
            for (int r = 0; r < nr; ++r) sum = fmaf(wr[r], fch[r * dc + c], sum);
          } else {
            for (int s = 0; s < gs; ++s) {
              const float* wr = w + (g * gs + s) * ch;
              for (int r = 0; r < nr; ++r)
                sum = fmaf(wr[r], fch[r * dc + c], sum);
            }
          }
          pg[g * dc + c] += sum;
        }
        __syncthreads();  // product done before W / fch are overwritten
      }
      // scatter the group rows into the node block: one thread per column
      // walks the groups in order, so rows shared by groups need no atomics
      for (int c = threadIdx.x; c < width; c += blockDim.x) {
        const int* ln = local_node + (int64_t)t * gpt + g0;
        for (int g = 0; g < ng; ++g) acc[__ldg(ln + g) * dc + c] += pg[g * dc + c];
      }
      __syncthreads();  // pg read before the next group chunk zeroes it
    }
  }
  __syncthreads();

  const int64_t row0 = (int64_t)tile_node_block[t0] * ont;
  for (int i = threadIdx.x; i < ont * width; i += blockDim.x) {
    const int r = i / width;
    const int c = i - r * width;
    out[(row0 + r) * d_pad + col0 + c] = acc[r * dc + c];
  }
}

template <typename T, bool kFolded>
static int launch(const void* feat, const int* nbrs, const float* ev,
                  const int* local_node, const int* tile_node_block,
                  const int* tile_window, const int* run_start, float* out,
                  int num_runs, int gs, int gpt, int ont, int src_win,
                  int d_pad, int gc, int ch, int dc, int smem_bytes,
                  cudaStream_t stream) {
  auto kernel = onehot_kernel<T, kFolded>;
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(num_runs, (d_pad + dc - 1) / dc);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(feat), nbrs, ev, local_node, tile_node_block,
      tile_window, run_start, out, gs, gpt, ont, src_win, d_pad, gc, ch, dc);
  return (int)cudaGetLastError();
}

template <bool kFolded>
static int dispatch(int dtype, const void* feat, const int* nbrs,
                    const float* ev, const int* local_node,
                    const int* tile_node_block, const int* tile_window,
                    const int* run_start, float* out, int num_runs, int gs,
                    int gpt, int ont, int src_win, int d_pad, int gc, int ch,
                    int dc, int smem_bytes, cudaStream_t s) {
  switch (dtype) {
    case kF32:
      return launch<float, kFolded>(feat, nbrs, ev, local_node,
                                    tile_node_block, tile_window, run_start,
                                    out, num_runs, gs, gpt, ont, src_win,
                                    d_pad, gc, ch, dc, smem_bytes, s);
    case kBF16:
      return launch<__nv_bfloat16, kFolded>(
          feat, nbrs, ev, local_node, tile_node_block, tile_window, run_start,
          out, num_runs, gs, gpt, ont, src_win, d_pad, gc, ch, dc, smem_bytes,
          s);
    case kF16:
      return launch<__half, kFolded>(feat, nbrs, ev, local_node,
                                     tile_node_block, tile_window, run_start,
                                     out, num_runs, gs, gpt, ont, src_win,
                                     d_pad, gc, ch, dc, smem_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro_torch

extern "C" int repro_group_aggregate_onehot(
    int folded, int dtype, const void* feat, const int* nbrs, const float* ev,
    const int* local_node, const int* tile_node_block, const int* tile_window,
    const int* run_start, float* out, int num_runs, int gs, int gpt, int ont,
    int src_win, int d_pad, int gc, int ch, int dc, int smem_bytes,
    void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (folded)
    return dispatch<true>(dtype, feat, nbrs, ev, local_node, tile_node_block,
                          tile_window, run_start, out, num_runs, gs, gpt, ont,
                          src_win, d_pad, gc, ch, dc, smem_bytes, s);
  return dispatch<false>(dtype, feat, nbrs, ev, local_node, tile_node_block,
                         tile_window, run_start, out, num_runs, gs, gpt, ont,
                         src_win, d_pad, gc, ch, dc, smem_bytes, s);
}
