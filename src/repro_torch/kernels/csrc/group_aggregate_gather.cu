// group_aggregate_gather: the `direct` gather variant of group aggregation.
//
// Replaces the TPU body `_direct_kernel` (src/repro/kernels/group_aggregate.py:117,
// launched by `group_aggregate_pallas` at :446).  Computes
//   out[nb*ont + local_node[t,g], c] = sum_t,g sum_s ev[t,g,s] * feat[nbrs[t,g,s], c]
// over the group schedule: per slot, one gathered row of `feat`.
//
// What bounds it on the H100: latency, then bytes.  At the GIN serving shape
// (127,722 edges, D 500 -> 504 columns, f32) the rows the real edges read
// are 257 MB from a 33 MB feature matrix that stays in the 50 MB L2, about
// 0.05 ms at L2 rates, and 68% of the slots of the live tiles are padding
// (ev == 0).  The earlier design walked every slot of a run on one block,
// each item a gs-long chain of dependent id and row loads (1.45 ms).  Here
// a block is a short chain of dependent round trips (run bounds, slot
// metadata, kUnroll-deep rounds of row loads, the partials' sum), and the
// launch ends with its longest run: one node block of the GIN shape holds
// 3,010 live slots, 94 rounds of row loads for each of its blocks, and
// sets the launch's time even when it starts first.  On full reddit
// (18.6M edges, D 64) the floor is bytes: 4.8 GB of rows, the 60 MB matrix
// partly in L2, and the padded slot metadata read once from device memory
// (0.93 GB, 0.28 ms).  PERF.md has the times and the timeline.
//
// Mapping.  One thread block per (run of tiles sharing a node block, column
// slice of `dc` = min(dt, 128) columns), as the schedule contract in
// common.cuh sets out.  The runs launch longest first (`run_order`), a
// run's slices neighbours in launch order, so the longest run overlaps the
// rest instead of starting late and ending the launch alone.  The run's
// slots are cut into 32-slot chunks and kWarps (8) warps split them (warp
// w takes chunks w, w + 8, ...), so a long run is walked by all of the
// block's warps:
//   * a lane loads one slot's id, value and group row per chunk, kAhead
//     chunks a batch, the next batch's loads in flight while this one is
//     listed (plain coalesced loads: the kernel takes any gs and gpt);
//     `__ballot_sync` appends the live slots (ev != 0) in slot order to the
//     warp's list (row, value, output row) in shared memory;
//   * when the list is full and at the run's end the warp walks it: lw
//     lanes an entry, kCols (4) neighbouring columns a lane in one load (16
//     bytes of f32, 8 of bf16 / f16, converted in registers), so 32 / lw
//     entries at once, and kUnroll entries per lane with their row loads in
//     flight together; each entry is `fmaf`-ed in f32 into the warp's
//     private ont x dc partial (one per lane group) in shared memory;
//   * at the run's end the block sums the partials in a fixed order and
//     writes the slice of the node block once.
// Work follows the live slots, not the padded tile; no atomics anywhere and
// a fixed summation order, so two calls give bit-identical output.  Four
// columns a lane (not 16 bytes of 16-bit elements) keep the partials at
// 4 KB a warp at ont 8, so 4 blocks of 8 warps fit an SM for every dtype.
// `launch_geometry` in repro_torch.kernels.group_aggregate mirrors `Layout`
// and is the one source of the shared memory; the kernel refuses a launch
// whose `smem_bytes` differs from its own layout.
//
// No tensor cores: an `mma` k-step needs 16 rows of one window per tile,
// and the planner's tiles touch far fewer distinct rows (the one-hot
// kernel's source note has the counts).
#include <type_traits>

#include "common.cuh"

namespace repro_torch {

constexpr int kWarps = 8;      // warps per block
constexpr int kCols = 4;       // neighbouring columns a lane loads at once
constexpr int kListCap = 128;  // live-slot list entries per warp
constexpr int kAhead = 2;      // 32-slot chunks per metadata batch
constexpr int kUnroll = 4;     // list entries per lane per round of row loads
constexpr int kMinBlocks = 4;  // blocks per SM the register budget is set for

// The block's shared memory: one ont x dc f32 partial per warp and lane
// group, then each warp's list.  Mirrored by
// repro_torch.kernels.group_aggregate.launch_geometry.
struct Layout {
  int lw, parts_floats, total;
  __host__ __device__ Layout(int ont, int dc) {
    lw = 1;  // lanes per entry: the slice row's kCols-column pieces, to a power of two
    while (lw * kCols < dc) lw <<= 1;
    parts_floats = kWarps * (32 / lw) * ont * dc;
    total = 4 * parts_floats + 12 * kWarps * kListCap;
  }
};

// kCols neighbouring feature elements: one load (16 bytes of f32, 8 of bf16
// or f16) and their floats (16-bit types exactly)
template <typename T>
using Raw = std::conditional_t<sizeof(T) == 4, uint4, uint2>;

__device__ __forceinline__ void unpack(float, const uint4& v, float* x) {
  x[0] = __uint_as_float(v.x), x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z), x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(__nv_bfloat16, const uint2& v,
                                       float* x) {
  // element 2k is the low half of word k; a bf16 is a float's high half
  x[0] = __uint_as_float(v.x << 16), x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16), x[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ float half_bits(uint32_t h) {
  return __half2float(__ushort_as_half((unsigned short)h));
}
__device__ __forceinline__ void unpack(__half, const uint2& v, float* x) {
  x[0] = half_bits(v.x & 0xffffu), x[1] = half_bits(v.x >> 16);
  x[2] = half_bits(v.y & 0xffffu), x[3] = half_bits(v.y >> 16);
}

// one metadata batch: a lane's slot in each of kAhead chunks
struct Meta {
  int nb[kAhead], ln[kAhead];
  float w[kAhead];
};

// 64 registers a thread: 4 blocks of 8 warps per SM, with kUnroll row loads
// in flight per lane and the next metadata batch, without spills (at
// kUnroll 8 the f32 instantiation spills).
template <typename T>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
gather_kernel(const T* __restrict__ feat, const int* __restrict__ nbrs,
              const float* __restrict__ ev, const int* __restrict__ local_node,
              const int* __restrict__ tile_node_block,
              const int* __restrict__ run_start,
              const int* __restrict__ run_order, float* __restrict__ out,
              int gs, int gpt, int ont, int d_pad, int dc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(ont, dc);
  float* parts = reinterpret_cast<float*>(smem);
  int* lists = reinterpret_cast<int*>(parts + lay.parts_floats);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // block -> (run, column slice): runs in `run_order` (longest first, so
  // the launch does not end on a long run started late), a run's slices
  // neighbours in launch order
  const int slices = (d_pad + dc - 1) / dc;
  const int nth = blockIdx.x / slices;
  const int run = run_order[nth];
  const int t0 = run_start[run];
  const int t1 = run_start[run + 1];
  const int col0 = (blockIdx.x - nth * slices) * dc;
  const int width = min(dc, d_pad - col0);
  const int64_t g0 = (int64_t)t0 * gpt;  // the run's first group
  const int nslots = (t1 - t0) * gpt * gs;
  const int nchunks = (nslots + 31) >> 5;
  const bool gpow2 = (gs & (gs - 1)) == 0;
  const int gshift = __ffs(gs) - 1;

  // the warp's batch starting at chunk j: chunks j, j + kWarps, ...
  auto load = [&](int j) {
    Meta m;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int s = ((j + k * kWarps) << 5) + lane;  // slot within the run
      m.nb[k] = m.ln[k] = 0;
      m.w[k] = 0.f;
      if (s < nslots) {
        const int64_t q = g0 * gs + s;
        m.nb[k] = __ldg(nbrs + q);
        m.w[k] = __ldg(ev + q);
        m.ln[k] = __ldg(local_node + g0 + (gpow2 ? s >> gshift : s / gs));
      }
    }
    return m;
  };
  Meta cur = load(warp);  // in flight while the partials are zeroed

  for (int i = threadIdx.x; i < lay.parts_floats / 4; i += blockDim.x)
    reinterpret_cast<float4*>(parts)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int lw = lay.lw;
  const int nsub = 32 / lw;
  const int sub = lane / lw;
  const int c = kCols * (lane - sub * lw);  // this lane's columns in the slice
  const bool has_cols = c < width;
  float* part = parts + (warp * nsub + sub) * ont * dc;
  int* lrow = lists + warp * 3 * kListCap;
  float* lwt = reinterpret_cast<float*>(lrow + kListCap);
  int* lln = lrow + 2 * kListCap;
  const unsigned below = (1u << lane) - 1u;

  // walk the list's first `len` entries: lane group `sub` takes entries
  // sub, sub + nsub, ..., kUnroll at a time, in list order
  auto flush = [&](int len) {
    __syncwarp();
    for (int b = sub; b < len; b += nsub * kUnroll) {
      Raw<T> f[kUnroll];  // kUnroll row loads in flight
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = b + u * nsub;
        f[u] = {};
        if (e < len && has_cols)
          f[u] = __ldg(reinterpret_cast<const Raw<T>*>(
              feat + (int64_t)lrow[e] * d_pad + col0 + c));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = b + u * nsub;
        if (e < len && has_cols) {
          float x[kCols];
          unpack(T(), f[u], x);
          const float wt = lwt[e];
          float4* a = reinterpret_cast<float4*>(part + lln[e] * dc + c);
          float4 acc = *a;
          acc.x = fmaf(wt, x[0], acc.x);
          acc.y = fmaf(wt, x[1], acc.y);
          acc.z = fmaf(wt, x[2], acc.z);
          acc.w = fmaf(wt, x[3], acc.w);
          *a = acc;
        }
      }
    }
    __syncwarp();
  };

  int cnt = 0;  // entries in the list (warp-uniform)
  for (int j = warp; j < nchunks; j += kWarps * kAhead) {
    const Meta nxt = load(j + kWarps * kAhead);  // next batch in flight
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const bool live = cur.w[k] != 0.f;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (cnt + __popc(m) > kListCap) {
        flush(cnt);
        cnt = 0;
      }
      if (live) {
        const int p = cnt + __popc(m & below);  // slot order
        lrow[p] = cur.nb[k];
        lwt[p] = cur.w[k];
        lln[p] = cur.ln[k];
      }
      cnt += __popc(m);
    }
    cur = nxt;
  }
  flush(cnt);
  __syncthreads();

  // sum the partials in order; one writer per output row of the slice
  const int nparts = kWarps * nsub;
  const int64_t row0 = (int64_t)tile_node_block[t0] * ont;
  const int w4 = width >> 2;
  for (int i = threadIdx.x; i < ont * w4; i += blockDim.x) {
    const int r = i / w4;
    const int c4 = (i - r * w4) << 2;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < nparts; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(
          parts + (p * ont + r) * dc + c4);
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + (row0 + r) * d_pad + col0 + c4) = s;
  }
}

template <typename T>
static int launch(const void* feat, const int* nbrs, const float* ev,
                  const int* local_node, const int* tile_node_block,
                  const int* run_start, const int* run_order, float* out,
                  int num_runs, int gs, int gpt, int ont, int d_pad, int dc,
                  int smem_bytes, cudaStream_t stream) {
  if (dc <= 0 || dc % kCols || dc > 32 * kCols || d_pad % kCols ||
      Layout(ont, dc).total != smem_bytes)
    return (int)cudaErrorInvalidValue;
  auto kernel = gather_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)num_runs * ((d_pad + dc - 1) / dc);
  kernel<<<(unsigned)blocks, 32 * kWarps, smem_bytes, stream>>>(
      static_cast<const T*>(feat), nbrs, ev, local_node, tile_node_block,
      run_start, run_order, out, gs, gpt, ont, d_pad, dc);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// `dc` is the column slice of one block (min(dt, 32 * kCols)) and
// `smem_bytes` its `Layout`, both from `launch_geometry`; `run_order` (R,)
// is the launch order of the runs (`DeviceSchedule.run_order`).
extern "C" int repro_group_aggregate_gather(
    int dtype, const void* feat, const int* nbrs, const float* ev,
    const int* local_node, const int* tile_node_block, const int* run_start,
    const int* run_order, float* out, int num_runs, int gs, int gpt, int ont,
    int d_pad, int dc, int smem_bytes, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(feat, nbrs, ev, local_node, tile_node_block,
                           run_start, run_order, out, num_runs, gs, gpt, ont,
                           d_pad, dc, smem_bytes, s);
    case kBF16:
      return launch<__nv_bfloat16>(feat, nbrs, ev, local_node,
                                   tile_node_block, run_start, run_order, out,
                                   num_runs, gs, gpt, ont, d_pad, dc,
                                   smem_bytes, s);
    case kF16:
      return launch<__half>(feat, nbrs, ev, local_node, tile_node_block,
                            run_start, run_order, out, num_runs, gs, gpt, ont,
                            d_pad, dc, smem_bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
