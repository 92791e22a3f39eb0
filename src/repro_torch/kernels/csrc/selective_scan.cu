// selective_scan: the fused Mamba-1 selective scan (sm_90a, plain C ABI).
//
// Replaces the TPU kernel `selective_scan_pallas`
// (src/repro/kernels/selective_scan.py:82, body `_kernel` :36,
// `pl.pallas_call` at :102).  For every batch row b and channel d:
//   dt_t    = softplus(dt_raw[b,t,d] + dt_bias[d])
//   h_t[n]  = exp(dt_t A[d,n]) h_{t-1}[n] + dt_t xc[b,t,d] B[b,t,n],
//             A = -exp(a_log), h_{-1} = 0
//   y[b,t,d] = sum_n C[b,t,n] h_t[n] + D[d] xc[b,t,d]
// all in f32.  softplus is JAX's, max(x,0) + log1p(exp(-|x|)), with the
// full-precision expf / log1pf; exp(dt A) is one ex2.approx.ftz of
// dt (A log2 e) (error budget below).
//
// Operands (f32, row-major, contiguous):
//   xc, dt_raw, y   (B, S, d_inner)
//   b, c            (B, S, N)          N <= 32
//   a_log           (d_inner, N)
//   dt_bias, d_skip (d_inner,)
// Offsets are 64-bit: B*S*d_inner passes 2^31 at prefill sizes a
// deployment runs (32 x 32,768 x 8,192 = 8.6e9).
//
// What bounds it on the H100.  At (B 4, S 2048, d_inner 8192, N 16), one
// Falcon-Mamba-7B layer of a prefill, the function reads xc and dt_raw and
// writes y (805 MB) and reads B and C (1 MB): 0.2409 ms at 3.35 TB/s.  It
// needs N exps per (b, t, d) for exp(dt A), plus softplus's exp and
// log1p: 1.2e9 special-function results, 0.2889 ms at 16 a clock per SM
// (`repro_torch.hw.H100_SXM.peak_sfu`) with every exp on the SFUs, as
// here.  The rest is FMA-pipe work that shares the issue slots: per state
// and step dt A, dt xc B, the update and C h, four instructions beside
// the exp, so about 0.26 ms of issue at full rate.  The design reads each
// byte once (bytes), keeps N + 2 special-function results per (b, t, d)
// (the SFU floor) and spends nothing per step beyond those four: no
// shuffle, no reload, no recomputed softplus.  With the full-precision
// expf each exp is one MUFU.EX2 and about eight FMA-pipe instructions,
// which more than doubles the issue (the `p1-expf` probe).
//
// Mapping.  The TPU grid walks the sequence chunks in order and carries h
// in a VMEM scratch; blocks here run in no order, so each block walks the
// whole sequence and h lives in registers.  A thread owns one (b, d)
// channel and holds its N states h[n] and A[n] log2 e in registers (N
// padded to a power of two >= 4 with A = B = C = 0), so y is summed in the
// thread, with no shuffle.  A block is 128 threads, 128 consecutive
// channels of one batch row; the grid is B x ceil(d_inner / 128) (256
// blocks, 2 an SM, at the prefill shape).  Where that grid has fewer
// blocks than the card has SMs, as (1, 256, 8192, 16) has (64), the
// launch gives each channel P = 2 lanes of N / 2 states, whose partial
// sums meet in one shuffle a step (`scan_lanes`, decided from the shape).
//   * Staging: for each chunk of 16 steps the block copies its channels'
//     xc and dt_raw rows (512 coalesced bytes a step) and the chunk's
//     B[t,:] and C[t,:] rows, once a block, into shared memory with
//     16-byte `cp.async` copies (4-byte ones where a row is not in whole
//     16 bytes); the copies of chunk k + 1 are issued before the walk of
//     chunk k, so they are in flight while it runs (two stages).  B and C
//     are then read as broadcast 16-byte loads.
//   * softplus: once per (t, d), by one lane of the channel (lane p takes
//     steps p, p + P, ...), written back over dt_raw in shared memory.
//   * The walk, unrolled 8 steps: per step and state, dA = ex2(dt A'[n])
//     (independent of h, so the exps of a step and of the next overlap),
//     h = dA h + (dt xc) B[n] in one fmaf, y += C[n] h into four partial
//     sums; y goes from registers straight to device memory.
//
// Error budget.  The exp of dt A is ex2.approx.ftz.f32 of x' = dt (A log2
// e), where A log2 e is rounded once a channel: the argument carries two
// float32 roundings (relative error 2^-23 each, so an absolute error in
// the exponent of |x'| 2^-22 at most) and ex2.approx adds a relative error
// of a few ulp (2^-22 order), against expf's 2 ulp; dA of order 1e-38 and
// below flushes to zero, where dA h no longer moves h.  Each step rounds h
// once (fmaf) where the plain version rounds twice, and y is summed in
// four partial sums where the plain version sums in order.  The state
// decays (dA < 1), so a step's rounding does not grow along the sequence.
// Measured against the checks' unchanged limits (PERF.md): kernel
// vs plain and vs the float64 witness at most 2.3e-7 in max|k-p| / (1 +
// max|p|) at the four phase-6 shapes (limit 1e-5; 1.17e-7 at the prefill
// shape, where expf reads 1.00e-7); every layer of a full-depth prefill
// at most 2.3e-7 (limit 1e-5); prefill vs decode 4.5e-5 to 9.0e-5 at
// weight seeds 1-5 (limit 1e-4), where the plain version's own prefill
// reads 9.05e-5 at seed 1 and the expf probe 9.27e-5.
#include <cstring>

#include "common.cuh"

namespace repro_torch {

constexpr int kScanThreads = 128;  // threads a block
constexpr int kScanChunk = 16;     // steps a staged chunk
constexpr int kScanStages = 2;     // the chunk walked and the next in flight

// How a step takes exp(dt A[n]): the full-precision expf, or one
// ex2.approx.ftz of dt (A log2 e) with A pre-scaled once.
enum ScanExp { kExpf = 0, kEx2 = 1 };

// One instantiation: NS states a lane, P lanes a channel, the exp, steps
// a walk unrolls, and the blocks an SM its registers must allow (0: no
// bound).
template <int NS_, int P_, int E_, int U_, int MB_>
struct ScanCfg {
  static constexpr int NS = NS_, P = P_, E = E_, U = U_, MB = MB_;
  static constexpr int kCh = kScanThreads / P;  // channels a block
  static constexpr int kN = NS * P;             // padded states a channel
};

template <int E>
__device__ __forceinline__ float decay(float x) {
  if constexpr (E == kEx2) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
  } else {
    return expf(x);
  }
}

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// cp.async of 4 bytes (cached) or 16 (L2 only: each byte is read once);
// !valid fills zero and reads nothing
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `kPending` of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct ScanArgs {
  const float* xc;
  const float* dt_raw;
  const float* b;
  const float* c;
  const float* a_log;
  const float* dt_bias;
  const float* d_skip;
  float* y;
  int batch, seq, di, n_state;
};

template <class Cfg>
struct ScanSmem {
  alignas(16) float x[kScanStages][kScanChunk][Cfg::kCh];
  alignas(16) float dt[kScanStages][kScanChunk][Cfg::kCh];  // dt_raw, then softplus
  alignas(16) float b[kScanStages][kScanChunk][Cfg::kN];
  alignas(16) float c[kScanStages][kScanChunk][Cfg::kN];
};

// The block's threads copy rows [0, kScanChunk) x columns [0, kCols) of a
// row-major f32 matrix whose rows lie `stride` apart into dst, zero past
// `rows` rows and `cols` columns, in pieces of kW floats (4: 16-byte
// copies, which need cols, stride and src in whole 16 bytes; 1: 4-byte
// ones).  A thread keeps one column and steps down the rows, so its
// address advances by one add a piece.
template <int kW, int kCols>
__device__ __forceinline__ void copy_tile(float (*dst)[kCols],
                                          const float* src, int stride,
                                          int rows, int cols) {
  constexpr int kPerRow = kCols / kW;                  // pieces a row
  constexpr int kRowStep = kScanThreads / kPerRow;     // rows a pass
  const int r0 = threadIdx.x / kPerRow;
  const int col = kW * (threadIdx.x % kPerRow);
  const bool col_ok = col < cols;
  const float* q = src + (int64_t)r0 * stride + col;
  const int64_t step = (int64_t)kRowStep * stride;
#pragma unroll
  for (int r = r0, k = 0; k < (kScanChunk + kRowStep - 1) / kRowStep;
       ++k, r += kRowStep, q += step) {
    if (kScanChunk % kRowStep == 0 || r < kScanChunk) {
      const bool ok = col_ok && r < rows;
      if constexpr (kW == 4)
        cp_async16(&dst[r][col], ok ? q : src, ok);
      else
        cp_async4(&dst[r][col], ok ? q : src, ok);
    }
  }
}

// Issue the copies of the chunk of `len` steps whose first step is the
// (b, t) row `row` into stage `s`: the block's channels' xc and dt_raw
// rows and the B and C rows, zero past the block's channels, past n_state
// and past the sequence.
template <class Cfg>
__device__ __forceinline__ void stage_chunk(ScanSmem<Cfg>& sm, int s,
                                            const ScanArgs& a, int64_t row,
                                            int len, int d0, bool vec_x,
                                            bool vec_bc) {
  const int64_t off = row * a.di + d0, boff = row * a.n_state;
  if (vec_x) {
    copy_tile<4>(sm.x[s], a.xc + off, a.di, len, a.di - d0);
    copy_tile<4>(sm.dt[s], a.dt_raw + off, a.di, len, a.di - d0);
  } else {
    copy_tile<1>(sm.x[s], a.xc + off, a.di, len, a.di - d0);
    copy_tile<1>(sm.dt[s], a.dt_raw + off, a.di, len, a.di - d0);
  }
  if (vec_bc) {
    copy_tile<4>(sm.b[s], a.b + boff, a.n_state, len, a.n_state);
    copy_tile<4>(sm.c[s], a.c + boff, a.n_state, len, a.n_state);
  } else {
    copy_tile<1>(sm.b[s], a.b + boff, a.n_state, len, a.n_state);
    copy_tile<1>(sm.c[s], a.c + boff, a.n_state, len, a.n_state);
  }
}

template <class Cfg>
__device__ __forceinline__ void scan_block(const ScanArgs& a) {
  constexpr int NS = Cfg::NS, P = Cfg::P, C = kScanChunk, kCh = Cfg::kCh;
  __shared__ ScanSmem<Cfg> sm;

  const int ch = threadIdx.x / P;  // a channel's P lanes are neighbours
  const int p = threadIdx.x % P;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + ch;
  const bool live = d < a.di;
  const int64_t row0 = (int64_t)blockIdx.y * a.seq;  // (b, t = 0) row
  float av[NS], h[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = p * NS + j;
    av[j] = (live && n < a.n_state)
                ? -expf(a.a_log[(int64_t)d * a.n_state + n]) : 0.f;
    if constexpr (Cfg::E == kEx2) av[j] *= 1.4426950408889634f;  // log2 e
    h[j] = 0.f;
  }
  const float bias = live ? a.dt_bias[d] : 0.f;
  const float dsk = live ? a.d_skip[d] : 0.f;
  // whole 16-byte pieces of the rows: d0 is a multiple of 4 (kCh is)
  const auto al16 = [](const float* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  const bool vec_x = a.di % 4 == 0 && al16(a.xc) && al16(a.dt_raw);
  const bool vec_bc = a.n_state % 4 == 0 && al16(a.b) && al16(a.c);

  const int chunks = (a.seq + C - 1) / C;
  stage_chunk<Cfg>(sm, 0, a, row0, min(C, a.seq), d0, vec_x, vec_bc);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int s = k & 1;
    const int t0 = k * C;
    if (k + 1 < chunks)  // the next chunk's copies fly during this walk
      stage_chunk<Cfg>(sm, s ^ 1, a, row0 + t0 + C, min(C, a.seq - t0 - C),
                       d0, vec_x, vec_bc);
    cp_async_commit();   // empty on the last chunk: the count stays uniform
    cp_async_wait<1>();  // this thread's copies of chunk k have landed
    __syncthreads();     // and every thread's
    // softplus once per (t, d): lane p of the channel takes steps p, p + P
#pragma unroll
    for (int q = 0; q < C / P; ++q) {
      const int tt = q * P + p;
      sm.dt[s][tt][ch] = softplus_f(sm.dt[s][tt][ch] + bias);
    }
    __syncwarp();        // a channel's lanes are in one warp
    float* yp = a.y + (row0 + t0) * a.di + d;
#pragma unroll 1
    for (int u0 = 0; u0 < C; u0 += Cfg::U) {
#pragma unroll
    for (int tt = u0; tt < u0 + Cfg::U; ++tt) {
      const float dtv = sm.dt[s][tt][ch];
      const float xv = sm.x[s][tt][ch];
      const float dtx = dtv * xv;
      const float4* bq = reinterpret_cast<const float4*>(&sm.b[s][tt][p * NS]);
      const float4* cq = reinterpret_cast<const float4*>(&sm.c[s][tt][p * NS]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < NS / 4; ++q) {
        const float4 b4 = bq[q], c4 = cq[q];
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * q + i;
          h[j] = fmaf(decay<Cfg::E>(dtv * av[j]), h[j], dtx * bv[i]);
          acc[i] = fmaf(cv[i], h[j], acc[i]);
        }
      }
      float yv = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1)  // the channel's lanes only
        yv += __shfl_xor_sync(0xffffffffu, yv, o);
      // steps past the sequence (last chunk) ran on zeros and are dropped
      if (p == tt % P && live && t0 + tt < a.seq)
        yp[(int64_t)tt * a.di] = fmaf(dsk, xv, yv);
    }
    }
    __syncthreads();     // stage s takes chunk k + 2's copies next
  }
}

template <class Cfg>
__global__ void __launch_bounds__(kScanThreads, Cfg::MB)
selective_scan_kernel(const ScanArgs a) {
  scan_block<Cfg>(a);
}

template <class Cfg>
cudaError_t launch(const ScanArgs& a, cudaStream_t stream) {
  if (a.n_state > Cfg::kN) return cudaErrorInvalidValue;
  const dim3 grid((a.di + Cfg::kCh - 1) / Cfg::kCh, a.batch);
  selective_scan_kernel<Cfg><<<grid, kScanThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// states a channel, padded: a power of two >= 4 (whole 16-byte B/C loads)
inline int padded_states(int n_state) {
  int n = 4;
  while (n < n_state) n <<= 1;
  return n;
}

// The shipped launches: a thread a channel (the walk unrolled 8 steps, 2
// blocks an SM), or 2 lanes a channel (8 states a lane, no register bound)
// when one thread a channel gives fewer blocks than the card has SMs; ex2
// both.  `kN` is the padded N.
template <int kN>
using OneLane = ScanCfg<kN, 1, kEx2, 8, 2>;
template <int kN>
using TwoLanes = ScanCfg<kN / 2, 2, kEx2, 16, 0>;

// lanes a channel of the shipped launch: 2 when a thread a channel leaves
// SMs without a block and N > 4 (a lane holds at least four states)
int scan_lanes(int batch, int di, int n_state) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t blocks = (int64_t)batch * ((di + kScanThreads - 1) /
                                           kScanThreads);
  return blocks < sms && padded_states(n_state) >= 8 ? 2 : 1;
}

int run_shipped(const ScanArgs& a, cudaStream_t s) {
  const bool two = scan_lanes(a.batch, a.di, a.n_state) == 2;
  switch (padded_states(a.n_state)) {
    case 4: return (int)launch<OneLane<4>>(a, s);
    case 8: return (int)(two ? launch<TwoLanes<8>>(a, s)
                             : launch<OneLane<8>>(a, s));
    case 16: return (int)(two ? launch<TwoLanes<16>>(a, s)
                              : launch<OneLane<16>>(a, s));
    default: return (int)(two ? launch<TwoLanes<32>>(a, s)
                              : launch<OneLane<32>>(a, s));
  }
}

// The probes of `chip_smoke.py --scan-variants`, at N <= 16, by name: the
// two shipped launches at every shape, 4 lanes a channel, and both
// mappings with the full-precision expf in place of ex2.
struct Probe {
  const char* name;
  cudaError_t (*fn)(const ScanArgs&, cudaStream_t);
};
const Probe kProbes[] = {
    {"p1-ex2", launch<OneLane<16>>},
    {"p2-ex2", launch<TwoLanes<16>>},
    {"p4-ex2", launch<ScanCfg<4, 4, kEx2, 16, 0>>},
    {"p1-expf", launch<ScanCfg<16, 1, kExpf, 8, 2>>},
    {"p2-expf", launch<ScanCfg<8, 2, kExpf, 16, 0>>},
};

bool args_ok(const ScanArgs& a) {
  return a.n_state >= 1 && a.n_state <= 32 && a.batch <= 65535;
}

}  // namespace repro_torch

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  The wrapper checks shapes and rejects n_state > 32, more than
// 65,535 batch rows (grid.y) and empty operands before it calls this.
extern "C" int repro_selective_scan(const float* xc, const float* dt_raw,
                                    const float* b, const float* c,
                                    const float* a_log, const float* dt_bias,
                                    const float* d_skip, float* y, int batch,
                                    int seq, int di, int n_state,
                                    void* stream) {
  using namespace repro_torch;
  const ScanArgs a{xc, dt_raw, b, c, a_log, dt_bias, d_skip, y,
                   batch, seq, di, n_state};
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  return run_shipped(a, static_cast<cudaStream_t>(stream));
}

// Lanes a channel of the shipped launch at this shape.
extern "C" int repro_selective_scan_lanes(int batch, int di, int n_state) {
  return repro_torch::scan_lanes(batch, di, n_state);
}

// The probe named `name` (see kProbes) at the same arguments; the wrapper
// never calls it.  Returns cudaErrorInvalidValue for an unknown name or
// n_state > 16.
extern "C" int repro_selective_scan_probe(const char* name, const float* xc,
                                          const float* dt_raw, const float* b,
                                          const float* c, const float* a_log,
                                          const float* dt_bias,
                                          const float* d_skip, float* y,
                                          int batch, int seq, int di,
                                          int n_state, void* stream) {
  using namespace repro_torch;
  const ScanArgs a{xc, dt_raw, b, c, a_log, dt_bias, d_skip, y,
                   batch, seq, di, n_state};
  if (!args_ok(a)) return (int)cudaErrorInvalidValue;
  for (const Probe& pr : kProbes)
    if (std::strcmp(pr.name, name) == 0)
      return (int)pr.fn(a, static_cast<cudaStream_t>(stream));
  return (int)cudaErrorInvalidValue;
}
