// selective_scan: the fused Mamba-1 selective scan (sm_90a, plain C ABI).
//
// Replaces the TPU kernel `selective_scan_pallas`
// (src/repro/kernels/selective_scan.py:82, body `_kernel` :36,
// `pl.pallas_call` at :102).  For every batch row b and channel d:
//   dt_t    = softplus(dt_raw[b,t,d] + dt_bias[d])
//   h_t[n]  = exp(dt_t A[d,n]) h_{t-1}[n] + dt_t xc[b,t,d] B[b,t,n],
//             A = -exp(a_log), h_{-1} = 0
//   y[b,t,d] = sum_n C[b,t,n] h_t[n] + D[d] xc[b,t,d]
// all in f32.  softplus is JAX's, max(x,0) + log1p(exp(-|x|)), and exp /
// log1p are the full-precision expf / log1pf (not __expf), so the kernel
// and the plain version (`repro_torch.kernels.ref.selective_scan_ref`)
// differ only by float32 rounding.
//
// Operands (f32, row-major, contiguous):
//   xc, dt_raw, y   (B, S, d_inner)
//   b, c            (B, S, N)          N <= 32
//   a_log           (d_inner, N)
//   dt_bias, d_skip (d_inner,)
// Offsets are 64-bit: B*S*d_inner passes 2^31 at prefill sizes a
// deployment runs (32 x 32,768 x 8,192 = 8.6e9).
//
// Mapping.  The TPU grid walks the sequence chunks in order and carries h
// in a VMEM scratch; blocks here run in no order, so the whole sequence
// loop runs inside one block and h lives in a register: nothing is carried
// between blocks.  One lane per state index n (L = the next power of two
// >= N lanes per channel, lanes n >= N masked to zero), 128 / L channels of
// one batch row per block (8 at N = 16), so the grid is
// B x d_inner / (128 / L) blocks (4,096 at B 4, d_inner 8,192).  For each
// chunk of kChunk steps the block stages B[t,:] and C[t,:] (shared by all
// its channels) and its channels' xc and dt in shared memory; softplus is
// applied once per (t, d) while staging, not once per lane.  Each lane then
// walks the chunk: a = exp(dt A[n]), h = a h + dt xc B[t,n], and the
// channel's L lanes sum h C[t,n] by __shfl_xor_sync (log2 L steps); lane 0
// puts y in shared memory and the block writes the chunk's y rows out.
//
// What bounds it on the card: bytes.  Per (b, t, d) the function reads
// xc and dt_raw and writes y (12 B, plus 8 N B per (b, t) for B and C),
// does about 7 N FLOP, and needs N exps for the discretization plus
// softplus's exp and log1p: N + 2 special-function results.  At (B 4,
// S 2048, d_inner 8192, N 16) that is 0.24 ms of bytes at 3.35 TB/s,
// 0.11 ms of FLOP at 67 TFLOP/s and 0.29 ms of exp/log at the
// special-function rate (16 per clock per SM,
// `repro_torch.hw.H100_SXM.peak_sfu`).  The bytes bound the card: an exp
// can also run as a polynomial on the FMA pipes, and with the exps split
// between both the compute fits under 0.24 ms.  This design runs every
// exp/log on the SFUs, so 0.29 ms is its own floor; it evaluates each exp
// once and reads each input once, and the per-step shuffle reduction (4
// shuffles per lane at N = 16) is what it spends above that floor.
#include "common.cuh"

namespace repro_torch {

constexpr int kScanThreads = 128;

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

template <int L>
__global__ void __launch_bounds__(kScanThreads)
selective_scan_kernel(const float* __restrict__ xc,
                      const float* __restrict__ dt_raw,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a_log,
                      const float* __restrict__ dt_bias,
                      const float* __restrict__ d_skip,
                      float* __restrict__ y, int seq, int di, int n_state) {
  constexpr int kCh = kScanThreads / L;                 // channels per block
  constexpr int kChunk = 1024 / (L > kCh ? L : kCh);    // steps per chunk
  __shared__ float b_s[kChunk * L];
  __shared__ float c_s[kChunk * L];
  __shared__ float dt_s[kChunk * kCh];
  __shared__ float x_s[kChunk * kCh];
  __shared__ float y_s[kChunk * kCh];

  const int ch = threadIdx.x / L;
  const int n = threadIdx.x % L;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + ch;
  const int64_t row0 = (int64_t)blockIdx.y * seq;     // (b, t = 0) row
  const float a = (d < di && n < n_state)
                      ? -expf(a_log[(int64_t)d * n_state + n]) : 0.f;
  const float dsk = d < di ? d_skip[d] : 0.f;
  float h = 0.f;

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int len = min(kChunk, seq - t0);
    // stage B[t,:], C[t,:] for the chunk, padded to L lanes with zeros
    for (int i = threadIdx.x; i < kChunk * L; i += kScanThreads) {
      const int tt = i / L, nn = i % L;
      float bv = 0.f, cv = 0.f;
      if (tt < len && nn < n_state) {
        const int64_t off = (row0 + t0 + tt) * n_state + nn;
        bv = bm[off];
        cv = cm[off];
      }
      b_s[i] = bv;
      c_s[i] = cv;
    }
    // stage xc and dt = softplus(dt_raw + dt_bias) of the block's channels
    for (int i = threadIdx.x; i < kChunk * kCh; i += kScanThreads) {
      const int tt = i / kCh, cc = i % kCh;
      float xv = 0.f, dv = 0.f;
      if (tt < len && d0 + cc < di) {
        const int64_t off = (row0 + t0 + tt) * di + d0 + cc;
        xv = xc[off];
        dv = softplus_f(dt_raw[off] + dt_bias[d0 + cc]);
      }
      x_s[i] = xv;
      dt_s[i] = dv;
    }
    __syncthreads();
    // the recurrence; every lane of the block runs every step (masked
    // lanes and channels carry zeros), so the shuffles see full warps
    for (int tt = 0; tt < len; ++tt) {
      const float dtv = dt_s[tt * kCh + ch];
      const float xv = x_s[tt * kCh + ch];
      h = expf(dtv * a) * h + dtv * xv * b_s[tt * L + n];
      float p = h * c_s[tt * L + n];
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (n == 0) y_s[tt * kCh + ch] = p + dsk * xv;
    }
    __syncthreads();
    // the chunk's y rows; the next chunk rewrites y_s only after its
    // staging barrier, which every thread reaches after this loop
    for (int i = threadIdx.x; i < len * kCh; i += kScanThreads) {
      const int tt = i / kCh, cc = i % kCh;
      if (d0 + cc < di) y[(row0 + t0 + tt) * di + d0 + cc] = y_s[i];
    }
  }
}

template <int L>
cudaError_t launch(const float* xc, const float* dt_raw, const float* b,
                   const float* c, const float* a_log, const float* dt_bias,
                   const float* d_skip, float* y, int batch, int seq, int di,
                   int n_state, cudaStream_t stream) {
  constexpr int kCh = kScanThreads / L;
  const dim3 grid((di + kCh - 1) / kCh, batch);
  selective_scan_kernel<L><<<grid, kScanThreads, 0, stream>>>(
      xc, dt_raw, b, c, a_log, dt_bias, d_skip, y, seq, di, n_state);
  return cudaGetLastError();
}

}  // namespace repro_torch

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  The wrapper checks shapes and rejects n_state > 32 and empty
// operands before it calls this.
extern "C" int repro_selective_scan(const float* xc, const float* dt_raw,
                                    const float* b, const float* c,
                                    const float* a_log, const float* dt_bias,
                                    const float* d_skip, float* y, int batch,
                                    int seq, int di, int n_state,
                                    void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_state <= 1)
    return (int)launch<1>(xc, dt_raw, b, c, a_log, dt_bias, d_skip, y, batch,
                          seq, di, n_state, s);
  if (n_state <= 2)
    return (int)launch<2>(xc, dt_raw, b, c, a_log, dt_bias, d_skip, y, batch,
                          seq, di, n_state, s);
  if (n_state <= 4)
    return (int)launch<4>(xc, dt_raw, b, c, a_log, dt_bias, d_skip, y, batch,
                          seq, di, n_state, s);
  if (n_state <= 8)
    return (int)launch<8>(xc, dt_raw, b, c, a_log, dt_bias, d_skip, y, batch,
                          seq, di, n_state, s);
  if (n_state <= 16)
    return (int)launch<16>(xc, dt_raw, b, c, a_log, dt_bias, d_skip, y, batch,
                           seq, di, n_state, s);
  if (n_state <= 32)
    return (int)launch<32>(xc, dt_raw, b, c, a_log, dt_bias, d_skip, y, batch,
                           seq, di, n_state, s);
  return (int)cudaErrorInvalidValue;
}
