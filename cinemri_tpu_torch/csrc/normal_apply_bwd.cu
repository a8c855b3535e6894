// Backward of the masked normal operator apply, planar (re, im) float32.
//
// Forward (csrc/normal_apply.cu):
//   out[b,t] = Σ_c conj(S[b,c]) ⊙ (K[b,t'] ·_h (S[b,c] ⊙ x[b,t])) + λ·x[b,t]
// For the cotangent g of out, with ȳ_c = Kᴴ ·_h (S_c ⊙ g) and
// z_c = K ·_h (S_c ⊙ x) (recomputed, not saved):
//   x̄[b,t]   = Σ_c conj(S_c) ⊙ ȳ_c + λ·g
//   s̄[b,c]   = Σ_t conj(g) ⊙ z_c + ȳ_c ⊙ conj(x)
//   λ̄[b,t]   = Σ_{h,w} Re(g ⊙ conj(x))   (partials; the caller sums them)
//
//   x, g, x̄: (b, t, h, w)   K: (b, kt, h, h), t' = t if kt > 1 else 0
//   S, s̄: (b, c, h, w)      partials: (b, t, c, h, w)   λ̄: (b, t)
//   λ: one float32 in device memory, read by the kernel
//
// Replaces the backward Pallas kernel _bwd_pallas_call (body _bwd_kernel) of
// normal_apply_pallas (cinemri_tpu/ops/kernels/normal_pallas.py), the
// custom VJP that carries the normal apply through the VarNet train step.
//
// Arithmetic: the 4-multiplication complex product in full f32 on CUDA
// cores (FMA, no TF32), matching the JAX package's Precision.HIGHEST.
//
// What bounds it on the H100: two h-contractions per coil, 16·t·c·h·h·w
// FLOP (19.2 GFLOP at t=15, c=10, h=w=200) against about 30 MB of
// inputs and outputs: the FP32 rate.
//
// Design.
// - The Pallas kernel adds each frame's s̄ into an output block that stays
//   resident across the TPU's sequential grid. CUDA blocks run in parallel
//   in no order, so pass 1 writes per-frame partials s̄[b,t,c] and pass 2
//   (normal_apply_bwd_reduce_kernel) sums them over t: deterministic, at
//   the cost of b·t·c·h·w·8 bytes of scratch (48 MB at the flagship).
// - Pass 1 tiles (w, h, b·t) as the forward does, 64 x 64 output tiles, and
//   per coil runs the two contractions one after the other so that only one
//   4 x 4 complex accumulator is live beside x̄'s (the forward's register
//   profile): first ȳ, whose epilogue folds conj(S_c)⊙ȳ into x̄ and writes
//   ȳ⊙conj(x) to the partial, then z, whose epilogue adds conj(g)⊙z to the
//   same partial element. The same thread writes and re-reads that element,
//   so no synchronisation is needed.
// - Kᴴ is a contraction over K's first axis. Its tile is staged transposed
//   and conjugated into shared memory from rows of K, so both contractions
//   read K row-wise (coalesced) from device memory.
// - λ̄'s partials come from a third small kernel, one block per (b, t).

#include <cuda_runtime.h>

namespace {

constexpr int BH = 64, BW = 64, BK = 16, TM = 4, TN = 4;
constexpr int TX = BW / TN;  // threads along w
constexpr int TY = BH / TM;  // threads along h
constexpr int NT = TX * TY;

struct Smem {
  float ar[BK][BH + 1], ai[BK][BH + 1];  // A[i, k] of the contraction, stored k-major
  float yr[BK][BW], yi[BK][BW];          // (S_c ⊙ u)[k, w]
};

// acc[i, w] = Σ_k A[i, k] · (S_c ⊙ u)[k, w] over this block's tile, with
// A = K (ADJ false) or A = Kᴴ, A[i, k] = conj(K[k, i]) (ADJ true).
template <bool ADJ>
__device__ __forceinline__ void contract(float (&accr)[TM][TN], float (&acci)[TM][TN],
                                         const float* __restrict__ krp,
                                         const float* __restrict__ kip,
                                         const float* __restrict__ srp,
                                         const float* __restrict__ sip,
                                         const float* __restrict__ urp,
                                         const float* __restrict__ uip, int H, int W,
                                         int i0, int w0, Smem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) accr[m][n] = acci[m][n] = 0.f;

  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int idx = tid; idx < BH * BK; idx += NT) {
      int r, kk;
      if (ADJ) {  // neighbouring threads read neighbouring i of row k of K
        kk = idx / BH;
        r = idx % BH;
      } else {    // neighbouring threads read neighbouring k of row i of K
        r = idx / BK;
        kk = idx % BK;
      }
      const int i = i0 + r, k = k0 + kk;
      float vr = 0.f, vi = 0.f;
      if (i < H && k < H) {
        const long g = ADJ ? static_cast<long>(k) * H + i : static_cast<long>(i) * H + k;
        vr = krp[g];
        vi = ADJ ? -kip[g] : kip[g];
      }
      sm.ar[kk][r] = vr;
      sm.ai[kk][r] = vi;
    }
    for (int idx = tid; idx < BK * BW; idx += NT) {
      const int kk = idx / BW, col = idx % BW;
      const int k = k0 + kk, w = w0 + col;
      float yr = 0.f, yi = 0.f;
      if (k < H && w < W) {
        const long g = static_cast<long>(k) * W + w;
        const float a = srp[g], bb = sip[g], u = urp[g], v = uip[g];
        yr = a * u - bb * v;
        yi = a * v + bb * u;
      }
      sm.yr[kk][col] = yr;
      sm.yi[kk][col] = yi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        ar[m] = sm.ar[kk][ty + TY * m];
        ai[m] = sm.ai[kk][ty + TY * m];
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        br[n] = sm.yr[kk][tx + TX * n];
        bi[n] = sm.yi[kk][tx + TX * n];
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          accr[m][n] = fmaf(ar[m], br[n], accr[m][n]);
          accr[m][n] = fmaf(-ai[m], bi[n], accr[m][n]);
          acci[m][n] = fmaf(ar[m], bi[n], acci[m][n]);
          acci[m][n] = fmaf(ai[m], br[n], acci[m][n]);
        }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT)
normal_apply_bwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                        const float* __restrict__ gr, const float* __restrict__ gi,
                        const float* __restrict__ kr, const float* __restrict__ ki,
                        const float* __restrict__ sr, const float* __restrict__ si,
                        const float* __restrict__ lamp, float* __restrict__ xbr,
                        float* __restrict__ xbi,
                        float* __restrict__ spr, float* __restrict__ spi, int T, int C,
                        int H, int W, int KT) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int w0 = blockIdx.x * BW;
  const int i0 = blockIdx.y * BH;
  const int bt = blockIdx.z;
  const int b = bt / T;
  const int t = bt % T;

  const long plane = static_cast<long>(H) * W;
  const long xoff = bt * plane;
  const long koff = (static_cast<long>(b) * KT + (KT > 1 ? t : 0)) * H * H;
  const float* krp = kr + koff;
  const float* kip = ki + koff;

  float xbar_r[TM][TN], xbar_i[TM][TN], accr[TM][TN], acci[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) xbar_r[m][n] = xbar_i[m][n] = 0.f;

  for (int c = 0; c < C; ++c) {
    const float* srp = sr + (static_cast<long>(b) * C + c) * plane;
    const float* sip = si + (static_cast<long>(b) * C + c) * plane;
    float* sprp = spr + (static_cast<long>(bt) * C + c) * plane;
    float* spip = spi + (static_cast<long>(bt) * C + c) * plane;

    // ȳ = Kᴴ (S_c ⊙ g): x̄ += conj(S_c) ⊙ ȳ ; partial = ȳ ⊙ conj(x)
    contract<true>(accr, acci, krp, kip, srp, sip, gr + xoff, gi + xoff, H, W, i0, w0, sm);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int i = i0 + ty + TY * m;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int w = w0 + tx + TX * n;
        if (i < H && w < W) {
          const long p = static_cast<long>(i) * W + w;
          const float a = srp[p], bb = sip[p], u = xr[xoff + p], v = xi[xoff + p];
          const float yr = accr[m][n], yi = acci[m][n];
          xbar_r[m][n] += a * yr + bb * yi;
          xbar_i[m][n] += a * yi - bb * yr;
          sprp[p] = yr * u + yi * v;
          spip[p] = yi * u - yr * v;
        }
      }
    }

    // z = K (S_c ⊙ x): partial += conj(g) ⊙ z
    contract<false>(accr, acci, krp, kip, srp, sip, xr + xoff, xi + xoff, H, W, i0, w0, sm);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int i = i0 + ty + TY * m;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int w = w0 + tx + TX * n;
        if (i < H && w < W) {
          const long p = static_cast<long>(i) * W + w;
          const float u = gr[xoff + p], v = gi[xoff + p];
          const float zr = accr[m][n], zi = acci[m][n];
          sprp[p] += u * zr + v * zi;
          spip[p] += u * zi - v * zr;
        }
      }
    }
  }

  const float lam = *lamp;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = i0 + ty + TY * m;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int w = w0 + tx + TX * n;
      if (i < H && w < W) {
        const long g = xoff + static_cast<long>(i) * W + w;
        xbr[g] = xbar_r[m][n] + lam * gr[g];
        xbi[g] = xbar_i[m][n] + lam * gi[g];
      }
    }
  }
}

// s̄[b, e] = Σ_t partial[b, t, e], e over the c·h·w elements of a batch row.
__global__ void normal_apply_bwd_reduce_kernel(const float* __restrict__ spr,
                                               const float* __restrict__ spi,
                                               float* __restrict__ sbr, float* __restrict__ sbi,
                                               int B, int T, long chw) {
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= B * chw) return;
  const long b = idx / chw, e = idx % chw;
  const float* pr = spr + b * T * chw + e;
  const float* pi = spi + b * T * chw + e;
  float ar = 0.f, ai = 0.f;
  for (int t = 0; t < T; ++t) {
    ar += pr[t * chw];
    ai += pi[t * chw];
  }
  sbr[idx] = ar;
  sbi[idx] = ai;
}

// λ̄[b, t] = Σ_{h,w} g_re·x_re + g_im·x_im, one block per (b, t).
constexpr int LB_THREADS = 256;

__global__ void __launch_bounds__(LB_THREADS)
normal_apply_bwd_lambda_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                               const float* __restrict__ gr, const float* __restrict__ gi,
                               float* __restrict__ lb, long plane) {
  __shared__ float warp_sums[LB_THREADS / 32];
  const long off = static_cast<long>(blockIdx.x) * plane;
  float s = 0.f;
  for (long p = threadIdx.x; p < plane; p += LB_THREADS)
    s += gr[off + p] * xr[off + p] + gi[off + p] * xi[off + p];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int j = 0; j < LB_THREADS / 32; ++j) total += warp_sums[j];
    lb[blockIdx.x] = total;
  }
}

}  // namespace

extern "C" int cinemri_normal_apply_bwd(const float* xr, const float* xi, const float* gr,
                                        const float* gi, const float* kr, const float* ki,
                                        const float* sr, const float* si, const float* lam,
                                        float* xbr, float* xbi, float* spr, float* spi,
                                        float* sbr, float* sbi, float* lb, int b, int t,
                                        int c, int h, int w, int kt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + BW - 1) / BW, (h + BH - 1) / BH, b * t);
  normal_apply_bwd_kernel<<<grid, NT, 0, s>>>(xr, xi, gr, gi, kr, ki, sr, si, lam, xbr, xbi,
                                               spr, spi, t, c, h, w, kt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long chw = static_cast<long>(c) * h * w;
  const int threads = 256;
  const long blocks = (b * chw + threads - 1) / threads;
  normal_apply_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      spr, spi, sbr, sbi, b, t, chw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  normal_apply_bwd_lambda_kernel<<<b * t, LB_THREADS, 0, s>>>(xr, xi, gr, gi, lb,
                                                              static_cast<long>(h) * w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cinemri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
