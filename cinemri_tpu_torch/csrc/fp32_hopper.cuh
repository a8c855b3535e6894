// The normal apply's h-contraction at 'highest' on the H100's CUDA cores with
// the products formed in its staging: the route FP32_FUSED of normal_wgmma.cuh,
// shared by the forward (csrc/normal_apply.cu) and both contractions of its
// backward (csrc/normal_apply_bwd.cu), taken where the caller asks for it
// (ops/kernels/normal_cuda.py set_fp32_tile('fused')); the default
// 'highest' route is the engine's Fp32Tile (normal_passes.cuh), which is
// faster on the H100 (PERF.md):
//
//   z[f, c] = B_g ·_h (S[b, c] ⊙ u[f])
//
// over the groups g of G slabs that share one B (h x h, k-contiguous rows):
// K in the forward and the backward's z = K·(S⊙x), the conjugate-transposed
// copy Kᴴ in the backward's ȳ = Kᴴ·(S⊙g). u is x or the cotangent g.
//
// Arithmetic: what the tile engine of cgemm_tile.cuh computes at 'highest',
// bit for bit. Each output is one chain per part, k ascending from 0, no
// split-K, with the engine's FMAs (cgemm_tile.cuh mma_chunk):
//   cr = fma(ar, br, cr); cr = fma(−ai, bi, cr); ci = fma(ar, bi, ci); ci = fma(ai, br, ci)
// and A = S ⊙ u formed as normal_passes.cuh's products<VEC, false> pass
// forms it (product() below). With B = Kᴴ copied (br = Re K, bi = −Im K
// transposed) the chains are those of the engine's conjugated read of K.
//
// What bounds it on the H100: 8·N FLOP per output element (N = h = K), so
// 9.6 GFLOP at the flagship (b 1, t 15, c 10, 200 x 200, kt 15) against
// ~48 MB of operands: the FP32 rate, 0.1446 ms at 67 TFLOP/s. It removes
// what the engine's route pays beside its FMAs:
// - waves: the engine's blocks fill a whole number of waves only by tile
//   shape; here persistent blocks walk a tile queue;
// - y = S ⊙ u goes to a 48 MB scratch in the engine route and comes back
//   through L2 once per 40-row column tile (5 times at h = 200); here u and
//   S pass through L2 once per block tile and y never reaches device memory;
// - a __syncthreads per 8- or 16-deep chunk in the engine; here the copies
//   complete on mbarriers, and one barrier a 16-deep chunk orders the
//   products' formation and the slot's reuse.
// What it costs: at h = 200 a block is 5 squads, 10 warps an SM (3 on two
// of an SM's four schedulers, 2 on the others), where the engine's Fp32Tile
// runs 12; no thread count that is a multiple of 128 splits 200 rows into
// 40-row squads. On an NVIDIA H100 80GB HBM3 at 700 W its contraction takes
// 0.404 ms at the flagship against Fp32Tile's 0.287 plus the products
// pass's 0.020 (PERF.md, chip_smoke.py [precision]); the fewer warps
// are the likely cause.
//
// Design:
// - A block tile covers all of h: 64 slab columns (m) x h output rows (n).
//   The threads form squads of 64, one per 40 rows of n (5 at h = 200, 320
//   threads; h > 200 takes passes of at most 5 squads). A thread owns 8 m
//   x 5 n complex outputs (80 accumulators): m = 4·ty + 32·j + e (two float4
//   runs), n = 40·squad + tx + 8·jn, a warp 8 tx x 4 ty. Per k it reads two
//   float4 of A re and im each (4 distinct per warp, broadcast to 8 lanes),
//   and per 4 k one float4 of B re and im along k for each of its 5 rows
//   (64-byte rows in the TMA's 64-byte swizzle: the 8 lanes of a
//   quarter-warp hit 32 distinct banks), for 160 FMAs a k.
// - Products in staging: each 16-deep chunk brings u and S raw (the four
//   planes' columns, [part][k][m]) into a ring slot by every thread's 16-byte
//   cp.async copies (zero past the matrix), and the chunk of B (rows of 16 k,
//   re and im) by two 2-D TMA copies (cp.async.bulk.tensor, 64-byte swizzle)
//   that one thread issues; both complete on the slot's mbarrier. The block
//   then forms y = S ⊙ u in place, once per element, and one __syncthreads a
//   chunk (16 k, 2560 FMAs a thread) makes it visible and frees the slot of
//   the chunk before for the copies of chunk + SLOTS − 1: u and S pass
//   through L2 once per block tile, y never reaches device memory, and the
//   products pass and its scratch are gone.
// - B goes by TMA, so that the threads issue only A's copies (a third of the
//   bytes): the tensor map's hardware address generation takes B off them.
// - Persistent blocks (as many as fit at once, 1 an SM at h = 200): a
//   block's tiles form one stream of chunks through a ring of 4 slots, so
//   the next tile's copies are in flight during a tile's last chunks and its
//   epilogue (registers straight to z, a float4 of 4 slab columns per
//   store). 480 tiles at the flagship on 132 SMs.
// Launch requirements (normal_wgmma.cuh route(): else the call takes the
// engine route): every operand 16-byte aligned, h % 4 == 0 and w % 4 == 0.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "wgmma_tf32.cuh"

namespace fp32 {

constexpr int BM = 64;          // slab columns a tile
constexpr int BK = 16;          // k a chunk: one 64-byte row of B a TMA box row
constexpr int SQUAD = 64;       // threads a squad
constexpr int SN = 40;          // output rows a squad
constexpr int TM = 8, TN = 5;   // complex outputs a thread: m x n
constexpr int SLOTS = 4;        // ring slots
constexpr int MAX_SQUADS = 5;   // squads a block (h ≤ 200 in one pass)
constexpr int MAX_THREADS = SQUAD * MAX_SQUADS;
constexpr int A_FLOATS = 4 * BK * BM;  // u re, u im, S re, S im: [part][k][m]
static_assert(SQUAD == 8 * (BM / TM) && SN == 8 * TN, "a squad is 8 tx x 8 ty threads");
static_assert(BK * 4 == 64 && SN % 8 == 0, "B rows of 64 bytes, 512-byte swizzle atoms");

// Floats of one ring slot with `squads` squads: A's four parts, then B's
// rows re and im (a multiple of 256 floats: every slot stays 1024-byte aligned).
__host__ __device__ constexpr int slot_floats(int squads) { return A_FLOATS + 2 * squads * SN * BK; }
inline int smem_bytes(int squads) { return 1024 + SLOTS * slot_floats(squads) * 4 + 8 * SLOTS; }

// One launch's operands.
struct Problem {
  const float* ur;  // u: x or g, (b·t, h, w)
  const float* ui;
  const float* sr;  // coil maps S (b, c, h, w)
  const float* si;
  const float* br;  // B: N x N, k-contiguous rows; group g's at + g·N·N
  const float* bi;
  float* zr;        // z (b·t·c, h, w): slab sl = f·C + c, frame f = b·T + t
  float* zi;
  long M;           // slab columns of a group: G·W
  int N, W, C, T;
  int groups;
  int squads = 0;      // set by launch: squads a block
  int passes = 0;      // passes over n of squads·SN rows
  long row_tiles = 0;  // tiles of BM slab columns in a group
  CUtensorMap b_map[2] = {};  // set by launch: B re and im as (groups·N rows) x N
};

// y = S ⊙ u as normal_passes.cuh's products<VEC, false> pass computes it
// (its FMA contraction by nvcc, read from the SASS: both products kernels
// compile to this), here with explicit roundings so that the fused staging
// gives the same bits.
__device__ __forceinline__ void product(float sr, float si, float ur, float ui, float& yr,
                                        float& yi) {
  yr = __fmaf_rn(sr, ur, -__fmul_rn(si, ui));
  yi = __fmaf_rn(sr, ui, __fmul_rn(si, ur));
}

// -- PTX primitives: 2-D TMA loads completing on an mbarrier ----------------------
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// box at (c0 innermost, c1) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// -- end PTX primitives ---------------------------------------------------------------

// A tile: slab columns [gm0, gm0 + rows) (global over the groups), output
// rows [n0, n0 + squads·SN), its group's first row of B. Tile t runs over
// (group, row tile, pass), the passes of a row tile side by side.
struct Span {
  long gm0;
  int rows, n0, b_row;
};

__device__ __forceinline__ Span span(const Problem& p, long t) {
  const long rt = t / p.passes, group = rt / p.row_tiles;
  const long m0 = (rt - group * p.row_tiles) * BM;
  const int n0 = static_cast<int>(t - rt * p.passes) * p.squads * SN;
  return Span{group * p.M + m0, p.M - m0 < BM ? static_cast<int>(p.M - m0) : BM, n0,
              static_cast<int>(group) * p.N + n0};
}

// Offsets at k = 0 of the column group of 4 slab columns gm0 + 4·g4 (in one
// slab: w % 4 == 0) in u and in S.
struct Cols {
  long u, s;
  bool valid;
};

__device__ __forceinline__ Cols columns(const Problem& p, const Span& sp, int g4) {
  const long gc = sp.gm0 + 4 * g4, sl = gc / p.W, i = gc - sl * p.W, f = sl / p.C;
  const long plane = static_cast<long>(p.N) * p.W;
  return Cols{f * plane + i, (f / p.T * p.C + (sl - f * p.C)) * plane + i, 4 * g4 < sp.rows};
}

// Stage chunk `chunk` of tile sp into slot s (its mbarrier `bar`): this
// thread's 16-byte copies of A (its column group cols, at the [part][k] rows
// tid / 16 + i·threads / 16) and its arrival once they land; thread 0 also
// expects B's bytes and issues its two TMA boxes (rows b_row.., k0..k0 + 15;
// zero past the matrix).
__device__ __forceinline__ void stage(const Problem& p, const Span& sp, const Cols& cols, float* s,
                                      uint32_t bar, int chunk) {
  const int k0 = chunk * BK, g4 = threadIdx.x % (BM / 4);
  if (threadIdx.x == 0) {
    const uint32_t b = wgmma::smem_addr(s + A_FLOATS), part = p.squads * SN * BK * 4;
    mbar_expect_tx(bar, 2 * part);
    tma_load_2d(b, &p.b_map[0], k0, sp.b_row, bar);
    tma_load_2d(b + part, &p.b_map[1], k0, sp.b_row, bar);
  }
  for (int row = threadIdx.x / (BM / 4); row < 4 * BK; row += blockDim.x / (BM / 4)) {
    const int part = row / BK, kk = row % BK;
    const bool ok = cols.valid && k0 + kk < p.N;
    const float* const src = part == 0 ? p.ur : part == 1 ? p.ui : part == 2 ? p.sr : p.si;
    const long off = (part < 2 ? cols.u : cols.s) + static_cast<long>(k0 + kk) * p.W;
    cgemm::cp_async16(s + row * BM + 4 * g4, ok ? src + off : p.ur, ok ? 16 : 0);
  }
  wgmma::cp_async_arrive(bar);
}

// Form y = S ⊙ u of the chunk in slot s, in place of u (parts 0 and 1).
__device__ __forceinline__ void form_products(float* s) {
  constexpr int P = BK * BM;  // floats of a part
  for (int e = threadIdx.x; e < BK * BM / 4; e += blockDim.x) {
    float4* const y_r = reinterpret_cast<float4*>(s) + e;
    float4* const y_i = reinterpret_cast<float4*>(s + P) + e;
    const float4 u_r = *y_r, u_i = *y_i;
    const float4 s_r = reinterpret_cast<const float4*>(s + 2 * P)[e];
    const float4 s_i = reinterpret_cast<const float4*>(s + 3 * P)[e];
    float4 o_r, o_i;
    product(s_r.x, s_i.x, u_r.x, u_i.x, o_r.x, o_i.x);
    product(s_r.y, s_i.y, u_r.y, u_i.y, o_r.y, o_i.y);
    product(s_r.z, s_i.z, u_r.z, u_i.z, o_r.z, o_i.z);
    product(s_r.w, s_i.w, u_r.w, u_i.w, o_r.w, o_i.w);
    *y_r = o_r;
    *y_i = o_i;
  }
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc += y[m, k0 : k0 + 4·nq] · B[k0 : k0 + 4·nq, n] on the formed chunk in
// slot s: k ascending, the engine's four FMAs per complex product. `b_row`
// is this thread's first B row (squad·SN + tx) in the slot; row r's 16-byte
// chunk q sits at chunk q ^ ((r >> 1) & 3) (the TMA's 64-byte swizzle), so
// the 8 rows a quarter-warp reads fall on 32 distinct banks.
__device__ __forceinline__ void mma_chunk(const float* __restrict__ s, int b_row, int rb, int ty,
                                          int nq, float (&cr)[TM][TN], float (&ci)[TM][TN]) {
  const float* const ar = s + 4 * ty;
  const float* const ai = ar + BK * BM;
  const float* const br = s + A_FLOATS;
  const float* const bi = br + rb * BK;
#pragma unroll 1
  for (int kq = 0; kq < nq; ++kq) {
    float4 b_r[TN], b_i[TN];
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int r = b_row + 8 * n, off = r * BK + 4 * (kq ^ ((r >> 1) & 3));
      b_r[n] = *reinterpret_cast<const float4*>(br + off);
      b_i[n] = *reinterpret_cast<const float4*>(bi + off);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 4 * kq + kk;
      float a_r[TM], a_i[TM];
#pragma unroll
      for (int j = 0; j < TM / 4; ++j) {
        const float4 vr = *reinterpret_cast<const float4*>(ar + k * BM + 32 * j);
        const float4 vi = *reinterpret_cast<const float4*>(ai + k * BM + 32 * j);
        a_r[4 * j] = vr.x, a_r[4 * j + 1] = vr.y, a_r[4 * j + 2] = vr.z, a_r[4 * j + 3] = vr.w;
        a_i[4 * j] = vi.x, a_i[4 * j + 1] = vi.y, a_i[4 * j + 2] = vi.z, a_i[4 * j + 3] = vi.w;
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          const float bvr = lane4(b_r[n], kk), bvi = lane4(b_i[n], kk);
          cr[m][n] = fmaf(a_r[m], bvr, cr[m][n]);
          cr[m][n] = fmaf(-a_i[m], bvi, cr[m][n]);
          ci[m][n] = fmaf(a_r[m], bvi, ci[m][n]);
          ci[m][n] = fmaf(a_i[m], bvr, ci[m][n]);
        }
    }
  }
}

// Store this thread's outputs of tile sp: for each run of 4 slab columns
// and each of its rows, one float4 of z re and im.
__device__ __forceinline__ void epilogue(const Problem& p, const Span& sp, int n_first, int ty,
                                         const float (&cr)[TM][TN], const float (&ci)[TM][TN]) {
  const long plane = static_cast<long>(p.N) * p.W;
#pragma unroll
  for (int j = 0; j < TM / 4; ++j) {
    const int m = 4 * ty + 32 * j;
    if (m >= sp.rows) continue;  // rows % 4 == 0: a run is whole or absent
    const long gc = sp.gm0 + m, sl = gc / p.W, base = sl * plane + (gc - sl * p.W);
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int row = n_first + 8 * n;
      if (row >= p.N) continue;
      const long o = base + static_cast<long>(row) * p.W;
      *reinterpret_cast<float4*>(p.zr + o) =
          make_float4(cr[4 * j][n], cr[4 * j + 1][n], cr[4 * j + 2][n], cr[4 * j + 3][n]);
      *reinterpret_cast<float4*>(p.zi + o) =
          make_float4(ci[4 * j][n], ci[4 * j + 1][n], ci[4 * j + 2][n], ci[4 * j + 3][n]);
    }
  }
}

// One persistent block: tiles blockIdx.x, + gridDim.x, ... as one stream of
// chunks q (tile q / nk, chunk q % nk) through the ring. Iteration q: wait
// for chunk q's copies, form its products, barrier (every thread is done
// with chunk q − 1 and sees chunk q's products), stage chunk q + SLOTS − 1
// into the slot chunk q − 1 left, run chunk q's FMAs; after a tile's last
// chunk, its epilogue. Slots are 1024-byte aligned (the swizzle atoms).
__device__ __forceinline__ void run(const Problem& p) {
  const uint32_t s0 = wgmma::smem_addr(cgemm::smem);
  float* const ring = reinterpret_cast<float*>(reinterpret_cast<char*>(cgemm::smem) +
                                               (((s0 + 1023) & ~1023u) - s0));
  const int sf = slot_floats(p.squads);
  const uint32_t bar0 = wgmma::smem_addr(ring + SLOTS * sf);
  const long tiles = p.groups * p.row_tiles * p.passes;
  const int nk = (p.N + BK - 1) / BK;
  const long total = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * nk;  // chunks of this block
  auto tile_of = [&](long q) { return blockIdx.x + q / nk * gridDim.x; };
  const int squad = threadIdx.x / SQUAD, tx = threadIdx.x % 8, ty = threadIdx.x % SQUAD / 8;
  const int g4 = threadIdx.x % (BM / 4), rb = p.squads * SN;

  if (threadIdx.x == 0) {  // every thread's copies, and thread 0's expected bytes
    for (int i = 0; i < SLOTS; ++i) wgmma::mbar_init(bar0 + 8 * i, blockDim.x + 1);
    wgmma::mbar_init_fence();
  }
  __syncthreads();
  Span st = span(p, tile_of(0));  // the tile being staged
  Cols cols = columns(p, st, g4);
  for (long q = 0; q < SLOTS - 1 && q < total; ++q) {
    if (q % nk == 0 && q > 0) {
      st = span(p, tile_of(q));
      cols = columns(p, st, g4);
    }
    stage(p, st, cols, ring + q * sf, bar0 + 8 * static_cast<uint32_t>(q), static_cast<int>(q % nk));
  }
  Span cur = span(p, tile_of(0));  // the tile whose products run
  float cr[TM][TN], ci[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) cr[m][n] = ci[m][n] = 0.f;
  for (long q = 0; q < total; ++q) {
    const int slot = static_cast<int>(q % SLOTS), c = static_cast<int>(q % nk);
    float* const s = ring + slot * sf;
    wgmma::mbar_wait(bar0 + 8 * slot, (q / SLOTS) & 1);  // chunk q's copies landed
    form_products(s);
    __syncthreads();  // chunk q's products formed; chunk q − 1's FMAs done
    const long next = q + SLOTS - 1;  // into the slot of chunk q − 1
    if (next < total) {
      if (next % nk == 0) {
        st = span(p, tile_of(next));
        cols = columns(p, st, g4);
      }
      const int s2 = static_cast<int>(next % SLOTS);
      stage(p, st, cols, ring + s2 * sf, bar0 + 8 * s2, static_cast<int>(next % nk));
    }
    if (c == 0 && q > 0) cur = span(p, tile_of(q));
    mma_chunk(s, squad * SN + tx, rb, ty, min(BK, p.N - c * BK) / 4, cr, ci);
    if (c == nk - 1) {  // the tile's last chunk
      epilogue(p, cur, cur.n0 + squad * SN + tx, ty, cr, ci);
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) cr[m][n] = ci[m][n] = 0.f;
    }
  }
}

// B (groups·N rows of N floats) as a 2-D tensor map: boxes of BK x rows,
// 64-byte swizzle, zero past the matrix. The encoder comes from the driver
// through the runtime (no link to libcuda).
inline bool encode_b(CUtensorMap* map, const float* b, int N, int groups, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return false;
    }
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(groups) * N};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * sizeof(float)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(rows)}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(b), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch `Kernel` (a __global__ taking one __grid_constant__ Problem,
// __launch_bounds__(MAX_THREADS, 1)) over p.groups groups of p.M slab
// columns: squads for all of h in passes of at most MAX_SQUADS, and as many
// persistent blocks as fit on the card at once (read once per squad count),
// or one a tile.
template <auto Kernel>
int launch(Problem p, cudaStream_t s) {
  const int blocks_n = (p.N + SN - 1) / SN;
  p.passes = (blocks_n + MAX_SQUADS - 1) / MAX_SQUADS;
  p.squads = (blocks_n + p.passes - 1) / p.passes;
  p.row_tiles = (p.M + BM - 1) / BM;
  const long tiles = p.groups * p.row_tiles * p.passes;
  if (tiles == 0) return 0;
  if (!encode_b(&p.b_map[0], p.br, p.N, p.groups, p.squads * SN) ||
      !encode_b(&p.b_map[1], p.bi, p.N, p.groups, p.squads * SN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = SQUAD * p.squads, smem = smem_bytes(p.squads);
  static int resident[MAX_SQUADS + 1] = {};
  if (resident[p.squads] == 0) {
    cudaError_t err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem_bytes(MAX_SQUADS));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[p.squads] = per_sm * cgemm::sm_count();
  }
  const dim3 grid(static_cast<unsigned>(tiles < resident[p.squads] ? tiles : resident[p.squads]));
  Kernel<<<grid, threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32
