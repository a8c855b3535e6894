// Complex matrix product on the H100's tensor cores in TF32 through wgmma,
// the 'high' (3 passes) and 'default' (1 pass) precisions of the DFT
// (csrc/dft_matmul.cu) and of the normal apply's forward contraction
// (csrc/normal_apply.cu):
//
//   C (M x N) = A (M x K) · Bᵀ      B (N x K) k-contiguous, K = N
//
// on planar (re, im) float32 operands. B is W (the DFT) or a frame's K (the
// normal apply); the rows of A are the rows of x (I == 1) or the columns of
// (N, I) slabs (I > 1), and, in the normal apply at 'default', the products
// S_c ⊙ x_t formed here while staging. It computes what cgemm_tf32.cuh
// computes and ops/kernels/precision.py emulates: tf32(v) = cvt.rna (round
// half away from zero to 10 mantissa bits); 'default' takes tf32(a)·tf32(b),
// 'high' splits v = hi + lo, lo = tf32(v − hi), and takes a_lo·b_hi +
// a_hi·b_lo + a_hi·b_hi, the small terms first, into one f32 accumulator.
// Products of TF32 values are exact in f32, so this tile and the emulation
// differ only in summation order. The complex product is the 4 real
// products, cr = Σ ar·br − Σ ai·bi and ci = Σ ar·bi + Σ ai·br, summed as the
// plain version sums them: B stacked as B′ = [Br; Bi] (2·BN rows),
// acc1 = Ar·B′ᵀ = [Σ ar·br | Σ ar·bi] and acc2 = Ai·B′ᵀ = [Σ ai·br | Σ ai·bi],
// then cr = acc1[:, :BN] − acc2[:, BN:] and ci = acc1[:, BN:] + acc2[:, :BN]
// in the epilogue (columns n and n + BN of an accumulator lie in one thread).
//
// What bounds it on the H100: at N = K = 200 it does 8·N FLOP per output
// against 16 bytes moved; 1xTF32 needs 0.019 ms of tensor time at the
// flagship (150, 200, 200) against 0.029 ms of memory, 3xTF32 0.058 ms. On
// the card (measured) wgmma m64n80k8 runs at the full TF32 rate from shared
// memory, and what holds a 40-column tile back is the traffic from L2 into
// the SMs: A is read once per column tile (5 times at N = 200), B once per
// row tile, ~315 MB at the flagship, plus the latency of each chunk's
// copies, barrier and rounding, which a block of 8 warps hides poorly.
//
// Design:
// - wgmma.mma_async m64n80k8 .f32.tf32.tf32; B (and the resident A) in
//   shared memory through descriptors, K-major with the 128-byte swizzle
//   (TF32 wgmma reads shared operands K-major only: it has no transpose
//   flags): a row of a tile is 32 k (128 bytes), 16-byte chunk q of row r
//   sits at chunk q ^ (r % 8), 8-row groups 1024 bytes apart; a k8 step
//   advances the descriptor by 32 bytes. No wgmma sits under a branch
//   (ptxas serializes them behind a warpgroup arrive it cannot prove
//   uniform): k past the matrix and columns past N are zeros.
// - One rounding per element: raw f32 tiles arrive in a ring by 16-byte
//   cp.async copies from every thread (zero-filled past the matrix), each
//   slot completed on an mbarrier (cp.async.mbarrier.arrive; 1-D
//   cp.async.bulk rows cost ~70 clocks each in the SM's copy engine on the
//   card, 200-340 of them a chunk). Depth 32 a chunk, one block barrier a
//   chunk (7 for a 200-deep contraction); the copies run SLOTS − 1 chunks
//   ahead, and a chunk's rounding overlaps the products of the one before.
// - The streaming tile ('high', and 'default' grids the resident tile does
//   not fill): BM = 64·WG rows (a warpgroup per 64) x BN = 40 columns, A in
//   registers: each thread reads its m64n8k8 fragments from the raw tile
//   (16-byte chunks permuted so the reads hit distinct banks) and rounds and
//   splits them there; the block rounds B once into a swizzled operand slot.
//   Persistent blocks: a block's tiles form one stream of chunks, so the
//   next tile's copies are in flight during a tile's epilogue.
// - The resident tile ('default', N ≤ 224, grids of 64-row tiles that fill
//   the card): a block rounds its 64 rows of A (or S⊙x) once into a resident
//   swizzled copy of the whole contraction, then runs all N columns over it,
//   80 at a time (40 a warpgroup), streaming only B: A comes through L2 once
//   instead of N/40 times.
// Launch requirements (else csrc/dft_matmul.cu routes to cgemm_tf32.cuh):
// every operand 16-byte aligned, N % 4 == 0 and I == 1 or I % 4 == 0.

#pragma once

#include "cgemm_tile.cuh"

namespace wgmma {

// -- PTX primitives -------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// this thread's arrival on `bar` once all its cp.async copies so far have landed
// (the arrival is counted in the mbarrier's expected count)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving an accumulator across a wgmma wait
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
// K-major operand descriptor, 128-byte swizzle: start address >> 4, leading
// offset 1 (unused by swizzled K-major), stride 1024 bytes between 8-row groups
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
// d (64 x 80, f32) += a (64 x 8) · b (80 x 8)ᵀ: A's TF32 fragment in registers
// (a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4] of
// the warp's 16 rows, lane 4g + t), B in shared memory
__device__ __forceinline__ void mma(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// the same with A (64 x 8) in shared memory too, K-major with the 128-byte swizzle
__device__ __forceinline__ void mma_ss(float (&d)[40], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39}, %40, %41, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(1));
}
// -- end PTX primitives ---------------------------------------------------------

// Where the rows of A come from: rows of x (I == 1), columns of (N, I) slabs,
// or columns of the normal apply's (b·t·c, h, w) slabs formed as S_c ⊙ x_t.
enum Source { ROWS, SLAB, FUSED };

// The block tile and its shared memory: 3 raw slots (A's parts, then B as
// [Br; Bi] rows of 32 k), 2 operand slots of B rounded (and its lo part at
// 'high'), 1024-byte aligned, and an mbarrier per raw slot. Raw A tiles are
// laid out for conflict-free fragment reads with 16-byte chunks permuted:
// rows of x as [r][k] with chunk q of row r at q ^ (r % 8) (4·(c ^ g) + t
// for the lanes), slab A as [k][column] with column c at c ^ 8·(k % 4)
// (8·t ^ c + g). 64-row tiles at 'default' fit two blocks an SM.
template <int WG_, int PASSES_, Source SRC_, int SLOTS_>
struct Tile {
  static constexpr int WG = WG_, PASSES = PASSES_, SLOTS = SLOTS_;
  static constexpr Source SRC = SRC_;
  static constexpr int BM = 64 * WG, BN = 40, BK = 32, THREADS = 128 * WG;
  static constexpr int A_PART = 4 * BM * BK;            // bytes
  static constexpr int A_PARTS = SRC == FUSED ? 4 : 2;  // x re, x im (, S re, S im)
  static constexpr int B_RAW = 4 * 2 * BN * BK;
  static constexpr int RAW = A_PARTS * A_PART + B_RAW;
  static constexpr int B_OP = 2 * BN * BK * 4;  // swizzled [Br; Bi]
  static constexpr int OP = (PASSES == 3 ? 2 : 1) * B_OP;
  static constexpr int SMEM = 1024 + SLOTS * RAW + 2 * OP + 8 * SLOTS;
  static_assert(PASSES == 1 || PASSES == 3, "1xTF32 or 3xTF32");
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
};

// One launch's operands. K = N: W (N x N) and K (H x H) are square.
struct Problem {
  const float* ar;  // A: x
  const float* ai;
  const float* sr;  // FUSED: coil maps S (b, c, h, w)
  const float* si;
  const float* br;  // B: N x N k-contiguous; group g's at + g·N·N
  const float* bi;
  float* yr;        // C: rows of y (I == 1), or (O, N, I) slabs
  float* yi;
  long M;           // rows of A in a group: rows or slab columns
  int N;
  int I;            // slab width (1: the rows instance)
  int C, T;         // FUSED: slab sl = f·C + c, frame f = b·T + t
  int groups = 1;   // groups of M rows, group g with B at + g·N·N
  int n_tiles = 0;  // column tiles of BN (set by launch)
  long row_tiles = 0;  // row tiles of BM in a group (set by launch)
};

// One output tile: rows [gm0, gm0 + rows) of A (global over the groups),
// columns [n0, n0 + nb), and its group's B. Tile t runs over (group, row
// tile, column tile), the column tiles of a row tile side by side.
struct Span {
  long gm0;
  int rows, n0, nb;
  const float* b_re;
  const float* b_im;
};

template <class T>
__device__ __forceinline__ Span span(const Problem& p, long t) {
  const long rt = t / p.n_tiles, group = rt / p.row_tiles;
  const long m0 = (rt - group * p.row_tiles) * T::BM;
  const int n0 = static_cast<int>(t - rt * p.n_tiles) * T::BN;
  const long bo = group * p.N * p.N;
  return Span{group * p.M + m0, p.M - m0 < T::BM ? static_cast<int>(p.M - m0) : T::BM, n0,
              min(T::BN, p.N - n0), p.br + bo, p.bi + bo};
}

// Where this thread's copies of a slab A come from: its column group (4
// columns, in one slab as I % 4 == 0) is the same at every chunk of a tile.
struct Cols {
  long x, s;   // offsets of the group's x and S columns at k = 0
  bool valid;  // inside the tile's rows
};

template <class T>
__device__ __forceinline__ Cols columns(const Problem& p, const Span& sp) {
  Cols c{0, 0, false};
  if constexpr (T::SRC != ROWS) {
    const int r = threadIdx.x % (T::BM / 4) * 4;
    const long gc = sp.gm0 + r, sl = gc / p.I, i = gc - sl * p.I, slab = static_cast<long>(p.N) * p.I;
    const long f = T::SRC == FUSED ? sl / p.C : sl;
    c.x = f * slab + i;
    c.s = (f / p.T * p.C + sl % p.C) * slab + i;
    c.valid = r < sp.rows;
  }
  return c;
}

// Stage chunk `chunk` of the tile `sp` into raw slot `raw`: every thread's
// 16-byte cp.async copies (zero past the matrix: rows, columns and k), then
// its arrival on the slot's mbarrier once they land.
template <class T>
__device__ __forceinline__ void stage(const Problem& p, const Span& sp, const Cols& cols,
                                      float* raw, uint32_t bar, int chunk) {
  constexpr int AF = T::A_PART / 4;  // floats of a part
  const int k0 = chunk * T::BK;
  if constexpr (T::SRC == ROWS) {  // part, row r, k 4q .. 4q + 3
    const int q = threadIdx.x % 8, k = k0 + 4 * q;
#pragma unroll
    for (int rr = threadIdx.x / 8; rr < 2 * T::BM; rr += T::THREADS / 8) {
      const int part = rr / T::BM, r = rr % T::BM;
      const bool ok = r < sp.rows && k < p.N;
      cgemm::cp_async16(raw + part * AF + r * T::BK + 4 * (q ^ (r & 7)),
                        ok ? (part ? p.ai : p.ar) + (sp.gm0 + r) * p.N + k : p.ar, ok ? 16 : 0);
    }
  } else {  // part, k row kk, this thread's column group
    constexpr int G = T::BM / 4;  // column groups
    static_assert(T::THREADS % G == 0, "a thread keeps its column group");
    const int c4 = threadIdx.x % G;
#pragma unroll
    for (int row = threadIdx.x / G; row < T::A_PARTS * T::BK; row += T::THREADS / G) {
      const int part = row / T::BK, kk = row % T::BK;
      const bool ok = cols.valid && k0 + kk < p.N;
      const float* const src = part == 0 ? p.ar : part == 1 ? p.ai : part == 2 ? p.sr : p.si;
      const long off = (part < 2 ? cols.x : cols.s) + static_cast<long>(k0 + kk) * p.I;
      cgemm::cp_async16(raw + part * AF + kk * T::BM + ((4 * c4) ^ (8 * (kk & 3))), ok ? src + off : p.ar,
                        ok ? 16 : 0);
    }
  }
  for (int u = threadIdx.x; u < 2 * T::BN * 8; u += T::THREADS) {  // B rows n0 + j, re then im
    const int q = u % 8, jj = u / 8, j = jj % T::BN, k = k0 + 4 * q;
    const bool ok = j < sp.nb && k < p.N;
    cgemm::cp_async16(raw + T::A_PARTS * AF + jj * T::BK + 4 * q,
                      ok ? (jj < T::BN ? sp.b_re : sp.b_im) + static_cast<long>(sp.n0 + j) * p.N + k
                         : p.br,
                      ok ? 16 : 0);
  }
  cp_async_arrive(bar);
}

// byte offset of 16-byte chunk q of row r in a swizzled K-major tile
__device__ __forceinline__ int swz(int r, int q) { return r * 128 + ((q ^ (r & 7)) << 4); }

// Round B of the raw slot (rows of 32 k) once into operand slot op:
// hi, and at 'high' lo = tf32(v − hi) B_OP bytes further.
template <class T>
__device__ __forceinline__ void convert_b(const float* raw, char* op) {
  const float* const b = raw + T::A_PARTS * T::A_PART / 4;
#pragma unroll
  for (int i = 0; i < (2 * T::BN * 8 + T::THREADS - 1) / T::THREADS; ++i) {
    const int u = threadIdx.x + i * T::THREADS, q = u % 8, jj = u / 8;
    if (u >= 2 * T::BN * 8) break;
    const float4 v = *reinterpret_cast<const float4*>(b + jj * T::BK + 4 * q);
    const uint4 hi = make_uint4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
    *reinterpret_cast<uint4*>(op + swz(jj, q)) = hi;
    if constexpr (T::PASSES == 3)
      *reinterpret_cast<uint4*>(op + T::B_OP + swz(jj, q)) =
          make_uint4(to_tf32(v.x - __uint_as_float(hi.x)), to_tf32(v.y - __uint_as_float(hi.y)),
                     to_tf32(v.z - __uint_as_float(hi.z)), to_tf32(v.w - __uint_as_float(hi.w)));
  }
}

// This thread's A fragments of a chunk, rounded (hi) and split (lo, 'high'):
// [re, im][k8 step][a0..a3].
template <class T>
struct Frags {
  uint32_t hi[2][T::BK / 8][4];
  uint32_t lo[2][T::BK / 8][T::PASSES == 3 ? 4 : 1];
};

template <class T>
__device__ __forceinline__ void load_a(const float* raw, Frags<T>& f) {
  constexpr int AF = T::A_PART / 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = threadIdx.x / 32 * 16 + g;  // rows r0, r0 + 8 of the block tile
#pragma unroll
  for (int ks = 0; ks < T::BK / 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e & 1) * 8, k = 8 * ks + t + (e >> 1) * 4;
      const int off = T::SRC == ROWS ? r * T::BK + 4 * ((k >> 2) ^ (r & 7)) + (k & 3)
                                     : k * T::BM + (r ^ (8 * (k & 3)));
      float vr = raw[off], vi = raw[AF + off];
      if constexpr (T::SRC == FUSED) {  // y = S ⊙ x, as products<VEC, true>
        const float sr = raw[2 * AF + off], si = raw[3 * AF + off];
        const float xr = vr, xi = vi;
        vr = __fsub_rn(__fmul_rn(sr, xr), __fmul_rn(si, xi));
        vi = __fadd_rn(__fmul_rn(sr, xi), __fmul_rn(si, xr));
      }
      f.hi[0][ks][e] = to_tf32(vr);
      f.hi[1][ks][e] = to_tf32(vi);
      if constexpr (T::PASSES == 3) {
        f.lo[0][ks][e] = to_tf32(vr - __uint_as_float(f.hi[0][ks][e]));
        f.lo[1][ks][e] = to_tf32(vi - __uint_as_float(f.hi[1][ks][e]));
      }
    }
}

// Pin the accumulators in their registers here, so that no other instruction
// defines them between two wgmmas (which would serialize them).
__device__ __forceinline__ void fence_acc(float (&acc1)[40], float (&acc2)[40]) {
#pragma unroll
  for (int e = 0; e < 40; ++e) {
    fence_reg(acc1[e]);
    fence_reg(acc2[e]);
  }
}

// Issue this warpgroup's products of a chunk (A fragments f, B in operand
// slot op) and commit them. No wgmma sits under a branch: ptxas serializes
// wgmmas behind a warpgroup arrive it cannot prove uniform.
template <class T>
__device__ __forceinline__ void mma_chunk(const Frags<T>& f, uint32_t op, float (&acc1)[40],
                                          float (&acc2)[40]) {
  fence_acc(acc1, acc2);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < T::BK / 8; ++ks) {  // all 4 steps: k past the matrix is zero
    const uint64_t b = desc(op + ks * 32);
    if constexpr (T::PASSES == 3) {
      const uint64_t bl = desc(op + T::B_OP + ks * 32);
      mma(acc1, f.lo[0][ks], b);  // a_lo · b_hi
      mma(acc2, f.lo[1][ks], b);
      mma(acc1, f.hi[0][ks], bl);  // a_hi · b_lo
      mma(acc2, f.hi[1][ks], bl);
    }
    mma(acc1, f.hi[0][ks], b);  // a_hi · b_hi
    mma(acc2, f.hi[1][ks], b);
  }
  wg_commit();
  fence_acc(acc1, acc2);
}

// Write this warpgroup's accumulators, 64 rows, to the rows [gm0, gm0 +
// rows) and columns [n0, n0 + nb) of C from the fragments (rows 16·warp + g
// and + 8, columns 8j + 2t and + 1): neighbouring lanes store neighbouring
// i of a slab, or pairs of columns of a row.
template <class R>
__device__ __forceinline__ void epilogue(const Problem& p, const Span& sp,
                                                const float (&acc1)[40], const float (&acc2)[40]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = threadIdx.x % 128 / 32 * 16 + g + 8 * h;
    if (r >= sp.rows) continue;
    const long gc = sp.gm0 + r;
    long off;  // y[row or column gc, column 0]
    if constexpr (R::SRC == ROWS) {
      off = gc * p.N;
    } else {
      const long sl = gc / p.I;
      off = sl * p.N * p.I + (gc - sl * p.I);
    }
#pragma unroll
    for (int j = 0; j < R::BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= sp.nb) continue;  // nb % 4 == 0: col + 1 < nb too
      const int e = 4 * j + 2 * h, f = 4 * (j + R::BN / 8) + 2 * h;
      const float r0 = acc1[e] - acc2[f], r1 = acc1[e + 1] - acc2[f + 1];
      const float i0 = acc1[f] + acc2[e], i1 = acc1[f + 1] + acc2[e + 1];
      if constexpr (R::SRC == ROWS) {
        *reinterpret_cast<float2*>(p.yr + off + sp.n0 + col) = make_float2(r0, r1);
        *reinterpret_cast<float2*>(p.yi + off + sp.n0 + col) = make_float2(i0, i1);
      } else {
        const long o0 = off + static_cast<long>(sp.n0 + col) * p.I;
        p.yr[o0] = r0;
        p.yr[o0 + p.I] = r1;
        p.yi[o0] = i0;
        p.yi[o0 + p.I] = i1;
      }
    }
  }
}

// One persistent block: tiles blockIdx.x, + gridDim.x, ... as one stream of
// chunks q (tile q / nk, chunk q % nk) through the ring of SLOTS raw slots.
// Iteration q: wait for chunk q's copies, round its B into operand slot
// q % 2, wait for this warpgroup's products of chunk q − 1, barrier, stage
// chunk q + SLOTS − 1 into the slot chunk q − 1 left, read and round A's
// fragments of chunk q and issue its products; after a tile's last chunk,
// its epilogue.
template <class T>
__device__ __forceinline__ void run(const Problem& p) {
  const uint32_t s0 = smem_addr(cgemm::smem);
  const uint32_t base = (s0 + 1023) & ~1023u;
  char* const gbase = reinterpret_cast<char*>(cgemm::smem) + (base - s0);
  const uint32_t op0 = base + T::SLOTS * T::RAW, bar0 = op0 + 2 * T::OP;
  auto raw = [&](int slot) { return reinterpret_cast<float*>(gbase + slot * T::RAW); };
  const long tiles = p.groups * p.row_tiles * p.n_tiles;
  const int nk = (p.N + T::BK - 1) / T::BK;
  const long total = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * nk;  // chunks of this block
  auto tile_of = [&](long q) { return blockIdx.x + q / nk * gridDim.x; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::SLOTS; ++i) mbar_init(bar0 + 8 * i, T::THREADS);
    mbar_init_fence();
  }
  __syncthreads();
  Span st = span<T>(p, tile_of(0));  // the tile being staged
  Cols cols = columns<T>(p, st);
  for (long q = 0; q < T::SLOTS - 1 && q < total; ++q) {
    if (q % nk == 0 && q > 0) {
      st = span<T>(p, tile_of(q));
      cols = columns<T>(p, st);
    }
    stage<T>(p, st, cols, raw(static_cast<int>(q)), bar0 + 8 * static_cast<uint32_t>(q),
             static_cast<int>(q % nk));
  }
  Span cur = span<T>(p, tile_of(0));  // the tile whose products run
  float acc1[40], acc2[40];
#pragma unroll
  for (int e = 0; e < 40; ++e) acc1[e] = acc2[e] = 0.f;
  for (long q = 0; q < total; ++q) {
    const int slot = static_cast<int>(q % T::SLOTS), c = static_cast<int>(q % nk), os = q & 1;
    mbar_wait(bar0 + 8 * slot, (q / T::SLOTS) & 1);  // every thread's copies of chunk q landed
    convert_b<T>(raw(slot), gbase + (op0 - base) + os * T::OP);
    fence_async_shared();
    wg_wait<0>();     // this warpgroup's products of chunk q − 1 are done
    __syncthreads();  // every warpgroup's are; B of chunk q is rounded
    const long next = q + T::SLOTS - 1;  // into the slot of chunk q − 1, read by now
    if (next < total) {
      if (next % nk == 0) {
        st = span<T>(p, tile_of(next));
        cols = columns<T>(p, st);
      }
      const int s2 = static_cast<int>(next % T::SLOTS);
      stage<T>(p, st, cols, raw(s2), bar0 + 8 * s2, static_cast<int>(next % nk));
    }
    if (c == 0 && q > 0) cur = span<T>(p, tile_of(q));
    Frags<T> f;
    load_a<T>(raw(slot), f);
    mma_chunk<T>(f, op0 + os * T::OP, acc1, acc2);
    if (c == nk - 1) {  // the tile's last chunk: store this warpgroup's 64 rows
      wg_wait<0>();
      fence_acc(acc1, acc2);
      const int w64 = threadIdx.x / 128 * 64;
      epilogue<T>(p, Span{cur.gm0 + w64, cur.rows - w64, cur.n0, cur.nb, nullptr, nullptr}, acc1,
                  acc2);
#pragma unroll
      for (int e = 0; e < 40; ++e) acc1[e] = acc2[e] = 0.f;
    }
  }
}

// 'default' (1xTF32) with A resident. Each block takes 64 rows of A: it
// stages them once, rounds them into a resident swizzled K-major copy of the
// whole contraction (K ≤ 224), then runs every column of the output over it
// in steps of 80 columns (40 a warpgroup), streaming only B. So A comes
// through L2 once instead of once per 40-column tile (5 times at N = 200),
// which is what bounds the streaming tile at 'default' on the card, and the
// normal apply's products are formed once per element. 'high' (hi and lo of A
// would take 224 KB) stays on the streaming tile.
template <Source SRC_>
struct Resident {
  static constexpr Source SRC = SRC_;
  static constexpr int PASSES = 1;
  static constexpr int BM = 64, BN = 40, BK = 32, THREADS = 256;
  static constexpr int NKB = 7;                   // 32-k blocks of the resident A: K ≤ 224
  static constexpr int CN = 2 * BN;               // columns a step
  static constexpr int A_BLOCK = BM * 128;        // bytes of one part's 32-k block
  static constexpr int A_BUF = NKB * 2 * A_BLOCK;
  static constexpr int A_PARTS = SRC == FUSED ? 4 : 2;
  static constexpr int A_JOB = A_PARTS * BM * BK * 4;
  static constexpr int B_JOB = 2 * CN * BK * 4;  // [Br; Bi] of each warpgroup's 40 columns
  static constexpr int SLOT = A_JOB > B_JOB ? A_JOB : B_JOB;
  static constexpr int SLOTS = SRC == FUSED ? 2 : 3;
  static constexpr int B_OP = 2 * CN * 128;
  static constexpr int SMEM = 1024 + A_BUF + 2 * B_OP + SLOTS * SLOT + 8 * SLOTS;
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
};

// Stage job j of a row tile into a ring slot: jobs 0 .. nk − 1 are A's 32-k
// chunks (raw as [part][r][k] rows, or [part][k][column] for slabs), then
// step s, chunk c of B at job nk + s·nk + c (rows jj = 80·w + 40·part + j:
// warpgroup w's column n0 + 40·w + j, re then im).
template <class R>
__device__ __forceinline__ void stage_job(const Problem& p, const Span& sp, const Cols& cols,
                                          float* slot, uint32_t bar, int job, int nk) {
  if (job < nk) {
    const int k0 = job * R::BK;
    if constexpr (R::SRC == ROWS) {
      const int q = threadIdx.x % 8, k = k0 + 4 * q;
#pragma unroll
      for (int i = 0; i < 2 * R::BM * 8 / R::THREADS; ++i) {
        const int rr = threadIdx.x / 8 + i * (R::THREADS / 8), part = rr / R::BM, r = rr % R::BM;
        const bool ok = r < sp.rows && k < p.N;
        cgemm::cp_async16(slot + rr * R::BK + 4 * q,
                          ok ? (part ? p.ai : p.ar) + (sp.gm0 + r) * p.N + k : p.ar, ok ? 16 : 0);
      }
    } else {
      constexpr int G = R::BM / 4;  // column groups
      const int c4 = threadIdx.x % G;
#pragma unroll
      for (int i = 0; i < R::A_PARTS * R::BK * G / R::THREADS; ++i) {
        const int row = threadIdx.x / G + i * (R::THREADS / G), part = row / R::BK, kk = row % R::BK;
        const bool ok = cols.valid && k0 + kk < p.N;
        const float* const src = part == 0 ? p.ar : part == 1 ? p.ai : part == 2 ? p.sr : p.si;
        const long off = (part < 2 ? cols.x : cols.s) + static_cast<long>(k0 + kk) * p.I;
        cgemm::cp_async16(slot + row * R::BM + 4 * c4, ok ? src + off : p.ar, ok ? 16 : 0);
      }
    }
  } else {
    const int b = job - nk, s = b / nk, c = b - s * nk, k = c * R::BK + 4 * (threadIdx.x % 8);
#pragma unroll
    for (int i = 0; i < 2 * R::CN * 8 / R::THREADS; ++i) {
      const int jj = threadIdx.x / 8 + i * (R::THREADS / 8);
      const int n = s * R::CN + jj / R::CN * R::BN + jj % R::BN, part = jj % R::CN / R::BN;
      const bool ok = n < p.N && k < p.N;
      cgemm::cp_async16(slot + jj * R::BK + 4 * (threadIdx.x % 8),
                        ok ? (part ? sp.b_im : sp.b_re) + static_cast<long>(n) * p.N + k : p.br,
                        ok ? 16 : 0);
    }
  }
  cp_async_arrive(bar);
}

// Round A's chunk c from its slot into the resident blocks (c, re) and (c, im).
template <class R>
__device__ __forceinline__ void convert_a(const float* slot, char* abuf, int c) {
  char* const blk = abuf + 2 * c * R::A_BLOCK;
  if constexpr (R::SRC == ROWS) {  // rows: 16-byte chunk q of row r
#pragma unroll
    for (int i = 0; i < 2 * R::BM * 8 / R::THREADS; ++i) {
      const int u = threadIdx.x + i * R::THREADS, q = u % 8, rr = u / 8;
      const float4 v = *reinterpret_cast<const float4*>(slot + rr * R::BK + 4 * q);
      *reinterpret_cast<uint4*>(blk + rr / R::BM * R::A_BLOCK + swz(rr % R::BM, q)) =
          make_uint4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
    }
  } else {  // [part][k][BM]: column r's k 4q .. 4q + 3, transposed
    constexpr int P = R::BK * R::BM;  // floats of a part
#pragma unroll
    for (int i = 0; i < R::BM * 8 / R::THREADS; ++i) {
      const int u = threadIdx.x + i * R::THREADS, r = u % R::BM, q = u / R::BM;
      const float* const s = slot + 4 * q * R::BM + r;
      uint32_t yr[4], yi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vr = s[e * R::BM], vi = s[P + e * R::BM];
        if constexpr (R::SRC == FUSED) {  // y = S ⊙ x, as products<VEC, true>
          const float sr = s[2 * P + e * R::BM], si = s[3 * P + e * R::BM], xr = vr, xi = vi;
          vr = __fsub_rn(__fmul_rn(sr, xr), __fmul_rn(si, xi));
          vi = __fadd_rn(__fmul_rn(sr, xi), __fmul_rn(si, xr));
        }
        yr[e] = to_tf32(vr);
        yi[e] = to_tf32(vi);
      }
      *reinterpret_cast<uint4*>(blk + swz(r, q)) = make_uint4(yr[0], yr[1], yr[2], yr[3]);
      *reinterpret_cast<uint4*>(blk + R::A_BLOCK + swz(r, q)) = make_uint4(yi[0], yi[1], yi[2], yi[3]);
    }
  }
}

// Round a B chunk from its slot into operand slot op (rows as staged).
template <class R>
__device__ __forceinline__ void convert_bstep(const float* slot, char* op) {
#pragma unroll
  for (int i = 0; i < 2 * R::CN * 8 / R::THREADS; ++i) {
    const int u = threadIdx.x + i * R::THREADS, q = u % 8, jj = u / 8;
    const float4 v = *reinterpret_cast<const float4*>(slot + jj * R::BK + 4 * q);
    *reinterpret_cast<uint4*>(op + swz(jj, q)) =
        make_uint4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
  }
}

// One block: row tile blockIdx.x (over the groups). Jobs through the ring as
// the streaming tile runs its chunks: wait for job j's copies, round it
// (A into the resident blocks, or B into operand slot), wait for this
// warpgroup's products of job j − 1, barrier, stage job j + SLOTS into the
// slot just read, and for a B job issue this warpgroup's products on the
// resident A; after a step's last chunk, its epilogue.
template <class R>
__device__ __forceinline__ void run_resident(const Problem& p) {
  const uint32_t s0 = smem_addr(cgemm::smem);
  const uint32_t base = (s0 + 1023) & ~1023u;
  char* const gbase = reinterpret_cast<char*>(cgemm::smem) + (base - s0);
  const uint32_t bop0 = base + R::A_BUF, ring0 = bop0 + 2 * R::B_OP, bar0 = ring0 + R::SLOTS * R::SLOT;
  auto slot = [&](int i) { return reinterpret_cast<float*>(gbase + (ring0 - base) + i * R::SLOT); };
  const long group = blockIdx.x / p.row_tiles, m0 = (blockIdx.x - group * p.row_tiles) * R::BM;
  const long bo = group * p.N * p.N;
  const Span sp{group * p.M + m0, p.M - m0 < R::BM ? static_cast<int>(p.M - m0) : R::BM, 0, 0,
                p.br + bo, p.bi + bo};
  const Cols cols = columns<R>(p, sp);
  const int nk = (p.N + R::BK - 1) / R::BK, steps = (p.N + R::CN - 1) / R::CN;
  const int jobs = nk + steps * nk, w = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < R::SLOTS; ++i) mbar_init(bar0 + 8 * i, R::THREADS);
    mbar_init_fence();
  }
  __syncthreads();
  for (int j = 0; j < R::SLOTS && j < jobs; ++j) stage_job<R>(p, sp, cols, slot(j), bar0 + 8 * j, j, nk);
  float acc1[40], acc2[40];
#pragma unroll
  for (int e = 0; e < 40; ++e) acc1[e] = acc2[e] = 0.f;
  for (int j = 0; j < jobs; ++j) {
    const int sl = j % R::SLOTS, b = j - nk;
    mbar_wait(bar0 + 8 * sl, (j / R::SLOTS) & 1);  // every thread's copies of job j landed
    if (b < 0) {
      convert_a<R>(slot(sl), gbase, j);
    } else {
      convert_bstep<R>(slot(sl), gbase + (bop0 - base) + (b & 1) * R::B_OP);
    }
    fence_async_shared();
    wg_wait<0>();     // this warpgroup's products of job j − 1 are done
    __syncthreads();  // every warpgroup's are; job j is rounded, its slot read
    if (j + R::SLOTS < jobs)
      stage_job<R>(p, sp, cols, slot(sl), bar0 + 8 * sl, j + R::SLOTS, nk);
    if (b < 0) continue;
    const int s = b / nk, c = b - s * nk, n0 = s * R::CN + w * R::BN;
    // unconditional products (a branch would serialize them): columns past N
    // and k past K are zero
    const uint32_t a = base + 2 * c * R::A_BLOCK, bb = bop0 + (b & 1) * R::B_OP + w * R::CN * 128;
    fence_acc(acc1, acc2);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < R::BK / 8; ++ks) {
      mma_ss(acc1, desc(a + ks * 32), desc(bb + ks * 32));
      mma_ss(acc2, desc(a + R::A_BLOCK + ks * 32), desc(bb + ks * 32));
    }
    wg_commit();
    fence_acc(acc1, acc2);
    if (c == nk - 1) {  // the step's last chunk: store this warpgroup's 40 columns
      wg_wait<0>();
      fence_acc(acc1, acc2);
      const Span out{sp.gm0, sp.rows, n0, min(R::BN, p.N - n0), nullptr, nullptr};
      epilogue<R>(p, out, acc1, acc2);  // none when n0 >= N
#pragma unroll
      for (int e = 0; e < 40; ++e) acc1[e] = acc2[e] = 0.f;
    }
  }
}

// Whether the resident tile R fills the card: one block a row tile.
template <class R>
bool resident_fills(long M, int N, int groups) {
  return N <= R::NKB * R::BK && (M + R::BM - 1) / R::BM * groups >= cgemm::sm_count();
}

// Launch `Kernel` on the resident tile R: one block a row tile of 64.
template <class R, auto Kernel>
int launch_resident(Problem p, cudaStream_t s) {
  p.n_tiles = 1;
  p.row_tiles = (p.M + R::BM - 1) / R::BM;
  const long blocks = p.groups * p.row_tiles;
  if (blocks == 0) return 0;
  return cgemm::launch<Kernel>(dim3(static_cast<unsigned>(blocks)), R::THREADS, R::SMEM, s, p);
}

// Instances of the streaming tile: 128 rows (two warpgroups) and a ring of 3
// when the tiles fill the card; else (the sens net's 2000 slab columns) 64
// rows, two blocks an SM: a ring of 3 at 'default' (99 KB), of 2 at 'high'
// (its operand slots hold hi and lo; 92 KB).
template <int PASSES, Source SRC>
using Wide = Tile<2, PASSES, SRC, 3>;
template <int PASSES, Source SRC>
using Narrow = Tile<1, PASSES, SRC, PASSES == 3 ? 2 : 3>;

// Launch `Kernel` (a __global__ taking one Problem) on tile T over M rows of
// each of p.groups groups: as many persistent blocks as the SMs hold at once
// (read once), or one a tile.
template <class T, auto Kernel>
int launch(Problem p, cudaStream_t s) {
  static int resident = 0;
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, Kernel, T::THREADS, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident *= cgemm::sm_count();
  }
  p.n_tiles = (p.N + T::BN - 1) / T::BN;
  p.row_tiles = (p.M + T::BM - 1) / T::BM;
  const long tiles = p.groups * p.row_tiles * p.n_tiles;
  if (tiles == 0) return 0;
  const dim3 grid(static_cast<unsigned>(tiles < resident ? tiles : resident));
  return cgemm::launch<Kernel>(grid, T::THREADS, T::SMEM, s, p);
}

// True when a launch of `tiles` blocks of the wide tile gives every SM one.
inline bool wide_fills(long rows, int N, int groups) {
  const long tiles = (rows + 127) / 128 * ((N + 39) / 40) * groups;
  return tiles >= cgemm::sm_count();
}

}  // namespace wgmma
