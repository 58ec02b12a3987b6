// The gradient of the Mamba2 SSD chunk scan in bf16 for Hopper (sm_90a):
// every product on the tensor cores (wgmma), xd, dy, B_ and C_ fed by TMA
// through mbarrier rings. The bf16 route of ssd_scan_bwd.cu's entry
// point; fp32 keeps the CUDA-core kernels there, and no bf16 launch
// reaches them.
//
// Replaces no pallas_call: on the TPU the gradient is XLA's autodiff of
// repro/models/ssm.py::ssd_chunked. It computes what
// kernels/ssd/ref.py::ssd_scan_bwd_ref computes (the formulas are at the
// top of ssd_scan_bwd.cu): dxd, da, dB and dC from dy and an optional
// fp32 dstate, for bf16 xd [B, L, H, P], B_ and C_ [B, L, N] and fp32 a
// [B, L, H]; chunk K 16, 32, 64 or 128, P <= 64, N <= 128, any L (a
// ragged last chunk's rows past L arrive as TMA's zeros, with a = 0).
//
// What bounds it on an H100. At Mamba2-370M's train launch (8, 512, 32,
// 64, 128, 128) the function needs 17.30 GFLOP (17.5 us at the bf16
// peak) and moves 55.6 MB (16.6 us at 3.35 TB/s): operations, barely. At
// Zamba2-2.7B's (8, 512, 80, 64, 64, 128) the bytes, 130.5 MB, 39.0 us.
// This design moves its fp32 states through device memory (the scratch
// below, more than the function's own bytes) and does ~2.6x the
// function's products (the pieces, the transposes formed again, whole
// diagonal tiles), each block two consumer warpgroups that wait on
// every product before the next; its times beside the bound, and what
// each part costs, are in PERF.md section 6.
//
// Design: four launches, every sum in a fixed order (no atomics, so two
// launches give the same bits and a row's bits do not depend on the
// batch).
//
// 1. ssd_wgmma_bwd_states, grid (H / HPB, B): the states as the
//    state-passing form gives them, one block per (batch, HPB heads: 1
//    at N > 64, else 2) walking the chunks forwards (the state S entering
//    each chunk, from zero) and then backwards (the cotangent dS of the
//    state leaving each chunk, from dstate), each head's [N, P] state in
//    fp32 registers of its consumer warpgroups (one a 64 rows of N, two
//    a block), each chunk's xd or dy and B_ or C_ loaded by TMA a stage
//    ahead. Per chunk: the state to the scratch, then state' = state
//    exp(cum_K) + (V o w)^T U, V o w (B o decay or C o exp(cum)) the
//    register A operand in UPDATE_PIECES bf16 pieces. On the way back
//    the walk reads its own S of the chunk again and writes exp(cum_K)
//    <S, dS> (da's last-row term) in fp32.
// 2. ssd_wgmma_bwd_chunks, grid (2 n_chunks, ceil(H / HEADS), B): one
//    launch of two kinds of block per (chunk, batch, group of HEADS
//    heads), each one consumer warpgroup a 64-row tile of the chunk and
//    a producer warpgroup. B_ and C_ of the chunk are loaded once; per head xd and
//    dy by TMA into a ring of two stages, while the producer's other
//    three warps split that head's fp32 state (S for the q-kind, dS for
//    the k-kind), brought by a bulk copy a head ahead, into STATE_PIECES
//    bf16 pieces in shared memory (the image wgmma reads). The heads are
//    walked in order, dB or dC summed over them in fp32 registers:
//    q-kind (rows q of the tile):
//      dy S            wgmma, S's pieces K-major; dC += exp(cum_q) o dy S,
//                      carried_q = exp(cum_q) C_q . (dy S)_q;
//      per 64 columns k <= q's tile:
//        C B^T, dy xd^T                 wgmma, every operand K-major;
//        D = (dy xd^T) o Lmat           in registers, exp only where k <= q;
//        rowsum(D o C B^T) for da;
//        dC += D B                      D the register A operand in
//                                       D_PIECES pieces, B MN-major.
//    k-kind (rows k of the tile):
//      xd dS           dB += decay_k o xd dS, G_k = decay_k B_k . (xd dS)_k;
//      B dS^T          DXD_STATE_PIECES of dS, MN-major: dxd = decay_k o
//                      B dS^T;
//      per 64 columns q >= k's tile:
//        B C^T, xd dy^T                 the transposes of C B^T and of
//                                       dy xd^T, formed directly;
//        D^T, M^T = (B C^T) o Lmat^T    in registers; colsum for da;
//        dB += D^T C, dxd += M^T dy     D^T and M^T register A operands
//                                       (D_PIECES, M_PIECES), C and dy
//                                       MN-major.
//    Each block writes its group's dB or dC in fp32 ([G, B, L, N]); its
//    rows' da terms and dxd per head.
// 3. ssd_wgmma_bwd_da, a warp per (chunk, head, batch): da, the reverse
//    cumsum over the chunk in double of rowsum + carried - colsum - G,
//    from sum(G) + exp(cum_K) <S, dS> at the last row.
// 4. ssd_wgmma_bwd_sum: dB and dC, the groups' sums in order, in bf16.
//
// As in every SSD kernel here: exp of the mask is taken only on and below
// the diagonal (above it exp can overflow at dt's clip, and 0 x inf is
// NaN); cum is summed in double and rounded once (the producer warp);
// rows past L never enter a sum and are never written.
//
// Numerics. xd, dy, B_ and C_ are bf16 and exact operands. The fp32
// operands go to the tensor cores in bf16 pieces, each the rounding of
// what the earlier ones leave, each product summed in fp32:
// UPDATE_PIECES of B o decay and C o exp(cum), STATE_PIECES of S and dS
// (DXD_STATE_PIECES of dS in dxd's B dS^T), D_PIECES of D and D^T,
// M_PIECES of M^T. tests/test_torch_ssd_bwd_numerics.py emulates this
// arithmetic on the CPU and chose them at
// Mamba2-370M's and Zamba2-2.7B's instantiations: each gradient within
// 1e-2 of its max |grad| of the plain version (the card's bound; bf16's
// own rounding takes most of it), and after a mid-chunk clip within
// three times the plain version's distance from float64. One piece
// fewer of any breaks a bound: one of the states' updates puts da 25-200x
// past the float64 bound after a mid-chunk clip (the card saw 316x), two
// of the states 1.3x past it at Zamba2's (three 0.14x).
//
// Scratch, fp32: S and dS [B, n_chunks, H, 64 NB, 64] (the state
// transposed, padded to 64-column slabs; the first chunk's S, zero, is
// neither written nor read), the groups' dB and dC [G, B, L, N], three
// [B, L, H] rows of da terms and [B, n_chunks, H] of exp(cum_K) <S, dS>:
// 85,463,040 bytes at Mamba2-370M's train launch and 108,800,000 at
// Zamba2-2.7B's (the fp32 route's: 203.4 and 253.8 MB), each written
// once and read once (S twice).
//
// The tensor maps are encoded per call as in ssd_scan_wgmma.cu; an
// operand the CUDA driver refuses (TMA's 16-byte rules) returns a code of
// its own before anything is launched, which the binding raises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int STAGES = 2;        // heads (or chunks) in a ring
constexpr int SLAB = 64;         // bf16 columns per TMA box (128 bytes)
constexpr int ROW_BYTES = 128;   // one slab row in shared memory
constexpr int HEADS = 8;         // heads a chunk block walks
constexpr int UPDATE_PIECES = 2; // bf16 pieces of B o decay, C o exp(cum)
constexpr int STATE_PIECES = 3;  // of S and dS
constexpr int DXD_STATE_PIECES = 1;  // of dS in dxd's B dS^T
constexpr int D_PIECES = 1;      // of D and D^T
constexpr int M_PIECES = 1;      // of M^T
constexpr int CONVERTERS = 96;   // producer threads splitting a state
constexpr int kRefusedShape = -1;

struct Params {
  const float* a;        // [B, L, H]
  const float* dstate;   // [B, H, P, N] or null (a zero cotangent)
  float* states;         // [B][nc][H][NP][64]: S, transposed
  float* dstates;        // the same: dS
  float* dBp;            // [G][B][L][N]
  float* dCp;            // [G][B][L][N]
  float* uq;             // [B][L][H]: rowsum(D o scores) + carried
  float* uk;             // [B][L][H]: colsum(D o scores)
  float* ug;             // [B][L][H]: G
  float* esd;            // [B][nc][H]: exp(cum_K) <S, dS>
  __nv_bfloat16* dxd;    // [B, L, H, P]
  float* da;             // [B, L, H]
  __nv_bfloat16* dB;     // [B, L, N]
  __nv_bfloat16* dC;
  int batch, L, H, P, N, K, nc, G;
};

// the states' walk: K rows a chunk, NB 64-row tiles of N; two consumer
// warpgroups, each one tile of one head: HPB heads a block
template <int K, int NB>
struct StatesCfg {
  static constexpr int NW = 2;                    // consumer warpgroups
  static constexpr int HPB = NW / NB;             // heads a block
  static constexpr int THREADS = 128 * (NW + 1);  // and the producer's
  static constexpr int UT = K * ROW_BYTES;        // xd's or dy's [K][64]
  static constexpr int VT = NB * K * ROW_BYTES;   // B's or C's [NB][K][64]
  static constexpr int STAGE = HPB * UT + VT;
  static constexpr int TX = (HPB + NB) * K * ROW_BYTES;
  static constexpr int VEC = 3 * K + 4;  // cum, exp(cum), decay, exp(total)
  static constexpr int SMEM = 1024 + STAGES * STAGE +
                              STAGES * HPB * VEC * 4 + 2 * 32 * 4 +
                              16 * STAGES;
  static_assert(SMEM <= 232448, "a block's shared memory on an H100");
};

// the chunks: NW 64-row tiles of a chunk of K rows (K < 64 padded to 64
// with zero rows), NB 64-column slabs of N
template <int K, int NB>
struct ChunkCfg {
  static constexpr int NW = K > 64 ? 2 : 1;       // consumer warpgroups
  static constexpr int THREADS = 128 * (NW + 1);  // and the producer's
  static constexpr int KR = K < 64 ? 64 : K;      // rows of a tile
  static constexpr int NP = 64 * NB;              // rows of a state image
  static constexpr int XT = KR * ROW_BYTES;       // xd's or dy's [KR][64]
  static constexpr int BT = NB * KR * ROW_BYTES;  // B's or C's [NB][KR][64]
  static constexpr int STAGE = 2 * XT;            // a head's xd and dy
  static constexpr int PIECE = NP * ROW_BYTES;    // a bf16 piece of a state
  static constexpr int IMG = STATE_PIECES * PIECE;
  static constexpr int STG = NP * 64 * 4;         // a state in fp32
  static constexpr int VEC = 3 * K + 4;
  static constexpr int TX = 2 * K * ROW_BYTES;        // TMA bytes a head
  static constexpr int TX_BC = 2 * NB * K * ROW_BYTES;  // B_ and C_
  // 1024 for aligning the base (128-byte swizzle atoms are 1024 bytes),
  // B_ and C_, the ring, the state's pieces and its fp32 copy, each
  // stage's vectors, and the mbarriers: full and empty a stage, the
  // pieces' two, B_ and C_'s, the fp32 copy's
  static constexpr int SMEM = 1024 + 2 * BT + STAGES * STAGE + IMG + STG +
                              STAGES * VEC * 4 + 8 * (2 * STAGES + 4);
  static_assert(SMEM <= 232448, "a block's shared memory on an H100");
};

// named barrier `id` of `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// cum of one chunk's rows of one (batch, head) into cum[0, K), summed in
// double and rounded once (each lane totals its run of rows, a = 0 past
// the chunk's `rows`, the runs' totals scanned across the warp), then
// exp(cum), exp(total - cum) and exp(total) beside it; a warp's lanes
// call it together
template <int K>
__device__ __forceinline__ void chunk_cum(const float* ab, int H, int t0,
                                          int rows, float* cum, int lane) {
  constexpr int PER = (K + 31) / 32;
  const int k0 = lane * PER;
  double v[PER], run = 0.0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int k = k0 + q;
    v[q] = k < rows ? (double)ab[(long long)(t0 + k) * H] : 0.0;
    run += v[q];
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  run = __shfl_up_sync(0xffffffffu, incl, 1);  // the rows before the run
  if (lane == 0) run = 0.0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    run += v[q];
    if (k0 + q < K) cum[k0 + q] = (float)run;
  }
  __syncwarp();
  const float total = cum[K - 1];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int k = k0 + q;
    if (k < K) {
      cum[K + k] = expf(cum[k]);
      cum[2 * K + k] = expf(total - cum[k]);
    }
  }
  if (lane == 0) cum[3 * K] = expf(total);
}

__device__ __forceinline__ float2 bf16x2_at(const uint8_t* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ------------------------------------------------------------- states --

// grid (ceil(H / HPB), B). Steps i < nc walk the chunks forwards (U =
// xd, V = B_, w = exp(total - cum)), steps i >= nc backwards (U = dy, V =
// C_, w = exp(cum)); each writes the state it holds, then takes the chunk
// in. Consumer warpgroup wg holds tile wg % NB of head h0 + wg / NB (a
// head past H, at an odd H with NB 1, is computed as head H - 1 and not
// stored).
template <int K, int NB>
__global__ void __launch_bounds__(StatesCfg<K, NB>::THREADS, 1)
ssd_wgmma_bwd_states(const __grid_constant__ CUtensorMap txd,
                     const __grid_constant__ CUtensorMap tdy,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc, const Params p) {
  using C = StatesCfg<K, NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  // [STAGES][HPB][VEC] the heads' cum vectors; [2][32] the sums of <S, dS>
  float* const vec = reinterpret_cast<float*>(gbase + STAGES * C::STAGE);
  float* const red = vec + STAGES * C::HPB * C::VEC;
  const uint32_t full0 = base + STAGES * C::STAGE +
                         STAGES * C::HPB * C::VEC * 4 + 2 * 32 * 4;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int h0 = blockIdx.x * C::HPB, b = blockIdx.y;
  const int nc = p.nc, steps = 2 * p.nc;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32 * C::HPB);  // the producer warps' lanes
      mbar_init(empty0 + 8 * s, C::NW);       // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == C::NW) {
    // ------------------------------------------------------ producer --
    // warp u sums head h0 + u's cum; warp 0's lane 0 first loads the tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int u = (threadIdx.x - 128 * C::NW) / 32, lane = threadIdx.x & 31;
    if (u >= C::HPB) return;
    const int hu = min(h0 + u, p.H - 1);
    for (int i = 0; i < steps; ++i) {
      const int s = i % STAGES;
      const bool rev = i >= nc;
      const int c = rev ? steps - 1 - i : i;
      if (i >= STAGES) mbar_wait(empty0 + 8 * s, ((i / STAGES) - 1) & 1);
      const int t0 = c * K;
      const uint32_t full = full0 + 8 * s;
      if (u == 0 && lane == 0) {  // the tiles first, then each head's cum
        const uint32_t dst = base + s * C::STAGE;
        mbar_expect_tx_only(full, C::TX);
#pragma unroll
        for (int v = 0; v < C::HPB; ++v)
          tma_load_4d(dst + v * C::UT, rev ? &tdy : &txd, full, 0,
                      min(h0 + v, p.H - 1), t0, b);
#pragma unroll
        for (int n = 0; n < NB; ++n)
          tma_load_3d(dst + C::HPB * C::UT + n * K * ROW_BYTES,
                      rev ? &tc : &tb, full, n * SLAB, t0, b);
      }
      chunk_cum<K>(p.a + (long long)b * p.L * p.H + hu, p.H, t0,
                   min(K, p.L - t0), vec + (s * C::HPB + u) * C::VEC, lane);
      mbar_arrive(full);  // this lane's cum is written
    }
    return;
  }

  // ----------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int slot = wg / NB, nt = wg % NB;  // the head's slot, N's tile
  const bool live = h0 + slot < p.H;
  const int h = min(h0 + slot, p.H - 1);
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, t = lane & 3;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // rows r0, r0 + 8 of N
  constexpr int NPR = 64 * NB;
  float st[32];  // the state transposed: rows 64 nt + r0 (+ 8) of N
#pragma unroll
  for (int j = 0; j < 32; ++j) st[j] = 0.0f;

  for (int i = 0; i < steps; ++i) {
    const int s = i % STAGES;
    const bool rev = i >= nc;
    const int c = rev ? steps - 1 - i : i;
    const long long img = (((long long)b * nc + c) * p.H + h) * NPR * 64;
    // on the way back, this thread's own elements of the chunk's S (for
    // <S, dS>), read while the chunk's tiles arrive; the first chunk's S
    // is zero, and is neither written nor read
    float2 sv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sv[j] = make_float2(0.0f, 0.0f);
    if (rev && c > 0) {
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int n = 64 * nt + r0 + 8 * ((j >> 1) & 1);
        const int col = 8 * (j >> 2) + 2 * t;
        sv[j / 2] =
            *reinterpret_cast<const float2*>(p.states + img + n * 64 + col);
      }
    }
    mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
    const float* const cum = vec + (s * C::HPB + slot) * C::VEC;
    const float* const w = cum + (rev ? K : 2 * K);  // exp(cum) or decay
    const float keep = cum[3 * K];

    if (i == nc) {  // the backward walk starts from dstate (or zero)
      const float* d0 = p.dstate == nullptr
                            ? nullptr
                            : p.dstate + ((long long)b * p.H + h) * p.P * p.N;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int n = 64 * nt + r0 + 8 * ((j >> 1) & 1);
        const int col = 8 * (j >> 2) + 2 * t + (j & 1);
        st[j] = (d0 != nullptr && n < p.N && col < p.P)
                    ? d0[(long long)col * p.N + n]
                    : 0.0f;
      }
    }
    // the state this walk holds at the chunk, to the scratch
    if (live && (rev || c > 0)) {
      float* const out = (rev ? p.dstates : p.states) + img;
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int n = 64 * nt + r0 + 8 * ((j >> 1) & 1);
        const int col = 8 * (j >> 2) + 2 * t;
        *reinterpret_cast<float2*>(out + n * 64 + col) =
            make_float2(st[j], st[j + 1]);
      }
    }
    if (rev) {  // <S, dS>, summed over the head's warpgroups in order
      float sd = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        sd = fmaf(st[j], sv[j / 2].x, sd);
        sd = fmaf(st[j + 1], sv[j / 2].y, sd);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sd += __shfl_xor_sync(0xffffffffu, sd, o);
      float* const r = red + 32 * (i & 1) + 8 * slot;
      if (lane == 0) r[4 * nt + (tid >> 5)] = sd;
      named_sync(1 + slot, 128 * NB);
      if (nt == 0 && tid == 0 && live) {
        float tot = 0.0f;
        for (int q = 0; q < 4 * NB; ++q) tot += r[q];
        p.esd[((long long)b * nc + c) * p.H + h] = keep * tot;
      }
    }

    // state' = state exp(total) + (V o w)^T U, the product summed onto
    // the decayed state: register e of k-step kk of the A operand is row
    // r0 + 8 (e & 1) of the tile, columns k, k + 1 with k = 16 kk + 2 t
    // + 8 (e >> 1)
    const uint8_t* const vt = gbase + s * C::STAGE + C::HPB * C::UT +
                              nt * K * ROW_BYTES;
    uint32_t va[UPDATE_PIECES][K / 4];
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = r0 + 8 * (e & 1);
        const int k = 16 * kk + 2 * t + 8 * (e >> 1);
        const float2 wk = *reinterpret_cast<const float2*>(w + k);
        const float x0 = __bfloat162float(*reinterpret_cast<
            const __nv_bfloat16*>(vt + sw128_offset(k, n)));
        const float x1 = __bfloat162float(*reinterpret_cast<
            const __nv_bfloat16*>(vt + sw128_offset(k + 1, n)));
        split(x0 * wk.x, x1 * wk.y, va, 4 * kk + e);
      }
    const uint32_t us = base + s * C::STAGE + slot * C::UT;
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] *= keep;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
      for (int q = 0; q < UPDATE_PIECES; ++q)
        wgmma_rs_t(st, &va[q][4 * kk],
                   sw128_desc(us + kk * 16 * ROW_BYTES, C::UT, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    pin(st);
#pragma unroll
    for (int q = 0; q < UPDATE_PIECES; ++q) pin(va[q]);
    if (tid == 0) mbar_arrive(empty0 + 8 * s);
  }
}

// -------------------------------------------------------------- chunks --

// The shared memory of a chunk block, as addresses (shared window) and,
// for the vectors, a generic pointer.
template <int K, int NB>
struct ChunkSmem {
  using C = ChunkCfg<K, NB>;
  uint32_t b, c, ring, img, stg, full0, empty0, sfull, sempty, bcfull, gfull;
  float* vec;
  __device__ ChunkSmem(uint8_t* smem_raw) {
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    b = base;
    c = base + C::BT;
    ring = base + 2 * C::BT;
    img = ring + STAGES * C::STAGE;
    stg = img + C::IMG;
    vec = reinterpret_cast<float*>(smem_raw + (stg + C::STG - raw));
    full0 = stg + C::STG + STAGES * C::VEC * 4;
    empty0 = full0 + 8 * STAGES;
    sfull = empty0 + 8 * STAGES;
    sempty = sfull + 8;
    bcfull = sempty + 8;
    gfull = bcfull + 8;
  }
  __device__ uint32_t x(int s) const { return ring + s * C::STAGE; }
  __device__ uint32_t y(int s) const { return ring + s * C::STAGE + C::XT; }
};

// element (row, n) of B_'s or C_'s tile at `tile` (generic), a pair n, n+1
template <int K>
__device__ __forceinline__ float2 bc_pair(const uint8_t* tile, int row,
                                          int n) {
  constexpr int KR = K < 64 ? 64 : K;
  return bf16x2_at(tile + (n >> 6) * KR * ROW_BYTES +
                   sw128_offset(row, n & 63));
}

// a consumer warpgroup's [64, NP] fp32 accumulator (its tile's rows of dB
// or dC) to o [rows, N]: through shared memory (the state's pieces and
// fp32 copy, which no one reads once every head is done), so that each
// row goes out in 16-byte pieces
template <int K, int NB>
__device__ __forceinline__ void store_rows(const float (&acc)[NB * 32],
                                           float* o, int rows, int N,
                                           uint8_t* smem_raw) {
  using C = ChunkCfg<K, NB>;
  constexpr int STRIDE = C::NP + 4;  // floats a row: rows fall in other banks
  const ChunkSmem<K, NB> sm(smem_raw);
  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int lane = tid & 31, t = lane & 3;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  named_sync(3, 128 * C::NW);  // every warpgroup is past its last head
  float* const tile = reinterpret_cast<float*>(
                          smem_raw + (sm.img - smem_addr(smem_raw))) +
                      wg * 64 * STRIDE;
#pragma unroll
  for (int j = 0; j < NB * 32; j += 2) {
    const int r = r0 + 8 * ((j >> 1) & 1), n = 8 * (j >> 2) + 2 * t;
    *reinterpret_cast<float2*>(tile + r * STRIDE + n) =
        make_float2(acc[j], acc[j + 1]);
  }
  named_sync(4 + wg, 128);
  for (int e = tid; e < 64 * C::NP / 4; e += 128) {
    const int r = e / (C::NP / 4), n = 4 * (e % (C::NP / 4));
    const int row = 64 * wg + r;
    if (row < rows && n < N)
      *reinterpret_cast<float4*>(o + (long long)row * N + n) =
          *reinterpret_cast<const float4*>(tile + r * STRIDE + n);
  }
}

// the q-kind: dC of the group's heads and each row's rowsum + carried
template <int K, int NB>
__device__ __forceinline__ void q_block(const Params& p, uint8_t* smem_raw,
                                        int c, int g, int b) {
  using C = ChunkCfg<K, NB>;
  const ChunkSmem<K, NB> sm(smem_raw);
  const uint8_t* const cg = smem_raw + (sm.c - smem_addr(smem_raw));
  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int lane = tid & 31, t = lane & 3;
  const int ra = 64 * wg + 16 * (tid >> 5) + (lane >> 2), rb = ra + 8;
  const int ia = min(ra, K - 1), ib = min(rb, K - 1);
  const int t0 = c * K, rows = min(K, p.L - t0);
  const int h0 = g * HEADS, nh = min(HEADS, p.H - h0);

  float dc[NB * 32];
#pragma unroll
  for (int j = 0; j < NB * 32; ++j) dc[j] = 0.0f;
  mbar_wait(sm.bcfull, 0);

  for (int i = 0; i < nh; ++i) {
    const int s = i % STAGES, h = h0 + i;
    mbar_wait(sm.full0 + 8 * s, (i / STAGES) & 1);
    mbar_wait(sm.sfull, i & 1);
    const float* const cum = sm.vec + s * C::VEC;
    const float ca = cum[ia], cb = cum[ib];
    const float ea = cum[K + ia], eb = cum[K + ib];
    const uint32_t xs = sm.x(s), ys = sm.y(s);

    // 1. dy S, S in STATE_PIECES pieces (K-major: rows of N, columns P)
    float ds[NB * 32];
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < STATE_PIECES; ++q)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(ds, sw128_desc(ys + 64 * wg * ROW_BYTES + kk * 32, 16, 1024),
                 sw128_desc(sm.img + q * C::PIECE + kk * 32, 16, 1024),
                 q > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(ds);
    if (tid == 0) mbar_arrive(sm.sempty);  // the state's pieces are read
    float car_a = 0.0f, car_b = 0.0f;
#pragma unroll
    for (int j = 0; j < NB * 32; j += 2) {
      const bool second = (j >> 1) & 1;
      const int n = 8 * (j >> 2) + 2 * t;
      const float2 cv = bc_pair<K>(cg, second ? rb : ra, n);
      const float e = second ? eb : ea;
      const float part = cv.x * ds[j] + cv.y * ds[j + 1];
      if (second) car_b += part; else car_a += part;
      dc[j] = fmaf(e, ds[j], dc[j]);
      dc[j + 1] = fmaf(e, ds[j + 1], dc[j + 1]);
    }

    // 2. per 64 columns k up to this tile's: C B^T, D, dC += D B
    float er_a = 0.0f, er_b = 0.0f;
    for (int kb = 0; kb <= wg; ++kb) {
      float sc[32], dm[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        wgmma_ss(sc,
                 sw128_desc(sm.c + (kk / 4) * C::XT + 64 * wg * ROW_BYTES +
                                (kk % 4) * 32, 16, 1024),
                 sw128_desc(sm.b + (kk / 4) * C::XT + 64 * kb * ROW_BYTES +
                                (kk % 4) * 32, 16, 1024),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dm, sw128_desc(ys + 64 * wg * ROW_BYTES + kk * 32, 16, 1024),
                 sw128_desc(xs + 64 * kb * ROW_BYTES + kk * 32, 16, 1024),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      pin(dm);
      uint32_t df[D_PIECES][16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const bool second = (j >> 1) & 1;
        const int q = second ? rb : ra;
        const float cq = second ? cb : ca;
        const int k = 64 * kb + 8 * (j >> 2) + 2 * t;
        // select, never mask by a product: see the top
        const float d0 =
            k <= q ? dm[j] * fast_exp(cq - cum[min(k, K - 1)]) : 0.0f;
        const float d1 =
            k + 1 <= q ? dm[j + 1] * fast_exp(cq - cum[min(k + 1, K - 1)])
                       : 0.0f;
        const float part = d0 * sc[j] + d1 * sc[j + 1];
        if (second) er_b += part; else er_a += part;
        split(d0, d1, df, j / 2);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < D_PIECES; ++q)
          wgmma_rs_t(dc, &df[q][4 * kk],
                     sw128_desc(sm.b + (64 * kb + 16 * kk) * ROW_BYTES,
                                C::XT, 1024),
                     1);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dc);
#pragma unroll
      for (int q = 0; q < D_PIECES; ++q) pin(df[q]);
    }
    if (tid == 0) mbar_arrive(sm.empty0 + 8 * s);  // xd, dy, cum are read
    er_a = quad_sum(er_a);
    er_b = quad_sum(er_b);
    car_a = quad_sum(car_a);
    car_b = quad_sum(car_b);
    if (t == 0) {
      float* const u = p.uq + ((long long)b * p.L + t0) * p.H + h;
      if (ra < rows) u[(long long)ra * p.H] = er_a + ea * car_a;
      if (rb < rows) u[(long long)rb * p.H] = er_b + eb * car_b;
    }
  }

  store_rows<K, NB>(
      dc, p.dCp + (((long long)g * p.batch + b) * p.L + t0) * p.N, rows,
      p.N, smem_raw);
}

// the k-kind: dB of the group's heads, each head's dxd, each row's colsum
// and G
template <int K, int NB>
__device__ __forceinline__ void k_block(const Params& p, uint8_t* smem_raw,
                                        int c, int g, int b) {
  using C = ChunkCfg<K, NB>;
  const ChunkSmem<K, NB> sm(smem_raw);
  const uint8_t* const bg = smem_raw + (sm.b - smem_addr(smem_raw));
  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127;
  const int lane = tid & 31, t = lane & 3;
  const int ra = 64 * wg + 16 * (tid >> 5) + (lane >> 2), rb = ra + 8;
  const int ia = min(ra, K - 1), ib = min(rb, K - 1);
  const int t0 = c * K, rows = min(K, p.L - t0);
  const int h0 = g * HEADS, nh = min(HEADS, p.H - h0);

  float db[NB * 32];
#pragma unroll
  for (int j = 0; j < NB * 32; ++j) db[j] = 0.0f;
  mbar_wait(sm.bcfull, 0);

  for (int i = 0; i < nh; ++i) {
    const int s = i % STAGES, h = h0 + i;
    mbar_wait(sm.full0 + 8 * s, (i / STAGES) & 1);
    mbar_wait(sm.sfull, i & 1);
    const float* const cum = sm.vec + s * C::VEC;
    const float ca = cum[ia], cb = cum[ib];
    const float da_ = cum[2 * K + ia], db_ = cum[2 * K + ib];  // decay
    const uint32_t xs = sm.x(s), ys = sm.y(s);

    // 1. xd dS (dS K-major) and B dS^T (dS MN-major: rows of N run along
    // the product's depth), dS in STATE_PIECES pieces
    float xds[NB * 32], dx[32];
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < STATE_PIECES; ++q)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(xds,
                 sw128_desc(xs + 64 * wg * ROW_BYTES + kk * 32, 16, 1024),
                 sw128_desc(sm.img + q * C::PIECE + kk * 32, 16, 1024),
                 q > 0 || kk > 0);
    wgmma_commit();
#pragma unroll
    for (int q = 0; q < DXD_STATE_PIECES; ++q)
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        wgmma_ss_t(dx,
                   sw128_desc(sm.b + (kk / 4) * C::XT + 64 * wg * ROW_BYTES +
                                  (kk % 4) * 32, 16, 1024),
                   sw128_desc(sm.img + q * C::PIECE + kk * 16 * ROW_BYTES,
                              C::PIECE, 1024),
                   q > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // xd dS is in; B dS^T may still run
    pin(xds);
    float g_a = 0.0f, g_b = 0.0f;
#pragma unroll
    for (int j = 0; j < NB * 32; j += 2) {
      const bool second = (j >> 1) & 1;
      const int n = 8 * (j >> 2) + 2 * t;
      const float2 bv = bc_pair<K>(bg, second ? rb : ra, n);
      const float dk = second ? db_ : da_;
      const float part = bv.x * xds[j] + bv.y * xds[j + 1];
      if (second) g_b += part; else g_a += part;
      db[j] = fmaf(dk, xds[j], db[j]);
      db[j + 1] = fmaf(dk, xds[j + 1], db[j + 1]);
    }
    wgmma_wait<0>();
    pin(dx);
    if (tid == 0) mbar_arrive(sm.sempty);  // the state's pieces are read
#pragma unroll
    for (int j = 0; j < 32; ++j) dx[j] *= (j >> 1) & 1 ? db_ : da_;

    // 2. per 64 columns q from this tile's: B C^T, xd dy^T, D^T and M^T,
    // dB += D^T C, dxd += M^T dy
    float ec_a = 0.0f, ec_b = 0.0f;
    for (int qb = wg; qb < C::NW; ++qb) {
      float sct[32], dmt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        wgmma_ss(sct,
                 sw128_desc(sm.b + (kk / 4) * C::XT + 64 * wg * ROW_BYTES +
                                (kk % 4) * 32, 16, 1024),
                 sw128_desc(sm.c + (kk / 4) * C::XT + 64 * qb * ROW_BYTES +
                                (kk % 4) * 32, 16, 1024),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dmt,
                 sw128_desc(xs + 64 * wg * ROW_BYTES + kk * 32, 16, 1024),
                 sw128_desc(ys + 64 * qb * ROW_BYTES + kk * 32, 16, 1024),
                 kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sct);
      pin(dmt);
      uint32_t dtf[D_PIECES][16], mtf[M_PIECES][16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const bool second = (j >> 1) & 1;
        const int k = second ? rb : ra;
        const float ck = second ? cb : ca;
        const int q = 64 * qb + 8 * (j >> 2) + 2 * t;
        // select, never mask by a product: see the top
        const float l0 = q >= k ? fast_exp(cum[min(q, K - 1)] - ck) : 0.0f;
        const float l1 =
            q + 1 >= k ? fast_exp(cum[min(q + 1, K - 1)] - ck) : 0.0f;
        const float d0 = dmt[j] * l0, d1 = dmt[j + 1] * l1;
        const float part = d0 * sct[j] + d1 * sct[j + 1];
        if (second) ec_b += part; else ec_a += part;
        split(d0, d1, dtf, j / 2);
        split(sct[j] * l0, sct[j + 1] * l1, mtf, j / 2);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < D_PIECES; ++q)
          wgmma_rs_t(db, &dtf[q][4 * kk],
                     sw128_desc(sm.c + (64 * qb + 16 * kk) * ROW_BYTES,
                                C::XT, 1024),
                     1);
#pragma unroll
        for (int q = 0; q < M_PIECES; ++q)
          wgmma_rs_t(dx, &mtf[q][4 * kk],
                     sw128_desc(ys + (64 * qb + 16 * kk) * ROW_BYTES, C::XT,
                                1024),
                     1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(db);
      pin(dx);
#pragma unroll
      for (int q = 0; q < D_PIECES; ++q) pin(dtf[q]);
#pragma unroll
      for (int q = 0; q < M_PIECES; ++q) pin(mtf[q]);
    }
    ec_a = quad_sum(ec_a);
    ec_b = quad_sum(ec_b);
    g_a = quad_sum(g_a);
    g_b = quad_sum(g_b);
    const long long row0 = (long long)b * p.L + t0;
    if (t == 0) {
      const long long at = row0 * p.H + h;
      if (ra < rows) {
        p.uk[at + (long long)ra * p.H] = ec_a;
        p.ug[at + (long long)ra * p.H] = da_ * g_a;
      }
      if (rb < rows) {
        p.uk[at + (long long)rb * p.H] = ec_b;
        p.ug[at + (long long)rb * p.H] = db_ * g_b;
      }
    }
    // dxd of the head through this warpgroup's rows of xd's tile, which
    // no product reads again this head (the rows past K keep their
    // zeros), so that each row goes out in 16-byte pieces
    uint8_t* const xt =
        smem_raw + (xs - smem_addr(smem_raw)) + 64 * wg * ROW_BYTES;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra - 64 * wg + 8 * half;
      if (64 * wg + r >= K) continue;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
        *reinterpret_cast<__nv_bfloat162*>(xt +
                                           sw128_offset(r, 8 * jb + 2 * t)) =
            __floats2bfloat162_rn(dx[4 * jb + 2 * half],
                                  dx[4 * jb + 2 * half + 1]);
    }
    named_sync(4 + wg, 128);
    __nv_bfloat16* const xo = p.dxd + (row0 * p.H + h) * p.P;
    for (int e = tid; e < 64 * 8; e += 128) {
      const int r = e >> 3, col = 8 * (e & 7), row = 64 * wg + r;
      if (row < rows && col < p.P)
        *reinterpret_cast<uint4*>(xo + (long long)row * p.H * p.P + col) =
            *reinterpret_cast<const uint4*>(xt + sw128_offset(r, col));
    }
    fence_async_smem();  // the tile's generic accesses before TMA refills it
    named_sync(4 + wg, 128);
    if (tid == 0) mbar_arrive(sm.empty0 + 8 * s);  // xd, dy, cum are read
  }

  store_rows<K, NB>(
      db, p.dBp + (((long long)g * p.batch + b) * p.L + t0) * p.N, rows,
      p.N, smem_raw);
}

// grid (2 n_chunks, G, B): x even the q-kind, x odd the k-kind of chunk
// x / 2. The producer warpgroup's warp 0 loads B_ and C_ once and each
// head's xd and dy, with the head's cum; its warps 1-3 split each head's
// S (q-kind) or dS (k-kind) into the pieces' image.
template <int K, int NB>
__global__ void __launch_bounds__(ChunkCfg<K, NB>::THREADS, 1)
ssd_wgmma_bwd_chunks(const __grid_constant__ CUtensorMap txd,
              const __grid_constant__ CUtensorMap tdy,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tc, const Params p) {
  using C = ChunkCfg<K, NB>;
  extern __shared__ uint8_t smem_raw[];
  const ChunkSmem<K, NB> sm(smem_raw);
  const uint32_t raw = smem_addr(smem_raw);
  const int side = blockIdx.x & 1, c = blockIdx.x >> 1;
  const int g = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int t0 = c * K;
  const int h0 = g * HEADS, nh = min(HEADS, p.H - h0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full0 + 8 * s, 32);      // the producer warp's lanes
      mbar_init(sm.empty0 + 8 * s, C::NW);  // one arrival per consumer
    }
    mbar_init(sm.sfull, CONVERTERS);
    mbar_init(sm.sempty, C::NW);
    mbar_init(sm.bcfull, 1);
    mbar_init(sm.gfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (C::KR > K) {  // rows past K: zeros no load overwrites
    constexpr int PAD = (C::KR - K) * ROW_BYTES / 16;  // uint4 a tile
    constexpr int TILES = 2 * NB + 2 * STAGES;  // B_ and C_ slabs, xd, dy
    for (int e = threadIdx.x; e < TILES * PAD; e += C::THREADS) {
      const uint32_t tile = sm.b + (e / PAD) * C::XT;  // each XT apart
      uint4* row = reinterpret_cast<uint4*>(smem_raw + (tile - raw) +
                                            K * ROW_BYTES);
      row[e % PAD] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_async_smem();
  }
  __syncthreads();

  if (wg == C::NW) {
    // ------------------------------------------------------ producer --
    if constexpr (C::NW == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int ptid = threadIdx.x - 128 * C::NW;
    if (ptid < 32) {
      const float* ab = p.a + (long long)b * p.L * p.H;
      if (ptid == 0) {
        mbar_expect_tx(sm.bcfull, C::TX_BC);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          tma_load_3d(sm.b + n * C::XT, &tb, sm.bcfull, n * SLAB, t0, b);
          tma_load_3d(sm.c + n * C::XT, &tc, sm.bcfull, n * SLAB, t0, b);
        }
      }
      for (int i = 0; i < nh; ++i) {
        const int s = i % STAGES, h = h0 + i;
        if (i >= STAGES) mbar_wait(sm.empty0 + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t full = sm.full0 + 8 * s;
        if (ptid == 0) {  // the tiles first, then the cum beside them
          mbar_expect_tx_only(full, C::TX);
          tma_load_4d(sm.x(s), &txd, full, 0, h, t0, b);
          tma_load_4d(sm.y(s), &tdy, full, 0, h, t0, b);
        }
        chunk_cum<K>(ab + h, p.H, t0, min(K, p.L - t0), sm.vec + s * C::VEC,
                     ptid);
        mbar_arrive(full);  // this lane's cum is written
      }
    } else {
      // each head's fp32 state [NP][64] by a bulk copy into shared memory
      // (the next head's while this one's pieces are in use), then split
      // into the pieces' image, four columns (16 bytes) of a row at a time
      const int ctid = ptid - 32;
      uint8_t* const img = smem_raw + (sm.img - raw);
      const float4* const stg =
          reinterpret_cast<const float4*>(smem_raw + (sm.stg - raw));
      const float* const src0 =
          (side ? p.dstates : p.states) +
          (((long long)b * p.nc + c) * p.H + h0) * C::NP * 64;
      // the first chunk's S is zero: its image is written once, of zeros
      const bool zero = side == 0 && c == 0;
      if (ctid == 0 && !zero) {
        mbar_expect_tx(sm.gfull, C::STG);
        bulk_load(sm.stg, src0, C::STG, sm.gfull);
      }
      for (int i = 0; i < nh; ++i) {
        if (!zero) mbar_wait(sm.gfull, i & 1);
        if (i >= 1) mbar_wait(sm.sempty, (i - 1) & 1);
        for (int e = ctid; e < (zero && i > 0 ? 0 : C::NP * 16);
             e += CONVERTERS) {
          const float4 v = zero ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                                : stg[e];
          const uint32_t off = sw128_offset(e >> 4, (e & 15) * 4);
          uint32_t lo[STATE_PIECES][1], hi[STATE_PIECES][1];
          split(v.x, v.y, lo, 0);
          split(v.z, v.w, hi, 0);
#pragma unroll
          for (int q = 0; q < STATE_PIECES; ++q)
            *reinterpret_cast<uint2*>(img + q * C::PIECE + off) =
                make_uint2(lo[q][0], hi[q][0]);
        }
        fence_async_smem();
        mbar_arrive(sm.sfull);
        // every converter has read the fp32 copy: the next head's may land
        named_sync(2, CONVERTERS);
        if (ctid == 0 && i + 1 < nh && !zero) {
          mbar_expect_tx(sm.gfull, C::STG);
          bulk_load(sm.stg, src0 + (long long)(i + 1) * C::NP * 64, C::STG,
                    sm.gfull);
        }
      }
    }
    return;
  }

  // ----------------------------------------------------- consumers --
  if constexpr (C::NW == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if (side == 0)
    q_block<K, NB>(p, smem_raw, c, g, b);
  else
    k_block<K, NB>(p, smem_raw, c, g, b);
}

// -------------------------------------------------------------- da, sums --

// a warp per (chunk, head) of batch row blockIdx.y: da, the reverse
// cumsum of dcum within the chunk in double (each lane its run of rows,
// the runs' sums scanned across the warp), from the state's decay and
// sum(G) at the last row
__global__ void __launch_bounds__(256) ssd_wgmma_bwd_da(const Params p) {
  const int w = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (w >= p.nc * p.H) return;
  const int c = w / p.H, h = w - c * p.H, b = blockIdx.y;
  const int t0 = c * p.K, rows = min(p.K, p.L - t0);
  const int per = (p.K + 31) / 32;  // at most 4: K <= 128
  const long long at = ((long long)b * p.L + t0) * p.H + h;
  float g = 0.0f;
  double v[4], own = 0.0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = lane * per + q;
    v[q] = 0.0;
    if (q < per && k < rows) {
      const long long i = at + (long long)k * p.H;
      g += p.ug[i];
      v[q] = (double)(p.uq[i] - p.uk[i] - p.ug[i]);
    }
    own += v[q];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) g += __shfl_xor_sync(0xffffffffu, g, o);
  double incl = own;  // the sum of this lane's run and every later one
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += u;
  }
  double run = __shfl_down_sync(0xffffffffu, incl, 1);  // the later runs
  if (lane == 31) run = 0.0;
  run += (double)(g + p.esd[((long long)b * p.nc + c) * p.H + h]);
#pragma unroll
  for (int q = 3; q >= 0; --q) {
    const int k = lane * per + q;
    run += v[q];
    if (q < per && k < rows) p.da[at + (long long)k * p.H] = (float)run;
  }
}

// grid (ceil(L N / 256), B, 2): dB (z = 0) and dC (z = 1), the groups'
// partial sums added in order, in bf16
__global__ void __launch_bounds__(256) ssd_wgmma_bwd_sum(const Params p) {
  const long long LN = (long long)p.L * p.N;
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= LN) return;
  const int b = blockIdx.y;
  const float* src = (blockIdx.z ? p.dCp : p.dBp) + (long long)b * LN + e;
  const long long step = (long long)p.batch * LN;
  float s = 0.0f;
  for (int g = 0; g < p.G; ++g) s += src[g * step];
  ((blockIdx.z ? p.dC : p.dB) + (long long)b * LN)[e] = __float2bfloat16(s);
}

// ---------------------------------------------------------------- host --

// a map over a contiguous bf16 tensor of `rank` dims (innermost first,
// strides in bytes of dims 1..), boxes of SLAB columns, `box` of the rest
bool make_map(CUtensorMap* map, const void* ptr, cuuint32_t rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                   const_cast<void*>(ptr), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap xd, dy, b, c;
};

template <int K, int NB>
cudaError_t launch(const Maps& m, const Params& p, cudaStream_t stream) {
  using S = StatesCfg<K, NB>;
  using C = ChunkCfg<K, NB>;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wgmma_bwd_states<K, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_wgmma_bwd_chunks<K, NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  ssd_wgmma_bwd_states<K, NB>
      <<<dim3((p.H + S::HPB - 1) / S::HPB, p.batch), S::THREADS, S::SMEM,
          stream>>>(m.xd, m.dy, m.b, m.c, p);
  ssd_wgmma_bwd_chunks<K, NB>
      <<<dim3(2 * p.nc, p.G, p.batch), C::THREADS, C::SMEM, stream>>>(
          m.xd, m.dy, m.b, m.c, p);
  ssd_wgmma_bwd_da<<<dim3((p.nc * p.H + 7) / 8, p.batch), 256, 0, stream>>>(p);
  const long long LN = (long long)p.L * p.N;
  ssd_wgmma_bwd_sum<<<dim3((unsigned)((LN + 255) / 256), p.batch, 2), 256,
                       0, stream>>>(p);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const Maps& m, const Params& p, cudaStream_t stream) {
  return p.N > SLAB ? launch<K, 2>(m, p, stream) : launch<K, 1>(m, p, stream);
}

}  // namespace

namespace ssd_bwd_wgmma {

// what backward returns for a shape it does not take (ssd_scan_bwd.cu's
// kRefusedShape) and when the CUDA driver refuses xd's, B_'s, C_'s or
// dy's tensor map: negative, so that no cudaError_t takes it (the
// binding's BWD_REFUSED and BWD_TMA_REFUSED)
constexpr int kTmaRefusedXd = -2, kTmaRefusedB = -3, kTmaRefusedC = -4,
              kTmaRefusedDy = -5;

// the fp32 scratch the bf16 route takes, in floats: S and dS, the groups'
// dB and dC, the three rows of da terms, exp(cum_K) <S, dS>
long long scratch_floats(int batch, int L, int H, int N, int K) {
  const long long nc = (L + K - 1) / K, NP = N > SLAB ? 128 : 64;
  const long long G = (H + HEADS - 1) / HEADS;
  const long long st = (long long)batch * nc * H * NP * 64;
  const long long pt = G * batch * L * N;
  const long long vt = (long long)batch * L * H;
  return 2 * st + 2 * pt + 3 * vt + (long long)batch * nc * H;
}

// bf16 xd, dy, dxd [B, L, H, P], B_, C_, dB, dC [B, L, N]; fp32 a, da [B,
// L, H], dstate [B, H, P, N] or null; fp32 scratch of scratch_floats();
// all contiguous. Returns the launches' cudaError_t, or kRefusedShape
// (chunk not 16, 32, 64 or 128, P past 64, N past 128) or a kTmaRefused
// code before anything is launched.
int backward(const void* xd, const float* a, const void* B, const void* C,
             const void* dy, const float* dstate, float* scratch, void* dxd,
             float* da, void* dB, void* dC, int batch, int L, int H, int P,
             int N, int chunk, cudaStream_t stream) {
  if ((chunk != 16 && chunk != 32 && chunk != 64 && chunk != 128) || P < 1 ||
      P > SLAB || N < 1 || N > 2 * SLAB)
    return kRefusedShape;
  if (encoder() == nullptr) return cudaErrorNotSupported;
  const cuuint32_t rows = static_cast<cuuint32_t>(chunk);
  Maps m;
  {
    const cuuint64_t dims[4] = {cuuint64_t(P), cuuint64_t(H), cuuint64_t(L),
                                cuuint64_t(batch)};
    const cuuint64_t strides[3] = {cuuint64_t(P) * 2, cuuint64_t(H) * P * 2,
                                   cuuint64_t(L) * H * P * 2};
    const cuuint32_t box[4] = {SLAB, 1, rows, 1};
    if (!make_map(&m.xd, xd, 4, dims, strides, box)) return kTmaRefusedXd;
    if (!make_map(&m.dy, dy, 4, dims, strides, box)) return kTmaRefusedDy;
  }
  {
    const cuuint64_t dims[3] = {cuuint64_t(N), cuuint64_t(L),
                                cuuint64_t(batch)};
    const cuuint64_t strides[2] = {cuuint64_t(N) * 2, cuuint64_t(L) * N * 2};
    const cuuint32_t box[3] = {SLAB, rows, 1};
    if (!make_map(&m.b, B, 3, dims, strides, box)) return kTmaRefusedB;
    if (!make_map(&m.c, C, 3, dims, strides, box)) return kTmaRefusedC;
  }
  const int nc = (L + chunk - 1) / chunk, G = (H + HEADS - 1) / HEADS;
  const long long NP = N > SLAB ? 128 : 64;
  const long long st = (long long)batch * nc * H * NP * 64;
  const long long pt = (long long)G * batch * L * N;
  const long long vt = (long long)batch * L * H;
  Params p;
  p.a = a;
  p.dstate = dstate;
  p.states = scratch;
  p.dstates = p.states + st;
  p.dBp = p.dstates + st;
  p.dCp = p.dBp + pt;
  p.uq = p.dCp + pt;
  p.uk = p.uq + vt;
  p.ug = p.uk + vt;
  p.esd = p.ug + vt;
  p.dxd = static_cast<__nv_bfloat16*>(dxd);
  p.da = da;
  p.dB = static_cast<__nv_bfloat16*>(dB);
  p.dC = static_cast<__nv_bfloat16*>(dC);
  p.batch = batch;
  p.L = L;
  p.H = H;
  p.P = P;
  p.N = N;
  p.K = chunk;
  p.nc = nc;
  p.G = G;
  switch (chunk) {
    case 16: return launch_k<16>(m, p, stream);
    case 32: return launch_k<32>(m, p, stream);
    case 64: return launch_k<64>(m, p, stream);
    default: return launch_k<128>(m, p, stream);
  }
}

}  // namespace ssd_bwd_wgmma
