// Mamba2 SSD chunk scan in bf16 for Hopper (sm_90a): the four products of
// each chunk on the tensor cores (wgmma), the chunk's xd, B_ and C_ fed by
// TMA through a ring of shared-memory stages. The bf16 route of
// ssd_scan.cu's entry point; fp32 inputs keep the CUDA-core kernel there.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::_ssd_kernel
// (launched by ssd_pallas, wrapped by ssd/ops.py::ssd_scan_fused) for bf16
// xd, B_ and C_. For xd [B, L, H, P], a [B, L, H] (fp32), B_ and C_
// [B, L, N] it computes, for every (batch, head), chunk by chunk in order
// from a zero state (K rows a chunk):
//
//   cum    = cumsum(a) over the chunk;
//   M      = (C B^T) o exp(cum_i - cum_j) where j <= i, 0 above;
//   y      = M xd + (C state^T) o exp(cum_i);
//   state' = state exp(cum[-1]) + xd^T (B o exp(cum[-1] - cum_k)),
//
// y stored in bf16, the final state in fp32.
//
// Design. One block per (head, batch), as in the CUDA-core kernel: the
// block walks the chunks in order, and no sum crosses blocks, so a row's
// bits do not depend on the batch width. A block is one producer
// warpgroup and one consumer warpgroup per 64 rows of the chunk (two at
// K = 128, one at K <= 64). One producer warp loads each chunk's xd
// [K, P], B_ and C_ [K, N] tiles by TMA (tensor maps with L a dimension
// of its own, so that the rows of a ragged last chunk past L arrive as
// zeros, never as the next batch row's) into a ring of two stages, each
// completing on its stage's mbarrier. Meanwhile the warp sums the chunk's
// cum in double and rounds it once to fp32 (as ssd_scan.cu does: after a
// step at dt's clip, cum_i - cum_j keeps only the digits the two share),
// and puts exp(cum), exp(total - cum) and exp(total) beside it in the
// stage. The consumers, per chunk:
//
//   S = C B^T         wgmma m64nKk16, C and B K-major in shared memory;
//   y = C state^T     wgmma m64n64k16 on two bf16 pieces of the state,
//                     which the consumers write to shared memory from
//                     the registers that hold it; B MN-major (the
//                     descriptor's transpose bit);
//   y = y o exp(cum_i) + M xd
//                     M formed from S in registers, the exp (by the MUFU
//                     unit) taken only where j <= i (above the diagonal it
//                     can overflow to inf, and a 0/1 mask times inf is
//                     NaN), and given to wgmma as the register A operand
//                     in two bf16 pieces; xd the MN-major B operand;
//   dS = (B o decay)^T xd
//                     B o exp(total - cum_k) read from B's tile and formed
//                     in registers in three bf16 pieces, the A operand,
//                     into an accumulator of its own; then
//   state^T = state^T exp(total) + dS in fp32, in registers.
//
// The state stays in registers, transposed ([N, P], 64 rows of N in each
// accumulator tile), from the first chunk to the last and is written
// once. Shapes: K 16, 32, 64 or 128; N up to 128 and P up to 64 in
// 64-column slabs (a TMA box and a 128-byte swizzle atom a row) padded by
// TMA's zeros: N 8 is a product over 16 columns of which 8 are zeros, P
// 16 a 64-column product whose padded columns are never stored. C's tile
// has at least 64 rows (an m64 operand); its rows past K are zeroed once
// and never loaded.
//
// Numerics. xd, B_ and C_ are bf16 and so exact operands. M, the state
// and B o decay are fp32: each is split into bf16 pieces (the first the
// rounding of the value, each next one the rounding of what the earlier
// ones leave), and each product summed in fp32. M's exp is the MUFU
// unit's, good to about 2^-21, below its pieces' 2^-17; the state's decays
// and y's exp(cum_i) are expf's, taken once a row by the producer.
// tests/test_torch_ssd_numerics.py emulates this on the CPU and decides
// the number of pieces: two for M and for the state, three for B o decay.
// One piece fewer of M or of the state breaks y's bound against the plain
// version; two pieces of B o decay put the state past three times the
// plain version's error from float64 after a clip mid-chunk.
//
// What bounds it on an H100. At the serving path's long prompt (Mamba2-370M:
// 4 x 2048 tokens, 32 heads of 64, state 128, chunk 128) the bytes the
// function must move bound it, its products at the bf16 tensor-core peak a
// little below that. This kernel loads each chunk a stage ahead of its use
// (B_ and C_ once per head), but does about 2.5 times the function's
// products (the pieces, all of S's K x K tile, P and N padded to slabs) in
// 128 blocks, one to an SM, each walking its chunks as one chain of
// dependent steps: the products, M's exp and the pieces' conversions, in
// turn. That chain sets its pace. Its times beside the bound, and what each
// step of the chain costs (python3 chip_smoke.py --ssd-ablation), are in
// PERF.md section 6.
//
// The tensor maps are encoded on the host per call from the pointers and
// sizes the binding passes (cuTensorMapEncodeTiled, taken through
// cudaGetDriverEntryPointByVersion, so the library needs no -lcuda) and
// reach the kernel as __grid_constant__ parameters. TMA reads only 16-byte
// aligned tensors whose strides are 16-byte multiples; the CUDA driver's
// encoder holds both, and an operand it refuses returns a code of its own
// here, which the binding raises as a ValueError.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int STAGES = 2;       // chunks in the ring
constexpr int SLAB = 64;        // bf16 columns per TMA box (128 bytes)
constexpr int ROW_BYTES = 128;  // one slab row in shared memory
constexpr int M_PIECES = 2;     // bf16 pieces of M
constexpr int ST_PIECES = 2;    // of the state
constexpr int BD_PIECES = 3;    // of B o decay

struct Params {
  const float* a;
  __nv_bfloat16* y;
  float* state;
  int L, H, P, N;
};

// K rows a chunk; NB 64-column slabs of N (1: N <= 64, 2: N <= 128)
template <int K, int NB>
struct Cfg {
  static constexpr int NW = K > 64 ? 2 : 1;       // consumer warpgroups
  static constexpr int THREADS = 128 * (NW + 1);  // and the producer's
  static constexpr int CR = K < 64 ? 64 : K;      // rows of C's tile
  static constexpr int TPW = (NB + NW - 1) / NW;  // state tiles a consumer
  static constexpr int XD = K * ROW_BYTES;        // xd's tile [K][64]
  static constexpr int BT = NB * K * ROW_BYTES;   // B's [NB][K][64]
  static constexpr int CT = NB * CR * ROW_BYTES;  // C's [NB][CR][64]
  static constexpr int STAGE = XD + BT + CT;
  static constexpr int TX = (1 + 2 * NB) * K * ROW_BYTES;  // TMA bytes
  static constexpr int ST = NB * 64 * ROW_BYTES;  // a piece of state^T
  static constexpr int VEC = 3 * K + 4;  // cum, exp(cum), decay, exp(total)
  // 1024 for aligning the base (128-byte swizzle atoms are 1024 bytes),
  // the ring, the state's pieces, each stage's vectors, and two mbarriers
  // a stage
  static constexpr int SMEM = 1024 + STAGES * STAGE + ST_PIECES * ST +
                              STAGES * VEC * 4 + 16 * STAGES;
  static_assert(SMEM <= 227 * 1024, "a block's shared memory on an H100");
};

// ------------------------------------------------------------ barrier --

// named barrier 1: the consumer warpgroups, and not the producer
template <int NW>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(128 * NW) : "memory");
}

// ------------------------------------------------------------- kernel --

// grid (H, B). Accumulator element j of a thread of an m64n64 tile is
// row r0 + 8 ((j >> 1) & 1), column 8 (j >> 2) + 2 t + (j & 1), where
// r0 = 16 warp + lane / 4 and t = lane % 4; the same for the wider tiles
// of S.
template <int K, int NB>
__global__ void __launch_bounds__(Cfg<K, NB>::THREADS, 1)
ssd_chunk_wgmma(const __grid_constant__ CUtensorMap txd,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc, const Params p) {
  using C = Cfg<K, NB>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // stage s at s * STAGE
  uint8_t* const gbase = smem_raw + (base - raw);  // the same, generic
  const uint32_t st_s = base + STAGES * C::STAGE;  // [ST_PIECES][NB * 64]
  float* const vec = reinterpret_cast<float*>(
      gbase + STAGES * C::STAGE + ST_PIECES * C::ST);  // [STAGES][VEC]
  const uint32_t full0 = st_s + ST_PIECES * C::ST + STAGES * C::VEC * 4;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int chunks = (p.L + K - 1) / K;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32);      // the producer warp's lanes
      mbar_init(empty0 + 8 * s, C::NW);  // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (C::CR > K) {  // C's rows past K: zeros no load overwrites
    constexpr int PAD = (C::CR - K) * ROW_BYTES / 16;  // uint4 a slab
    for (int e = threadIdx.x; e < STAGES * NB * PAD; e += C::THREADS) {
      const int s = e / (NB * PAD);
      const int n = (e / PAD) % NB;
      uint4* row = reinterpret_cast<uint4*>(
          gbase + s * C::STAGE + C::XD + C::BT + n * C::CR * ROW_BYTES +
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
    const int lane = threadIdx.x - 128 * C::NW;
    if (lane >= 32) return;
    const float* ab = p.a + (long long)b * p.L * p.H + h;
    constexpr int PER = (K + 31) / 32;  // rows of cum a lane sums
    const int k0 = lane * PER;
    for (int c = 0; c < chunks; ++c) {
      const int s = c % STAGES;
      if (c >= STAGES) mbar_wait(empty0 + 8 * s, ((c / STAGES) - 1) & 1);
      const int t0 = c * K;
      const int rows = min(K, p.L - t0);
      float* cum = vec + s * C::VEC;
      // cum in double, rounded once: each lane totals its run of rows (a
      // = 0 past L: the padded rows are inert), the runs' totals are
      // scanned across the warp, then each lane writes its run's sums
      double v[PER], run = 0.0;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int k = k0 + q;
        v[q] = k < rows ? (double)ab[(long long)(t0 + k) * p.H] : 0.0;
        run += v[q];
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      run = __shfl_up_sync(0xffffffffu, incl, 1);  // the rows before
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
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) {
        cum[3 * K] = expf(total);
        const uint32_t dst = base + s * C::STAGE;
        mbar_expect_tx(full, C::TX);
        tma_load_4d(dst, &txd, full, 0, h, t0, b);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          tma_load_3d(dst + C::XD + n * K * ROW_BYTES, &tb, full, n * SLAB,
                      t0, b);
          tma_load_3d(dst + C::XD + C::BT + n * C::CR * ROW_BYTES, &tc,
                      full, n * SLAB, t0, b);
        }
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // ----------------------------------------------------- consumers --
  if constexpr (C::NW == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // rows r0, r0 + 8 of a tile
  const int i0 = 64 * wg + r0;                   // of the chunk
  uint8_t* const st_g = gbase + STAGES * C::STAGE;

  float st[C::TPW][32];  // state^T: tile wg * TPW + u, rows of N
#pragma unroll
  for (int u = 0; u < C::TPW; ++u)
#pragma unroll
    for (int j = 0; j < 32; ++j) st[u][j] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    const int s = c % STAGES;
    const uint32_t xs = base + s * C::STAGE;  // xd [K][64]
    const uint32_t bs = xs + C::XD;           // B [NB][K][64]
    const uint32_t cs = bs + C::BT;           // C [NB][CR][64]
    const uint8_t* const bg = gbase + s * C::STAGE + C::XD;
    const float* const cum = vec + s * C::VEC;
    const float* const decay = cum + 2 * K;
    const int t0 = c * K;
    const int rows = min(K, p.L - t0);

    // 1. the state in two bf16 pieces to shared memory (its owners), once
    // every consumer is done with the last chunk's pieces
    consumers_sync<C::NW>();
#pragma unroll
    for (int u = 0; u < C::TPW; ++u) {
      const int tile = wg * C::TPW + u;
      if (tile < NB) {
#pragma unroll
        for (int j = 0; j < 32; j += 2) {
          uint32_t piece[ST_PIECES][1];
          split(st[u][j], st[u][j + 1], piece, 0);
          const uint32_t off = sw128_offset(
              tile * 64 + r0 + 8 * ((j >> 1) & 1), 8 * (j >> 2) + 2 * t);
#pragma unroll
          for (int q = 0; q < ST_PIECES; ++q)
            *reinterpret_cast<uint32_t*>(st_g + q * C::ST + off) =
                piece[q][0];
        }
      }
    }
    fence_async_smem();
    consumers_sync<C::NW>();
    mbar_wait(full0 + 8 * s, (c / STAGES) & 1);

    // 2. S = C B^T and y = C state^T, k-steps over N: step kk reads
    // columns 16 kk.. of slab kk / 4
    float sc[K / 2], y[32];
    const uint32_t c_rows = cs + 64 * wg * ROW_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(sc,
               sw128_desc(c_rows + (kk / 4) * C::CR * ROW_BYTES + col, 16,
                          1024),
               sw128_desc(bs + (kk / 4) * K * ROW_BYTES + col, 16, 1024),
               kk > 0);
    }
#pragma unroll
    for (int q = 0; q < ST_PIECES; ++q)
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        wgmma_ss_t(y,
                   sw128_desc(c_rows + (kk / 4) * C::CR * ROW_BYTES +
                                  (kk % 4) * 32,
                              16, 1024),
                   sw128_desc(st_s + q * C::ST + kk * 16 * ROW_BYTES, C::ST,
                              1024),
                   q > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    pin(y);

    // 3. y = y o exp(cum_i) + M xd, M in two bf16 pieces; rows past K
    // (K < 64) read row K - 1's cum and are never stored
    const int ia = min(i0, K - 1), ib = min(i0 + 8, K - 1);
    const float ca = cum[ia], cb = cum[ib];
    const float ea = cum[K + ia], eb = cum[K + ib];
#pragma unroll
    for (int j = 0; j < 32; ++j) y[j] *= ((j >> 1) & 1) ? eb : ea;
    // The exp by the MUFU unit: M is split into bf16 pieces good to 2^-17,
    // below which its error stays. A group of 8 columns past the warp's
    // last row is 0 for all its rows and takes no exp.
    const int warp_last = 64 * wg + 16 * (tid >> 5) + 15;
    uint32_t m[M_PIECES][K / 4];
#pragma unroll
    for (int j = 0; j < K / 2; j += 2) {
      const int col = 8 * (j >> 2) + 2 * t;
      if (8 * (j >> 2) > warp_last) {
#pragma unroll
        for (int q = 0; q < M_PIECES; ++q) m[q][j / 2] = 0u;
        continue;
      }
      const bool second = (j >> 1) & 1;
      const int i = second ? i0 + 8 : i0;
      const float ci = second ? cb : ca;
      const float2 cj = *reinterpret_cast<const float2*>(cum + col);
      // select, never mask by a product: see the top
      const float m0 = col <= i ? sc[j] * fast_exp(ci - cj.x) : 0.0f;
      const float m1 = col + 1 <= i ? sc[j + 1] * fast_exp(ci - cj.y) : 0.0f;
      split(m0, m1, m, j / 2);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
      for (int q = 0; q < M_PIECES; ++q)
        wgmma_rs_t(y, &m[q][4 * kk],
                   sw128_desc(xs + kk * 16 * ROW_BYTES, C::XD, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    pin(y);
#pragma unroll
    for (int q = 0; q < M_PIECES; ++q) pin(m[q]);

    // 4. dS = (B o decay)^T xd, B o decay in three bf16 pieces: register
    // e of k-step kk is row r0 + 8 (e & 1) of the tile, columns k, k + 1
    // with k = 16 kk + 2 t + 8 (e >> 1); then the state. At K = 128 and
    // N <= 64 (NB 1, two consumers) the second consumer owns no tile: it
    // computes tile 0's dS again, and step 1 and the final store drop it. On
    // purpose: skipping it needs a branch on wg around these wgmmas, and
    // ptxas then serializes every wgmma of the instantiation (C7518).
    const float keep = cum[3 * K];
#pragma unroll
    for (int u = 0; u < C::TPW; ++u) {
      const int tile = (wg * C::TPW + u) % NB;
      const uint8_t* const bt = bg + tile * K * ROW_BYTES;
      uint32_t bd[BD_PIECES][K / 4];
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = r0 + 8 * (e & 1);
          const int k = 16 * kk + 2 * t + 8 * (e >> 1);
          const float2 d = *reinterpret_cast<const float2*>(decay + k);
          const float x0 = __bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(bt +
                                                      sw128_offset(k, n)));
          const float x1 = __bfloat162float(
              *reinterpret_cast<const __nv_bfloat16*>(
                  bt + sw128_offset(k + 1, n)));
          split(x0 * d.x, x1 * d.y, bd, 4 * kk + e);
        }
      float ds[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
        for (int q = 0; q < BD_PIECES; ++q)
          wgmma_rs_t(ds, &bd[q][4 * kk],
                     sw128_desc(xs + kk * 16 * ROW_BYTES, C::XD, 1024),
                     q > 0 || kk > 0);
      wgmma_commit();
      if (u == 0) {  // y's rows of the chunk, while the products run
        __nv_bfloat16* const yb =
            p.y + ((long long)b * p.L + t0) * p.H * p.P + (long long)h * p.P;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + 8 * half;
          if (i >= rows) continue;
          __nv_bfloat16* const yrow = yb + (long long)i * p.H * p.P;
#pragma unroll
          for (int jb = 0; jb < 8; ++jb) {
            const int col = 8 * jb + 2 * t;
            if (col < p.P)
              *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
                  __floats2bfloat162_rn(y[4 * jb + 2 * half],
                                        y[4 * jb + 2 * half + 1]);
          }
        }
      }
      wgmma_wait<0>();
      pin(ds);
#pragma unroll
      for (int q = 0; q < BD_PIECES; ++q) pin(bd[q]);
#pragma unroll
      for (int j = 0; j < 32; ++j) st[u][j] = fmaf(st[u][j], keep, ds[j]);
    }
    // the stage's tiles and vectors are read: the producer may refill it
    if (tid == 0) mbar_arrive(empty0 + 8 * s);
  }

  float* const so = p.state + ((long long)b * p.H + h) * p.P * p.N;
#pragma unroll
  for (int u = 0; u < C::TPW; ++u) {
    const int tile = wg * C::TPW + u;
    if (tile >= NB) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = tile * 64 + r0 + 8 * ((j >> 1) & 1);
      const int col = 8 * (j >> 2) + 2 * t + (j & 1);
      if (n < p.N && col < p.P) so[(long long)col * p.N + n] = st[u][j];
    }
  }
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

template <int K, int NB>
cudaError_t launch(const CUtensorMap& txd, const CUtensorMap& tb,
                   const CUtensorMap& tc, const Params& p, int batch,
                   cudaStream_t stream) {
  using C = Cfg<K, NB>;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_wgmma<K, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  ssd_chunk_wgmma<K, NB><<<dim3(p.H, batch), C::THREADS, C::SMEM, stream>>>(
      txd, tb, tc, p);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const CUtensorMap& txd, const CUtensorMap& tb,
                     const CUtensorMap& tc, const Params& p, int batch,
                     cudaStream_t stream) {
  return p.N > SLAB ? launch<K, 2>(txd, tb, tc, p, batch, stream)
                    : launch<K, 1>(txd, tb, tc, p, batch, stream);
}

}  // namespace

namespace ssd_wgmma {

// what forward returns when the CUDA driver refuses xd's, B_'s or C_'s
// tensor map: negative, so that no cudaError_t takes it (the binding's
// TMA_REFUSED)
constexpr int kTmaRefusedXd = -1, kTmaRefusedB = -2, kTmaRefusedC = -3;

// bf16 xd and y [B, L, H, P], B_ and C_ [B, L, N], fp32 a [B, L, H] and
// state [B, H, P, N], all contiguous; chunk 16, 32, 64 or 128, P <= 64,
// N <= 128. Returns the launch's cudaError_t, or a kTmaRefused code before
// any launch.
int forward(const void* xd, const float* a, const void* B, const void* C,
            void* y, float* state, int batch, int L, int H, int P, int N,
            int chunk, cudaStream_t stream) {
  if (P < 1 || P > SLAB || N < 1 || N > 2 * SLAB) return cudaErrorInvalidValue;
  if (encoder() == nullptr) return cudaErrorNotSupported;
  const cuuint32_t rows = static_cast<cuuint32_t>(chunk);
  CUtensorMap txd, tb, tc;
  {
    const cuuint64_t dims[4] = {cuuint64_t(P), cuuint64_t(H), cuuint64_t(L),
                                cuuint64_t(batch)};
    const cuuint64_t strides[3] = {cuuint64_t(P) * 2, cuuint64_t(H) * P * 2,
                                   cuuint64_t(L) * H * P * 2};
    const cuuint32_t box[4] = {SLAB, 1, rows, 1};
    if (!make_map(&txd, xd, 4, dims, strides, box)) return kTmaRefusedXd;
  }
  {
    const cuuint64_t dims[3] = {cuuint64_t(N), cuuint64_t(L),
                                cuuint64_t(batch)};
    const cuuint64_t strides[2] = {cuuint64_t(N) * 2, cuuint64_t(L) * N * 2};
    const cuuint32_t box[3] = {SLAB, rows, 1};
    if (!make_map(&tb, B, 3, dims, strides, box)) return kTmaRefusedB;
    if (!make_map(&tc, C, 3, dims, strides, box)) return kTmaRefusedC;
  }
  const Params p{a, static_cast<__nv_bfloat16*>(y), state, L, H, P, N};
  switch (chunk) {
    case 16: return launch_k<16>(txd, tb, tc, p, batch, stream);
    case 32: return launch_k<32>(txd, tb, tc, p, batch, stream);
    case 64: return launch_k<64>(txd, tb, tc, p, batch, stream);
    case 128: return launch_k<128>(txd, tb, tc, p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ssd_wgmma
