// The backward of flash attention in bf16 for Hopper (sm_90a): dq, dk and
// dv with every product on the tensor cores (wgmma), q, k, v and dout
// fed by TMA through rings of shared-memory stages. The bf16 route of
// flash_attention_bwd.cu's entry point; fp32 keeps the CUDA-core kernels
// there, and no bf16 launch reaches them.
//
// Replaces no TPU kernel of its own: the JAX package trains through XLA's
// autodiff of blocked_attention (repro/models/attention.py), the pure-JAX
// twin of repro/kernels/attention/kernel.py::_flash_kernel, whose bf16
// forward flash_attention_wgmma.cu replaces. It computes what
// ref.py::attention_bwd_ref computes, for training's launches (q_offset
// 0, every key valid; causal with an optional window, or no mask at
// all): for each (batch, query head h, query i, key j), kv head h /
// (Hq / Hkv),
//
//   P     = exp2(s_ij D^-0.5 log2(e) - lse_i log2(e)), 0 where the mask
//           removes the pair, recomputed from the forward's lse;
//   Delta = rowsum(dout_i o_i);  dP = dout_i . v_j;  dS = P (dP - Delta)
//   dv_j += P dout_i;  dk_j += dS q_i D^-0.5;  dq_i += dS k_j D^-0.5
//
// Two launches, each output element with one writer and a fixed order of
// sums (no atomics: a launch is deterministic, and training holds its
// runs bitwise):
//
//   delta_bf16      16 lanes a (batch, head, query) row, 16 bytes of o
//                   and of dout a lane at a time: Delta in fp32 from the
//                   bf16 o and dout, and lse in log2 units, into an fp32
//                   scratch [2][B][Hq][Sq_pad], Sq_pad = Sq rounded up to
//                   128; its padded rows hold 0 (finite, and masked by the
//                   blocks below anyway).
//   bwd_wgmma       one launch of two kinds of blocks, which need Delta and
//                   nothing of each other (one launch: the tail of one kind
//                   fills with blocks of the other). grid.x counts B x Hkv
//                   dK/dV blocks, then B x Hq dQ blocks; grid.y ranks their
//                   tiles from the most work down (dK/dV from the first key
//                   tile, dQ from the last query tile), and blocks start
//                   y-major, so the heaviest of both kinds start first.
//                   Each block: two consumer warpgroups of 64 rows and a
//                   producer warpgroup, whose one thread, after giving up
//                   registers (setmaxnreg), feeds a ring of four stages
//                   by TMA.
//     dK/dV block   (batch x kv head, tile of 128 keys): K and V loaded
//                   once, then Q, dout, lse and Delta in tiles of 64
//                   queries, for each query head of the GQA group and each
//                   query tile that can see a key of the block (from the
//                   diagonal down when causal, up to key + window with a
//                   window). Per stage each consumer runs
//                     S^T  = K Q^T      m64n64k16, both operands in shared
//                     dP^T = V dout^T   memory, keys as wgmma's M rows;
//                   then P^T and dS^T in the fp32 accumulators, which sit
//                   in the register layout of wgmma's A operand (the
//                   forward's trick for P.V), so each is packed once into
//                   bf16 fragments and fed from registers to
//                     dV += P^T dout    m64nDPk16, dout and Q read as
//                     dK += dS^T Q      MN-major B operands (the
//                                       descriptor's transpose bit).
//                   dK and dV stay in fp32 registers across the walk: the
//                   sum over the group is this loop, no second pass.
//     dQ block      (batch x query head, tile of 128 queries): Q and dout
//                   loaded once, K and V in tiles of 64 keys:
//                     S = Q K^T, dP = dout V^T   (K, V K-major B operands)
//                     dQ += dS K                 (dS from registers, K
//                                                 MN-major)
//                   dQ stays in registers and is stored once.
//
// The mask is a template parameter (bwd_wgmma<D, CAUSAL>). Tiles that no
// pair of a block's rows can see are never loaded; with the causal mask a
// consumer also hands back unread a loaded tile that every pair of its own
// 64 rows masks (the diagonal's other half: a tenth of the work at 512
// tokens). Without the mask no such test is compiled in: a branch around
// the products cost the unmasked launch more than it saved. Masks are
// applied only on tiles that cross the diagonal, the window's edge or a
// ragged end (P set to 0). TMA fills rows past Sq or Skv and columns past
// D with zeros, which does not mask: a zero row's score is 0, not -inf, so
// rows and columns past the ends are masked explicitly, and no lse or
// Delta past Sq is read (the scratch is padded). A box of A-operand rows
// that lies wholly past Sq or Skv is not loaded at all: those rows feed
// only rows of the same operand, which are not stored.
//
// Head dims as in the forward: every tile is kept as 64-column slabs (one
// TMA box of 64 rows each, 128-byte rows, 128-byte swizzle), D 32 and 64
// one slab, D 80 and 128 two; S^T, dP^T, S and dP run D / 16 k-steps
// (no product on the zero columns), dV, dK, dQ run at N = 64 or 128 and
// their padded columns are not stored.
//
// Numerics: P^T and dS^T go to the tensor cores in one bf16 piece each.
// The gradients are held at 1e-2 of each one's max |grad| (the card's
// check, chip_smoke.py FLASH_BWD_BF16_REL), a looser bound than the
// forward's elementwise one, which needed P in two pieces. Emulated on
// the CPU (tests/test_torch_flash_bwd_numerics.py: this kernel's tiles and
// roundings at causal 512 and 2048 tokens, D 128, and 1500 x 1500 and 448
// x 1500 without a mask, D 64), one piece stays within the bound (2.8e-3
// to 4.7e-3 of max |grad|), and fp8 (e4m3) for P and dS does not (3.0e-2
// to 0.31).
//
// What bounds it on an H100. At the train path's (8, 512, 512, 20, 20,
// 128) causal the function moves 168 MB (50.2 us at 3.35 TB/s) and does
// 10 D operations a pair (27.2 us at the bf16 peak): bytes bound it.
// This design does 14 D a pair (S and dP again in the dQ blocks: the
// price of one writer an element without atomics) plus the masked halves
// of diagonal tiles, and reads Q and dout once per key tile; its times
// beside that bound, the Delta pass alone and SDPA's backward are in
// PERF.md (python3 chip_smoke.py, and --flash-bwd).
//
// The tensor maps are encoded per call as in flash_attention_wgmma.cu;
// an operand the CUDA driver refuses (TMA's 16-byte rules) returns a code
// of its own before anything is launched, which the binding raises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int BKV = 128;        // keys per dK/dV block: 2 consumers x 64
constexpr int BQS = 64;         // queries per stage of the dK/dV walk
constexpr int BQ = 128;         // queries per dQ block: 2 consumers x 64
constexpr int BKS = 64;         // keys per stage of the dQ walk
constexpr int BOX = 64;         // rows per TMA box
constexpr int STAGES = 4;       // stages in each ring
constexpr int THREADS = 384;    // warpgroups 0, 1 consume; 2 produces
constexpr int SLAB = 64;        // bf16 columns per TMA box (128 bytes)
constexpr int ROW_BYTES = 128;  // one slab row in shared memory
constexpr int BOX_BYTES = BOX * ROW_BYTES;
constexpr int PAD = 128;        // the scratch's rows: Sq rounded up to it
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  void* dq;
  void* dk;
  void* dv;
  const float* lse2;   // [B, Hq, Sq_pad]: lse log2(e)
  const float* delta;  // [B, Hq, Sq_pad]
  int Sq, Skv, Sq_pad, Hq, Hkv, group, causal, window;
  float scale;       // D^-0.5
  float scale_log2;  // D^-0.5 log2(e)
};

template <int D>
struct Slabs {
  static constexpr int NB = (D + SLAB - 1) / SLAB;  // slabs per row
  static constexpr int DP = NB * SLAB;              // dV, dK, dQ's N
  static constexpr int KSTEPS = D / 16;             // S's and dP's k-steps
};

// dK/dV: K and V [NB][BKV rows] once, then Q and dout [STAGES][NB][BQS
// rows], lse and Delta [STAGES][BQS] fp32, and 1 + 2 STAGES mbarriers
template <int D>
struct KVTile : Slabs<D> {
  static constexpr int KV_SLAB = BKV * ROW_BYTES;
  static constexpr int KV_BYTES = Slabs<D>::NB * KV_SLAB;
  static constexpr int Q_SLAB = BQS * ROW_BYTES;
  static constexpr int Q_BYTES = Slabs<D>::NB * Q_SLAB;  // a stage's Q
  static constexpr int VEC_BYTES = BQS * 4;
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * STAGES * Q_BYTES +
                              2 * STAGES * VEC_BYTES + 8 * (1 + 2 * STAGES);
};

// dQ: Q and dout [NB][BQ rows] once, then K and V [STAGES][NB][BKS rows]
template <int D>
struct QTile : Slabs<D> {
  static constexpr int Q_SLAB = BQ * ROW_BYTES;
  static constexpr int Q_BYTES = Slabs<D>::NB * Q_SLAB;
  static constexpr int KV_SLAB = BKS * ROW_BYTES;
  static constexpr int KV_BYTES = Slabs<D>::NB * KV_SLAB;  // a stage's K
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

// a block's dynamic shared memory at most, on an H100
static_assert(KVTile<128>::SMEM <= 232448 && QTile<128>::SMEM <= 232448,
              "the rings do not fit shared memory at D 128");

// --------------------------------------------------------- the products --

// d = A B^T over D for one consumer's 64 rows of A and 64 rows of B, both
// [rows, D] in slabs `a_slab` and `b_slab` bytes apart: k-step kk reads
// columns 16 kk.. of slab kk / 4
template <int D>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a,
                                         uint32_t a_slab, uint32_t b,
                                         uint32_t b_slab) {
#pragma unroll
  for (int kk = 0; kk < Slabs<D>::KSTEPS; ++kk)
    wgmma_ss(d, sw128_desc(a + (kk / 4) * a_slab + (kk % 4) * 32, 16, 1024),
             sw128_desc(b + (kk / 4) * b_slab + (kk % 4) * 32, 16, 1024),
             kk > 0);
}

// o += A B for a 64 x 64 A in registers (k-step kk: registers 4 kk ..
// 4 kk + 3) and B [64 rows, DP] in slabs `b_slab` bytes apart, read
// MN-major
template <int N>
__device__ __forceinline__ void issue_rs(float (&o)[N],
                                         const uint32_t (&a)[16], uint32_t b,
                                         uint32_t b_slab) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_t(o, &a[4 * kk],
               sw128_desc(b + kk * 16 * ROW_BYTES, b_slab, 1024), 1);
}

// an fp32 accumulator of m64n64 into the bf16 A fragments of the next
// product: pair j / 2 is register (j / 2) % 4 of k-step j / 8
__device__ __forceinline__ void pack(const float (&s)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int j = 0; j < 32; j += 2) {
    __nv_bfloat162 h = __floats2bfloat162_rn(s[j], s[j + 1]);
    a[j / 2] = *reinterpret_cast<uint32_t*>(&h);
  }
}

// Accumulator element j of a thread sits at row 8 ((j >> 1) & 1) of its
// two rows (16 warp + lane / 4 in the warpgroup's 64) and column
// 8 (j >> 2) + 2 t + (j & 1), t = lane % 4.
template <bool CAUSAL>
__device__ __forceinline__ bool keep(const Params& p, int qp, int kp) {
  bool in = qp < p.Sq && kp < p.Skv;
  if (CAUSAL) in = in && kp <= qp && (p.window <= 0 || kp > qp - p.window);
  return in;
}

// stores the accumulator of m64nDP (rows row0, row0 + 8 of a [rows, H,
// D] bf16 tensor at `base`, `row_stride` elements apart) times `mul`,
// rows below n_rows, columns below D
template <int D>
__device__ __forceinline__ void store_rows(
    __nv_bfloat16* base, long long row_stride, int row0, int n_rows, int t,
    const float (&o)[Slabs<D>::DP / 2], float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    if (r >= n_rows) continue;
    __nv_bfloat16* row = base + r * row_stride;
#pragma unroll
    for (int jb = 0; jb < Slabs<D>::DP / 8; ++jb) {
      const int col = 8 * jb + 2 * t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(o[4 * jb + 2 * half] * mul,
                                  o[4 * jb + 2 * half + 1] * mul);
    }
  }
}

// -------------------------------------------------------------- kernels --

// Delta and lse in log2 units, 16 lanes a row of the [B, Hq, Sq_pad]
// scratch (query fastest), each lane reading 16 bytes of o and of dout
// at a time; o and dout contiguous [B, Sq, Hq, D], 16-byte aligned, lse
// the forward's [B, Hq, Sq]
__global__ void __launch_bounds__(256)
delta_bf16(const __nv_bfloat16* o, const __nv_bfloat16* dout,
           const float* lse, float* lse2, float* delta, long long rows,
           int Sq, int Sq_pad, int Hq, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * 16 +
                        threadIdx.x / 16;
  const int lane = threadIdx.x & 15;
  const long long bh = row / Sq_pad;
  const int s = static_cast<int>(row - bh * Sq_pad);
  const bool in = row < rows && s < Sq;
  float acc = 0.0f;
  if (in) {
    const long long b = bh / Hq;
    const int h = static_cast<int>(bh - b * Hq);
    const long long off = ((b * Sq + s) * Hq + h) * D;
    const uint4* o4 = reinterpret_cast<const uint4*>(o + off);
    const uint4* d4 = reinterpret_cast<const uint4*>(dout + off);
    for (int i = lane; i < D / 8; i += 16) {
      const uint4 x = o4[i], y = d4[i];
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xs[j]));
        const float2 c = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ys[j]));
        acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
      }
    }
  }
#pragma unroll
  for (int m = 8; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);  // within the 16 lanes
  if (row < rows && lane == 0) {
    delta[row] = acc;
    lse2[row] = in ? lse[bh * Sq + s] * LOG2E : 0.0f;
  }
}

template <int D, bool CAUSAL>
__device__ __forceinline__ void dkdv_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const Params& p, uint8_t* smem_raw, int bx,
    int by) {
  using T = KVTile<D>;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;          // [NB][BKV]
  const uint32_t v_s = k_s + T::KV_BYTES;              // [NB][BKV]
  const uint32_t q_s = v_s + T::KV_BYTES;              // [STAGES][NB][BQS]
  const uint32_t do_s = q_s + STAGES * T::Q_BYTES;     // [STAGES][NB][BQS]
  const uint32_t lse_s = do_s + STAGES * T::Q_BYTES;   // [STAGES][BQS]
  const uint32_t del_s = lse_s + STAGES * T::VEC_BYTES;
  const uint32_t kv_full = del_s + STAGES * T::VEC_BYTES;
  const uint32_t full0 = kv_full + 8;                  // a stage in
  const uint32_t empty0 = full0 + 8 * STAGES;          // a stage free again

  const int b = bx / p.Hkv;
  const int hk = bx - b * p.Hkv;
  const int k0 = by * BKV;  // the first tiles walk the most queries

  // the query tiles some key of this block is seen from
  const int k_last = min(k0 + BKV, p.Skv) - 1;
  const int q_begin = CAUSAL ? k0 : 0;
  int q_end = p.Sq;
  if (CAUSAL && p.window > 0) q_end = min(q_end, k_last + p.window);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BQS - 1) / BQS : 0;
  const int n_steps = p.group * n_qt;  // (query head, query tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256 && n_steps > 0) {
      // the second box of keys only where some of them exist
      const int boxes = k0 + BOX < p.Skv ? 2 : 1;
      mbar_expect_tx(kv_full, 2 * T::NB * boxes * BOX_BYTES);
      for (int c = 0; c < T::NB; ++c)
        for (int r = 0; r < boxes; ++r) {
          const uint32_t off = c * T::KV_SLAB + r * BOX_BYTES;
          tma_load_4d(k_s + off, &tk, kv_full, c * SLAB, hk, k0 + r * BOX, b);
          tma_load_4d(v_s + off, &tv, kv_full, c * SLAB, hk, k0 + r * BOX, b);
        }
      for (int it = 0; it < n_steps; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES)
          mbar_wait(empty0 + 8 * st, ((it / STAGES) - 1) & 1);
        const int g = it / n_qt;
        const int q0 = q_begin + (it - g * n_qt) * BQS;
        const int h = hk * p.group + g;
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * T::Q_BYTES + 2 * T::VEC_BYTES);
        for (int c = 0; c < T::NB; ++c) {
          const uint32_t off = st * T::Q_BYTES + c * T::Q_SLAB;
          tma_load_4d(q_s + off, &tq, full, c * SLAB, h, q0, b);
          tma_load_4d(do_s + off, &tdo, full, c * SLAB, h, q0, b);
        }
        const long long row =
            (static_cast<long long>(b) * p.Hq + h) * p.Sq_pad + q0;
        bulk_load(lse_s + st * T::VEC_BYTES, p.lse2 + row, T::VEC_BYTES,
                  full);
        bulk_load(del_s + st * T::VEC_BYTES, p.delta + row, T::VEC_BYTES,
                  full);
      }
    }
  } else {
    // ----------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int kw = k0 + 64 * wg;                     // the consumer's keys
    const int key0 = kw + 16 * warp + (lane >> 2);   // rows key0, key0 + 8
    const uint32_t k_rows = k_s + 64 * wg * ROW_BYTES;
    const uint32_t v_rows = v_s + 64 * wg * ROW_BYTES;
    const float* lse_v = reinterpret_cast<const float*>(smem_raw +
                                                        (lse_s - raw));
    const float* del_v = reinterpret_cast<const float*>(smem_raw +
                                                        (del_s - raw));
    float dk[T::DP / 2], dv[T::DP / 2];
#pragma unroll
    for (int j = 0; j < T::DP / 2; ++j) dk[j] = dv[j] = 0.0f;
    float s[32], dp[32];
    uint32_t pa[16], da[16];

    if (n_steps > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_steps; ++it) {
      const int st = it % STAGES;
      const int q0 = q_begin + (it % n_qt) * BQS;
      const uint32_t q_st = q_s + st * T::Q_BYTES;
      const uint32_t do_st = do_s + st * T::Q_BYTES;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
      // a tile whose every pair with this consumer's keys is masked is
      // handed back unread (causal: above the diagonal; a window: past it)
      const bool dead = CAUSAL && (kw >= p.Skv || kw > q0 + BQS - 1 ||
                                   (p.window > 0 && kw + 63 <= q0 - p.window));
      if (!dead) {
        wgmma_fence();
        issue_ss<D>(s, k_rows, T::KV_SLAB, q_st, T::Q_SLAB);
        wgmma_commit();
        issue_ss<D>(dp, v_rows, T::KV_SLAB, do_st, T::Q_SLAB);
        wgmma_commit();
        // a pair of this consumer's keys and the tile's queries is masked
        const bool edge = kw + 64 > p.Skv || q0 + BQS > p.Sq ||
                          (CAUSAL && (kw + 63 > q0 || (p.window > 0 &&
                                      kw <= q0 + BQS - 1 - p.window)));
        const float* lse = lse_v + st * BQS + 2 * t;
        const float* del = del_v + st * BQS + 2 * t;
        wgmma_wait<1>();  // S^T is in; dP^T may still run
        pin(s);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 l = *reinterpret_cast<const float2*>(lse + 8 * i);
#pragma unroll
          for (int j = 4 * i; j < 4 * i + 4; ++j)
            s[j] = ex2(fmaf(s[j], p.scale_log2, (j & 1) ? -l.y : -l.x));
        }
        if (edge) {
#pragma unroll
          for (int j = 0; j < 32; ++j)
            if (!keep<CAUSAL>(p, q0 + 8 * (j >> 2) + 2 * t + (j & 1),
                              key0 + 8 * ((j >> 1) & 1)))
              s[j] = 0.0f;
        }
        wgmma_wait<0>();
        pin(dp);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 d = *reinterpret_cast<const float2*>(del + 8 * i);
#pragma unroll
          for (int j = 4 * i; j < 4 * i + 4; ++j)
            dp[j] = s[j] * (dp[j] - ((j & 1) ? d.y : d.x));
        }
        pack(s, pa);
        pack(dp, da);
        wgmma_fence();
        issue_rs(dv, pa, do_st, T::Q_SLAB);
        issue_rs(dk, da, q_st, T::Q_SLAB);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dv);
        pin(dk);
        pin(pa);
        pin(da);
      }
      if (tid == 0) mbar_arrive(empty0 + 8 * st);  // the stage is read
    }

    const long long off =
        (static_cast<long long>(b) * p.Skv * p.Hkv + hk) * D;
    const long long stride = static_cast<long long>(p.Hkv) * D;
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dk) + off, stride, key0,
                  p.Skv, t, dk, p.scale);
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dv) + off, stride, key0,
                  p.Skv, t, dv, 1.0f);
  }
}

template <int D, bool CAUSAL>
__device__ __forceinline__ void dq_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const Params& p, uint8_t* smem_raw, int bx,
    int q0) {
  using T = QTile<D>;
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;  // [NB][BQ]
  const uint32_t do_s = q_s + T::Q_BYTES;                // [NB][BQ]
  const uint32_t k_s = do_s + T::Q_BYTES;                // [STAGES][NB][BKS]
  const uint32_t v_s = k_s + STAGES * T::KV_BYTES;       // [STAGES][NB][BKS]
  const uint32_t q_full = v_s + STAGES * T::KV_BYTES;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int b = bx / p.Hq;
  const int h = bx - b * p.Hq;

  // the key tiles some row of this block sees
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = CAUSAL ? min(p.Skv, q_last + 1) : p.Skv;
  int k_begin = CAUSAL && p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin -= k_begin % BKS;
  const int n_tiles = max(0, (k_end - k_begin + BKS - 1) / BKS);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------ producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256 && n_tiles > 0) {
      const int hk = h / p.group;
      const int boxes = q0 + BOX < p.Sq ? 2 : 1;
      mbar_expect_tx(q_full, 2 * T::NB * boxes * BOX_BYTES);
      for (int c = 0; c < T::NB; ++c)
        for (int r = 0; r < boxes; ++r) {
          const uint32_t off = c * T::Q_SLAB + r * BOX_BYTES;
          tma_load_4d(q_s + off, &tq, q_full, c * SLAB, h, q0 + r * BOX, b);
          tma_load_4d(do_s + off, &tdo, q_full, c * SLAB, h, q0 + r * BOX, b);
        }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES)
          mbar_wait(empty0 + 8 * st, ((it / STAGES) - 1) & 1);
        const int k0 = k_begin + it * BKS;
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * T::KV_BYTES);
        for (int c = 0; c < T::NB; ++c) {
          const uint32_t off = st * T::KV_BYTES + c * T::KV_SLAB;
          tma_load_4d(k_s + off, &tk, full, c * SLAB, hk, k0, b);
          tma_load_4d(v_s + off, &tv, full, c * SLAB, hk, k0, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    const int qw = q0 + 64 * wg;                    // the consumer's rows
    const int row0 = qw + 16 * warp + (lane >> 2);  // rows row0, row0 + 8
    const uint32_t q_rows = q_s + 64 * wg * ROW_BYTES;
    const uint32_t do_rows = do_s + 64 * wg * ROW_BYTES;
    // the scratch is padded to whole blocks: rows past Sq read its zeros
    const long long vrow =
        (static_cast<long long>(b) * p.Hq + h) * p.Sq_pad + row0;
    const float l0 = -p.lse2[vrow], l1 = -p.lse2[vrow + 8];
    const float d0 = p.delta[vrow], d1 = p.delta[vrow + 8];
    float dq[T::DP / 2];
#pragma unroll
    for (int j = 0; j < T::DP / 2; ++j) dq[j] = 0.0f;
    float s[32], dp[32];
    uint32_t da[16];

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const int k0 = k_begin + it * BKS;
      const uint32_t k_st = k_s + st * T::KV_BYTES;
      const uint32_t v_st = v_s + st * T::KV_BYTES;
      mbar_wait(full0 + 8 * st, (it / STAGES) & 1);
      const bool dead = CAUSAL && (qw >= p.Sq || k0 > qw + 63 ||
                                   (p.window > 0 &&
                                    k0 + BKS - 1 <= qw - p.window));
      if (!dead) {
        wgmma_fence();
        issue_ss<D>(s, q_rows, T::Q_SLAB, k_st, T::KV_SLAB);
        wgmma_commit();
        issue_ss<D>(dp, do_rows, T::Q_SLAB, v_st, T::KV_SLAB);
        wgmma_commit();
        const bool edge = k0 + BKS > p.Skv ||
                          (CAUSAL && (k0 + BKS - 1 > qw || (p.window > 0 &&
                                      k0 <= qw + 63 - p.window)));
        wgmma_wait<1>();
        pin(s);
#pragma unroll
        for (int j = 0; j < 32; ++j)
          s[j] = ex2(fmaf(s[j], p.scale_log2, ((j >> 1) & 1) ? l1 : l0));
        if (edge) {
#pragma unroll
          for (int j = 0; j < 32; ++j)
            if (!keep<CAUSAL>(p, row0 + 8 * ((j >> 1) & 1),
                              k0 + 8 * (j >> 2) + 2 * t + (j & 1)))
              s[j] = 0.0f;
        }
        wgmma_wait<0>();
        pin(dp);
#pragma unroll
        for (int j = 0; j < 32; ++j)
          dp[j] = s[j] * (dp[j] - (((j >> 1) & 1) ? d1 : d0));
        pack(dp, da);
        wgmma_fence();
        issue_rs(dq, da, k_st, T::KV_SLAB);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dq);
        pin(da);
      }
      if (tid == 0) mbar_arrive(empty0 + 8 * st);
    }

    const long long off = (static_cast<long long>(b) * p.Sq * p.Hq + h) * D;
    store_rows<D>(static_cast<__nv_bfloat16*>(p.dq) + off,
                  static_cast<long long>(p.Hq) * D, row0, p.Sq, t, dq,
                  p.scale);
  }
}

// One launch for both: blocks x < B Hkv are dK/dV blocks, the rest dQ
// blocks; y ranks the tiles from the most work down (dK/dV from the
// first key tile, dQ from the last query tile), and the card dispatches
// blocks y-major, so the heaviest of both kinds start first.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
bwd_wgmma(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo, const Params p,
          int kv_blocks) {
  extern __shared__ uint8_t smem_raw[];
  const int x = blockIdx.x, y = blockIdx.y;
  if (x < kv_blocks) {
    if (y * BKV < p.Skv)
      dkdv_block<D, CAUSAL>(tq, tk, tv, tdo, p, smem_raw, x, y);
  } else {
    const int n_qt = (p.Sq + BQ - 1) / BQ;
    if (y < n_qt)
      dq_block<D, CAUSAL>(tq, tk, tv, tdo, p, smem_raw, x - kv_blocks,
                          (n_qt - 1 - y) * BQ);
  }
}

// ---------------------------------------------------------------- host --

// a 4-d map over a contiguous bf16 [N, S, H, D] (given as D, H, S, N
// innermost first); boxes of SLAB columns x 1 head x BOX rows
bool make_map(CUtensorMap* map, const void* ptr, int D, int H, int S,
              int N) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S),
                              cuuint64_t(N)};
  const cuuint64_t sh = cuuint64_t(D) * 2;
  const cuuint64_t strides[3] = {sh, sh * H, sh * H * S};
  const cuuint32_t box[4] = {SLAB, 1, BOX, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int pad_rows(int Sq) { return (Sq + PAD - 1) / PAD * PAD; }

cudaError_t launch_delta(const void* o, const void* dout, const void* lse,
                         float* scratch, int B, int Sq, int Hq, int D,
                         cudaStream_t stream) {
  const int Sq_pad = pad_rows(Sq);
  const long long rows = static_cast<long long>(B) * Hq * Sq_pad;
  delta_bf16<<<static_cast<unsigned>((rows + 15) / 16), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), scratch, scratch + rows, rows, Sq,
      Sq_pad, Hq, D);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& tdo,
                   const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = KVTile<D>::SMEM > QTile<D>::SMEM ? KVTile<D>::SMEM
                                                        : QTile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_wgmma<D, CAUSAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int tiles = max((p.Skv + BKV - 1) / BKV, (p.Sq + BQ - 1) / BQ);
  bwd_wgmma<D, CAUSAL><<<dim3(B * p.Hkv + B * p.Hq, tiles), THREADS, smem,
                         stream>>>(tq, tk, tv, tdo, p, B * p.Hkv);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mask(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, const CUtensorMap& tdo,
                        const Params& p, int B, cudaStream_t stream) {
  return p.causal ? launch<D, true>(tq, tk, tv, tdo, p, B, stream)
                  : launch<D, false>(tq, tk, tv, tdo, p, B, stream);
}

}  // namespace

namespace flash_bwd_wgmma {

// what backward returns when the CUDA driver refuses q's, k's, v's or
// dout's tensor map: negative, so that no cudaError_t takes it (the
// binding's TMA_REFUSED)
constexpr int kTmaRefusedQ = -1, kTmaRefusedK = -2, kTmaRefusedV = -3,
              kTmaRefusedDout = -4;

// bf16 q, o, dout, dq contiguous [B, Sq, Hq, D], o 16-byte aligned; k,
// v, dk, dv contiguous [B, Skv, Hkv, D]; D one of 32, 64, 80, 128; lse the
// forward's fp32 [B, Hq, Sq]; scratch an fp32 [2, B, Hq, Sq rounded up to
// 128]. Returns the launches' cudaError_t, or a kTmaRefused code before
// any launch.
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* scratch, void* dq,
             void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
             int D, int causal, int window, float scale,
             cudaStream_t stream) {
  if (encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, D, Hq, Sq, B)) return kTmaRefusedQ;
  if (!make_map(&tk, k, D, Hkv, Skv, B)) return kTmaRefusedK;
  if (!make_map(&tv, v, D, Hkv, Skv, B)) return kTmaRefusedV;
  if (!make_map(&tdo, dout, D, Hq, Sq, B)) return kTmaRefusedDout;
  // the Delta pass reads o 16 bytes at a time (dout's map holds it to
  // the same rule)
  if (reinterpret_cast<uintptr_t>(o) % 16 != 0) return cudaErrorInvalidValue;
  const int Sq_pad = pad_rows(Sq);
  float* lse2 = static_cast<float*>(scratch);
  const float* delta = lse2 + static_cast<long long>(B) * Hq * Sq_pad;
  cudaError_t err = launch_delta(o, dout, lse, lse2, B, Sq, Hq, D, stream);
  if (err != cudaSuccess) return err;
  const Params p{dq, dk, dv, lse2, delta, Sq, Skv, Sq_pad, Hq, Hkv,
                 Hq / Hkv, causal, window, scale, scale * LOG2E};
  switch (D) {
    case 32: return launch_mask<32>(tq, tk, tv, tdo, p, B, stream);
    case 64: return launch_mask<64>(tq, tk, tv, tdo, p, B, stream);
    case 80: return launch_mask<80>(tq, tk, tv, tdo, p, B, stream);
    case 128: return launch_mask<128>(tq, tk, tv, tdo, p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash_bwd_wgmma

extern "C" {

// The Delta pass alone (bf16 o and dout, 16-byte aligned; the scratch as
// backward's), for timing it on its own: returns cudaGetLastError() after
// its launch.
int flash_attention_bwd_delta(const void* o, const void* dout,
                              const void* lse, void* scratch, int B, int Sq,
                              int Hq, int D, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(dout)) %
          16 != 0)
    return cudaErrorInvalidValue;
  return launch_delta(o, dout, lse, static_cast<float*>(scratch), B, Sq, Hq,
                      D, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
