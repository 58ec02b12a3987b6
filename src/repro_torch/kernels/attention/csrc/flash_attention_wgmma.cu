// Flash attention in bf16 for Hopper (sm_90a): QK^T and P.V on the
// tensor cores (wgmma), K and V fed by TMA through a ring of shared-memory
// stages, the online softmax in registers. The bf16 route of
// flash_attention.cu's entry point; fp32 inputs keep the CUDA-core kernel
// there.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py::_flash_kernel
// (launched by flash_attention_pallas, wrapped by
// attention/ops.py::flash_attention) for bf16 q, k, v. It computes what
// that kernel computes, for q [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D]:
//
//   s   = (q . k) * D^-0.5 in fp32, -1e30 where a mask removes the pair
//         (key >= kv_valid, key > query when causal, key <= query -
//         window), query position q_offset + row; query head h reads kv
//         head h / (Hq / Hkv);
//   out = softmax(s) v by the running max m, denominator l and
//         accumulator acc, all fp32; acc / max(l, 1e-30) stored in bf16;
//   lse = each row's logsumexp of its scaled scores, (m + log2(l)) ln 2
//         with m kept in log2 units, fp32 [B, Hq, Sq], stored by the
//         quad's first thread only when the pointer is not null (the
//         training forward's; serving passes null). It adds no live
//         register to the loop: m and l are there already.
//
// Design. One block of three warpgroups per (batch x query head, tile of
// 128 query rows); the tiles are walked last first (blockIdx.y counts from
// the end), so the longest causal rows start first. Warpgroup 2 produces:
// after giving up registers (setmaxnreg) one of its threads loads the
// block's Q once and then K and V tile by tile (128 keys a stage, a ring
// of three stages) with TMA (cp.async.bulk.tensor, 4-d tensor maps over
// the caller's [B, S, H, D] strides), each load completing on the
// stage's mbarrier. Warpgroups 0 and 1 consume, 64 query rows each:
//
//   S = Q K^T   wgmma m64n128k16, both operands in shared memory, K
//               [keys, D] with D contiguous as the K-major B operand;
//               the fp32 accumulator stays in registers, where the masks
//               are applied (only on the tiles that cross the diagonal,
//               the window's edge or kv_valid);
//   softmax     each row lives in the four threads of a quad: its max by
//               two __shfl_xor_sync, then P = exp2(s * scale log2(e) -
//               m) by one FFMA and one MUFU op, the running m, l and the
//               rescale of acc, all in registers;
//   acc += P V  P never leaves the registers: the accumulator layout of
//               S is the A-operand layout of the next product, so each
//               fp32 pair is packed into bf16x2 fragments and fed to
//               wgmma m64nDPk16 with A in registers, V [keys, D] the
//               MN-major B operand (the descriptor's transpose bit).
//
// The two consumers take turns on the tensor cores (named barriers 1, 2):
// in its turn a consumer issues S(i + 1) = Q K(i + 1)^T and acc += P(i)
// V(i), hands the turn over, computes the softmax of S(i + 1) while its
// P(i) V(i) and the other consumer's products run, then releases stage i
// to the producer (an arrival on the stage's "empty" mbarrier, two per
// round). Key tiles that every row of the block masks are never loaded
// (the TPU kernel's block skip); the ragged edges are masked here: TMA
// fills rows past Sq or Skv, and columns past D, with zeros.
//
// Head dims. Every tile is kept as 64-column slabs (one TMA box each, 128
// bytes a row, 128-byte swizzle, which the wgmma descriptors name):
// D 32 and 64 take one slab, D 80 and 128 two (D 32's upper half and
// D 80's last 48 columns are TMA's zeros). QK^T runs D / 16 k-steps, so
// the zero columns cost no product there; P.V runs at N = 64 or 128 and
// the padded columns are not stored.
//
// Numerics: P in two halves. The TPU kernel and the plain version keep P
// in fp32, and the card holds this kernel against the plain version at
// one bf16 step of the output (rtol 1e-2, atol 1e-4). A bf16 wgmma takes
// P in bf16. Emulated on the CPU (tests/test_torch_flash_numerics.py, the
// kernel's tiles and online softmax at 1 x 2048 x 4 heads x 128, causal,
// bf16-exact q, k, v): P rounded once to bf16 gives a max error of
// 1.56e-2, 15.3x the allowed error at the worst element and 16,745
// elements over the bound; P split into P_hi = bf16(P) and P_lo = bf16(P
// - P_hi), with P.V = P_hi.V + P_lo.V accumulated in fp32, gives 1.95e-3,
// at most 0.71x the allowed error, no element over. V is exact in bf16,
// so the only rounding left is P_lo's, about 2^-17 of P. So P.V is two
// wgmmas into one accumulator: 6 products per (query, key, dim) where a
// single-P kernel does 4. That test holds both halves of the finding.
//
// What bounds it on an H100. At the serving path's long prompt
// (Qwen1.5-4B: 4 x 2048, 20 heads of 128, causal) the function's work is
// 4 * B * H * D * (causal pairs) = 86 GFLOP against 168 MB of q, k, v
// and o: operations bound it, 86.9 us at the bf16 tensor-core peak of 989
// TFLOP/s. This kernel does 1.5x those products, plus the upper half of
// each diagonal tile. Its times on an H100 (80GB HBM3, 700 W), beside
// copies with the P_lo product, the softmax or the consumers' turns
// taken out (`python3 chip_smoke.py --flash-ablation`), are in PERF.md
// section 6: about a third of the bound, the products themselves taking
// most of the time and the softmax hiding behind them but for some 5 %.
// At the short prompt (8 x 32: 160 blocks, one to an SM at a time on
// 132 SMs) the second round of blocks costs some 70 % of what the
// first does.
//
// The tensor maps are encoded on the host per call from the pointers and
// strides the binding passes (cuTensorMapEncodeTiled, taken through
// cudaGetDriverEntryPointByVersion, so the library needs no -lcuda) and
// reach the kernel as __grid_constant__ parameters. TMA wants 16-byte
// aligned base pointers and 16-byte multiples for every stride; the
// CUDA driver's encoder holds both, and an operand it refuses returns a
// code of its own here, which the binding raises as a ValueError.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;         // query rows per block: 2 consumers x 64
constexpr int BK = 128;         // keys per K/V stage
constexpr int STAGES = 3;       // K/V stages in the ring (225 KB at D 128)
constexpr int THREADS = 384;    // warpgroups 0, 1 consume; 2 produces
constexpr int SLAB = 64;        // bf16 columns per TMA box (128 bytes)
constexpr int ROW_BYTES = 128;  // one slab row in shared memory
constexpr float NEG_INF = -1e30f;
constexpr float MASKED = -1e20f;  // a scaled max below it: no key seen yet
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  void* o;
  float* lse;  // [B, Hq, Sq], or null
  long long o_sb, o_ss, o_sh;
  int Sq, Hq, group, causal, window, q_offset, kv_valid;
  float scale_log2;  // D^-0.5 * log2(e): the softmax runs on exp2
};

template <int D>
struct Tile {
  static constexpr int NB = (D + SLAB - 1) / SLAB;  // slabs per row
  static constexpr int DP = NB * SLAB;              // P.V's N
  static constexpr int KSTEPS = D / 16;             // QK^T's k-steps
  static constexpr int Q_BYTES = NB * BQ * ROW_BYTES;
  static constexpr int KV_BYTES = NB * BK * ROW_BYTES;  // K or V, a stage
  // 1024 for aligning the base (128-byte swizzle atoms are 1024 bytes),
  // then Q, the K and V rings, and 1 + 2 * STAGES mbarriers
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-d tensor map at (c0 = column, c1 = head, c2 = row,
// c3 = batch) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (each >> 4)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// returns once at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// named barriers 1 and 2 hand the tensor cores from one consumer to the
// other: warpgroup w issues its products once barrier 1 + w completes
// (its 128 threads wait, the other warpgroup's 128 arrive)
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" :: "r"(2 - wg) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define ACC8(a, i)                                                     \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),          \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])

// s (+)= A B, m64n128k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&s)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(s, 0), ACC8(s, 8), ACC8(s, 16), ACC8(s, 24), ACC8(s, 32),
        ACC8(s, 40), ACC8(s, 48), ACC8(s, 56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// o += A B, m64n128k16, A (4 bf16x2 registers a thread) in registers, B
// MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_pv(float (&o)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(o, 0), ACC8(o, 8), ACC8(o, 16), ACC8(o, 24), ACC8(o, 32),
        ACC8(o, 40), ACC8(o, 48), ACC8(o, 56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// the same at m64n64k16
__device__ __forceinline__ void wgmma_pv(float (&o)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(o, 0), ACC8(o, 8), ACC8(o, 16), ACC8(o, 24)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef ACC8

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// 2^x in one MUFU op; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------ consumer steps --

// S = Q K^T for one consumer's 64 rows and one K stage: k-step kk reads
// columns 16 kk.. of slab kk / 4 (D / 16 steps: no product on the zero
// columns of D 32's and D 80's last slab)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_rows,
                                         uint32_t k_st) {
#pragma unroll
  for (int kk = 0; kk < Tile<D>::KSTEPS; ++kk) {
    const uint32_t qcol = (kk / 4) * BQ * ROW_BYTES + (kk % 4) * 32;
    const uint32_t kcol = (kk / 4) * BK * ROW_BYTES + (kk % 4) * 32;
    wgmma_qk(s, sw128_desc(q_rows + qcol, 16, 1024),
             sw128_desc(k_st + kcol, 16, 1024), kk > 0);
  }
}

// acc += P_hi V + P_lo V for one V stage: k-step kk takes keys 16 kk.. of
// the stage, whose A fragment is registers 4 kk .. 4 kk + 3 of each half
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N],
                                         const uint32_t (&hi)[32],
                                         const uint32_t (&lo)[32],
                                         uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv =
        sw128_desc(v_st + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
    wgmma_pv(o, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3],
             dv);
    wgmma_pv(o, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3],
             dv);
  }
}

// A thread's two rows: query positions qpos and qpos + 8, running max m,
// its share of the denominator l (the quad sums the shares at the end).
// Accumulator element j of a thread is row 8 ((j >> 1) & 1) of the two,
// column 8 (j >> 2) + 2 t + (j & 1).
struct Rows {
  int qpos, t;
  float m0, m1, l0, l1;
};

// One tile's scores (keys k0 .. k0 + BK) in place: masked where the tile
// crosses a mask's edge for some row in wg_first .. wg_first + 63, then
// P = exp2(s * scale_log2 - m), one FFMA and one MUFU op an element, with
// the rows' running max m (kept scaled) updated. Adds the rows' sums of P
// to l and returns each row's correction exp2(m_old - m_new) for the
// accumulator.
__device__ __forceinline__ float2 softmax_tile(float (&s)[64], Rows& r,
                                               const Params& p, int k0,
                                               int wg_first) {
  const bool edge = k0 + BK > p.kv_valid ||
                    (p.causal && k0 + BK - 1 > wg_first) ||
                    (p.window > 0 && k0 <= wg_first + 63 - p.window);
  if (edge) {
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int kp = k0 + 8 * (j >> 2) + 2 * r.t + (j & 1);
      const int qp = r.qpos + 8 * ((j >> 1) & 1);
      bool keep = kp < p.kv_valid;
      if (p.causal) keep = keep && kp <= qp;
      if (p.window > 0) keep = keep && kp > qp - p.window;
      s[j] = keep ? s[j] : NEG_INF;
    }
  }
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    if ((j >> 1) & 1) mx1 = fmaxf(mx1, s[j]);
    else mx0 = fmaxf(mx0, s[j]);
  }
  // the scale is positive, so the max of the scaled scores is the scaled
  // max. A row that every key so far masks has m near -1e30 * scale: its
  // exponents are taken against 0 instead, so that its P is 0 (the FMA's
  // unrounded -1e30 * scale minus the rounded m could be 1e22 either way)
  const float mn0 = fmaxf(r.m0, quad_max(mx0) * p.scale_log2);
  const float mn1 = fmaxf(r.m1, quad_max(mx1) * p.scale_log2);
  const float2 c = make_float2(ex2(r.m0 - mn0), ex2(r.m1 - mn1));
  r.m0 = mn0;
  r.m1 = mn1;
  const float base0 = mn0 < MASKED ? 0.0f : -mn0;
  const float base1 = mn1 < MASKED ? 0.0f : -mn1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const bool second = (j >> 1) & 1;
    s[j] = ex2(fmaf(s[j], p.scale_log2, second ? base1 : base0));
    if (second) sum1 += s[j];
    else sum0 += s[j];
  }
  r.l0 = r.l0 * c.x + sum0;
  r.l1 = r.l1 * c.y + sum1;
  return c;
}

// P (fp32) into the two bf16 A operands of P.V: hi = bf16(P), lo =
// bf16(P - hi); pair j / 2 is register (j / 2) % 4 of k-step j / 8
__device__ __forceinline__ void split_p(const float (&s)[64],
                                        uint32_t (&hi)[32],
                                        uint32_t (&lo)[32]) {
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(s[j], s[j + 1]);
    const float2 hf = __bfloat1622float2(h2);
    hi[j / 2] = bf16x2_bits(h2);
    lo[j / 2] =
        bf16x2_bits(__floats2bfloat162_rn(s[j] - hf.x, s[j + 1] - hf.y));
  }
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float2 c) {
#pragma unroll
  for (int j = 0; j < N; ++j) o[j] *= ((j >> 1) & 1) ? c.y : c.x;
}

// ------------------------------------------------------------- kernel --

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Params p) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;  // [NB][BQ]
  const uint32_t k_s = q_s + T::Q_BYTES;          // [STAGES][NB][BK]
  const uint32_t v_s = k_s + STAGES * T::KV_BYTES;  // [STAGES][NB][BK]
  const uint32_t q_full = v_s + STAGES * T::KV_BYTES;
  const uint32_t full0 = q_full + 8;              // K and V of a stage in
  const uint32_t empty0 = full0 + 8 * STAGES;     // a stage free again

  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x - b * p.Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  // the key tiles some row of this block may see
  const int first_pos = p.q_offset + q0;
  const int last_pos = first_pos + min(BQ, p.Sq - q0) - 1;
  int k_end = p.kv_valid;
  if (p.causal) k_end = min(k_end, last_pos + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, first_pos - p.window + 1);
  k_begin -= k_begin % BK;
  const int n_tiles = max(0, (k_end - k_begin + BK - 1) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const int hk = h / p.group;
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::NB; ++c)
        tma_load(q_s + c * BQ * ROW_BYTES, &tq, q_full, c * SLAB, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES)
          mbar_wait(empty0 + 8 * st, ((it / STAGES) - 1) & 1);
        const int k0 = k_begin + it * BK;
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, 2 * T::KV_BYTES);
        for (int c = 0; c < T::NB; ++c) {
          const uint32_t off = st * T::KV_BYTES + c * BK * ROW_BYTES;
          tma_load(k_s + off, &tk, full, c * SLAB, hk, k0, b);
          tma_load(v_s + off, &tv, full, c * SLAB, hk, k0, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int row0 = 64 * wg + 16 * warp + (lane >> 2);  // rows row0, +8
    const int wg_first = first_pos + 64 * wg;
    const uint32_t q_rows = q_s + 64 * wg * ROW_BYTES;
    Rows r{first_pos + row0, lane & 3, NEG_INF, NEG_INF, 0.0f, 0.0f};
    float o[T::DP / 2];
#pragma unroll
    for (int j = 0; j < T::DP / 2; ++j) o[j] = 0.0f;
    float s[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) s[j] = 0.0f;
    uint32_t hi[32], lo[32];

    // Per tile it, in turns with the other consumer: issue S(it + 1) =
    // Q K(it + 1)^T and acc += P(it) V(it), pass the turn, then the
    // softmax of S(it + 1) while P(it) V(it) runs; the tensor cores work
    // on one consumer's products while the other computes its softmax.
    // The last tile is peeled off, so that no wgmma sits in a branch
    // (ptxas would serialize them).
    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      if (wg == 1) turn_pass(wg);  // consumer 0 issues first
      mbar_wait(full0, 0);
      turn_wait(wg);
      wgmma_fence();
      issue_qk<D>(s, q_rows, k_s);
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait<0>();
      pin(s);
      softmax_tile(s, r, p, k_begin, wg_first);
      split_p(s, hi, lo);
      for (int it = 0; it + 1 < n_tiles; ++it) {
        const int st = it % STAGES;
        const int nst = (it + 1) % STAGES;
        mbar_wait(full0 + 8 * nst, ((it + 1) / STAGES) & 1);
        turn_wait(wg);
        wgmma_fence();
        issue_qk<D>(s, q_rows, k_s + nst * T::KV_BYTES);
        wgmma_commit();
        issue_pv(o, hi, lo, v_s + st * T::KV_BYTES);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<1>();  // S(it + 1) is in; P(it) V(it) may still run
        pin(s);
        const float2 c =
            softmax_tile(s, r, p, k_begin + (it + 1) * BK, wg_first);
        wgmma_wait<0>();
        pin(o);
        pin(hi);
        pin(lo);
        if (tid == 0) mbar_arrive(empty0 + 8 * st);  // K(it), V(it) read
        split_p(s, hi, lo);
        rescale(o, c);
      }
      // the last tile: consumer 1 passes no turn here, its first pass
      // came up front
      const int st = (n_tiles - 1) % STAGES;
      turn_wait(wg);
      wgmma_fence();
      issue_pv(o, hi, lo, v_s + st * T::KV_BYTES);
      wgmma_commit();
      if (wg == 0) turn_pass(wg);
      wgmma_wait<0>();
      pin(o);
      pin(hi);
      pin(lo);
    }

    const float d0 = fmaxf(quad_sum(r.l0), 1e-30f);
    const float d1 = fmaxf(quad_sum(r.l1), 1e-30f);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                        h * p.o_sh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = q0 + row0 + 8 * half;
      if (qi >= p.Sq) continue;
      const float d = half ? d1 : d0;
      if (p.lse != nullptr && r.t == 0)
        p.lse[static_cast<long long>(blockIdx.x) * p.Sq + qi] =
            ((half ? r.m1 : r.m0) + log2f(d)) * LN2;
      __nv_bfloat16* orow = ob + qi * p.o_ss;
#pragma unroll
      for (int jb = 0; jb < T::DP / 8; ++jb) {
        const int col = 8 * jb + 2 * r.t;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * jb + 2 * half] / d,
                                    o[4 * jb + 2 * half + 1] / d);
      }
    }
  }
}

// ---------------------------------------------------------------- host --

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a 4-d map over [N, S, H, D] (given as D, H, S, N innermost first) with
// strides in elements; boxes of SLAB columns x 1 head x `rows` rows. A
// stride of a dim of size 1 is never used to address: it is replaced by
// the packed one, so that a size-1 view's arbitrary stride cannot fail
// the 16-byte rule.
bool make_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int N,
              long long sh, long long ss, long long sn, int rows) {
  if (H == 1) sh = D;
  if (S == 1) ss = sh * H;
  if (N == 1) sn = ss * S;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S),
                              cuuint64_t(N)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2,
                                 cuuint64_t(sn) * 2};
  const cuuint32_t box[4] = {SLAB, 1, cuuint32_t(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const Params& p, int B,
                   cudaStream_t stream) {
  constexpr int smem = Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.Hq, (p.Sq + BQ - 1) / BQ);
  flash_fwd_wgmma<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

namespace flash_wgmma {

// what forward returns when the CUDA driver refuses q's, k's or v's
// tensor map: negative, so that no cudaError_t takes it (the binding's
// TMA_REFUSED)
constexpr int kTmaRefusedQ = -1, kTmaRefusedK = -2, kTmaRefusedV = -3;

// bf16 q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], o [B, Sq, Hq, D],
// strides in elements, last dim contiguous; D one of 32, 64, 80, 128;
// lse null or a contiguous fp32 [B, Hq, Sq].
// Returns the launch's cudaError_t, or a kTmaRefused code before any
// launch.
int forward(const void* q, const void* k, const void* v, void* o,
            float* lse, long long q_sb, long long q_ss, long long q_sh,
            long long k_sb, long long k_ss, long long k_sh,
            long long v_sb, long long v_ss, long long v_sh,
            long long o_sb, long long o_ss, long long o_sh, int B,
            int Sq, int Skv, int Hq, int Hkv, int D, int causal,
            int window, int q_offset, int kv_valid, float scale,
            cudaStream_t stream) {
  if (encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Hq, Sq, B, q_sh, q_ss, q_sb, BQ))
    return kTmaRefusedQ;
  if (!make_map(&tk, k, D, Hkv, Skv, B, k_sh, k_ss, k_sb, BK))
    return kTmaRefusedK;
  if (!make_map(&tv, v, D, Hkv, Skv, B, v_sh, v_ss, v_sb, BK))
    return kTmaRefusedV;
  const Params p{o, lse, o_sb, o_ss, o_sh, Sq, Hq, Hq / Hkv, causal, window,
                 q_offset, kv_valid, scale * LOG2E};
  switch (D) {
    case 32: return launch<32>(tq, tk, tv, p, B, stream);
    case 64: return launch<64>(tq, tk, tv, p, B, stream);
    case 80: return launch<80>(tq, tk, tv, p, B, stream);
    case 128: return launch<128>(tq, tk, tv, p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace flash_wgmma
