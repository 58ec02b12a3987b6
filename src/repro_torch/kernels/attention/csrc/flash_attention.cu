// Flash attention for Hopper (sm_90a), the entry point of both routes:
// bf16 q, k, v go to the tensor-core kernel of flash_attention_wgmma.cu
// (wgmma fed by TMA); fp32 ones to the CUDA-core kernel below. The choice
// is the dtype's and is made here, in flash_attention_forward: the tensor
// cores have no fp32-exact product (TF32 keeps 10 bits of mantissa, and
// the fp32 route is held to rtol 2e-4), so fp32 stays on fp32 FMAs, and no
// bf16 input reaches them.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py::_flash_kernel
// (launched by flash_attention_pallas, wrapped by
// attention/ops.py::flash_attention). Both kernels compute what that
// kernel computes, for q [B, Sq, Hq, D] and k, v [B, Skv, Hkv, D]:
//
//   s   = (q . k) * D^-0.5 for every (query, key) pair, in fp32;
//         -1e30 where a mask removes the pair: key >= kv_valid, key >
//         query (causal), key <= query - window (sliding window), with
//         query position q_offset + row;
//   out = softmax(s) v, by the running max m, denominator l and
//         accumulator acc (all fp32), the products with v on fp32
//         probabilities (the bf16 kernel: on their two bf16 halves, good
//         to about 2^-17), acc / max(l, 1e-30) stored in q's dtype;
//   lse = m + log(l), each row's logsumexp of its scaled scores, in
//         fp32 [B, Hq, Sq], written only when its pointer is not null:
//         training's forward asks for it (the backward of
//         flash_attention_bwd.cu recomputes P = exp(s - lse) from it);
//         serving and decode pass null, and their launches store
//         exactly what they stored before it existed.
//
// Query head h reads kv head h / (Hq / Hkv), so GQA never copies k or v.
// The tensors are read and written through their strides (the last dim
// contiguous): the caller's [B, S, H, D] layout, no transposed copy.
//
// The fp32 kernel (simple and right first). One block of 128 threads per
// (batch x query head, tile of 64 query rows). The query tile is staged
// once in shared memory; the block then walks the key tiles of 32 keys in
// order, each staged in shared memory, and keeps the running statistics
// of its rows in registers: thread (ty, tx) owns rows ty + 16 i (i < 4),
// the scores of keys tx + 8 j (j < 4) of the tile, and the accumulator
// columns tx + 8 c (c < D / 8). A row's max and sum go across its 8
// threads by warp shuffles; the probabilities pass through a shared tile
// to the P.V product. Key tiles that every row of the block masks (above
// the diagonal, before the window, at or past kv_valid) are never loaded,
// the TPU kernel's block skip; the ragged edges (Sq, Skv not multiples of
// the tiles) are masked here, not padded by the caller. Shared-memory
// rows are padded (D + 1, 32 + 8 floats) so that the reads of a warp fall
// in distinct banks. D is a template parameter: 32, 64, 80, 128. It runs
// on the CUDA cores (67 TFLOP/s of fp32 at most) behind shared-memory
// loads; the serving path's model runs in bf16 and never reaches it
// (chip_smoke.py's card-vs-CPU check of Qwen1.5-4B in fp32 does).
//
// The C entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per shared-memory tile
constexpr int THREADS = 128;  // 16 row groups (ty) x 8 column lanes (tx)
constexpr int PS = BK + 8;    // padded row stride of the probability tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Hq, Sq], or null
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int Sq, Skv, Hq, group, causal, window, q_offset, kv_valid;
  float scale;
};

template <int D>
constexpr int smem_bytes() {
  return (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS) * 4;
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(Params p) {
  constexpr int DP = D + 1;   // padded row stride of the q and k tiles
  constexpr int DC = D / 8;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][DP]
  float* ks = qs + BQ * DP;   // [BK][DP]
  float* vs = ks + BK * DP;   // [BK][D]
  float* ps = vs + BK * D;    // [BQ][PS]

  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x - b * p.Hq;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb
                    + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb
                    + (h / p.group) * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb
                    + (h / p.group) * p.v_sh;
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int qi = q0 + r;
    qs[r * DP + d] = qi < p.Sq ? qb[qi * p.q_ss + d] : 0.0f;
  }

  // the key tiles some row of this block may see
  const int first_pos = p.q_offset + q0;
  const int last_pos = first_pos + min(BQ, p.Sq - q0) - 1;
  int k_end = p.kv_valid;
  if (p.causal) k_end = min(k_end, last_pos + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, first_pos - p.window + 1);
  k_begin -= k_begin % BK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // q staged; the previous tile's k, v, p consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D;
      const int d = i - r * D;
      const int kj = k0 + r;
      const bool in = kj < p.Skv;
      ks[r * DP + d] = in ? kb[kj * p.k_ss + d] : 0.0f;
      vs[r * D + d] = in ? vb[kj * p.v_ss + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = first_pos + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 8 * j;
        bool keep = kp < p.kv_valid;
        if (p.causal) keep = keep && kp <= qp;
        if (p.window > 0) keep = keep && kp > qp - p.window;
        s[i][j] = keep ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * PS + tx + 8 * j] = e;
        sum += e;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = vs[kk * D + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = ob + qi * p.o_ss;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 8 * c] = acc[i][c] / denom;
    if (p.lse != nullptr && tx == 0)
      p.lse[static_cast<long long>(blockIdx.x) * p.Sq + qi] =
          m[i] + logf(denom);
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.Hq, (p.Sq + BQ - 1) / BQ);
  flash_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32>(p, B, stream);
    case 64: return launch<64>(p, B, stream);
    case 80: return launch<80>(p, B, stream);
    case 128: return launch<128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace flash_wgmma {
int forward(const void* q, const void* k, const void* v, void* o,
            float* lse, long long q_sb, long long q_ss, long long q_sh,
            long long k_sb, long long k_ss, long long k_sh,
            long long v_sb, long long v_ss, long long v_sh,
            long long o_sb, long long o_ss, long long o_sh, int B,
            int Sq, int Skv, int Hq, int Hkv, int D, int causal,
            int window, int q_offset, int kv_valid, float scale,
            cudaStream_t stream);  // flash_attention_wgmma.cu
}

extern "C" {

// q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], o [B, Sq, Hq, D], each
// with its (batch, seq, head) strides in elements and the last dim
// contiguous; all fp32 (bf16 = 0) or all bf16 (bf16 = 1). window <= 0
// means no window. lse: null, or a contiguous fp32 [B, Hq, Sq] that
// takes each row's logsumexp. Returns cudaGetLastError() after the
// launch (0 when there is nothing to launch), or, for bf16, -1, -2 or -3 when the
// CUDA driver refuses q's, k's or v's tensor map (TMA's 16-byte rules).
int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int Sq, int Skv, int Hq, int Hkv, int D, int bf16, int causal,
    int window, int q_offset, int kv_valid, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return flash_wgmma::forward(q, k, v, o, static_cast<float*>(lse), q_sb,
                                q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
                                v_sh, o_sb, o_ss, o_sh, B, Sq, Skv, Hq, Hkv,
                                D, causal, window, q_offset, kv_valid, scale,
                                s);
  const Params p{q, k, v, o, static_cast<float*>(lse),
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 Sq, Skv, Hq, Hq / Hkv, causal, window, q_offset, kv_valid,
                 scale};
  return launch_fp32(p, B, D, s);
}

}  // extern "C"
