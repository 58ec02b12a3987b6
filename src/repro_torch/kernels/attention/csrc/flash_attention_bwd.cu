// The backward of flash attention for Hopper (sm_90a): dq, dk and dv of
// out = softmax(q k^T * D^-0.5 + mask) v, from q, k, v, the forward's
// output o, the cotangent dout and the forward's logsumexp lse (written
// by flash_attention.cu's entry point when training asks for it). The
// entry point of both routes: bf16 goes to the tensor-core kernels of
// flash_attention_bwd_wgmma.cu (wgmma fed by TMA); fp32 to the CUDA-core
// kernels below, as the forward's entry chooses (the tensor cores have no
// fp32-exact product), and no bf16 input reaches them.
//
// Replaces no TPU kernel of its own: the JAX package trains through
// XLA's autodiff of blocked_attention (repro/models/attention.py), the
// pure-JAX twin of repro/kernels/attention/kernel.py::_flash_kernel,
// whose forward flash_attention.cu and flash_attention_wgmma.cu replace.
// This is the gradient of that forward, so that a training step on the
// card runs every attention product through kernels of the port. For
// each (batch, query head h, query i, key j), kv head h / (Hq / Hkv):
//
//   P     = exp(s - lse_i), s = (q_i . k_j) * D^-0.5, 0 where the mask
//           removes the pair (key > query when causal, key <= query -
//           window), recomputed from lse: no [Sq, Skv] matrix is kept;
//   Delta = rowsum(dout_i o_i)                         (fp32 [B, Hq, Sq])
//   dv_j += P dout_i;  dP = dout_i . v_j;  dS = P (dP - Delta_i)
//   dq_i += dS k_j D^-0.5;  dk_j += dS q_i D^-0.5
//
// all in fp32. Training's launches only: q_offset 0, every key valid,
// causal with an optional window or no mask at all (the binding refuses
// any other), so every query row sees at least one key.
//
// The fp32 kernels, right first, on the CUDA cores; three kernels, each
// output element written by one thread of one block in a fixed order, so
// a launch is deterministic (no atomics: training holds runs bitwise).
//
//   delta_kernel  one warp a (batch, query, head) row: Delta by a
//                 shuffle sum.
//   dkdv_kernel   one block of 128 threads per (batch x kv head, tile
//                 of 64 keys). K and V are staged once; the block walks
//                 the group's Hq / Hkv query heads and, for each, the
//                 tiles of 32 queries that can see a key of its tile
//                 (from the diagonal down when causal, up to key + window
//                 with a window), staging q, dout, lse and Delta. Thread
//                 (ty, tx) owns keys ty + 16 i (i < 4), queries tx + 8 j
//                 (j < 4) of the tile's P and dS, and dk, dv columns tx +
//                 8 c (c < D / 8) of its keys, in registers; P and dS
//                 pass through shared tiles to the products with dout
//                 and q. The sum over the group is this loop: no second
//                 pass, no reduction across blocks.
//   dq_kernel     one block per (batch x query head, tile of 64 queries),
//                 q, dout, lse and Delta staged once; the block walks the
//                 tiles of 32 keys its rows can see, dS through a shared
//                 tile to the product with k.
//
// Shared-memory rows are padded (D + 1, 32 + 1 floats) as in the fp32
// forward. D is a template parameter: 32, 64, 80, 128.
//
// What bounds them on an H100: the work is 2.5x the forward's products
// (s again, dP, dv, dk, dq: 10 D flops a (query, key) pair), done here on
// fp32 FMAs behind shared-memory reads, at most 67 TFLOP/s. Only the fp32
// copy of the training path and the fp32 checks launch them.
//
// The C entry point launches the three kernels of its route in order on
// one stream and returns cudaGetLastError() after them.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // 16 row groups (ty) x 8 column lanes (tx)
constexpr int BKV = 64;       // keys per dk/dv block
constexpr int BQI = 32;       // queries per tile of the dk/dv walk
constexpr int BQ = 64;        // queries per dq block
constexpr int BKI = 32;       // keys per tile of the dq walk
constexpr int PS = 33;        // padded row stride of the P and dS tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // [B, Hq, Sq]
  float* delta;       // [B, Hq, Sq], written by delta_kernel
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, Hq, Hkv, group, causal, window;
  float scale;
};

// the mask of training's launches (q_offset 0, every key valid)
__device__ __forceinline__ bool keep(const Params& p, int qp, int kp) {
  bool in = qp < p.Sq && kp < p.Skv;
  if (p.causal) in = in && kp <= qp;
  if (p.window > 0) in = in && kp > qp - p.window;
  return in;
}

// rows [r0, r0 + n) of a contiguous [B, S, H, D] tensor at (b, h) into a
// shared [n][D + 1] tile, zeros past S
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int b,
                                      int h, int S, int H, int r0, int n) {
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D;
    const int d = i - r * D;
    const int s = r0 + r;
    dst[r * (D + 1) + d] =
        s < S ? src[((static_cast<long long>(b) * S + s) * H + h) * D + d]
              : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) delta_kernel(Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) +
                        threadIdx.x / 32;  // (b, s, h), h fastest
  if (row >= static_cast<long long>(p.B) * p.Sq * p.Hq) return;
  const int lane = threadIdx.x & 31;
  const float* o = static_cast<const float*>(p.o) + row * D;
  const float* dout = static_cast<const float*>(p.dout) + row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(dout[d], o[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % p.Hq);
    const long long bs = row / p.Hq;
    const int s = static_cast<int>(bs % p.Sq);
    const int b = static_cast<int>(bs / p.Sq);
    p.delta[(static_cast<long long>(b) * p.Hq + h) * p.Sq + s] = acc;
  }
}

template <int D>
constexpr int dkdv_smem() {
  return (2 * BKV * (D + 1) + 2 * BQI * (D + 1) + 2 * BKV * PS + 2 * BQI) *
         4;
}

template <int D>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 8;
  extern __shared__ float smem[];
  float* ks = smem;              // [BKV][DP]
  float* vs = ks + BKV * DP;     // [BKV][DP]
  float* qs = vs + BKV * DP;     // [BQI][DP]
  float* dos = qs + BQI * DP;    // [BQI][DP]
  float* ps = dos + BQI * DP;    // [BKV][PS]: P^T
  float* dss = ps + BKV * PS;    // [BKV][PS]: dS^T
  float* lse_s = dss + BKV * PS; // [BQI]
  float* del_s = lse_s + BQI;    // [BQI]

  const int b = blockIdx.x / p.Hkv;
  const int hk = blockIdx.x - b * p.Hkv;
  const int k0 = blockIdx.y * BKV;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const float* q = static_cast<const float*>(p.q);
  const float* dout = static_cast<const float*>(p.dout);

  stage<D>(ks, static_cast<const float*>(p.k), b, hk, p.Skv, p.Hkv, k0, BKV);
  stage<D>(vs, static_cast<const float*>(p.v), b, hk, p.Skv, p.Hkv, k0, BKV);

  // the query tiles some key of this block is seen from
  const int k_last = min(k0 + BKV, p.Skv) - 1;
  int q_begin = p.causal ? k0 : 0;
  q_begin -= q_begin % BQI;
  const int q_end =
      p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const long long row0 = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQI) {
      __syncthreads();  // k, v staged; the previous tile's P, dS consumed
      stage<D>(qs, q, b, h, p.Sq, p.Hq, q0, BQI);
      stage<D>(dos, dout, b, h, p.Sq, p.Hq, q0, BQI);
      if (tid < BQI) {
        const bool in = q0 + tid < p.Sq;
        lse_s[tid] = in ? p.lse[row0 + q0 + tid] : 0.0f;
        del_s[tid] = in ? p.delta[row0 + q0 + tid] : 0.0f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ks[(ty + 16 * i) * DP + d];
          vv[i] = vs[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(tx + 8 * j) * DP + d];
          ov[j] = dos[(tx + 8 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i;
          const int c = tx + 8 * j;
          const float pr = keep(p, q0 + c, k0 + r)
                               ? expf(s[i][j] * p.scale - lse_s[c])
                               : 0.0f;
          ps[r * PS + c] = pr;
          dss[r * PS + c] = pr * (dp[i][j] - del_s[c]);
        }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < BQI; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[(ty + 16 * i) * PS + qq];
          dsv[i] = dss[(ty + 16 * i) * PS + qq];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float ov = dos[qq * DP + tx + 8 * c];
          const float qv = qs[qq * DP + tx + 8 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pv[i], ov, dv[i][c]);
            dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  float* dkb = static_cast<float*>(p.dk);
  float* dvb = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= p.Skv) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Skv + kj) * p.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkb[off + tx + 8 * c] = dk[i][c] * p.scale;
      dvb[off + tx + 8 * c] = dv[i][c];
    }
  }
}

template <int D>
constexpr int dq_smem() {
  return (2 * BQ * (D + 1) + 2 * BKI * (D + 1) + BQ * PS) * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS) dq_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 8;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][DP]
  float* dos = qs + BQ * DP;    // [BQ][DP]
  float* ks = dos + BQ * DP;    // [BKI][DP]
  float* vs = ks + BKI * DP;    // [BKI][DP]
  float* dss = vs + BKI * DP;   // [BQ][PS]

  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x - b * p.Hq;
  const int hk = h / p.group;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

  stage<D>(qs, static_cast<const float*>(p.q), b, h, p.Sq, p.Hq, q0, BQ);
  stage<D>(dos, static_cast<const float*>(p.dout), b, h, p.Sq, p.Hq, q0, BQ);
  const long long row0 = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
  float lse[4], del[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lse[i] = qi < p.Sq ? p.lse[row0 + qi] : 0.0f;
    del[i] = qi < p.Sq ? p.delta[row0 + qi] : 0.0f;
  }

  // the key tiles some row of this block sees
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  const int k_end = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin -= k_begin % BKI;

  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BKI) {
    __syncthreads();  // q, dout staged; the previous tile's dS consumed
    stage<D>(ks, k, b, hk, p.Skv, p.Hkv, k0, BKI);
    stage<D>(vs, v, b, hk, p.Skv, p.Hkv, k0, BKI);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * DP + d];
        ov[i] = dos[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 8 * j) * DP + d];
        vv[j] = vs[(tx + 8 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 8 * j;
        const float pr = keep(p, q0 + r, k0 + c)
                             ? expf(s[i][j] * p.scale - lse[i])
                             : 0.0f;
        dss[r * PS + c] = pr * (dp[i][j] - del[i]);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BKI; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = ks[kk * DP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(dsv[i], kv, dq[i][c]);
      }
    }
  }

  float* dqb = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Sq + qi) * p.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqb[off + tx + 8 * c] = dq[i][c] * p.scale;
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int kv_smem = dkdv_smem<D>();
  constexpr int q_smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_smem);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.Hq;
  const int rows_per_block = THREADS / 32;
  delta_kernel<D><<<static_cast<unsigned>(
                         (rows + rows_per_block - 1) / rows_per_block),
                     THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3(p.B * p.Hkv, (p.Skv + BKV - 1) / BKV), THREADS,
                   kv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<dim3(p.B * p.Hq, (p.Sq + BQ - 1) / BQ), THREADS, q_smem,
                 stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_fp32(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32>(p, stream);
    case 64: return launch<64>(p, stream);
    case 80: return launch<80>(p, stream);
    case 128: return launch<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace flash_bwd_wgmma {
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* scratch, void* dq,
             void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
             int D, int causal, int window, float scale,
             cudaStream_t stream);  // flash_attention_bwd_wgmma.cu
}

extern "C" {

// q, o, dout, dq contiguous [B, Sq, Hq, D]; k, v, dk, dv contiguous
// [B, Skv, Hkv, D]; all fp32 (bf16 = 0) or all bf16 (bf16 = 1); lse the
// forward's fp32 [B, Hq, Sq]; delta an fp32 scratch of 2 B Hq Sq_pad
// floats, Sq_pad = Sq rounded up to 128 (fp32 uses its first B Hq Sq).
// window <= 0 means no window. Returns cudaGetLastError() after the three
// launches (0 when there is nothing to launch), or, for bf16, -1, -2, -3
// or -4 when the CUDA driver refuses q's, k's, v's or dout's tensor map
// (TMA's 16-byte rules), before any launch.
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* delta, void* dq,
                             void* dk, void* dv, int B, int Sq, int Skv,
                             int Hq, int Hkv, int D, int bf16, int causal,
                             int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return flash_bwd_wgmma::backward(q, k, v, o, dout, lse, delta, dq, dk,
                                     dv, B, Sq, Skv, Hq, Hkv, D, causal,
                                     window, scale, s);
  const Params p{q, k, v, o, dout, static_cast<const float*>(lse),
                 static_cast<float*>(delta), dq, dk, dv, B, Sq, Skv, Hq,
                 Hkv, Hq / Hkv, causal, window, scale};
  return launch_fp32(p, D, s);
}

}  // extern "C"
