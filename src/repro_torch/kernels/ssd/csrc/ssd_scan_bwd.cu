// The gradient of the Mamba2 SSD chunk scan for Hopper (sm_90a): from the
// cotangents dy of y and dstate of the final state, dxd, da, dB and dC of
// the scan of ssd_scan.cu / ssd_scan_wgmma.cu; fp32 on the CUDA cores
// here, each gradient in its input's dtype. The entry point chooses by
// dtype: bf16 runs ssd_scan_bwd_wgmma.cu (wgmma fed by TMA), fp32 the
// kernels below.
//
// Replaces no pallas_call: on the TPU the gradient is XLA's autodiff of
// repro/models/ssm.py::ssd_chunked, the plain scan that the Pallas kernel
// repro/kernels/ssd/kernel.py::_ssd_kernel computes. Its plain PyTorch
// version is kernels/ssd/ref.py::ssd_scan_bwd_ref. For a chunk of K rows,
// cum the cumsum of a over it, S the state that enters it, dS the
// cotangent of the state that leaves it, Lmat = exp(cum_q - cum_k) on and
// below the diagonal, scores = C B^T, D = (dy xd^T) o Lmat, decay_k =
// exp(cum_K - cum_k) and cum_K the chunk's last cum:
//
//   dxd   = (scores o Lmat)^T dy + (B o decay) dS^T
//   dC    = D B + exp(cum) o (dy S)            (summed over the heads)
//   dB    = D^T C + decay o (xd dS)            (summed over the heads)
//   dS_in = exp(cum_K) dS + sum_q exp(cum_q) dy_q^T C_q
//   dcum  = rowsum(D o scores) - colsum(D o scores)
//           + exp(cum_q) C_q . (dy S)_q - decay_k B_k . (xd dS)_k,
//           and at the last row the state's decay: the sum of the last
//           term's and exp(cum_K) <S, dS>;
//   da    = the reverse cumsum of dcum within the chunk.
//
// Design of the fp32 route (simple and right first; every product on the
// CUDA cores, each thread owning whole outputs, no float atomics, so
// every bit is the same from run to run and a row's bits do not depend
// on the batch; blocks of 512 threads, dot products in four interleaved
// partial sums):
//
// 1. ssd_bwd_scores, grid (n_chunks, B): C B^T of each chunk, which the
//    heads share, once, into an fp32 scratch (and its transpose).
// 2. ssd_bwd_states, grid (H, B, 2), one block per (head, batch) and
//    direction, walks the chunks as the forward does: forwards, writing
//    the state that enters each chunk (from zero, recomputed in fp32 as
//    the forward kernels form it; the forward kernels are left as they
//    are and write no state for the backward); backwards, writing the
//    cotangent of the state that leaves each chunk (from dstate, or
//    zero). Both go to an fp32 scratch [B, n_chunks, H, P, N] (33.5 MB
//    each at Mamba2-370M's training shape). The [P, N] state lives in
//    shared memory beside one chunk's operands.
// 3. ssd_bwd_chunk, grid (H, n_chunks, B), one block per (head, chunk,
//    batch): everything above for its chunk, from the two states. xd,
//    dy, B and C are held transposed in shared memory ([P or N][K + 1],
//    so that both a row's and a column's walks fall in distinct banks);
//    the [K, K] matrices are never held whole: the q-indexed outputs
//    (dC, the row sums) take D and D o scores 16 rows at a time, the
//    k-indexed ones (dB, dxd, the column terms) D^T and (scores o Lmat)^T
//    16 columns at a time, D formed again from the operands; the states
//    are read 16 rows at a time into shared memory. At K 128, P 64, N
//    128 that is 226,048 bytes of the 232,448 a block can take. dB and
//    dC are written per head into fp32 partials [B, H, L, N].
// 4. ssd_bwd_sum_heads adds the heads' partials in order into dB and dC.
//
// As in the forward: exp of the mask is taken only on and below the
// diagonal (above it cum_q - cum_k > 0 overflows expf at dt's clip of
// 100, and 0 x inf is NaN); cum is summed in double and rounded once;
// a ragged last chunk's rows past L are never loaded, never enter a sum
// and are never written (what the TPU wrapper's inert padding amounts
// to). A shape whose shared memory passes the limit, or a state past
// MAX_STATE, is refused before anything is launched.
//
// What bounds it on an H100. The products in fp32 at the CUDA cores'
// peak: at Mamba2-370M's training shape (B 8, L 512, H 32, P 64, N 128,
// K 128) 17.3 GFLOP, 258 us at 67 TFLOP/s. These kernels run them each
// fma behind two shared-memory loads, far from that; the bf16 training
// launches take the wgmma route.
//
// The C entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

namespace ssd_bwd_wgmma {
// the bf16 route (ssd_scan_bwd_wgmma.cu): wgmma on the tensor cores, fed
// by TMA; returns the launches' cudaError_t, kRefusedShape, or -2 .. -5
// when the CUDA driver refuses xd's, B_'s, C_'s or dy's tensor map
int backward(const void* xd, const float* a, const void* B, const void* C,
             const void* dy, const float* dstate, float* scratch, void* dxd,
             float* da, void* dB, void* dC, int batch, int L, int H, int P,
             int N, int chunk, cudaStream_t stream);
}  // namespace ssd_bwd_wgmma

namespace {

constexpr int THREADS = 512;
constexpr int ROW_BLOCK = 16;   // rows (columns) of the [K, K] matrices held
constexpr int STATE_TILE = 16;  // rows of a state held at once (= ROW_BLOCK)
constexpr int MAX_STATE = 128;  // N: the register accumulators' bound
constexpr int OUTS = ROW_BLOCK * MAX_STATE / THREADS;
constexpr size_t SMEM_LIMIT = 232448;
// the entry point's return when a shape is refused, before any launch;
// cudaError values are positive
constexpr int kRefusedShape = -1;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

size_t states_smem_bytes(int K, int P, int N) {
  return sizeof(float) * ((size_t)K * P + (size_t)K * N + (size_t)P * N +
                          2 * (size_t)K);
}

size_t chunk_smem_bytes(int K, int P, int N) {
  const size_t KP = K + 1, RB = K < ROW_BLOCK ? K : ROW_BLOCK;
  return sizeof(float) * ((2 * (size_t)P + 2 * (size_t)N) * KP +
                          2 * RB * KP + (size_t)STATE_TILE * N +
                          6 * (size_t)K + 32);
}

// sum_i x[i sx] y[i sy] over i < n in four interleaved partial sums, so
// that four loads and fmas are in flight at once, added in a fixed order
__device__ __forceinline__ float dot(const float* x, int sx, const float* y,
                                    int sy, int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    s0 = fmaf(x[i * sx], y[i * sy], s0);
    s1 = fmaf(x[(i + 1) * sx], y[(i + 1) * sy], s1);
    s2 = fmaf(x[(i + 2) * sx], y[(i + 2) * sy], s2);
    s3 = fmaf(x[(i + 3) * sx], y[(i + 3) * sy], s3);
  }
  for (; i < n; ++i) s0 = fmaf(x[i * sx], y[i * sy], s0);
  return (s0 + s1) + (s2 + s3);
}

// a warp's sum of its lanes' x, in a fixed order; every lane gets it
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the inclusive cumsum of cum[0, rows) in place: warp 0 sums in double
// and rounds each once to fp32, as ssd_scan.cu does (see the top); the
// caller syncs before and after
__device__ void scan_cum(float* cum, int rows, int tid) {
  if (tid >= 32) return;
  const int per = (rows + 31) / 32;
  const int k0 = min(tid * per, rows), k1 = min(k0 + per, rows);
  double s = 0.0;
  for (int k = k0; k < k1; ++k) s += cum[k];
  double incl = s;
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (tid >= o) incl += v;
  }
  s = __shfl_up_sync(0xffffffffu, incl, 1);  // the rows before the run
  if (tid == 0) s = 0.0;
  for (int k = k0; k < k1; ++k) {
    s += cum[k];
    cum[k] = (float)s;
  }
}

// grid (H, B, 2); block THREADS. z = 0: the state entering each chunk
// into states; z = 1: the cotangent of the state leaving each chunk into
// dstates, from dstate (nullable: zero). Both [B][nc][H][P][N].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_states(const T* __restrict__ xd, const float* __restrict__ a,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const T* __restrict__ dy,
                   const float* __restrict__ dstate,
                   float* __restrict__ states, float* __restrict__ dstates,
                   int L, int H, int P, int N, int K, int nc) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const bool rev = blockIdx.z == 1;
  extern __shared__ float smem[];
  float* us = smem;          // [K][P]  xd (forwards) or dy (backwards)
  float* vs = us + K * P;    // [K][N]  B or C, then times the row's weight
  float* st = vs + K * N;    // [P][N]  the state or its cotangent
  float* cum = st + P * N;   // [K]
  float* w = cum + K;        // [K]     exp(cum_K - cum) or exp(cum)

  const T* U = rev ? dy : xd;
  const T* V = rev ? Cm : Bm;
  float* out = rev ? dstates : states;
  const long long step = (long long)H * P;
  // st: each thread reads and writes only its own elements
  const float* d0 = (rev && dstate != nullptr)
                        ? dstate + ((long long)b * H + h) * P * N
                        : nullptr;
  for (int e = tid; e < P * N; e += THREADS) st[e] = d0 ? d0[e] : 0.f;

  for (int i = 0; i < nc; ++i) {
    const int c = rev ? nc - 1 - i : i;
    const int t0 = c * K, rows = min(K, L - t0);
    float* o = out + (((long long)b * nc + c) * H + h) * P * N;
    for (int e = tid; e < P * N; e += THREADS) o[e] = st[e];
    if (i == nc - 1) break;           // no chunk beyond this one needs it
    __syncthreads();                  // the previous chunk's reads are done
    const long long row0 = (long long)b * L + t0;
    for (int e = tid; e < rows * P; e += THREADS) {
      const int k = e / P, p = e - k * P;
      us[e] = load_f(U + (row0 + k) * step + (long long)h * P + p);
    }
    for (int e = tid; e < rows * N; e += THREADS) {
      const int k = e / N, n = e - k * N;
      vs[e] = load_f(V + (row0 + k) * N + n);
    }
    for (int k = tid; k < rows; k += THREADS) cum[k] = a[(row0 + k) * H + h];
    __syncthreads();
    scan_cum(cum, rows, tid);
    __syncthreads();
    const float total = cum[rows - 1];
    for (int k = tid; k < rows; k += THREADS)
      w[k] = rev ? expf(cum[k]) : expf(total - cum[k]);
    __syncthreads();
    for (int e = tid; e < rows * N; e += THREADS) vs[e] *= w[e / N];
    __syncthreads();
    const float keep = expf(total);
    for (int e = tid; e < P * N; e += THREADS) {
      const int p = e / N, n = e - p * N;
      st[e] = st[e] * keep + dot(us + p, P, vs + n, N, rows);
    }
  }
}

// grid (nc, B); block THREADS. scores = C B^T of each chunk, which the
// heads share, on and below the diagonal: sc [B][nc][K][K] (row q,
// column k) and its transpose sct (row k, column q), so that both the
// chunk kernel's row and column walks read consecutive addresses; the
// entries above the diagonal and past the chunk's rows are never written
// and never read. Its shared memory, B^T and C^T [N][K + 1], is less
// than the chunk kernel's.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_scores(const T* __restrict__ Bm, const T* __restrict__ Cm,
                   float* __restrict__ sc, float* __restrict__ sct, int L,
                   int N, int K) {
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x,
            tid = threadIdx.x;
  const int t0 = c * K, rows = min(K, L - t0), KP = K + 1;
  extern __shared__ float smem[];
  float* bt = smem;         // [N][KP]  B^T
  float* ct = bt + N * KP;  // [N][KP]  C^T
  const long long row0 = (long long)b * L + t0;
  for (int e = tid; e < rows * N; e += THREADS) {
    const int k = e / N, n = e - k * N;
    const long long off = (row0 + k) * N + n;
    bt[n * KP + k] = load_f(Bm + off);
    ct[n * KP + k] = load_f(Cm + off);
  }
  __syncthreads();
  const long long blk = ((long long)b * nc + c) * K * K;
  for (int e = tid; e < rows * rows; e += THREADS) {
    const int q = e / rows, k = e - q * rows;
    if (k <= q) {
      const float s = dot(ct + q, KP, bt + k, KP, N);
      sc[blk + q * K + k] = s;
      sct[blk + k * K + q] = s;
    }
  }
}

// grid (H, nc, B); block THREADS. dxd and da of the chunk's rows for
// this head; dB and dC of this head into the partials [B][H][L][N].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_chunk(const T* __restrict__ xd, const float* __restrict__ a,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const T* __restrict__ dy,
                  const float* __restrict__ states,
                  const float* __restrict__ dstates,
                  const float* __restrict__ sc, const float* __restrict__ sct,
                  T* __restrict__ dxd,
                  float* __restrict__ da, float* __restrict__ dBpart,
                  float* __restrict__ dCpart, int L, int H, int P, int N,
                  int K) {
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z,
            nc = gridDim.y, tid = threadIdx.x;
  const int t0 = c * K, rows = min(K, L - t0);
  const int KP = K + 1, RB = K < ROW_BLOCK ? K : ROW_BLOCK;
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int WARPS = THREADS / 32;

  extern __shared__ float smem[];
  float* xt = smem;                 // [P][KP]  xd^T
  float* gt = xt + P * KP;          // [P][KP]  dy^T
  float* bt = gt + P * KP;          // [N][KP]  B^T
  float* ct = bt + N * KP;          // [N][KP]  C^T
  float* m1 = ct + N * KP;          // [RB][KP] D (rows) or D^T (columns)
  float* m2 = m1 + RB * KP;         // [RB][KP] D o scores, or (scores o Lmat)^T
  float* stile = m2 + RB * KP;      // [STATE_TILE][N] rows of S or dS,
  float* red = stile;               // then [RB][N] terms of a row's dcum
  float* cum = stile + STATE_TILE * N;  // [K]
  float* ecum = cum + K;            // [K] exp(cum)
  float* dec = ecum + K;            // [K] exp(cum_K - cum)
  float* dcum = dec + K;            // [K] row sums of D o scores + carried
  float* colE = dcum + K;           // [K] column sums of D o scores
  float* G = colE + K;              // [K] decay_k B_k . (xd dS)_k
  float* part = G + K;              // [32]

  const long long step = (long long)H * P;
  const long long row0 = (long long)b * L + t0;
  for (int e = tid; e < rows * P; e += THREADS) {
    const int k = e / P, p = e - k * P;
    const long long off = (row0 + k) * step + (long long)h * P + p;
    xt[p * KP + k] = load_f(xd + off);
    gt[p * KP + k] = load_f(dy + off);
  }
  for (int e = tid; e < rows * N; e += THREADS) {
    const int k = e / N, n = e - k * N;
    const long long off = (row0 + k) * N + n;
    bt[n * KP + k] = load_f(Bm + off);
    ct[n * KP + k] = load_f(Cm + off);
  }
  for (int k = tid; k < rows; k += THREADS) {
    cum[k] = a[(row0 + k) * H + h];
    dcum[k] = 0.f;
    colE[k] = 0.f;
  }
  __syncthreads();
  scan_cum(cum, rows, tid);
  __syncthreads();
  const float total = cum[rows - 1];
  for (int k = tid; k < rows; k += THREADS) {
    ecum[k] = expf(cum[k]);
    dec[k] = expf(total - cum[k]);
  }
  const long long soff = (((long long)b * nc + c) * H + h) * P * N;
  const float* S = states + soff;    // [P][N]
  const float* dS = dstates + soff;  // [P][N]
  const long long poff = ((long long)b * H + h) * L + t0;  // partials' row
  const float* scb = sc + ((long long)b * nc + c) * K * K;   // C B^T
  const float* sctb = sct + ((long long)b * nc + c) * K * K;
  float acc[OUTS];

  // 1. the q-indexed outputs, RB rows at a time
  for (int q0 = 0; q0 < rows; q0 += RB) {
    const int qb = min(RB, rows - q0);
    __syncthreads();
    for (int e = tid; e < qb * rows; e += THREADS) {
      const int i = e / rows, k = e - i * rows, q = q0 + i;
      if (k <= q) {  // select, never mask by a product: see the top
        const float dm = dot(gt + q, KP, xt + k, KP, P);
        const float d = dm * expf(cum[q] - cum[k]);
        const float s = scb[q * K + k];
        m1[i * KP + k] = d;
        m2[i * KP + k] = d * s;
      }
    }
    __syncthreads();
    for (int i = warp; i < qb; i += WARPS) {  // a warp a row
      const int q = q0 + i;
      float s = 0.f;
      for (int k = lane; k <= q; k += 32) s += m2[i * KP + k];
      s = warp_sum(s);
      if (lane == 0) dcum[q] += s;
    }
    for (int k = tid; k < rows; k += THREADS) {
      float s = colE[k];
      for (int i = max(k - q0, 0); i < qb; ++i) s += m2[i * KP + k];
      colE[k] = s;
    }
    // dy S for the block's rows, the state read STATE_TILE rows at a time
#pragma unroll
    for (int r = 0; r < OUTS; ++r) acc[r] = 0.f;
    for (int p0 = 0; p0 < P; p0 += STATE_TILE) {
      const int pt = min(STATE_TILE, P - p0);
      __syncthreads();
      for (int e = tid; e < pt * N; e += THREADS) stile[e] = S[p0 * N + e];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < OUTS; ++r) {
        const int e = tid + r * THREADS;
        if (e < qb * N) {
          const int i = e / N, n = e - i * N, q = q0 + i;
          float s = acc[r];
          for (int pp = 0; pp < pt; ++pp)
            s = fmaf(gt[(p0 + pp) * KP + q], stile[pp * N + n], s);
          acc[r] = s;
        }
      }
    }
    __syncthreads();  // the state's rows are read: red takes their place
#pragma unroll
    for (int r = 0; r < OUTS; ++r) {
      const int e = tid + r * THREADS;
      if (e < qb * N) {
        const int i = e / N, n = e - i * N, q = q0 + i;
        const float intra = dot(m1 + i * KP, 1, bt + n * KP, 1, q + 1);
        const float carried = ecum[q] * acc[r];
        dCpart[(poff + q) * N + n] = intra + carried;
        red[i * N + n] = carried * ct[n * KP + q];
      }
    }
    __syncthreads();
    for (int i = warp; i < qb; i += WARPS) {
      float s = 0.f;
      for (int n = lane; n < N; n += 32) s += red[i * N + n];
      s = warp_sum(s);
      if (lane == 0) dcum[q0 + i] += s;
    }
  }

  // 2. the k-indexed outputs, RB columns at a time
  for (int k0 = 0; k0 < rows; k0 += RB) {
    const int kb = min(RB, rows - k0);
    __syncthreads();
    for (int e = tid; e < kb * rows; e += THREADS) {
      const int j = e / rows, q = e - j * rows, k = k0 + j;
      if (q >= k) {
        const float dm = dot(gt + q, KP, xt + k, KP, P);
        const float s = sctb[k * K + q];
        const float l = expf(cum[q] - cum[k]);
        m1[j * KP + q] = dm * l;
        m2[j * KP + q] = s * l;
      }
    }
#pragma unroll
    for (int r = 0; r < OUTS; ++r) acc[r] = 0.f;
    for (int p0 = 0; p0 < P; p0 += STATE_TILE) {
      const int pt = min(STATE_TILE, P - p0);
      __syncthreads();
      for (int e = tid; e < pt * N; e += THREADS) stile[e] = dS[p0 * N + e];
      __syncthreads();
      // xd dS for the block's columns
#pragma unroll
      for (int r = 0; r < OUTS; ++r) {
        const int e = tid + r * THREADS;
        if (e < kb * N) {
          const int j = e / N, n = e - j * N, k = k0 + j;
          float s = acc[r];
          for (int pp = 0; pp < pt; ++pp)
            s = fmaf(xt[(p0 + pp) * KP + k], stile[pp * N + n], s);
          acc[r] = s;
        }
      }
      // dxd of the block's columns at the tile's head dims
      for (int e = tid; e < kb * pt; e += THREADS) {
        const int j = e % kb, pp = e / kb, k = k0 + j, p = p0 + pp;
        const float intra =
            dot(m2 + j * KP + k, 1, gt + p * KP + k, 1, rows - k);
        const float s = dot(bt + k, KP, stile + pp * N, 1, N);
        store_f(dxd + (row0 + k) * step + (long long)h * P + p,
                intra + dec[k] * s);
      }
    }
    __syncthreads();  // the state's rows are read: red takes their place
#pragma unroll
    for (int r = 0; r < OUTS; ++r) {
      const int e = tid + r * THREADS;
      if (e < kb * N) {
        const int j = e / N, n = e - j * N, k = k0 + j;
        const float intra =
            dot(m1 + j * KP + k, 1, ct + n * KP + k, 1, rows - k);
        const float decayed = dec[k] * acc[r];
        dBpart[(poff + k) * N + n] = intra + decayed;
        red[j * N + n] = decayed * bt[n * KP + k];
      }
    }
    __syncthreads();
    for (int j = warp; j < kb; j += WARPS) {
      float s = 0.f;
      for (int n = lane; n < N; n += 32) s += red[j * N + n];
      s = warp_sum(s);
      if (lane == 0) G[k0 + j] = s;
    }
  }

  // 3. <S, dS>, then da: the reverse cumsum of dcum, in double
  float sd = 0.f;
  for (int e = tid; e < P * N; e += THREADS) sd = fmaf(S[e], dS[e], sd);
  sd = warp_sum(sd);
  if (lane == 0) part[warp] = sd;
  __syncthreads();
  if (tid == 0) {
    float sdot = 0.f, gsum = 0.f;
    for (int w = 0; w < WARPS; ++w) sdot += part[w];
    for (int k = 0; k < rows; ++k) gsum += G[k];
    double run = (double)(gsum + expf(total) * sdot);  // the state's decay
    for (int k = rows - 1; k >= 0; --k) {
      run += (double)(dcum[k] - colE[k] - G[k]);
      da[(row0 + k) * H + h] = (float)run;
    }
  }
}

// grid (ceil(L N / THREADS), B, 2); block THREADS: dB (z = 0) and dC
// (z = 1) of each (batch, row, n), the heads' partials added in order
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_bwd_sum_heads(const float* __restrict__ dBpart,
                      const float* __restrict__ dCpart, T* __restrict__ dB,
                      T* __restrict__ dC, int L, int H, int N) {
  const long long LN = (long long)L * N;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= LN) return;
  const int b = blockIdx.y;
  const float* src = (blockIdx.z ? dCpart : dBpart) + (long long)b * H * LN + e;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += src[h * LN];
  store_f((blockIdx.z ? dC : dB) + (long long)b * LN + e, s);
}

template <typename T>
int launch(const void* xd, const float* a, const void* B, const void* C,
           const void* dy, const float* dstate, float* scratch, void* dxd,
           float* da, void* dB, void* dC, int batch, int L, int H, int P,
           int N, int K, cudaStream_t stream) {
  const size_t s1 = states_smem_bytes(K, P, N), s2 = chunk_smem_bytes(K, P, N);
  if (N > MAX_STATE || s1 > SMEM_LIMIT || s2 > SMEM_LIMIT)
    return kRefusedShape;
  const int nc = (L + K - 1) / K;
  const long long st = (long long)batch * nc * H * P * N;
  const long long pt = (long long)batch * H * L * N;
  const long long kt = (long long)batch * nc * K * K;
  float* states = scratch;
  float* dstates = states + st;
  float* dBpart = dstates + st;
  float* dCpart = dBpart + pt;
  float* sc = dCpart + pt;
  float* sct = sc + kt;
  const size_t s0 = sizeof(float) * 2 * (size_t)N * (K + 1);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_scores<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s0);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_bwd_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_bwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return err;
  const T* x = static_cast<const T*>(xd);
  const T* Bm = static_cast<const T*>(B);
  const T* Cm = static_cast<const T*>(C);
  const T* g = static_cast<const T*>(dy);
  ssd_bwd_scores<T><<<dim3(nc, batch), THREADS, s0, stream>>>(
      Bm, Cm, sc, sct, L, N, K);
  ssd_bwd_states<T><<<dim3(H, batch, 2), THREADS, s1, stream>>>(
      x, a, Bm, Cm, g, dstate, states, dstates, L, H, P, N, K, nc);
  ssd_bwd_chunk<T><<<dim3(H, nc, batch), THREADS, s2, stream>>>(
      x, a, Bm, Cm, g, states, dstates, sc, sct, static_cast<T*>(dxd), da,
      dBpart, dCpart, L, H, P, N, K);
  const long long LN = (long long)L * N;
  ssd_bwd_sum_heads<T><<<dim3((unsigned)((LN + THREADS - 1) / THREADS),
                              batch, 2), THREADS, 0, stream>>>(
      dBpart, dCpart, static_cast<T*>(dB), static_cast<T*>(dC), L, H, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xd, dy and dxd [B, L, H, P], B_, C_, dB and dC [B, L, N], all in one
// dtype (bf16 when ``bf16``, else fp32); a and da [B, L, H] fp32; dstate
// [B, H, P, N] fp32 or null (a zero cotangent); all contiguous, L >= 1;
// ``chunk`` is K. The dtype picks the kernels: bf16 runs
// ssd_scan_bwd_wgmma.cu's (chunk 16, 32, 64 or 128, P <= 64, N <= 128;
// scratch of its scratch_floats), fp32 the CUDA-core kernels above
// (scratch fp32 of 2 B n_chunks H P N + 2 B H L N + 2 B n_chunks K K
// floats). Returns cudaGetLastError() after the launches, or
// kRefusedShape (a shape the route does not take: for fp32, N past
// MAX_STATE or a kernel's shared memory past SMEM_LIMIT) or, for bf16,
// a tensor map's refusal (-2 .. -5) before anything is launched.
int ssd_scan_backward(const void* xd, const float* a, const void* B,
                      const void* C, const void* dy, const float* dstate,
                      float* scratch, void* dxd, float* da, void* dB,
                      void* dC, int batch, int L, int H, int P, int N,
                      int chunk, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ssd_bwd_wgmma::backward(xd, a, B, C, dy, dstate, scratch, dxd, da,
                                   dB, dC, batch, L, H, P, N, chunk, s);
  return launch<float>(xd, a, B, C, dy, dstate, scratch, dxd, da, dB, dC,
                       batch, L, H, P, N, chunk, s);
}

}  // extern "C"
