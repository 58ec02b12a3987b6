// Mamba2 SSD chunk scan for Hopper (sm_90a): the state-space-duality
// recurrence over the chunks of a sequence, from a zero state; bf16 or
// fp32 in, fp32 inside, y in the inputs' dtype, the final state in fp32.
//
// Replaces the TPU kernel repro/kernels/ssd/kernel.py::_ssd_kernel
// (launched by ssd_pallas, wrapped by ssd/ops.py::ssd_scan_fused). For
// xd [B, L, H, P], a [B, L, H] (fp32), B_ and C_ [B, L, N] it computes,
// for every (batch, head), chunk by chunk in order (K rows a chunk):
//
//   cum    = cumsum(a) over the chunk;
//   M      = (C B^T) o exp(cum_i - cum_j) where j <= i, 0 above;
//   y      = M xd + (C state^T) o exp(cum_i);
//   state' = state exp(cum[-1]) + xd^T (B o exp(cum[-1] - cum_k)).
//
// The exp of the mask is taken only below the diagonal: above it
// cum_i - cum_j > 0 can overflow expf to inf (a step at dt's clip of 100
// gives a = -100), and a 0/1 mask times inf is NaN. Past such a step
// every later cum of the chunk is ~ -100, and cum_i - cum_j keeps only
// the digits those share, so cum is summed in double and rounded once:
// its fp32 error is then half an ulp, not the several ulps a float scan
// gathers. The TPU wrapper pads
// L to a multiple of K with a = 0 and xd = B = C = 0; here the last,
// ragged chunk is masked instead: its rows past L are never loaded,
// never enter a sum and are never written, which is what the padded
// (inert) rows amount to, the final state included.
//
// Design (simple and right first). One block of 256 threads per
// (head, batch) walks the chunks in order, as the TPU kernel's
// sequential grid dimension did; the [P, N] state stays in shared memory
// from the first chunk to the last and is written once. The TPU's VMEM
// held every operand of a chunk at once; here the chunk's operands are
// widened to fp32 into dynamic shared memory: xd [K][P], B^T [N][K + 1]
// (padded so that its transposing stores fall in distinct banks), C
// [K][N], state^T [N][P], the masked scores of 32 rows at a time [32][K]
// and cum. At K = 128, P = 64, N = 128 (Mamba2-370M) that is 214,016
// bytes, above the 48 KB default, so the launch raises the block's limit
// with cudaFuncSetAttribute (227 KB at most; the wrapper refuses shapes
// past it, and the launch returns the attribute's error for any shape
// that still asks for more). Every product is a dot product read from
// shared memory in a fixed order, each thread owning whole outputs: one
// operand broadcast across a warp, the other read at consecutive
// addresses. C B^T is recomputed by each head of a batch row (B_ and C_
// are shared by the heads), and only for j <= i. cum is one warp's scan,
// in double. A row's bits do
// not depend on the batch width: no sum crosses a (batch, head) block.
//
// What bounds it on an H100. At the serving path's long prompt (B 4,
// L 2048, H 32, P 64, N 128, K 128, bf16) it must read xd and write y
// (33.6 MB each), read B_, C_ and a, and write the final state: 76.5 MB,
// 22.8 us at 3.35 TB/s, against 15.1 GFLOP of products (15.3 us on the
// bf16 tensor cores): bytes bound it, barely. At the short prompt (B 8,
// L 32, one ragged chunk) the 8.4 MB of final state dominates (3.2 us).
// This kernel runs its products in fp32 on the CUDA cores, each fma
// behind shared-memory loads, so it is far from either bound; wgmma
// products and TMA-fed tiles are the later work.
//
// The C entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW_BLOCK = 32;  // rows of masked scores held at once

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int K, int P, int N) {
  const int rb = K < ROW_BLOCK ? K : ROW_BLOCK;
  return sizeof(float) * ((size_t)K * P + (size_t)N * (K + 1) +
                          (size_t)K * N + (size_t)N * P + (size_t)rb * K +
                          (size_t)K);
}

// grid (H, B); block THREADS
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const T* __restrict__ xd, const float* __restrict__ a,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               T* __restrict__ y, float* __restrict__ state_out, int L,
               int H, int P, int N, int K) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int KB = K + 1;
  const int RB = K < ROW_BLOCK ? K : ROW_BLOCK;

  extern __shared__ float smem[];
  float* xs = smem;          // [K][P]   xd of the chunk
  float* bt = xs + K * P;    // [N][KB]  B^T, then B^T o decay to the end
  float* cs = bt + N * KB;   // [K][N]   C
  float* st = cs + K * N;    // [N][P]   state^T
  float* ms = st + N * P;    // [RB][K]  masked scores of a row block
  float* cum = ms + RB * K;  // [K]      a, then its inclusive cumsum

  for (int e = tid; e < N * P; e += THREADS) st[e] = 0.f;

  const long long step = (long long)H * P;  // xd, y: elements per step
  const T* xb = xd + (long long)b * L * step + (long long)h * P;
  T* yb = y + (long long)b * L * step + (long long)h * P;
  const float* ab = a + (long long)b * L * H + h;
  const T* Bb = Bm + (long long)b * L * N;
  const T* Cb = Cm + (long long)b * L * N;

  for (int t0 = 0; t0 < L; t0 += K) {
    const int rows = min(K, L - t0);  // the last chunk may be ragged
    __syncthreads();                  // the previous chunk's reads are done
    for (int e = tid; e < rows * P; e += THREADS) {
      const int k = e / P, p = e - k * P;
      xs[e] = load_f(xb + (long long)(t0 + k) * step + p);
    }
    for (int e = tid; e < rows * N; e += THREADS) {
      const int k = e / N, n = e - k * N;
      const long long off = (long long)(t0 + k) * N + n;
      bt[n * KB + k] = load_f(Bb + off);
      cs[e] = load_f(Cb + off);
    }
    for (int k = tid; k < rows; k += THREADS)
      cum[k] = ab[(long long)(t0 + k) * H];
    __syncthreads();

    // cum: warp 0 scans in double and rounds each cum once to fp32
    // (see the top): each lane totals its run of rows, the lanes' totals
    // are scanned across the warp, then each lane writes its run's sums
    if (tid < 32) {
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
    __syncthreads();

    // y, 32 rows at a time
    for (int i0 = 0; i0 < rows; i0 += RB) {
      const int ib = min(RB, rows - i0);
      for (int e = tid; e < ib * K; e += THREADS) {
        const int r = e / K, j = e - r * K, i = i0 + r;
        if (j <= i) {  // select, never mask by a product: see the top
          const float* ci = cs + i * N;
          float s = 0.f;
          for (int n = 0; n < N; ++n) s = fmaf(ci[n], bt[n * KB + j], s);
          ms[e] = s * expf(cum[i] - cum[j]);
        }
      }
      __syncthreads();
      for (int e = tid; e < ib * P; e += THREADS) {
        const int r = e / P, p = e - r * P, i = i0 + r;
        const float* ci = cs + i * N;
        float carried = 0.f;
        for (int n = 0; n < N; ++n) carried = fmaf(ci[n], st[n * P + p], carried);
        const float* mr = ms + r * K;
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(mr[j], xs[j * P + p], intra);
        store_f(yb + (long long)(t0 + i) * step + p,
                intra + carried * expf(cum[i]));
      }
      __syncthreads();
    }

    // state' = state exp(total) + xd^T (B o exp(total - cum))
    const float total = cum[rows - 1];
    for (int e = tid; e < N * rows; e += THREADS) {
      const int n = e / rows, k = e - n * rows;
      bt[n * KB + k] *= expf(total - cum[k]);
    }
    __syncthreads();
    const float keep = expf(total);
    for (int e = tid; e < N * P; e += THREADS) {
      const int n = e / P, p = e - n * P;
      const float* bn = bt + n * KB;
      float s = 0.f;
      for (int k = 0; k < rows; ++k) s = fmaf(xs[k * P + p], bn[k], s);
      st[e] = st[e] * keep + s;
    }
  }
  __syncthreads();
  float* so = state_out + ((long long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    so[e] = st[n * P + p];
  }
}

template <typename T>
int launch(const void* xd, const float* a, const void* B, const void* C,
           void* y, float* state, int batch, int L, int H, int P, int N,
           int K, cudaStream_t stream) {
  const size_t smem = smem_bytes(K, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(H, batch), THREADS, smem, stream>>>(
      static_cast<const T*>(xd), a, static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), state, L, H, P, N, K);
  return cudaGetLastError();
}

}  // namespace

namespace ssd_wgmma {
// the bf16 kernel (ssd_scan_wgmma.cu): wgmma on the tensor cores, fed by
// TMA; returns the launch's cudaError_t, or -1, -2 or -3 when the CUDA
// driver refuses xd's, B_'s or C_'s tensor map
int forward(const void* xd, const float* a, const void* B, const void* C,
            void* y, float* state, int batch, int L, int H, int P, int N,
            int chunk, cudaStream_t stream);
}  // namespace ssd_wgmma

extern "C" {

// xd [B, L, H, P] and y [B, L, H, P] in one dtype (bf16 when ``bf16``,
// else fp32), a [B, L, H] fp32, B_ and C_ [B, L, N] in xd's dtype, state
// [B, H, P, N] fp32, all contiguous; ``chunk`` is K. The dtype picks the
// kernel: bf16 runs the tensor-core kernel of ssd_scan_wgmma.cu (chunk
// 16, 32, 64 or 128, P <= 64, N <= 128), fp32 the CUDA-core kernel above.
// Returns cudaGetLastError() after the launch or, for bf16, -1, -2 or -3
// when the CUDA driver refuses xd's, B_'s or C_'s tensor map (TMA's
// 16-byte rules), before anything is launched.
int ssd_scan_forward(const void* xd, const float* a, const void* B,
                     const void* C, void* y, float* state, int batch, int L,
                     int H, int P, int N, int chunk, int bf16,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ssd_wgmma::forward(xd, a, B, C, y, state, batch, L, H, P, N,
                              chunk, s);
  return launch<float>(xd, a, B, C, y, state, batch, L, H, P, N, chunk, s);
}

}  // extern "C"
