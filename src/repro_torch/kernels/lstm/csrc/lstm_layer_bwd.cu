// The backward of T steps of one LSTM layer for W workers at once, fp32,
// for Hopper (sm_90a), the time loop inside the kernel.
//
// Replaces the gradient that XLA's autodiff takes through the TPU kernel
// repro/kernels/lstm/kernel.py::_lstm_kernel under the lax.scan of
// repro/models/rnn.py::lstm_layer_apply when the JAX package trains
// (jax.value_and_grad), generalised to a given initial carry. From the
// forward's saved activated gates (i, f, g, o) [W,B,T,4H] and cell states
// c_t [W,B,T,H] (lstm_layer.cu writes both on request), c0 [W,B,H], the
// incoming dhs [W,B,T,H] and (dhT, dcT) [W,B,H], for each worker w, row r
// and step t = T-1 down to 0, from (dh, dc) = (dhT, dcT):
//
//     dh_t   = dhs[t] + dh
//     dct    = dc + dh_t * o * (1 - tanh(c_t)^2)
//     dgates = [dct * g * i(1-i),  dct * c_{t-1} * f(1-f),
//               dct * i * (1-g^2), dh_t * tanh(c_t) * o(1-o)]
//     dc     = dct * f
//     dh     = dgates @ wh[w]^T          (the chain: step t-1 needs it)
//     dx_t   = dgates @ wx[w]^T          (off the chain; where x needs it)
//
// with c_{-1} = c0, and (dh0, dc0) = (dh, dc) after step 0. Outputs:
// dgates [W,B,T,4H] (the host turns them into the weight gradients
// x^T dgates, h_prev^T dgates and sum dgates over B and T with one
// product each per window: no TPU kernel computes those, XLA does), dxs
// [W,B,T,I] or null (the first layer's input is data), dh0 and dc0. dhs,
// dhT and dcT may be null: autograd gave no gradient there, read as 0.
// A step's arithmetic is that of the per-step backward kernel this one
// replaced, so each step of a launch is ref.lstm_cell_bwd_ref's function.
//
// c_t is saved by the forward, not recomputed here: the backward walks
// time backwards and c_t depends on every earlier step, so recomputing it
// from c0 and the gates would need a forward sweep of its own first; the
// forward's store of [W,B,T,H] is a few KB per window and gives the
// forward's bits exactly.
//
// Design. As the forward: one block per (worker, tile of ROWS batch rows)
// holding all H units of its rows, so dh and dc never leave the block.
// The products have Kd = H (+ I with dx) outputs k a row, the block is
// that wide (up to 128 threads a row). Thread (tx, ty) owns row ty and
// units j = tx, tx + blockDim.x, ... < H; in the products it owns the k's
// tx, tx + blockDim.x, ... < Kd, so the dh it writes (k < H) is the dh
// it reads in the next step, and k >= H is dx column k - H. Each
// step: the elementwise part writes its row's dgates into shared memory;
// one __syncthreads(); then the products read them. The dgates rows are
// double-buffered, so step t-1's elementwise part never writes a row that
// step t's products still read: one barrier a step, no grid or cluster
// synchronisation, no atomics. Each (row, k) sums over n = 0..4H-1 in one
// fixed order (four partial sums over n mod 4, added as (s0 + s1) +
// (s2 + s3)), so a row's bits depend on that row's inputs and its
// worker's weights only: never on B, W, T, ROWS or its block. A T-step
// launch is T chained launches at T = 1 (dhT, dcT from the previous
// launch's dh0, dc0), bit for bit. fp32 throughout: plain FMAs, tanhf,
// no TF32 and no fast-math intrinsics.
//
// The weights stay resident. Before the last step the block copies its
// worker's wh, and wx where dx is wanted, into shared memory with 16-byte
// cp.async, once per launch, as rows k of 4H columns (wh rows first, then
// wx), each row padded to GP = 4 (H + 1 | 1) floats: a thread reads its
// row k four columns at a time (one 16-byte load), and with GP / 4 odd
// the eight threads of each quarter-warp, on eight consecutive rows, hit
// 32 different banks. 66,560 B at the paper's layer 1 (I 5, no dx: wh
// only), 133,120 B at layer 2 (I 64, H 64). Where they do not fit the
// 227 KB a block may opt in to (H 128 with I 16, for one), the same loop
// reads the rows from device memory (row stride 4H) instead. Each step's
// per-row inputs (the gates, c_t, c_{t-1}, dhs) are copied in with
// cp.async while the step before runs.
//
// What bounds it on an H100. At the training shapes (W <= 4, B 32, T 20,
// I in {5, 64}, H 64) a launch moves ~0.5-3 MB (the gates, c, dhs,
// dgates and dx, the weights once per worker) and does 10-40 MFLOP: a
// bound of well under a microsecond. Latency is the bound, as in the
// forward: the steps follow one another, and within a step each thread
// walks a chain of 4H / 4 iterations (two 16-byte shared loads and four
// FMAs), while the block's rows read the whole Kd x 4H matrix out of
// shared memory once each (64 KB a row at layer 1); its times are in
// PERF.md section 6.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 2;  // batch rows per block, as in the forward
// shared memory a block may opt in to on an H100 (227 KB)
constexpr int kMaxSmem = 232448;
// threads a block may have, as in the forward
constexpr int kMaxThreads = 256;
// per-step inputs of a row, in units of H: gates (4), c_t, c_{t-1}, dhs
constexpr int kStepIn = 7;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the padded row length of the staged weights: a multiple of 4 floats
// (16-byte rows) with GP / 4 odd (conflict-free 16-byte loads)
__host__ __device__ __forceinline__ int padded_row(int H) {
  return 4 * ((H + 1) | 1);
}

// Floats of shared memory a launch takes: the Kd = H (+ I with dx) weight
// rows if `resident`, the double-buffered dgates and step inputs of
// ROWS rows, and the rows' dh and dc.
size_t smem_floats(int I, int H, bool dx, bool resident) {
  const size_t Kd = H + (dx ? I : 0);
  return (resident ? Kd * padded_row(H) : 0) + 2 * ROWS * 4 * (size_t)H
         + 2 * ROWS * kStepIn * (size_t)H + 2 * ROWS * (size_t)H;
}

bool weights_fit(int I, int H, bool dx) {
  return smem_floats(I, H, dx, true) * sizeof(float) <= (size_t)kMaxSmem;
}

// Copy step t's inputs of unit j of row r into `in` (this thread's own
// elements: it alone reads them), without waiting. dhs null: 0.
__device__ __forceinline__ void fetch_step(
    float* in, const float* gates, const float* cs, const float* c0,
    const float* dhs, size_t row, int t, int T, int H, int j) {
  const size_t rt = row * T + t;
  const float* gr = gates + rt * 4 * H;
  cp_async4(in + j, gr + j);
  cp_async4(in + H + j, gr + H + j);
  cp_async4(in + 2 * H + j, gr + 2 * H + j);
  cp_async4(in + 3 * H + j, gr + 3 * H + j);
  cp_async4(in + 4 * H + j, cs + rt * H + j);
  cp_async4(in + 5 * H + j,
            t > 0 ? cs + (rt - 1) * H + j : c0 + row * H + j);
  if (dhs != nullptr)
    cp_async4(in + 6 * H + j, dhs + rt * H + j);
  else
    in[6 * H + j] = 0.0f;
}

// dgates row d (4H, in shared memory) times weight row w (4H columns, in
// shared or device memory, 16-byte aligned): four partial sums over
// n mod 4, then (s0 + s1) + (s2 + s3)
__device__ __forceinline__ float dot_row(const float* d, const float* w,
                                         int G) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  const float4* d4 = reinterpret_cast<const float4*>(d);
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll 8
  for (int n = 0; n < G / 4; ++n) {
    const float4 a = d4[n];
    const float4 b = w4[n];
    s0 = fmaf(a.x, b.x, s0);
    s1 = fmaf(a.y, b.y, s1);
    s2 = fmaf(a.z, b.z, s2);
    s3 = fmaf(a.w, b.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// The T steps of row r (thread row ty), t = T-1 down to 0. `wrows` holds
// the Kd weight rows (wh, then wx) at a stride of `ws` floats, or is null
// and the rows are read from device memory (wh, wx at a stride of 4H).
__device__ __forceinline__ void steps(
    const float* wrows, int ws, const float* wx, const float* wh,
    const float* gates, const float* cs, const float* c0, const float* dhs,
    float* ds, float* in, float* dhc, float* dcc, float* dgates, float* dxs,
    size_t row, bool live, int T, int I, int H, int Kd) {
  const int G = 4 * H;
  const int tx = threadIdx.x, ty = threadIdx.y, bx = blockDim.x;
  for (int t = T - 1; t >= 0; --t) {
    float* d = ds + ((t & 1) * ROWS + ty) * G;
    const float* cur = in + ((t & 1) * ROWS + ty) * kStepIn * H;
    if (live) {
      cp_async_wait_all();              // this thread's step-t inputs
      const size_t rt = row * T + t;
      for (int j = tx; j < H; j += bx) {
        const float ig = cur[j], fg = cur[H + j], gg = cur[2 * H + j],
                    og = cur[3 * H + j];
        const float tc = tanhf(cur[4 * H + j]);
        const float cp = cur[5 * H + j];
        const float dhn = cur[6 * H + j] + dhc[ty * H + j];
        const float dct = dcc[ty * H + j] + dhn * og * (1.0f - tc * tc);
        const float dai = dct * gg * ig * (1.0f - ig);
        const float daf = dct * cp * fg * (1.0f - fg);
        const float dag = dct * ig * (1.0f - gg * gg);
        const float dao = dhn * tc * og * (1.0f - og);
        d[j] = dai;
        d[H + j] = daf;
        d[2 * H + j] = dag;
        d[3 * H + j] = dao;
        float* dg = dgates + rt * G;
        dg[j] = dai;
        dg[H + j] = daf;
        dg[2 * H + j] = dag;
        dg[3 * H + j] = dao;
        dcc[ty * H + j] = dct * fg;
      }
      // step t-1's inputs fly while this step's products run
      if (t > 0) {
        float* nxt = in + (((t - 1) & 1) * ROWS + ty) * kStepIn * H;
        for (int j = tx; j < H; j += bx)
          fetch_step(nxt, gates, cs, c0, dhs, row, t - 1, T, H, j);
      }
    }
    __syncthreads();
    if (live) {
      for (int k = tx; k < Kd; k += bx) {
        const float* w;
        if (wrows != nullptr)
          w = wrows + (size_t)k * ws;
        else
          w = k < H ? wh + (size_t)k * G : wx + (size_t)(k - H) * G;
        const float acc = dot_row(d, w, G);
        if (k < H)
          dhc[ty * H + k] = acc;        // this thread's unit k next step
        else
          dxs[(row * T + t) * I + (k - H)] = acc;
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_layer_bwd_kernel(const float* __restrict__ dhs,
                      const float* __restrict__ dhT,
                      const float* __restrict__ dcT,
                      const float* __restrict__ gates,
                      const float* __restrict__ cs,
                      const float* __restrict__ c0,
                      const float* __restrict__ wx,
                      const float* __restrict__ wh,
                      float* __restrict__ dgates, float* __restrict__ dxs,
                      float* __restrict__ dh0, float* __restrict__ dc0,
                      int B, int T, int I, int H, int resident) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const bool dx = dxs != nullptr;
  const int Kd = H + (dx ? I : 0);
  const int GP = padded_row(H);
  const size_t wid = blockIdx.y;       // this block's worker
  wx += wid * I * G;
  wh += wid * H * G;
  float* wsm = smem;                                     // [Kd][GP]
  float* ds = smem + (resident ? (size_t)Kd * GP : 0);   // [2][ROWS][4H]
  float* in = ds + 2 * ROWS * G;                         // [2][ROWS][7H]
  float* dhc = in + 2 * ROWS * kStepIn * H;              // [ROWS][H]
  float* dcc = dhc + ROWS * H;                           // [ROWS][H]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx, nthreads = blockDim.x * ROWS;
  const int r = blockIdx.x * ROWS + ty;
  const bool live = r < B;
  const size_t row = wid * B + r;      // the row's index over W x B

  if (resident) {
    // rows of G floats as G / 4 16-byte pieces each, neighbouring
    // threads on neighbouring pieces
    const int q = G / 4;
    for (int e = tid; e < Kd * q; e += nthreads) {
      const int k = e / q, p = e - k * q;
      const float* src = k < H ? wh + (size_t)k * G : wx + (size_t)(k - H) * G;
      cp_async16(wsm + (size_t)k * GP + 4 * p, src + 4 * p);
    }
  }
  if (live) {
    float* first = in + (((T - 1) & 1) * ROWS + ty) * kStepIn * H;
    for (int j = tx; j < H; j += blockDim.x) {
      dhc[ty * H + j] = dhT != nullptr ? dhT[row * H + j] : 0.0f;
      dcc[ty * H + j] = dcT != nullptr ? dcT[row * H + j] : 0.0f;
      fetch_step(first, gates, cs, c0, dhs, row, T - 1, T, H, j);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // the same loop over the weights in shared memory or, where they do not
  // fit, in device memory: inlined once for each
  if (resident)
    steps(wsm, GP, wx, wh, gates, cs, c0, dhs, ds, in, dhc, dcc, dgates, dxs,
          row, live, T, I, H, Kd);
  else
    steps(nullptr, G, wx, wh, gates, cs, c0, dhs, ds, in, dhc, dcc, dgates,
          dxs, row, live, T, I, H, Kd);

  if (live)
    for (int j = tx; j < H; j += blockDim.x) {
      dh0[row * H + j] = dhc[ty * H + j];
      dc0[row * H + j] = dcc[ty * H + j];
    }
}

cudaError_t allow_max_smem() {
  return cudaFuncSetAttribute(lstm_layer_bwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

}  // namespace

extern "C" {

// Launch the backward of T steps for W workers on `stream`. All pointers
// are device pointers to contiguous fp32 arrays: dhs, cs [W, B, T, H];
// dhT, dcT, c0, dh0, dc0 [W, B, H]; gates, dgates [W, B, T, 4H]; wx
// [W, I, 4H] and wh [W, H, 4H], both 16-byte aligned; dxs [W, B, T, I] or
// null (dx not computed). dhs, dhT and dcT may be null (read as 0).
// Returns the first CUDA error (0 = launched); nothing is synchronised.
int lstm_layer_backward(const float* dhs, const float* dhT, const float* dcT,
                        const float* gates, const float* cs, const float* c0,
                        const float* wx, const float* wh, float* dgates,
                        float* dxs, float* dh0, float* dc0, int W, int B,
                        int T, int I, int H, void* stream) {
  // opt in to more than 48 KB of shared memory once per process
  static const cudaError_t opt_in = allow_max_smem();
  if (opt_in != cudaSuccess) return (int)opt_in;
  if (((reinterpret_cast<uintptr_t>(wx) | reinterpret_cast<uintptr_t>(wh))
       & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const bool dx = dxs != nullptr;
  const bool resident = weights_fit(I, H, dx);
  const size_t smem = smem_floats(I, H, dx, resident) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int width = (H + (dx ? I : 0) + 31) / 32 * 32;
  const dim3 block(width < kMaxThreads / ROWS ? width : kMaxThreads / ROWS,
                   ROWS);
  const dim3 grid((B + ROWS - 1) / ROWS, W);
  lstm_layer_bwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      dhs, dhT, dcT, gates, cs, c0, wx, wh, dgates, dxs, dh0, dc0, B, T, I,
      H, resident);
  return (int)cudaGetLastError();
}

}  // extern "C"
