// The backward of one LSTM time step for W workers, fp32, for Hopper
// (sm_90a).
//
// Replaces the gradient that XLA's autodiff takes through the TPU kernel
// repro/kernels/lstm/kernel.py::_lstm_kernel when the JAX package trains
// (jax.value_and_grad over lax.scan of the cell). Given the forward's
// saved activated gates (i, f, g, o) [W,B,4H], c [W,B,H] and c' [W,B,H],
// and the incoming dh', dc' [W,B,H], it computes for each worker w
//
//     dc_tot = dc' + dh' * o * (1 - tanh(c')^2)
//     dgates = [dc_tot * g * i(1-i),  dc_tot * c * f(1-f),
//               dc_tot * i * (1-g^2), dh' * tanh(c') * o(1-o)]  [W,B,4H]
//     dc     = dc_tot * f                                      [W,B,H]
//     dx     = dgates @ wx[w]^T                                [W,B,I]
//     dh     = dgates @ wh[w]^T                                [W,B,H]
//
// the two products that mirror the forward's x @ wx and h @ wh. The
// weight gradients x^T @ dgates, h^T @ dgates and sum_B dgates reduce
// over the batch; no TPU kernel computes them (XLA does), so they stay
// torch.bmm / sum in the autograd Function's backward (ops.py).
//
// Design. A block holds ROWS rows of one worker and KTILE of the I + H
// input dims k of [x | h]. It copies the KTILE weight rows it needs,
// all 4H columns of each, into shared memory with cp.async (rows padded
// to 4H + 1 floats, so the 32 threads of a warp, one per k, read 32
// different banks), and while the copies fly it computes the dgates of
// its ROWS rows into shared memory (elementwise; every k-tile block of a
// row computes them again, and only the first writes them and dc out).
// Then one thread per (row, k) sums dgates[row, n] * w[k, n] over
// n = 0..4H-1 in that fixed order: a row's bits do not depend on B, W or
// its block, and there are no atomics, so two runs give the same bits.
// When dx is not wanted (the first layer's input is data) the blocks
// start at k = I. fp32 throughout, no fast-math intrinsics.
//
// What bounds it on an H100. At the training shapes (W <= 4, B = 32,
// I in {5, 64}, H = 64) a call moves ~0.1-0.6 MB and does ~1-5 MFLOP:
// a bound of well under a microsecond against a launch of a few. Like
// the forward, it is bound by latency: one round trip to L2 for the
// weight tile, then a 4H-long FMA chain per thread from shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int KTILE = 32;  // input dims per block (one warp wide)
constexpr int ROWS = 4;    // batch rows per block
// shared memory a block may opt in to on an H100 (227 KB)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(KTILE * ROWS)
lstm_cell_bwd_kernel(const float* __restrict__ dh_new,
                     const float* __restrict__ dc_new,
                     const float* __restrict__ gates,
                     const float* __restrict__ c,
                     const float* __restrict__ c_new,
                     const float* __restrict__ wx,
                     const float* __restrict__ wh,
                     float* __restrict__ dgates, float* __restrict__ dc,
                     float* __restrict__ dx, float* __restrict__ dh,
                     int B, int I, int H, int k_begin) {
  extern __shared__ float smem[];
  const int K = I + H;
  const int G = 4 * H;
  const int GP = G + 1;                   // padded weight row
  float* ws = smem;                       // [KTILE][GP] weight rows
  float* ds = smem + KTILE * GP;          // [ROWS][G] dgates rows
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int t = ty * KTILE + tx;
  const int k0 = k_begin + blockIdx.x * KTILE;
  const int r0 = blockIdx.y * ROWS;
  // this block's worker
  const size_t w = blockIdx.z;
  wx += w * I * G;
  wh += w * H * G;
  const size_t rowI = w * B * I, rowH = w * B * H, rowG = w * B * G;

  // the weight rows k0 .. k0 + KTILE - 1 of [wx; wh], asynchronously;
  // neighbouring threads copy neighbouring columns
  for (int e = t; e < KTILE * G; e += KTILE * ROWS) {
    const int kk = e / G, n = e - kk * G;
    const int k = k0 + kk;
    float* dst = ws + kk * GP + n;
    if (k < I)
      cp_async4(dst, wx + (size_t)k * G + n);
    else if (k < K)
      cp_async4(dst, wh + (size_t)(k - I) * G + n);
    else
      *dst = 0.0f;
  }

  // dgates of the block's rows, while the copies fly
  for (int e = t; e < ROWS * H; e += KTILE * ROWS) {
    const int rr = e / H, j = e - rr * H;
    const int r = r0 + rr;
    float* d = ds + rr * G;
    if (r >= B) {
      d[j] = d[H + j] = d[2 * H + j] = d[3 * H + j] = 0.0f;
      continue;
    }
    const size_t o = rowH + (size_t)r * H + j;
    const float* gr = gates + rowG + (size_t)r * G;
    const float ig = gr[j], fg = gr[H + j], gg = gr[2 * H + j],
                og = gr[3 * H + j];
    const float tc = tanhf(c_new[o]);
    const float dhn = dh_new[o];
    const float dct = dc_new[o] + dhn * og * (1.0f - tc * tc);
    const float dai = dct * gg * ig * (1.0f - ig);
    const float daf = dct * c[o] * fg * (1.0f - fg);
    const float dag = dct * ig * (1.0f - gg * gg);
    const float dao = dhn * tc * og * (1.0f - og);
    d[j] = dai;
    d[H + j] = daf;
    d[2 * H + j] = dag;
    d[3 * H + j] = dao;
    if (blockIdx.x == 0) {
      float* dgo = dgates + rowG + (size_t)r * G;
      dgo[j] = dai;
      dgo[H + j] = daf;
      dgo[2 * H + j] = dag;
      dgo[3 * H + j] = dao;
      dc[o] = dct * fg;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int k = k0 + tx, r = r0 + ty;
  if (k >= K || r >= B) return;
  const float* wk = ws + tx * GP;
  const float* dr = ds + ty * G;
  float acc = 0.0f;
#pragma unroll 8
  for (int n = 0; n < G; ++n) acc = fmaf(dr[n], wk[n], acc);
  if (k < I)
    dx[rowI + (size_t)r * I + k] = acc;
  else
    dh[rowH + (size_t)r * H + (k - I)] = acc;
}

cudaError_t allow_max_smem() {
  return cudaFuncSetAttribute(lstm_cell_bwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

}  // namespace

extern "C" {

// Shared memory one launch needs for H, in bytes: the padded weight rows
// and the dgates rows. The caller checks it against the 227 KB a block
// may opt in to.
int lstm_cell_bwd_smem_bytes(int H) {
  return (int)(((size_t)KTILE * (4 * H + 1) + (size_t)ROWS * 4 * H)
               * sizeof(float));
}

// Launch the backward of one step for W workers on `stream`. All
// pointers are device pointers to contiguous fp32 arrays: dh_new,
// dc_new, c, c_new, dc, dh [W, B, H]; gates, dgates [W, B, 4H];
// wx [W, I, 4H]; wh [W, H, 4H]; dx [W, B, I] or null (then dx is not
// computed). Returns the first CUDA error (0 = launched); nothing is
// synchronised.
int lstm_cell_backward(const float* dh_new, const float* dc_new,
                       const float* gates, const float* c,
                       const float* c_new, const float* wx, const float* wh,
                       float* dgates, float* dc, float* dx, float* dh,
                       int W, int B, int I, int H, void* stream) {
  static const cudaError_t opt_in = allow_max_smem();
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int k_begin = dx != nullptr ? 0 : I;
  const int K = I + H - k_begin;
  const dim3 block(KTILE, ROWS);
  const dim3 grid((K + KTILE - 1) / KTILE, (B + ROWS - 1) / ROWS, W);
  const size_t smem = (size_t)lstm_cell_bwd_smem_bytes(H);
  lstm_cell_bwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      dh_new, dc_new, gates, c, c_new, wx, wh, dgates, dc, dx, dh, B, I, H,
      k_begin);
  return (int)cudaGetLastError();
}

}  // extern "C"
