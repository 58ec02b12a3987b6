// One LSTM time step for W workers at once, fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/lstm/kernel.py::_lstm_kernel
// (launched by lstm_cell_pallas). Same function, for each worker w:
//
//     gates = x[w] @ wx[w] + h[w] @ wh[w] + b[w]   packed [i, f, g, o]
//     i, f, o = sigmoid(.)   g = tanh(.)
//     c' = f * c + i * g     h' = o * tanh(c')
//
// The worker dim W leads every operand: x [W,B,I], h and c [W,B,H],
// wx [W,I,4H], wh [W,H,4H], b [W,4H]. It is the JAX package's
// jax.vmap over local-SGD workers (repro/core/async_local_sgd.py) made
// one launch per time step for all W workers (blockIdx.z); serving
// calls it at W = 1. In training an optional output saves the activated
// gates [W,B,4H] for the backward kernel (lstm_cell_bwd.cu); serving
// passes null.
//
// Design. One thread per (row r, hidden unit j). The thread accumulates
// the four gate sums of its unit (columns j, H+j, 2H+j, 3H+j) over k in
// one fixed order, 0..I-1 over x then 0..H-1 over h, so the bits of a row
// depend on that row's inputs and its worker's weights only: never on B,
// on W, on the block the row lands in, or on its position in that
// block. The serving path rests on that (a session's step, its replay
// and its slot-resident generate agree bitwise). A block holds ROWS rows
// x JTILE units of one worker. It
// first copies the weight columns of its JTILE units, all I + H rows of
// them, into shared memory with cp.async (every thread issues all of its
// copies before waiting on any, so the whole tile is one round trip to
// L2), and its x and h rows beside them; the FMA loop then reads only
// shared memory. The TPU's padding of B and I to multiples of 8 is not
// carried over: the kernel masks its own ragged edges and takes I = 5 as
// it is. fp32 throughout, plain FMAs, no TF32 and no fast-math
// intrinsics.
//
// What bounds it on an H100. At the serving shapes (B <= 64, I in {5, 64},
// H = 64) the work is ~0.3-4 MFLOP and ~140 KB of weights: the bytes
// bound is 0.02-0.07 us at the card's 3.35 TB/s, far below what a launch
// costs (about 2.3 us per kernel node in a CUDA graph on an H100 80GB
// HBM3 at 700 W, measured with chip_smoke.py). Latency is the bound. A
// first version read the weights from L2 inside the k loop; the
// compiler kept only a few loads in flight, so each k waited out an L2
// round trip (21 us at I = 64, 13.5 us at I = 5). Staging the tile with
// cp.async, each thread issuing all its copies before the first wait,
// pays that round trip once (5.4 us and 4.0 us on the same card).
// Later work: the weights resident in shared memory across both layers,
// one fused 2-layer + head + alert launch per generate, and CUDA graphs
// for the host's share, which dominates the serving path.

#include <cuda_runtime.h>

namespace {

constexpr int JTILE = 32;  // hidden units per block (one warp wide)
constexpr int ROWS = 4;    // batch rows per block
// shared memory a block may opt in to on an H100 (227 KB)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(JTILE * ROWS)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ wx,
                 const float* __restrict__ wh, const float* __restrict__ b,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 float* __restrict__ gates, int B, int I, int H) {
  extern __shared__ float smem[];
  const int K = I + H;
  float* ws = smem;                            // [K][4][JTILE] weights
  float* vs = smem + (size_t)K * 4 * JTILE;    // [ROWS][K] x then h rows
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * JTILE;
  const int r = blockIdx.y * ROWS + ty;
  const size_t G = 4 * (size_t)H;
  // this block's worker
  const size_t wid = blockIdx.z;
  x += wid * B * I;
  h += wid * B * H;
  c += wid * B * H;
  wx += wid * I * G;
  wh += wid * H * G;
  b += wid * G;
  h_out += wid * B * H;
  c_out += wid * B * H;

  // the block's weight tile, [k][gate][unit]: thread (tx, ty) copies
  // column j0 + tx of gate ty for every k, one async copy per k
  const int j = j0 + tx;
  for (int g = ty; g < 4; g += ROWS) {
    float* dst = ws + g * JTILE + tx;
    if (j < H) {
      const float* src = wx + g * H + j;
      for (int k = 0; k < I; ++k, src += G, dst += 4 * JTILE)
        cp_async4(dst, src);
      src = wh + g * H + j;
      for (int k = 0; k < H; ++k, src += G, dst += 4 * JTILE)
        cp_async4(dst, src);
    } else {
      for (int k = 0; k < K; ++k, dst += 4 * JTILE) *dst = 0.0f;
    }
  }
  float* v = vs + ty * K;
  for (int k = tx; k < K; k += JTILE) {
    float val = 0.0f;
    if (r < B) val = k < I ? x[(size_t)r * I + k] : h[(size_t)r * H + k - I];
    v[k] = val;
  }
  cp_async_wait_all();
  __syncthreads();

  if (j >= H || r >= B) return;

  float ai = b[j], af = b[H + j], ag = b[2 * H + j], ao = b[3 * H + j];
  const float* w = ws + tx;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float vk = v[k];
    const float* wk = w + k * 4 * JTILE;
    ai = fmaf(vk, wk[0], ai);
    af = fmaf(vk, wk[JTILE], af);
    ag = fmaf(vk, wk[2 * JTILE], ag);
    ao = fmaf(vk, wk[3 * JTILE], ao);
  }

  const float ig = sigmoidf(ai);
  const float fg = sigmoidf(af);
  const float gg = tanhf(ag);
  const float og = sigmoidf(ao);
  if (gates != nullptr) {
    float* gr = gates + (wid * B + r) * G;
    gr[j] = ig;
    gr[H + j] = fg;
    gr[2 * H + j] = gg;
    gr[3 * H + j] = og;
  }
  const size_t o = (size_t)r * H + j;
  const float cn = fg * c[o] + ig * gg;
  c_out[o] = cn;
  h_out[o] = og * tanhf(cn);
}

cudaError_t allow_max_smem() {
  return cudaFuncSetAttribute(lstm_cell_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

}  // namespace

extern "C" {

// Shared memory one launch needs for (I, H), in bytes: the weight tile
// and the x/h rows. The caller checks it against the 227 KB a block may
// opt in to.
int lstm_cell_smem_bytes(int I, int H) {
  return (int)((size_t)(I + H) * (4 * JTILE + ROWS) * sizeof(float));
}

// Launch one step for W workers on `stream`. All pointers are device
// pointers to contiguous fp32 arrays: x [W, B, I], h, c, h_out, c_out
// [W, B, H], wx [W, I, 4H], wh [W, H, 4H], b [W, 4H], and gates
// [W, B, 4H] or null (then no gates are saved). Returns the first CUDA
// error (0 = launched); nothing is synchronised.
int lstm_cell_forward(const float* x, const float* h, const float* c,
                      const float* wx, const float* wh, const float* b,
                      float* h_out, float* c_out, float* gates, int W,
                      int B, int I, int H, void* stream) {
  // opt in to more than 48 KB of shared memory once per process
  static const cudaError_t opt_in = allow_max_smem();
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 block(JTILE, ROWS);
  const dim3 grid((H + JTILE - 1) / JTILE, (B + ROWS - 1) / ROWS, W);
  const size_t smem = (size_t)lstm_cell_smem_bytes(I, H);
  lstm_cell_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, h, c, wx, wh, b, h_out, c_out, gates, B, I, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
