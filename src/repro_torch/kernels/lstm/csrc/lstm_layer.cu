// T steps of one LSTM layer for W workers at once, fp32, for Hopper
// (sm_90a), the time loop inside the kernel.
//
// Replaces the TPU kernel repro/kernels/lstm/kernel.py::_lstm_kernel
// (launched by lstm_cell_pallas), one cell step, together with the
// lax.scan over time that repro/models/rnn.py::lstm_layer_apply wraps
// around it, generalised to a given initial carry. For each worker w,
// row r and step t = 0..T-1, from (h, c) = (h0, c0):
//
//     gates = x[w,r,t] @ wx[w] + h @ wh[w] + b[w]   packed [i, f, g, o]
//     i, f, o = sigmoid(.)   g = tanh(.)
//     c = f * c + i * g      h = o * tanh(c)        hs[w,r,t] = h
//
// and (hT, cT) = (h, c) after the last step. The worker dim W leads every
// operand: x [W,B,T,I], h0 and c0 [W,B,H], wx [W,I,4H], wh [W,H,4H],
// b [W,4H]; hs [W,B,T,H], hT and cT [W,B,H]. It is the JAX package's
// jax.vmap over local-SGD workers (repro/core/async_local_sgd.py) as
// blockIdx.y; serving calls it at W = 1. A window runs in one launch,
// served or trained; one step of a session is the same launch at T = 1.
// Optional outputs: hs (null: not written, the cell needs hT only), and
// the activated gates [W,B,T,4H] and every step's c [W,B,T,H] for the
// backward kernel (lstm_layer_bwd.cu; null: not saved). Storing c changes
// no bit of the forward.
//
// Design. One block per (worker, tile of ROWS batch rows). It holds all
// H units of its rows, so h_t never leaves the block: each step reads
// its rows' [x_t | h_{t-1}] from one shared buffer and writes h_t into
// the other, and one __syncthreads() per step hands it on. No grid or
// cluster synchronisation. Thread (tx, ty) owns row ty of the tile and
// units tx, tx + blockDim.x, ...; for each it sums its four gates over k
// in one fixed order, 0..I-1 over x then 0..H-1 over h, from the bias,
// with plain FMAs, so the bits of a row depend on that row's inputs and
// its worker's weights only: never on B, W, T, ROWS or the block the row
// lands in. Step t of a T-step launch is T launches at T = 1 chained
// through (hT, cT), bit for bit; the serving path rests on that (a
// session's step, its replay and its slot-resident generate agree
// bitwise). The sums, the activations and the update are those of the
// per-step kernel this one replaced, so a launch at T = 1 gives its bits.
// fp32 throughout: expf/tanhf, no TF32 and no fast-math intrinsics.
//
// The weights stay resident. Before the first step the block copies its
// worker's wx | wh, K = I + H rows of 4H columns, into shared memory with
// cp.async (16-byte copies where both arrays are 16-byte aligned; every
// copy issued before the first wait, so the whole matrix is one round
// trip to L2), and reads them from there for all T steps: 70,656 B at the
// paper's layer 1 (I 5, H 64), 131,072 B at layer 2 (I 64, H 64). Where
// they do not fit the 227 KB a block may opt in to beside the row
// buffers (H 128 with I 16, for one), the same loop reads them from
// device memory through the caches instead; no model config of the repo
// comes there. x_{t+1} is copied in with cp.async while step t runs.
//
// What bounds it on an H100. At the serving and training shapes (B <= 64,
// T 20 or 1, H = 64) the bytes that must move are 70-140 KB of weights
// per worker plus x and hs, and the operations 0.3-40 MFLOP: far below
// what the card moves and computes in the kernel's time. Latency is the
// bound: the steps follow one another, and within a step each thread
// walks a chain of K iterations, each one load of the row, four loads of
// weights with their address arithmetic, and four FMAs. ROWS was chosen
// by timing copies of this kernel at each value; the times, and what the
// weights' staging costs a launch at T = 1, are in PERF.md section 6.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 2;  // batch rows per block
// shared memory a block may opt in to on an H100 (227 KB)
constexpr int kMaxSmem = 232448;
// threads a block may have: a bound of 1024 held ptxas to 32 registers,
// too few to keep the k loop's loads in flight (it spilled, and each k
// waited out its shared-memory loads; PERF.md section 6); wider layers
// loop over their units
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

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

// n floats from src to dst, by every thread of the block, without waiting
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      bool wide, int tid, int nthreads) {
  if (wide) {
    for (int i = tid; i < n / 4; i += nthreads)
      cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = tid; i < n; i += nthreads) cp_async4(dst + i, src + i);
  }
}

// Floats of shared memory a launch takes: the weights if `resident`, the
// bias, two [ROWS][K] row buffers and the [ROWS][H] cell states.
size_t smem_floats(int I, int H, bool resident) {
  const size_t K = I + H, G = 4 * (size_t)H;
  return (resident ? K * G : 0) + G + 2 * ROWS * K + ROWS * (size_t)H;
}

bool weights_fit(int I, int H) {
  return smem_floats(I, H, true) * sizeof(float) <= (size_t)kMaxSmem;
}

// One step of unit j of one row: the four gate sums over v = [x_t | h]
// (wxr: I rows, whr: H rows of 4H columns, in shared or device memory),
// then the cell update. Returns h' and updates c in place.
__device__ __forceinline__ float cell(const float* v, const float* wxr,
                                      const float* whr, const float* bs,
                                      float& c, float* gr, int I, int H,
                                      int j) {
  const int G = 4 * H;
  float ai = bs[j], af = bs[H + j], ag = bs[2 * H + j], ao = bs[3 * H + j];
  const float* w = wxr + j;
#pragma unroll 8
  for (int k = 0; k < I; ++k) {
    const float vk = v[k];
    const float* wk = w + k * G;
    ai = fmaf(vk, wk[0], ai);
    af = fmaf(vk, wk[H], af);
    ag = fmaf(vk, wk[2 * H], ag);
    ao = fmaf(vk, wk[3 * H], ao);
  }
  w = whr + j;
#pragma unroll 8
  for (int k = 0; k < H; ++k) {
    const float vk = v[I + k];
    const float* wk = w + k * G;
    ai = fmaf(vk, wk[0], ai);
    af = fmaf(vk, wk[H], af);
    ag = fmaf(vk, wk[2 * H], ag);
    ao = fmaf(vk, wk[3 * H], ao);
  }
  const float ig = sigmoidf(ai);
  const float fg = sigmoidf(af);
  const float gg = tanhf(ag);
  const float og = sigmoidf(ao);
  if (gr != nullptr) {
    gr[j] = ig;
    gr[H + j] = fg;
    gr[2 * H + j] = gg;
    gr[3 * H + j] = og;
  }
  // the fused multiply-add written out: left to ptxas, which one of the
  // two products it fuses depends on the code around it; this one is what
  // the per-step kernel this one replaced compiled to (its bits, checked
  // by chip_smoke.py against digests that kernel took)
  const float cn = fmaf(ig, gg, fg * c);
  c = cn;
  return og * tanhf(cn);
}

// The T steps of row r (thread row ty of the block), from the row buffer
// and cell states staged in shared memory: each step reads [x_t | h_{t-1}]
// from one buffer, writes [x_{t+1} | h_t] into the other (x by cp.async
// while the step runs), then waits for the whole block.
__device__ __forceinline__ void steps(
    const float* x, float* vs, const float* wxr, const float* whr,
    const float* bs, float* cs, float* hs, float* hT, float* cT,
    float* gates, float* csave, size_t wid, int r, bool live, int B, int T,
    int I, int H) {
  const int K = I + H;
  const int G = 4 * H;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int t = 0; t < T; ++t) {
    const float* vc = vs + ((t & 1) * ROWS + ty) * K;
    float* vn = vs + (((t + 1) & 1) * ROWS + ty) * K;
    if (live) {
      if (t + 1 < T)
        for (int k = tx; k < I; k += blockDim.x)
          cp_async4(vn + k, x + ((size_t)r * T + t + 1) * I + k);
      const size_t rt = (wid * B + r) * (size_t)T + t;
      float* gr = gates != nullptr ? gates + rt * G : nullptr;
      for (int j = tx; j < H; j += blockDim.x) {
        float c = cs[ty * H + j];
        const float h = cell(vc, wxr, whr, bs, c, gr, I, H, j);
        cs[ty * H + j] = c;
        vn[I + j] = h;
        if (hs != nullptr) hs[rt * H + j] = h;
        if (csave != nullptr) csave[rt * H + j] = c;
        if (t == T - 1) {
          hT[(wid * B + r) * H + j] = h;
          cT[(wid * B + r) * H + j] = c;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_layer_kernel(const float* __restrict__ x, const float* __restrict__ h0,
                  const float* __restrict__ c0, const float* __restrict__ wx,
                  const float* __restrict__ wh, const float* __restrict__ b,
                  float* __restrict__ hs, float* __restrict__ hT,
                  float* __restrict__ cT, float* __restrict__ gates,
                  float* __restrict__ csave, int B, int T, int I, int H,
                  int resident) {
  extern __shared__ __align__(16) float smem[];
  const int K = I + H;
  const int G = 4 * H;
  const size_t wid = blockIdx.y;       // this block's worker
  x += wid * B * T * I;
  h0 += wid * B * H;
  c0 += wid * B * H;
  wx += wid * I * G;
  wh += wid * H * G;
  b += wid * G;
  float* ws = smem;                                  // [K][4H] if resident
  float* bs = smem + (resident ? (size_t)K * G : 0);  // [4H]
  float* vs = bs + G;                                // [2][ROWS][K]
  float* cs = vs + 2 * ROWS * K;                     // [ROWS][H]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * blockDim.x + tx, nthreads = blockDim.x * ROWS;
  const int r = blockIdx.x * ROWS + ty;
  const bool live = r < B;

  if (resident) {
    const bool wide = ((reinterpret_cast<uintptr_t>(wx)
                        | reinterpret_cast<uintptr_t>(wh)) & 15) == 0;
    stage(ws, wx, I * G, wide, tid, nthreads);
    stage(ws + (size_t)I * G, wh, H * G, wide, tid, nthreads);
  }
  stage(bs, b, G, false, tid, nthreads);
  float* v = vs + ty * K;
  for (int k = tx; k < K; k += blockDim.x) {
    float val = 0.0f;
    if (live) val = k < I ? x[(size_t)r * T * I + k] : h0[(size_t)r * H + k - I];
    v[k] = val;
  }
  for (int j = tx; j < H; j += blockDim.x)
    cs[ty * H + j] = live ? c0[(size_t)r * H + j] : 0.0f;
  cp_async_wait_all();
  __syncthreads();

  // the same loop over the weights in shared memory or, where they do not
  // fit, in device memory: inlined once for each, so that the first reads
  // shared memory with its own loads
  if (resident)
    steps(x, vs, ws, ws + (size_t)I * G, bs, cs, hs, hT, cT, gates, csave,
          wid, r, live, B, T, I, H);
  else
    steps(x, vs, wx, wh, bs, cs, hs, hT, cT, gates, csave, wid, r, live, B,
          T, I, H);
}

cudaError_t allow_max_smem() {
  return cudaFuncSetAttribute(lstm_layer_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

}  // namespace

extern "C" {

// Launch T steps for W workers on `stream`. All pointers are device
// pointers to contiguous fp32 arrays: x [W, B, T, I], h0, c0, hT, cT
// [W, B, H], wx [W, I, 4H], wh [W, H, 4H], b [W, 4H]; hs [W, B, T, H] or
// null (not written); gates [W, B, T, 4H] and cs [W, B, T, H] (each
// step's c) or null (not saved). Returns the first CUDA error
// (0 = launched); nothing is synchronised.
int lstm_layer_forward(const float* x, const float* h0, const float* c0,
                       const float* wx, const float* wh, const float* b,
                       float* hs, float* hT, float* cT, float* gates,
                       float* cs, int W, int B, int T, int I, int H,
                       void* stream) {
  // opt in to more than 48 KB of shared memory once per process
  static const cudaError_t opt_in = allow_max_smem();
  if (opt_in != cudaSuccess) return (int)opt_in;
  const bool resident = weights_fit(I, H);
  const size_t smem = smem_floats(I, H, resident) * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int width = (H + 31) / 32 * 32;
  const dim3 block(width < kMaxThreads / ROWS ? width : kMaxThreads / ROWS,
                   ROWS);
  const dim3 grid((B + ROWS - 1) / ROWS, W);
  lstm_layer_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      x, h0, c0, wx, wh, b, hs, hT, cT, gates, cs, B, T, I, H, resident);
  return (int)cudaGetLastError();
}

}  // extern "C"
