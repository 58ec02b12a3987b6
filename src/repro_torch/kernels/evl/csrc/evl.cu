// The Extreme Value Loss (paper eq. 6) and its derivative in u, fp32,
// in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/evl/kernel.py::_evl_kernel
// (launched by evl_pallas, wrapped by evl/ops.py::evl_loss_fused), an
// elementwise pass whose wrapper then reduces by mean, sum or none, and
// XLA's autodiff of it. u, v are [W, N] (W local-SGD workers, N the
// batch). Elementwise, with u clipped to [lo, hi] = [eps, 1 - eps]:
//
//     w+ = beta0 * max(1 - u / gamma, 1e-12)^gamma
//     w- = beta1 * max(1 - (1 - u) / gamma, 1e-12)^gamma
//     l  = -w+ * v * log(u) - w- * (1 - v) * log(1 - u)
//
// The loss is each row's mean or sum, [W] (as jax.vmap(evl_loss) gives
// one loss per worker), or l itself, [W, N], for none. When du is not
// null the same launch writes du_unit [W, N], the derivative of that
// loss in u in closed form: dl/du / N for mean, dl/du for sum and none.
// The incoming gradient is not applied here: the autograd Function
// multiplies by it. du_unit follows the JAX package's derivative
// everywhere, ties included: at u == eps or u == 1 - eps exactly the
// clip passes half the gradient, as jnp.clip's maximum/minimum do (and
// torch.maximum/minimum in the plain version), and the 1e-12 floors
// likewise.
//
// Design. One warp per row, up to 32 rows a block, the grid over rows
// beyond that. Lane l takes the elements l, l + 32, l + 64, ... in that
// order, and a 5-step __shfl_xor_sync butterfly sums the row (every
// lane ends with the same bits; lane 0 writes). No shared memory, no
// barrier, no atomics: a row's bits depend on N alone, not on W, on the
// other rows of the block, or on the run. Each element is read once, and
// its clip, both weights (w = beta * pow(a, gamma - 1) * a, the power
// shared with the derivative) and both logs are computed once for the
// loss term and the gradient term together.
//
// What bounds it on an H100. A call reads 2 * W * N floats and writes
// W (or W * N) losses and W * N gradients: at W = 4, N = 32 about 1.5
// KB, a bound of under a nanosecond. It is bound by its launch, so the
// loss and its gradient share one launch rather than taking one each.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 32;

struct EvlParams {
  float beta0, beta1, gamma, lo, hi;
};

// the derivative of max(a, floor) in a: 1 above, 1/2 at the tie, 0 below
__device__ __forceinline__ float dmax(float a, float floor) {
  return a > floor ? 1.0f : (a == floor ? 0.5f : 0.0f);
}

// reduce: 0 none, 1 sum, 2 mean; du may be null (no gradient)
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
evl_fused_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 float* __restrict__ out, float* __restrict__ du, int W,
                 int N, EvlParams p, int reduce) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= W) return;  // row is the same across a warp
  const size_t base = (size_t)row * N;
  float acc = 0.0f;
  for (int n = lane; n < N; n += kWarp) {
    const float x = u[base + n], y = v[base + n];
    const float uc = fminf(fmaxf(x, p.lo), p.hi);
    const float a = 1.0f - uc / p.gamma;
    const float b = 1.0f - (1.0f - uc) / p.gamma;
    const float ap = fmaxf(a, 1e-12f), bp = fmaxf(b, 1e-12f);
    const float pa = powf(ap, p.gamma - 1.0f);
    const float pb = powf(bp, p.gamma - 1.0f);
    const float wp = p.beta0 * (pa * ap), wn = p.beta1 * (pb * bp);
    const float lu = logf(uc), lnu = logf(1.0f - uc);
    const float l = -wp * y * lu - wn * (1.0f - y) * lnu;
    if (reduce == 0)
      out[base + n] = l;
    else
      acc += l;
    if (du != nullptr) {
      // d clip(u) / du, ties halved; d w+ / du and d w- / du
      // (da/du = -1/gamma, db/du = 1/gamma)
      const float dclip = (x > p.lo && x < p.hi)
                              ? 1.0f
                              : ((x == p.lo || x == p.hi) ? 0.5f : 0.0f);
      const float dwp = -p.beta0 * pa * dmax(a, 1e-12f);
      const float dwn = p.beta1 * pb * dmax(b, 1e-12f);
      const float dl = -dwp * y * lu - wp * y / uc
                       - dwn * (1.0f - y) * lnu
                       + wn * (1.0f - y) / (1.0f - uc);
      const float d = dl * dclip;
      du[base + n] = reduce == 2 ? d / (float)N : d;
    }
  }
  if (reduce == 0) return;
  for (int m = kWarp / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) out[row] = reduce == 2 ? acc / (float)N : acc;
}

}  // namespace

extern "C" {

// Launch the loss of W rows of N, and with du its derivative in u, on
// `stream`: u, v [W, N] fp32, contiguous, on the device; out [W]
// (reduce 1 = sum, 2 = mean) or [W, N] (reduce 0 = none); du [W, N] or
// null for the loss alone. lo, hi are the clip bounds eps and 1 - eps
// as fp32. Returns the first CUDA error (0 = launched); nothing is
// synchronised.
int evl_fused(const float* u, const float* v, float* out, float* du, int W,
              int N, float beta0, float beta1, float gamma, float lo,
              float hi, int reduce, void* stream) {
  const EvlParams p{beta0, beta1, gamma, lo, hi};
  const int rows = W < kRowsPerBlock ? W : kRowsPerBlock;
  const dim3 grid((W + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kWarp * rows);
  evl_fused_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, v, out, du, W, N, p, reduce);
  return (int)cudaGetLastError();
}

}  // extern "C"
