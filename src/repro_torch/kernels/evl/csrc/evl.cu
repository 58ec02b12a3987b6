// The Extreme Value Loss (paper eq. 6) and its gradient, fp32, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/evl/kernel.py::_evl_kernel
// (launched by evl_pallas, wrapped by evl/ops.py::evl_loss_fused), an
// elementwise pass whose wrapper then reduces by mean, sum or none.
// Here the reduction is fused in, per worker row: u, v are [W, N] (W
// local-SGD workers, N the batch), and the loss is [W] for mean and sum,
// as jax.vmap(evl_loss) gives one loss per worker, or [W, N] for none.
// Elementwise, with u clipped to [lo, hi] = [eps, 1 - eps]:
//
//     w+ = beta0 * max(1 - u / gamma, 1e-12)^gamma
//     w- = beta1 * max(1 - (1 - u) / gamma, 1e-12)^gamma
//     l  = -w+ * v * log(u) - w- * (1 - v) * log(1 - u)
//
// The backward kernel writes dL/du in closed form, scaled by the
// incoming gradient (g[w] / N for mean, g[w] for sum, g[w, n] for none).
// It follows the JAX package's derivative everywhere, ties included: at
// u == eps or u == 1 - eps exactly the clip passes half the gradient, as
// jnp.clip's maximum/minimum do (and as torch.maximum/minimum do in the
// plain version), and the 1e-12 floors likewise.
//
// Design. One block per worker row. Each thread sums the terms of the
// elements n = tid, tid + 128, ... in that order, then the block adds
// the 128 partial sums in a fixed tree in shared memory: no atomics, so
// the loss has the same bits on every run. N is the batch (32 on the
// paper's path), so one block holds a row.
//
// What bounds it on an H100. A call reads 2 * W * N floats and writes W
// (or W * N): at W = 4, N = 32 about 1 KB, a bound of a fraction of a
// nanosecond. It is bound by its launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

struct EvlParams {
  float beta0, beta1, gamma, lo, hi;
};

// the derivative of max(a, floor) in a: 1 above, 1/2 at the tie, 0 below
__device__ __forceinline__ float dmax(float a, float floor) {
  return a > floor ? 1.0f : (a == floor ? 0.5f : 0.0f);
}

__device__ __forceinline__ float evl_term(float u, float v, EvlParams p) {
  const float uc = fminf(fmaxf(u, p.lo), p.hi);
  const float wp = p.beta0 * powf(fmaxf(1.0f - uc / p.gamma, 1e-12f),
                                  p.gamma);
  const float wn = p.beta1 * powf(fmaxf(1.0f - (1.0f - uc) / p.gamma,
                                        1e-12f), p.gamma);
  return -wp * v * logf(uc) - wn * (1.0f - v) * logf(1.0f - uc);
}

__device__ __forceinline__ float evl_grad(float u, float v, EvlParams p) {
  // d clip(u) / du, ties halved
  const float dclip = (u > p.lo && u < p.hi)
                          ? 1.0f
                          : ((u == p.lo || u == p.hi) ? 0.5f : 0.0f);
  const float uc = fminf(fmaxf(u, p.lo), p.hi);
  const float a = 1.0f - uc / p.gamma;
  const float b = 1.0f - (1.0f - uc) / p.gamma;
  const float ap = fmaxf(a, 1e-12f), bp = fmaxf(b, 1e-12f);
  const float wp = p.beta0 * powf(ap, p.gamma);
  const float wn = p.beta1 * powf(bp, p.gamma);
  // d w+ / du and d w- / du (da/du = -1/gamma, db/du = 1/gamma)
  const float dwp = -p.beta0 * powf(ap, p.gamma - 1.0f) * dmax(a, 1e-12f);
  const float dwn = p.beta1 * powf(bp, p.gamma - 1.0f) * dmax(b, 1e-12f);
  const float dl = -dwp * v * logf(uc) - wp * v / uc
                   - dwn * (1.0f - v) * logf(1.0f - uc)
                   + wn * (1.0f - v) / (1.0f - uc);
  return dl * dclip;
}

// reduce: 0 none, 1 sum, 2 mean
__global__ void __launch_bounds__(THREADS)
evl_forward_kernel(const float* __restrict__ u, const float* __restrict__ v,
                   float* __restrict__ out, int N, EvlParams p, int reduce) {
  __shared__ float part[THREADS];
  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * N;
  float acc = 0.0f;
  for (int n = tid; n < N; n += THREADS) {
    const float l = evl_term(u[row + n], v[row + n], p);
    if (reduce == 0)
      out[row + n] = l;
    else
      acc += l;
  }
  if (reduce == 0) return;
  part[tid] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) part[tid] += part[tid + s];
    __syncthreads();
  }
  if (tid == 0)
    out[blockIdx.x] = reduce == 2 ? part[0] / (float)N : part[0];
}

__global__ void __launch_bounds__(THREADS)
evl_backward_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    const float* __restrict__ g, float* __restrict__ du,
                    int N, EvlParams p, int reduce) {
  const size_t row = (size_t)blockIdx.x * N;
  for (int n = threadIdx.x; n < N; n += THREADS) {
    const float scale = reduce == 0   ? g[row + n]
                        : reduce == 1 ? g[blockIdx.x]
                                      : g[blockIdx.x] / (float)N;
    du[row + n] = evl_grad(u[row + n], v[row + n], p) * scale;
  }
}

}  // namespace

extern "C" {

// Launch the loss of W rows of N on `stream`: u, v [W, N] fp32,
// contiguous, on the device; out [W] (reduce 1 = sum, 2 = mean) or
// [W, N] (reduce 0 = none). lo, hi are the clip bounds eps and 1 - eps
// as fp32. Returns the first CUDA error (0 = launched); nothing is
// synchronised.
int evl_forward(const float* u, const float* v, float* out, int W, int N,
                float beta0, float beta1, float gamma, float lo, float hi,
                int reduce, void* stream) {
  const EvlParams p{beta0, beta1, gamma, lo, hi};
  evl_forward_kernel<<<W, THREADS, 0, (cudaStream_t)stream>>>(u, v, out, N,
                                                              p, reduce);
  return (int)cudaGetLastError();
}

// Launch dL/du on `stream`: g is the incoming gradient, [W] for sum and
// mean, [W, N] for none; du [W, N]. Otherwise as evl_forward.
int evl_backward(const float* u, const float* v, const float* g, float* du,
                 int W, int N, float beta0, float beta1, float gamma,
                 float lo, float hi, int reduce, void* stream) {
  const EvlParams p{beta0, beta1, gamma, lo, hi};
  evl_backward_kernel<<<W, THREADS, 0, (cudaStream_t)stream>>>(u, v, g, du,
                                                               N, p, reduce);
  return (int)cudaGetLastError();
}

}  // extern "C"
