"""Mamba2 (state-space duality, SSD) block of the model zoo
(``repro.models.ssm``): the forward and the decode path.

Within a chunk the quadratic "dual" form, across chunks a carried
[P, N] state: ``ssd_chunked`` is that scan, routed by device through
``kernels.dispatch.ssd_scan``: on the card the hand-written CUDA kernel,
on the CPU its plain version. In the JAX package the model runs the
plain ``lax.scan`` form and only the kernel tests reach the Pallas
kernel; both compute the same scan. A given initial state is folded in
outside the kernel on both devices (``kernels.ssd.ref.fold_state``), as
the TPU kernel's single-chunk entry does. ``ssd_reference`` is the O(L)
sequential oracle, for tests. Decode is the O(1) recurrence, plain
torch in both packages' sense (XLA in the JAX package, no kernel):

    state <- exp(dt*A) * state + (dt*x) outer B
    y     <- C . state + D * x

(``ssd_decode_step``; ``conv_decode_step`` the causal conv's step;
``mamba2_decode`` the whole block for one token).

Shapes (one SSM group, as in mamba2-370m):
    x  [B, L, H, P]   (H heads, P = head_dim)
    dt [B, L, H]      (positive, after softplus + bias)
    A  [H]            (negative; A = -exp(A_log))
    B_, C_ [B, L, N]  (N = ssm_state)
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd.ref import fold_state, segsum
from repro_torch.models.layers import rms_norm, silu

__all__ = ["causal_conv1d", "conv_decode_step", "mamba2_apply",
           "mamba2_decode", "segsum", "ssd_chunked", "ssd_decode_step",
           "ssd_reference"]


def ssd_chunked(xd, a, B_, C_, chunk: int = 128, initial_state=None):
    """Chunked SSD scan: xd [B, L, H, P] (dt-scaled inputs); a [B, L, H]
    (dt * A, negative, float32); B_, C_ [B, L, N]; initial_state
    optional [B, H, P, N]. Returns (y [B, L, H, P] in xd's dtype,
    final_state [B, H, P, N] float32). The scan runs from zero and a
    given state is folded in after it (``fold_state``). The kernel
    takes contiguous operands, so slices of the block's projection are
    copied first."""
    a = a.contiguous()
    C_ = C_.contiguous()
    y, state = dispatch.ssd_scan(xd.contiguous(), a, B_.contiguous(), C_,
                                 chunk)
    if initial_state is None:
        return y, state
    return fold_state(y, state, a, C_, initial_state)


def ssd_reference(xd, a, B_, C_, initial_state=None):
    """O(L) sequential oracle (tests only), in float32 (in float64 when
    xd is float64), from a zero state or ``initial_state``."""
    Bsz, L, H, P = xd.shape
    N = B_.shape[-1]
    work = torch.float64 if xd.dtype == torch.float64 else torch.float32
    state = (torch.zeros((Bsz, H, P, N), dtype=work, device=xd.device)
             if initial_state is None else initial_state.to(work))
    ys = []
    for t in range(L):
        state = (state * torch.exp(a[:, t]).to(work)[..., None, None]
                 + torch.einsum("bn,bhp->bhpn", B_[:, t].to(work),
                                xd[:, t].to(work)))
        ys.append(torch.einsum("bn,bhpn->bhp", C_[:, t].to(work), state))
    return torch.stack(ys, dim=1).to(xd.dtype), state


def ssd_decode_step(state, xd_t, a_t, B_t, C_t):
    """One decode step. state [B, H, P, N] float32; xd_t [B, H, P]; a_t
    [B, H]; B_t, C_t [B, N]. Returns (y_t [B, H, P] in xd_t's dtype,
    new_state float32)."""
    f32 = torch.float32
    decay = torch.exp(a_t.to(f32))[..., None, None]
    state = state * decay + torch.einsum("bn,bhp->bhpn", B_t.to(f32),
                                         xd_t.to(f32))
    y = torch.einsum("bn,bhpn->bhp", C_t.to(f32), state)
    return y.to(xd_t.dtype), state


# -------------------------------------------------------------------------
# Full Mamba2 block (in_proj -> causal conv -> SSD -> gated norm -> out)
# -------------------------------------------------------------------------

def _split_proj(zxbcdt, d_inner, n_state, n_heads):
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * n_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * n_state:]
    if dt.shape[-1] != n_heads:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt columns for "
                         f"{n_heads} heads")
    return z, xBC, dt


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x [B, L, Cdim]; w [Cdim, K]; b [Cdim].
    y[t] = sum_k x[t - K + 1 + k] * w[k] + b, the taps summed in order in
    x's dtype, as the JAX package sums them."""
    K = w.shape[-1]
    L = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:L, :] * w[None, None, :, 0]
    for k in range(1, K):
        out = out + xp[:, k:k + L, :] * w[None, None, :, k]
    return out + b[None, None, :]


def conv_decode_step(conv_state, x_t, w, b):
    """conv_state [B, K-1, Cdim] holds the last K-1 inputs; x_t
    [B, Cdim]. Returns (y [B, Cdim], the new conv state); with K = 1
    the state is empty and returned as it came. The taps are summed in
    order in x's dtype, as ``causal_conv1d`` sums them, so that a
    decoded step's conv is the forward's at that position bit for bit
    (the JAX package's einsum sums them in another order: the same in
    fp32 up to rounding, a bf16 step apart in bf16)."""
    K = w.shape[-1]
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # [B, K, C]
    y = full[:, 0] * w[None, :, 0]
    for k in range(1, K):
        y = y + full[:, k] * w[None, :, k]
    return y + b[None, :], full[:, 1:, :] if K > 1 else conv_state


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, x.new_zeros(()))


def mamba2_apply(p, x, *, head_dim: int, ssm_state: int, chunk: int = 128,
                 dt_limit=(1e-4, 1e2)):
    """Full block forward. x [B, L, D] -> [B, L, D]. In bf16, dt and a
    are float32, dt is rounded to x's dtype before it scales x, and the
    scan's state is float32, as in the JAX package."""
    Bsz, L, D = x.shape
    d_inner = p["out_proj"].shape[0]
    H = d_inner // head_dim
    N = ssm_state

    zxbcdt = x @ p["in_proj"]
    z, xBC, dt = _split_proj(zxbcdt, d_inner, N, H)
    xBC = silu(causal_conv1d(xBC, p["conv_w"], p["conv_b"]))
    xs = xBC[..., :d_inner].reshape(Bsz, L, H, head_dim)
    B_ = xBC[..., d_inner:d_inner + N]
    C_ = xBC[..., d_inner + N:]

    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])
    dt = torch.clamp(dt, *dt_limit)                             # [B, L, H]
    A = -torch.exp(p["A_log"].to(torch.float32))                # [H]
    a = dt * A[None, None, :]
    xd = xs * dt[..., None].to(xs.dtype)

    y, _ = ssd_chunked(xd, a, B_, C_, chunk=chunk)
    y = y + xs * p["D"][None, None, :, None]
    y = y.reshape(Bsz, L, d_inner)
    y = rms_norm(y * silu(z), p["norm_w"])
    return y @ p["out_proj"]


def mamba2_decode(p, x_t, conv_state, ssm_state_arr, *, head_dim: int,
                  ssm_state: int, dt_limit=(1e-4, 1e2)):
    """One-token decode. x_t [B, D]. Returns (y [B, D], conv_state,
    state)."""
    Bsz, D = x_t.shape
    d_inner = p["out_proj"].shape[0]
    H = d_inner // head_dim
    N = ssm_state

    zxbcdt = x_t @ p["in_proj"]
    z, xBC, dt = _split_proj(zxbcdt, d_inner, N, H)
    xBC, conv_state = conv_decode_step(conv_state, xBC, p["conv_w"],
                                       p["conv_b"])
    xBC = silu(xBC)
    xs = xBC[..., :d_inner].reshape(Bsz, H, head_dim)
    B_ = xBC[..., d_inner:d_inner + N]
    C_ = xBC[..., d_inner + N:]

    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])
    dt = torch.clamp(dt, *dt_limit)                             # [B, H]
    A = -torch.exp(p["A_log"].to(torch.float32))
    a_t = dt * A[None, :]
    xd_t = xs * dt[..., None].to(xs.dtype)

    y, ssm_state_arr = ssd_decode_step(ssm_state_arr, xd_t, a_t, B_, C_)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(Bsz, d_inner)
    y = rms_norm(y * silu(z), p["norm_w"])
    return y @ p["out_proj"], conv_state, ssm_state_arr
