"""Mamba2 (state-space duality, SSD) block of the model zoo
(``repro.models.ssm``), its forward (serving) half.

Within a chunk the quadratic "dual" form, across chunks a carried
[P, N] state: ``ssd_chunked`` is that scan, routed by device through
``kernels.dispatch.ssd_scan``: on the card the hand-written CUDA kernel,
on the CPU its plain version. In the JAX package the model runs the
plain ``lax.scan`` form and only the kernel tests reach the Pallas
kernel; both compute the same scan. ``ssd_reference`` is the O(L)
sequential oracle, for tests. The decode halves (``ssd_decode_step``,
``conv_decode_step``, ``mamba2_decode``) come with the decode path
(ROADMAP "Next"), as does an initial state for the scan.

Shapes (one SSM group, as in mamba2-370m):
    x  [B, L, H, P]   (H heads, P = head_dim)
    dt [B, L, H]      (positive, after softplus + bias)
    A  [H]            (negative; A = -exp(A_log))
    B_, C_ [B, L, N]  (N = ssm_state)
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.ssd.ref import segsum
from repro_torch.models.layers import rms_norm, silu

__all__ = ["causal_conv1d", "mamba2_apply", "segsum", "ssd_chunked",
           "ssd_reference"]


def ssd_chunked(xd, a, B_, C_, chunk: int = 128):
    """Chunked SSD scan from a zero state: xd [B, L, H, P] (dt-scaled
    inputs); a [B, L, H] (dt * A, negative, float32); B_, C_ [B, L, N].
    Returns (y [B, L, H, P] in xd's dtype, final_state [B, H, P, N]
    float32). The kernel takes contiguous operands, so slices of the
    block's projection are copied first."""
    return dispatch.ssd_scan(xd.contiguous(), a.contiguous(),
                             B_.contiguous(), C_.contiguous(), chunk)


def ssd_reference(xd, a, B_, C_):
    """O(L) sequential oracle (tests only), in float32 (in float64 when
    xd is float64)."""
    Bsz, L, H, P = xd.shape
    N = B_.shape[-1]
    work = torch.float64 if xd.dtype == torch.float64 else torch.float32
    state = torch.zeros((Bsz, H, P, N), dtype=work, device=xd.device)
    ys = []
    for t in range(L):
        state = (state * torch.exp(a[:, t]).to(work)[..., None, None]
                 + torch.einsum("bn,bhp->bhpn", B_[:, t].to(work),
                                xd[:, t].to(work)))
        ys.append(torch.einsum("bn,bhpn->bhp", C_[:, t].to(work), state))
    return torch.stack(ys, dim=1).to(xd.dtype), state


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
