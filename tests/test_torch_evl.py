"""The port's Extreme Value Loss (``repro_torch.extreme.evl`` over
``repro_torch.kernels.evl``) against the JAX package's: the loss
(mean, sum, none) against ``repro.extreme.evl.evl_loss`` and the Pallas
kernel in interpret mode, its gradient against ``jax.grad``, the edge
values of u included; the fused kernel's plain version (the reduced
loss and its dL/du) and the autograd Function around it, applied on the
CPU, against the same; the device route; and, on a card, the fused
kernel against its plain version.

The JAX package is imported inside the parity tests only, so that the
``cuda`` tests also run on a machine with a card and no jax:
``python -m pytest -q -m cuda tests/test_torch_evl.py``."""

import numpy as np
import pytest
import torch

from repro_torch.extreme import evl as tevl
from repro_torch.kernels import dispatch
from repro_torch.kernels.evl import kernel as evl_kernel
from repro_torch.kernels.evl.ops import EVLFunction, evl_loss
from repro_torch.kernels.evl.ref import (evl_grad_ref, evl_loss_and_grad_ref,
                                         evl_loss_ref, reduce_rows)

RTOL, ATOL = 1e-5, 1e-7      # tests/test_kernels.py's EVL tolerance
EPS = 1e-7
EDGES = [0.0, EPS, float(np.float32(1.0 - EPS)), 1.0]
BETAS = (0.93, 0.07, 2.0)


def _uv(n, seed=0, edges=True):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.0, n).astype(np.float32)
    if edges:
        u[:4] = EDGES
    v = (rng.uniform(size=n) < 0.3).astype(np.float32)
    v[:8] = [0, 0, 0, 0, 1, 1, 1, 1]
    if edges:
        u[4:8] = EDGES
    return u, v


@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
def test_loss_matches_reference_and_pallas_kernel(reduce):
    import jax.numpy as jnp

    from repro.extreme.evl import evl_loss as jax_evl_loss
    from repro.kernels.evl.ops import evl_loss_fused

    u, v = _uv(37)
    got = tevl.evl_loss(torch.from_numpy(u), torch.from_numpy(v), *BETAS,
                        reduce=reduce)
    want = jax_evl_loss(jnp.asarray(u), jnp.asarray(v), *BETAS, reduce=reduce)
    fused = evl_loss_fused(jnp.asarray(u), jnp.asarray(v), *BETAS,
                           reduce=reduce)
    assert tuple(got.shape) == tuple(np.shape(want))
    for other in (want, fused):
        np.testing.assert_allclose(got.numpy(), np.asarray(other),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
def test_gradient_matches_jax_grad_at_the_edges(reduce):
    """Ties at u == eps and u == 1 - eps pass half the gradient in both
    (jnp.clip; torch.maximum/minimum), none outside [eps, 1 - eps]."""
    import jax
    import jax.numpy as jnp

    from repro.extreme.evl import evl_loss as jax_evl_loss

    u, v = _uv(37, seed=1)
    g = np.random.default_rng(2).uniform(0.5, 1.5, 37).astype(np.float32)
    ju = jnp.asarray(u)

    def jloss(uu):
        out = jax_evl_loss(uu, jnp.asarray(v), *BETAS, reduce=reduce)
        return jnp.sum(out * jnp.asarray(g)) if reduce == "none" else out

    want = np.asarray(jax.grad(jloss)(ju))
    tu = torch.from_numpy(u).requires_grad_(True)
    out = tevl.evl_loss(tu, torch.from_numpy(v), *BETAS, reduce=reduce)
    (out * torch.from_numpy(g) if reduce == "none" else out).sum().backward()
    np.testing.assert_allclose(tu.grad.numpy(), want, rtol=RTOL, atol=ATOL)
    assert tu.grad[0] == 0 and tu.grad[3] == 0        # clipped away
    assert want[1] != 0 and want[2] != 0              # the halved ties


@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
def test_function_backward_matches_autograd_of_plain_version(reduce):
    """On the card EVLFunction's gradient is the closed-form dL/du, scaled
    for the reduction, times the incoming gradient; its plain version
    (what the kernel is held against on the card) equals torch autograd
    through the plain loss."""
    W, N = 3, 32
    u = np.stack([_uv(N, seed=s)[0] for s in range(W)])
    v = np.stack([_uv(N, seed=s)[1] for s in range(W)])
    g = np.random.default_rng(3).uniform(0.5, 1.5,
                                         (W, N) if reduce == "none" else W)
    g = torch.from_numpy(g.astype(np.float32))
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    scale = {"none": g, "sum": g[:, None], "mean": g[:, None] / N}[reduce]
    du = evl_grad_ref(tu, tv, *BETAS, EPS) * scale
    u2 = tu.clone().requires_grad_(True)
    (evl_loss(u2, tv, *BETAS, EPS, reduce) * g).sum().backward()
    torch.testing.assert_close(du, u2.grad, rtol=RTOL, atol=ATOL)


def test_rows_are_vmapped_reference():
    """u [W, N] gives one loss per row: ``jax.vmap(evl_loss)``."""
    import jax
    import jax.numpy as jnp

    from repro.extreme.evl import evl_loss as jax_evl_loss

    u = np.stack([_uv(16, seed=s, edges=False)[0] for s in range(4)])
    v = np.stack([_uv(16, seed=s, edges=False)[1] for s in range(4)])
    want = jax.vmap(lambda a, b: jax_evl_loss(a, b, *BETAS))(
        jnp.asarray(u), jnp.asarray(v))
    got = tevl.evl_loss(torch.from_numpy(u), torch.from_numpy(v), *BETAS)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
def test_no_rows_give_an_empty_loss_like_the_reference(reduce):
    """W = 0: the loss is empty, [0] for mean and sum and [0, N] for
    none, as ``jax.vmap`` of the reference gives it; under autograd (the
    plain route and ``EVLFunction`` applied on the CPU) the gradient is
    [0, N]."""
    import jax
    import jax.numpy as jnp

    from repro.extreme.evl import evl_loss as jax_evl_loss

    u = np.zeros((0, 32), np.float32)
    want = jax.vmap(lambda a, b: jax_evl_loss(a, b, *BETAS, reduce=reduce))(
        jnp.asarray(u), jnp.asarray(u))
    tu, tv = torch.from_numpy(u), torch.from_numpy(u)
    for loss in (lambda a: evl_loss(a, tv, *BETAS, EPS, reduce),
                 lambda a: EVLFunction.apply(a, tv, *BETAS, EPS, reduce),
                 lambda a: tevl.evl_loss(a, tv, *BETAS, EPS, reduce)):
        assert tuple(loss(tu).shape) == tuple(want.shape)
        ug = tu.clone().requires_grad_(True)
        out = loss(ug)
        assert tuple(out.shape) == tuple(want.shape)
        out.sum().backward()
        assert tuple(ug.grad.shape) == (0, 32)


def test_weights_and_bce_match_reference():
    import jax.numpy as jnp

    from repro.extreme import evl as jevl

    u, v = _uv(21, seed=4)
    for got, want in zip(tevl.evl_weights(u, v, *BETAS),
                         jevl.evl_weights(jnp.asarray(u), jnp.asarray(v),
                                          *BETAS)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    for reduce in ("mean", "sum", "none"):
        np.testing.assert_allclose(
            tevl.bce_loss(u, v, reduce=reduce).numpy(),
            np.asarray(jevl.bce_loss(jnp.asarray(u), jnp.asarray(v),
                                     reduce=reduce)), rtol=RTOL, atol=ATOL)


def test_grad_ref_matches_autograd_of_loss_ref():
    u, v = _uv(64, seed=5)
    tu = torch.from_numpy(u).requires_grad_(True)
    evl_loss_ref(tu, torch.from_numpy(v), *BETAS).sum().backward()
    torch.testing.assert_close(
        evl_grad_ref(torch.from_numpy(u), torch.from_numpy(v), *BETAS),
        tu.grad, rtol=RTOL, atol=ATOL)


def test_cpu_tensor_takes_plain_route_and_launches_nothing():
    u, v = (torch.from_numpy(a) for a in _uv(32))
    evl_kernel.EVL_LAUNCHES.reset()
    uu = u[None].clone().requires_grad_(True)
    dispatch.evl_loss(uu, v[None], *BETAS).sum().backward()
    EVLFunction.apply(uu, v[None], *BETAS, EPS, "mean").sum().backward()
    assert evl_kernel.EVL_LAUNCHES.total == 0


def _rows(W, N, seed=0):
    """u, v [W, N] with u at 0, eps, 1 - eps and 1 in every row."""
    u = np.stack([_uv(N, seed=seed + s)[0] for s in range(W)])
    v = np.stack([_uv(N, seed=seed + s)[1] for s in range(W)])
    return u, v


def _jax_rows(u, v, g, reduce):
    """The JAX package on u, v [W, N]: the loss rows of
    ``jax.vmap(evl_loss)``, the Pallas kernel's (interpret mode) row by
    row, and ``jax.grad`` of the rows weighted by g."""
    import jax
    import jax.numpy as jnp

    from repro.extreme.evl import evl_loss as jax_evl_loss
    from repro.kernels.evl.ops import evl_loss_fused

    ju, jv = jnp.asarray(u), jnp.asarray(v)

    def rows(uu):
        return jax.vmap(lambda a, b: jax_evl_loss(a, b, *BETAS, EPS,
                                                  reduce))(uu, jv)

    fused = np.stack([np.asarray(evl_loss_fused(ju[w], jv[w], *BETAS,
                                                reduce=reduce))
                      for w in range(u.shape[0])])
    grad = jax.grad(lambda uu: jnp.sum(rows(uu) * jnp.asarray(g)))(ju)
    return np.asarray(rows(ju)), fused, np.asarray(grad)


def _incoming(W, N, reduce, seed=7):
    return np.random.default_rng(seed).uniform(
        0.5, 1.5, (W, N) if reduce == "none" else W).astype(np.float32)


@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
def test_loss_and_grad_ref_matches_jax(reduce):
    """The fused kernel's plain version: its loss rows against
    ``jax.vmap(evl_loss)`` and the Pallas kernel, ``du_unit`` times the
    incoming gradient against ``jax.grad``, u at the clip's edges."""
    W, N = 3, 37
    u, v = _rows(W, N)
    g = _incoming(W, N, reduce)
    want, fused, grad = _jax_rows(u, v, g, reduce)
    loss, du = evl_loss_and_grad_ref(torch.from_numpy(u),
                                     torch.from_numpy(v), *BETAS, EPS,
                                     reduce)
    assert tuple(loss.shape) == want.shape and du.shape == (W, N)
    for other in (want, fused):
        np.testing.assert_allclose(loss.numpy(), other, rtol=RTOL, atol=ATOL)
    scale = torch.from_numpy(g if reduce == "none" else g[:, None])
    np.testing.assert_allclose((du * scale).numpy(), grad, rtol=RTOL,
                               atol=ATOL)
    assert du[:, 0].eq(0).all() and du[:, 3].eq(0).all()  # clipped away
    assert du[:, 1].ne(0).all() and du[:, 2].ne(0).all()  # halved ties


@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
def test_function_on_cpu_matches_jax_grad(reduce):
    """EVLFunction applied to CPU tensors: the plain fused forward and the
    multiply-only backward, against the JAX package's loss and
    ``jax.grad``."""
    W, N = 4, 32
    u, v = _rows(W, N, seed=10)
    g = _incoming(W, N, reduce, seed=8)
    want, _, grad = _jax_rows(u, v, g, reduce)
    tu = torch.from_numpy(u).requires_grad_(True)
    out = EVLFunction.apply(tu, torch.from_numpy(v), *BETAS, EPS, reduce)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tu.grad.numpy(), grad, rtol=RTOL, atol=ATOL)


def test_wrapper_rejects_bad_arguments():
    u, v = (torch.from_numpy(a) for a in _uv(8))
    with pytest.raises(ValueError, match="\\[W, N\\]"):
        evl_loss(u, v, *BETAS)
    with pytest.raises(ValueError, match="reduce"):
        evl_loss(u[None], v[None], *BETAS, reduce="max")
    with pytest.raises(ValueError, match="one device"):
        evl_loss(u[None], v[None].to("meta"), *BETAS)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
@pytest.mark.parametrize("W,N", [(1, 32), (4, 32), (2, 300), (40, 32)])
def test_cuda_kernels_match_plain_version(W, N, reduce):
    """The fused kernel's loss and ``du_unit`` against
    ``evl_loss_and_grad_ref``, u at the clip's edges in every row; the
    wrapper's gradient against autograd of the plain loss, in one
    launch. At gamma 2 and 1.5 (where the weight's power, taken as
    ``pow(a, gamma - 1) * a``, is not exact); W = 40 is two blocks, the
    last one partly empty."""
    _card()
    u, v = _rows(W, N)
    tu, tv = torch.from_numpy(u).cuda(), torch.from_numpy(v).cuda()
    g = torch.from_numpy(_incoming(W, N, reduce, seed=6)).cuda()
    for betas in (BETAS, BETAS[:2] + (1.5,)):
        out, du = evl_kernel.evl_cuda(tu, tv, *betas, EPS, reduce, True)
        want, dwant = evl_loss_and_grad_ref(tu, tv, *betas, EPS, reduce)
        torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(du, dwant, rtol=RTOL, atol=ATOL)
        uk = tu.clone().requires_grad_(True)
        ur = tu.clone().requires_grad_(True)
        before = evl_kernel.EVL_LAUNCHES.total
        got = evl_loss(uk, tv, *betas, EPS, reduce)
        ref = reduce_rows(evl_loss_ref(ur, tv, *betas, EPS), reduce)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
        (got * g).sum().backward()
        (ref * g).sum().backward()
        torch.cuda.synchronize()
        torch.testing.assert_close(uk.grad, ur.grad, rtol=RTOL, atol=ATOL)
        assert evl_kernel.EVL_LAUNCHES.total == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
def test_cuda_rows_do_not_depend_on_W(reduce):
    """A row of a W = 4 launch has the bits of the same row launched
    alone, loss and ``du_unit``."""
    _card()
    u, v = (torch.from_numpy(a).cuda() for a in _rows(4, 32, seed=3))
    out, du = evl_kernel.evl_cuda(u, v, *BETAS, EPS, reduce, True)
    for w in range(4):
        one, done = evl_kernel.evl_cuda(u[w:w + 1].contiguous(),
                                        v[w:w + 1].contiguous(), *BETAS,
                                        EPS, reduce, True)
        assert torch.equal(one[0], out[w]) and torch.equal(done[0], du[w])


@pytest.mark.cuda
def test_cuda_loss_is_the_same_on_every_run():
    _card()
    u = torch.rand(4, 32, generator=torch.Generator().manual_seed(0)).cuda()
    v = (u > 0.7).float()
    first = evl_loss(u, v, *BETAS)
    _, dfirst = evl_kernel.evl_cuda(u, v, *BETAS, EPS, "mean", True)
    for _ in range(5):
        assert torch.equal(evl_loss(u, v, *BETAS), first)
        assert torch.equal(
            evl_kernel.evl_cuda(u, v, *BETAS, EPS, "mean", True)[1], dfirst)


@pytest.mark.cuda
def test_cuda_call_without_grad_writes_no_gradient():
    """Without grad the wrapper launches the loss alone: one launch, no
    gradient output."""
    _card()
    u, v = (torch.from_numpy(a).cuda() for a in _rows(4, 32))
    before = evl_kernel.EVL_LAUNCHES.total
    out, du = evl_kernel.evl_cuda(u, v, *BETAS, EPS, "mean", False)
    assert du is None
    torch.testing.assert_close(out, evl_loss_and_grad_ref(
        u, v, *BETAS, EPS, "mean")[0], rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        got = evl_loss(u.clone().requires_grad_(True), v, *BETAS)
    assert got.grad_fn is None and torch.equal(got, out)
    assert evl_kernel.EVL_LAUNCHES.total == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
def test_cuda_no_rows_launch_nothing(reduce):
    """W = 0 on the card: an empty loss on the card ([0], or [0, N] for
    none) and under autograd a [0, N] gradient, with no launch (CUDA
    refuses a grid of 0 blocks)."""
    _card()
    u = torch.zeros((0, 32), device="cuda")
    want = (0, 32) if reduce == "none" else (0,)
    before = evl_kernel.EVL_LAUNCHES.total
    out = evl_loss(u, u, *BETAS, EPS, reduce)
    assert tuple(out.shape) == want and out.is_cuda
    ug = u.clone().requires_grad_(True)
    out = evl_loss(ug, u, *BETAS, EPS, reduce)
    assert tuple(out.shape) == want
    out.sum().backward()
    assert tuple(ug.grad.shape) == (0, 32) and ug.grad.is_cuda
    torch.cuda.synchronize()
    assert evl_kernel.EVL_LAUNCHES.total == before


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back():
    _card()
    u, v = (torch.from_numpy(a).cuda()[None] for a in _uv(32))
    before = evl_kernel.EVL_LAUNCHES.total
    with pytest.raises(TypeError, match="float32"):
        evl_loss(u.double(), v, *BETAS)
    with pytest.raises(ValueError, match="contiguous"):
        evl_loss(u.repeat(2, 1)[:, ::2], v.repeat(2, 1)[:, ::2], *BETAS)
    with pytest.raises(ValueError, match="one device"):
        evl_loss(u, v.cpu(), *BETAS)
    assert evl_kernel.EVL_LAUNCHES.total == before
