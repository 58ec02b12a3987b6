"""The port's optimizers (``repro_torch.optim.optimizers``) against the
JAX package's, on the same numpy params and gradients: one update and
several, SGD (momentum, weight decay, clipping) and Adam, the global
norm, and the worker-stacked form against ``jax.vmap`` of the
reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_leaves, tree_map

RTOL, ATOL = 1e-5, 1e-6


def _tree(seed, lead=()):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(lead + s).astype(np.float32)
    return {"lstm": [{"wx": f(3, 8), "b": f(8)}], "out": {"w": f(4, 1)}}


def _to_torch(tree):
    return tree_map(torch.from_numpy, tree)


def _assert_close(got, want):
    """Leaf by leaf, matched by position in the nest (jax orders a dict's
    leaves by key, the port by insertion)."""
    assert len(tree_leaves(got)) == len(jax.tree_util.tree_leaves(want))
    tree_map(lambda a, b: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL), got, want)


OPTIMIZERS = {
    "sgd": (lambda: topt.sgd(), lambda: jopt.sgd()),
    "sgd-momentum-wd": (lambda: topt.sgd(momentum=0.9, weight_decay=0.01),
                        lambda: jopt.sgd(momentum=0.9, weight_decay=0.01)),
    "sgd-clip": (lambda: topt.sgd(momentum=0.5, clip_norm=0.5),
                 lambda: jopt.sgd(momentum=0.5, clip_norm=0.5)),
    "adam": (lambda: topt.adam(), lambda: jopt.adam()),
    "adam-wd-clip": (lambda: topt.adam(weight_decay=0.01, clip_norm=1.0),
                     lambda: jopt.adam(weight_decay=0.01, clip_norm=1.0)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("steps", [1, 5])
def test_updates_match_reference(name, steps):
    make_t, make_j = OPTIMIZERS[name]
    topt_, jopt_ = make_t(), make_j()
    tp, jp = _to_torch(_tree(0)), jax.tree.map(jnp.asarray, _tree(0))
    ts, js = topt_.init(tp), jopt_.init(jp)
    for i in range(steps):
        grads = _tree(10 + i)
        lr = 0.05 / (1 + i)
        tu, ts = topt_.update(_to_torch(grads), ts, tp, lr)
        ju, js = jopt_.update(jax.tree.map(jnp.asarray, grads), js, jp, lr)
        _assert_close(tu, ju)
        tp = topt.apply_updates(tp, tu)
        jp = jopt.apply_updates(jp, ju)
    _assert_close(tp, jp)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_worker_stacked_updates_match_vmapped_reference(name):
    """``update(..., workers=True)`` on [W, ...] nests is the reference's
    optimizer under ``jax.vmap``: clipping norms and Adam's bias
    correction per worker."""
    W = 3
    make_t, make_j = OPTIMIZERS[name]
    topt_, jopt_ = make_t(), make_j()
    params = _tree(1, lead=(W,))
    tp, jp = _to_torch(params), jax.tree.map(jnp.asarray, params)
    ts = tree_map(lambda a: a.unsqueeze(0).expand((W,) + tuple(a.shape))
                  .contiguous(), topt_.init(tree_map(lambda a: a[0], tp)))
    js = jax.vmap(jopt_.init)(jp)
    vupd = jax.vmap(jopt_.update, in_axes=(0, 0, 0, None))
    for i in range(3):
        # one worker's gradients far larger, so only its norm clips
        grads = _tree(20 + i, lead=(W,))
        grads = jax.tree.map(lambda g: g * np.array([1, 30, 1], np.float32)
                             .reshape((W,) + (1,) * (g.ndim - 1)), grads)
        tu, ts = topt_.update(_to_torch(grads), ts, tp, 0.05, workers=True)
        ju, js = vupd(jax.tree.map(jnp.asarray, grads), js, jp, 0.05)
        _assert_close(tu, ju)
        tp, jp = topt.apply_updates(tp, tu), jopt.apply_updates(jp, ju)


def test_global_norm_and_clip_match_reference():
    tree = _tree(2)
    np.testing.assert_allclose(float(topt.global_norm(_to_torch(tree))),
                               float(jopt.global_norm(tree)), rtol=RTOL)
    for max_norm in (0.1, 1e6):
        _assert_close(topt.clip_by_global_norm(_to_torch(tree), max_norm),
                      jopt.clip_by_global_norm(
                          jax.tree.map(jnp.asarray, tree), max_norm))
    stacked = _tree(3, lead=(4,))
    per = topt.global_norm(_to_torch(stacked), workers=True)
    want = jax.vmap(jopt.global_norm)(jax.tree.map(jnp.asarray, stacked))
    np.testing.assert_allclose(per.numpy(), np.asarray(want), rtol=RTOL)
    assert float(topt.global_norm({})) == 0.0
