"""Zoo training in the port against the JAX package: ``lm_loss`` and its
gradient, the train step of ``launch.specs`` and the training CLI's zoo
mode, on the CPU.

- ``lm_loss`` and every gradient leaf (``specs.loss_and_grad``) against
  ``jax.value_and_grad(repro.models.transformer.lm_loss)`` for the
  reduced config of every family: Qwen1.5-4B (dense, MHA), Granite-20B
  (dense, MQA), Chameleon-34B (vlm, QK norm), Mixtral-8x7B (moe, its
  window), Mamba2-370M (ssm), Zamba2-2.7B (hybrid) and Whisper-medium
  (audio, with frames). The weights are the JAX init's, with noise on
  every leaf the init sets to a constant, on both sides through
  ``zoo_params_from_numpy``.
- Three ``make_train_step`` steps against the JAX package's, at
  microbatches 1 and 2, the parameters compared after each step; also
  Qwen3-MoE-235B-A22B's reduced config, whose Adam moments and
  accumulated gradients are bf16.
- ``cfg.remat`` on and off give the same bits (loss and gradients), for
  each way the forward groups its blocks.
- ``launch.train --arch qwen1.5-4b --reduced --steps 3 --device cpu``.

Tolerances: the loss at rtol 1e-5 (one fp32 mean); gradients at rtol
1e-4 / atol 1e-6 of fp32 (the same products summed in XLA's order on
one side and oneDNN's on the other, then through every layer's
backward), the scale of the zoo forward's 1e-4. After each train step
Adam's moments, which carry the accumulated, clipped gradients
linearly: mu at rtol 1e-4 / atol 1e-7, nu (a square) at rtol 2e-4 /
atol 1e-10; where they and the accumulated gradients are bf16, at rtol
2^-5 (up to four bf16 steps of 2^-8 to 2^-7: the microbatches' sum, its
division and the moment each rounded on either side; seen: 1.2e-2 in 1
of 262,144 elements) and atol 2^-8 of the leaf's largest (two bf16
microbatch gradients that cancel leave one rounding of theirs; seen:
2.3e-7 where one side summed to 0). The parameters: at most 1 in
1,000 of all elements beyond rtol 1e-4 / atol 1e-6 (with bf16 moments
and 2^-5 x lr x steps more: a bf16 moment carries 2^-8 to 2^-7 of
relative error into each step's m / sqrt(v); beyond rtol 1e-4 / atol
1e-6 alone, 0.24 % of Qwen3-MoE's elements after 3 steps), and none
further than 2 x lr x steps (lr 1e-4). Adam moves an element by about lr a step
whatever its gradient, m / (sqrt(v) + eps): where a gradient element is
rounding noise on both sides (a key bias's exact gradient is 0; an
element within a few eps, 1e-8, of zero; a bf16 sum near 0), the two
sides' steps differ by up to 2 lr (seen: 1 of 262,144 elements of a
dense layer 3.1e-6 off, a Whisper key bias off, a bf16-accumulated
element 9.9e-5 off). A wrong update (its sign, its scale, a lost
microbatch) moves most elements by about lr.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.launch import specs as jspecs
from repro.models import transformer as jtfm
from repro_torch.checkpoint.convert import zoo_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.tokens import synthetic_embedding_batch
from repro_torch.launch import specs, train
from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import build_model
from repro_torch.tree import tree_flatten_with_path, tree_leaves

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-6
LR = 1e-4
ARCHS = ["qwen1.5-4b", "granite-20b", "chameleon-34b", "mixtral-8x7b",
         "mamba2-370m", "zamba2-2.7b", "whisper-medium"]
# the leaves the JAX init sets to a constant, and the noise put on them
NOISE = {"A_log": 0.5, "dt_bias": 0.5, "conv_b": 0.2, "D": 0.2,
         "norm_w": 0.2, "w": 0.2, "b": 0.2, "bq": 0.2, "bk": 0.2,
         "bv": 0.2, "q_norm": 0.2, "k_norm": 0.2}
B, S = 4, 24


def _models(arch, seed=0):
    """(cfg, jcfg, port params, JAX params) of the reduced config: the
    JAX init with noise on every constant leaf, in fp32, and the same
    weights in the port."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    rng = np.random.default_rng(seed)

    def noise(path, a):
        a = np.asarray(a.astype(jnp.float32))
        name = jax.tree_util.keystr(path).rsplit("'", 2)[-2]
        if name in NOISE:
            a = a + NOISE[name] * rng.standard_normal(a.shape)
        return a.astype(np.float32)

    jp = jax.tree_util.tree_map_with_path(
        noise, jtfm.init_lm(jcfg, jax.random.PRNGKey(seed)))
    return cfg, jcfg, zoo_params_from_numpy(cfg, jp, "cpu"), \
        jax.tree.map(jnp.asarray, jp)


def _batch(cfg, seed=0, batch=B):
    """Tokens [batch, S] int32 and, for the audio family, frames."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, S)).astype(np.int32)
    frames = synthetic_embedding_batch(batch, cfg.n_frames, cfg.d_model,
                                       seed=seed) \
        if cfg.family == "audio" else None
    return toks, frames


def _torch(toks, frames):
    return (torch.from_numpy(toks).long(),
            None if frames is None else torch.from_numpy(frames))


def _by_path(jtree) -> dict:
    return {tuple(k.key for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}


def _hold(tree, jtree, what):
    want = _by_path(jtree)
    got = {path: t for path, t in tree_flatten_with_path(tree)}
    assert set(got) == set(want), what
    for path, t in got.items():
        np.testing.assert_allclose(t.float().numpy(), want[path], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {path}")


def _hold_state(state, jstate, bf16, what):
    """Adam's moments (see the module's tolerances)."""
    for name, rtol, atol in (("mu", 1e-4, 1e-7), ("nu", 2e-4, 1e-10)):
        want = _by_path(getattr(jstate, name))
        got = dict(tree_flatten_with_path(getattr(state, name)))
        assert set(got) == set(want), (what, name)
        for path, t in got.items():
            if bf16:
                rtol, atol = 2 ** -5, 2 ** -8 * float(np.abs(want[path]).max())
            np.testing.assert_allclose(
                t.float().numpy(), want[path], rtol=rtol, atol=atol,
                err_msg=f"{what} {name} {path}")


def _hold_params(tree, jtree, steps, bf16, what):
    """Parameters after ``steps`` Adam steps (see the module's
    tolerances)."""
    want = _by_path(jtree)
    got = dict(tree_flatten_with_path(tree))
    assert set(got) == set(want), what
    slack = 2 ** -5 * LR * steps if bf16 else 0.0
    off = n = 0
    for path, t in got.items():
        diff = np.abs(t.float().numpy() - want[path])
        off += int((diff > ATOL + slack + RTOL * np.abs(want[path])).sum())
        n += diff.size
        assert diff.max() <= 2 * LR * steps, (what, path, diff.max())
    assert off <= n * 1e-3, (what, off, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    cfg, jcfg, tparams, jparams = _models(arch, seed=len(arch))
    toks, frames = _batch(cfg, seed=1)
    jfn = jax.jit(jax.value_and_grad(functools.partial(jtfm.lm_loss, jcfg)))
    jloss, jgrads = jfn(jparams, jnp.asarray(toks),
                        None if frames is None else jnp.asarray(frames))
    loss, grads = specs.loss_and_grad(cfg, tparams, *_torch(toks, frames))
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert all(not t.requires_grad for t in tree_leaves(tparams))
    _hold(grads, jgrads, f"{arch} gradient")
    # the gradient reaches every leaf: none is left at zero
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(grads))


@pytest.mark.parametrize("arch,microbatches", [
    ("qwen1.5-4b", 1), ("qwen1.5-4b", 2), ("mixtral-8x7b", 1),
    ("mixtral-8x7b", 2), ("whisper-medium", 2),
    ("qwen3-moe-235b-a22b", 2), ("mamba2-370m", 1), ("zamba2-2.7b", 2)])
def test_train_steps_match_jax(arch, microbatches):
    """Three Adam steps of each package's train step from the same
    weights on the same batches; after each step the loss, Adam's
    moments and the parameters; Adam's step count."""
    cfg, jcfg, tparams, jparams = _models(arch, seed=3)
    step, opt = specs.make_train_step(cfg, lr=LR, microbatches=microbatches)
    jstep, jopt = jspecs.make_train_step(jcfg, lr=LR,
                                         microbatches=microbatches)
    jstep = jax.jit(jstep)
    state, jstate = opt.init(tparams), jopt.init(jparams)
    want_mdt = (torch.bfloat16 if cfg.adam_moment_dtype == "bfloat16"
                else torch.float32)
    assert all(m.dtype == want_mdt for m in tree_leaves(state.mu))
    for i in range(3):
        toks, frames = _batch(cfg, seed=10 + i)
        jargs = (jnp.asarray(toks),) + (
            () if frames is None else (jnp.asarray(frames),))
        jparams, jstate, jloss = jstep(jparams, jstate, *jargs)
        tparams, state, loss = step(tparams, state, *_torch(toks, frames))
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL)
        _hold_state(state, jstate, want_mdt == torch.bfloat16,
                    f"{arch} after step {i}")
        _hold_params(tparams, jparams, i + 1, want_mdt == torch.bfloat16,
                     f"{arch} params after step {i}")
    assert int(state.step) == int(jstate.step) == 3


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mixtral-8x7b",
                                  "mamba2-370m", "zamba2-2.7b",
                                  "whisper-medium"])
def test_remat_on_and_off_give_the_same_bits(arch):
    """Rematerialization recomputes each block's forward in the backward
    (a layer; the hybrid's stage; the audio family's encoder and decoder
    layers): the same loss and gradients, bit for bit."""
    cfg, _, tparams, _ = _models(arch, seed=4)
    assert cfg.remat
    toks, frames = _torch(*_batch(cfg, seed=5))
    loss, grads = specs.loss_and_grad(cfg, tparams, toks, frames)
    loss0, grads0 = specs.loss_and_grad(dataclasses.replace(cfg, remat=False),
                                        tparams, toks, frames)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                 tree_leaves(grads0)))


def test_unstacked_layers_keep_the_forward_bits():
    """The forward takes each stacked leaf's layers once by unbind; the
    logits are those of the same layers taken one by one."""
    cfg, _, tparams, _ = _models("qwen1.5-4b", seed=6)
    toks, _ = _torch(*_batch(cfg, seed=6))
    got, _ = tfm.lm_forward(cfg, tparams, toks)
    layers = tfm._unstack(tparams["layers"])
    assert len(layers) == cfg.n_layers
    for i, lp in enumerate(layers):
        for (path, t) in tree_flatten_with_path(lp):
            whole = tparams["layers"]
            for key in path:
                whole = whole[key]
            assert torch.equal(t, whole[i])
    x = tfm._embed(cfg, tparams, toks)
    pos = torch.arange(S)[None, :].expand(B, S)
    for i in range(cfg.n_layers):
        lp = {k: {n: t[i] for n, t in v.items()} if isinstance(v, dict)
              else v[i] for k, v in tparams["layers"].items()}
        x, _ = tfm._decoder_block(cfg, lp, x, pos, None)
    x = tfm.apply_norm(x, tparams["final_norm"], cfg.norm)
    assert torch.equal(got, x @ tparams["lm_head"])


def test_model_zoo_loss_is_lm_loss():
    cfg, _, tparams, _ = _models("mixtral-8x7b", seed=7)
    toks, _ = _torch(*_batch(cfg, seed=7))
    assert torch.equal(build_model(cfg).loss(tparams, toks),
                       tfm.lm_loss(cfg, tparams, toks))


def test_train_cli_trains_a_reduced_zoo_model(capsys):
    losses = train.main(["--arch", "qwen1.5-4b", "--reduced", "--steps",
                         "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "qwen1.5-4b-smoke:" in out and "step 0: loss" in out
    final = float(out.split("final loss ")[1].split()[0])
    assert len(losses) == 3 and np.isfinite(final)
    assert final == pytest.approx(losses[-1], abs=1e-4)
