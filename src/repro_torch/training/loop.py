"""Training loops for the paper's stock-prediction experiments (the port
of ``repro.training.loop``).

- ``train_rnn_serial``: the single-node baseline (the paper's reference
  point).
- ``train_rnn_local_sgd``: the proposed framework (n workers, linearly
  increasing rounds, model exchange, optional staleness) through
  ``repro_torch.core.AsyncLocalSGD``.

Both build the same loss: MSE on the next-step prediction, optionally
plus the EVL on the extreme-indicator head (through the EVL kernel on
the card), optionally with per-sample weights. Batches are drawn with
the reference's numpy order and wrap, so from the same ``init_params``
and seed the port sees the reference's batches. The reference draws its
initial weights from ``jax.random.PRNGKey(seed)``, which torch cannot
reproduce: pass them as ``init_params``
(``repro_torch.checkpoint.convert.params_from_numpy``); without it the
port's ``init_rnn`` runs from a ``torch.Generator`` seeded with
``seed``. Both run on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.async_local_sgd import (AsyncLocalSGD, LocalSGDConfig,
                                              to_device, value_and_grad,
                                              worker_mean)
from repro_torch.core.schedules import SampleSchedule, StepSizeSchedule
from repro_torch.data.sharding import client_splits
from repro_torch.data.windows import WindowDataset
from repro_torch.device import resolve_device
from repro_torch.extreme.evl import evl_loss
from repro_torch.extreme.indicators import extreme_fractions
from repro_torch.models.rnn import RNNConfig, init_rnn, rnn_apply
from repro_torch.optim.optimizers import Optimizer, apply_updates, sgd
from repro_torch.training.metrics import extreme_event_metrics, mse
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass
class TrainResult:
    params: PyTree
    loss_history: list
    test_mse: float
    test_extreme: dict
    communications: int
    iterations: int
    comm_bytes: int = 0


def make_loss_fn(cfg: RNNConfig, evl_weight: float = 0.0,
                 beta0: float = 0.95, beta1: float = 0.05,
                 gamma: float = 2.0, l2: float = 0.0):
    """batch = (x, y, v, w): windows, targets, indicators, sample weights.
    With unstacked params and x [B, T, I] the loss is a scalar; with
    worker-stacked params and x [W, B, T, I] it is [W], one per worker."""

    def loss_fn(params, batch):
        x, y, v, w = batch
        stacked = x.dim() == 4
        pred, u = rnn_apply(params, x, cfg)
        per = torch.square(pred - y)
        loss = torch.mean(per * w, dim=-1)
        if evl_weight > 0.0 and u is not None:
            vbin = (torch.abs(v) > 0).to(torch.float32)
            loss = loss + evl_weight * evl_loss(u, vbin, beta0, beta1, gamma)
        if l2 > 0.0:
            sq = sum(torch.square(p).flatten(1 if stacked else 0).sum(dim=-1)
                     for p in tree_leaves(params))
            loss = loss + 0.5 * l2 * sq
        return loss

    return loss_fn


def _batch_arrays(ds: WindowDataset, idx: np.ndarray, weights=None):
    w = (weights[idx] if weights is not None
         else np.ones(len(idx), np.float32))
    return (ds.x[idx], ds.y[idx], ds.v.astype(np.float32)[idx], w)


def _stack_batches(ds, order, pos, n, batch, weights=None):
    """n consecutive batches starting at cursor pos (wrapping)."""
    out = []
    for i in range(n):
        start = (pos + i * batch) % max(len(order) - batch, 1)
        out.append(_batch_arrays(ds, order[start:start + batch], weights))
    return tuple(np.stack([b[i] for b in out]) for i in range(4))


def _initial_params(init_params, cfg: RNNConfig, seed: int, device):
    if init_params is None:
        return init_rnn(torch.Generator().manual_seed(seed), cfg, device)
    return tree_map(lambda a: torch.as_tensor(a).to(device), init_params)


def evaluate(params, cfg: RNNConfig, ds: WindowDataset) -> tuple[float, dict]:
    device = tree_leaves(params)[0].device
    with torch.no_grad():
        pred, u = rnn_apply(params, torch.from_numpy(ds.x).to(device), cfg)
    test_mse = mse(pred, ds.y)
    ext = (extreme_event_metrics(u.cpu().numpy(), ds.v)
           if u is not None else {})
    return test_mse, ext


def _loss_fn_for(train_ds, cfg, evl_weight):
    fr = extreme_fractions(train_ds.v)
    return make_loss_fn(cfg, evl_weight, beta0=fr["normal"],
                        beta1=max(fr["right"] + fr["left"], 1e-3))


def train_rnn_serial(train_ds: WindowDataset, test_ds: WindowDataset,
                     cfg: RNNConfig | None = None, iterations: int = 2000,
                     batch: int = 32, optimizer: Optimizer | None = None,
                     stepsize: StepSizeSchedule | None = None,
                     evl_weight: float = 0.0, weights=None,
                     seed: int = 0, init_params: PyTree | None = None,
                     device="cuda") -> TrainResult:
    """Single-compute-node baseline: plain SGD with the paper's
    diminishing step size."""
    device = resolve_device(device)
    cfg = cfg or RNNConfig()
    stepsize = stepsize or StepSizeSchedule()
    loss_fn = _loss_fn_for(train_ds, cfg, evl_weight)
    opt = optimizer or sgd(momentum=0.0)
    params = _initial_params(init_params, cfg, seed, device)
    opt_state = opt.init(params)

    rng = np.random.default_rng(seed)
    order = np.arange(len(train_ds))
    rng.shuffle(order)
    losses = []
    pos = 0
    for t in range(iterations):
        if pos + batch > len(order):
            rng.shuffle(order)
            pos = 0
        b = to_device(_batch_arrays(train_ds, order[pos:pos + batch],
                                     weights), device)
        pos += batch
        loss, grads = value_and_grad(loss_fn, params, b)
        with torch.no_grad():
            upd, opt_state = opt.update(grads, opt_state, params,
                                        float(stepsize(t)))
            params = apply_updates(params, upd)
        losses.append(loss)
    # one device-to-host copy for the whole history
    history = torch.stack(losses).tolist() if losses else []

    test_mse, ext = evaluate(params, cfg, test_ds)
    return TrainResult(params=params, loss_history=history,
                       test_mse=test_mse, test_extreme=ext, communications=0,
                       iterations=iterations)


def train_rnn_local_sgd(train_ds: WindowDataset, test_ds: WindowDataset,
                        n_workers: int = 2, cfg: RNNConfig | None = None,
                        iterations: int = 2000, batch: int = 32,
                        schedule: SampleSchedule | None = None,
                        stepsize: StepSizeSchedule | None = None,
                        optimizer: Optimizer | None = None,
                        tau: int = 0, split: str = "iid",
                        evl_weight: float = 0.0, seed: int = 0,
                        round_callback=None,
                        init_params: PyTree | None = None,
                        device="cuda") -> TrainResult:
    """The paper's framework over worker-stacked params: all W workers'
    local steps run together, one cell launch per time step.

    ``round_callback(round_idx, avg_params)``, when given, is called after
    every cross-worker exchange with that round's worker-averaged (single
    model) params: the online-learning hook."""
    device = resolve_device(device)
    cfg = cfg or RNNConfig()
    loss_fn = _loss_fn_for(train_ds, cfg, evl_weight)
    opt = optimizer or sgd(momentum=0.0)
    lcfg = LocalSGDConfig(
        n_workers=n_workers, tau=tau,
        schedule=schedule or SampleSchedule(),
        stepsize=stepsize or StepSizeSchedule())
    trainer = AsyncLocalSGD(loss_fn, opt, lcfg)
    stacked, opt_state = trainer.init(
        _initial_params(init_params, cfg, seed, device))

    splits = client_splits(len(train_ds), n_workers, mode=split, seed=seed)
    rng = np.random.default_rng(seed)
    orders = [s.copy() for s in splits]
    for o in orders:
        rng.shuffle(o)
    cursors = [0] * n_workers

    round_i = 0
    while trainer.iterations_done < iterations:
        round_i += 1
        h = trainer.local_steps_for_round(round_i)
        per_worker = []
        for wkr in range(n_workers):
            bw = _stack_batches(train_ds, orders[wkr], cursors[wkr], h, batch)
            cursors[wkr] = (cursors[wkr] + h * batch) % max(
                len(orders[wkr]) - batch, 1)
            per_worker.append(bw)
        batches = tuple(np.stack([pw[i] for pw in per_worker])
                        for i in range(4))
        stacked, opt_state, _ = trainer.run_round(stacked, opt_state, batches)
        if round_callback is not None:
            round_callback(round_i, worker_mean(stacked))

    final = tree_map(lambda a: a[0], stacked)
    test_mse, ext = evaluate(final, cfg, test_ds)
    return TrainResult(params=final, loss_history=trainer.loss_history,
                       test_mse=test_mse, test_extreme=ext,
                       communications=trainer.communications,
                       iterations=trainer.iterations_done,
                       comm_bytes=trainer.communication_bytes(stacked))
