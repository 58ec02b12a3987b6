"""Asynchronous local SGD, the paper's technique: the port of
``repro.core.async_local_sgd``.

Params carry a leading worker dim [W, ...]. Within a round the W
workers each run H local steps and do not communicate; at the round's
end the models (not the gradients) are averaged. With the linearly
increasing sample schedule (s_i = a * i^p + b) the number of
communications for K iterations falls from O(K) to O(sqrt(K))
(Remark 1).

The reference runs ``jax.vmap(worker)`` over a ``lax.scan`` of H steps.
Here a local step runs all W workers at once: ``loss_fn`` takes the
worker-stacked params and a batch whose leaves are [W, B, ...] and
returns the W losses [W] (the paper model's cell is then one kernel
launch per time step for all W workers). The workers' losses are
independent, so the gradient of their sum with respect to worker w's
params is the gradient of worker w's loss.

Staleness (Definition 1): with ``tau >= 1`` the round-r average is
applied at round r + tau, and the worker keeps its local delta since
round r:

    w_w  <-  avg(w^(r)) + (w_w - w_w^(r))        at the end of round r + tau

Exchange modes (paper section VI.(iii) and footnote **):
    "model"    - local updates, models averaged at the round's end;
    "gradient" - gradients averaged every step (synchronous SGD), H = 1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.schedules import SampleSchedule, StepSizeSchedule
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.tree import (stack_workers, tree_leaves, tree_map,
                              tree_unflatten)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class LocalSGDConfig:
    n_workers: int = 2
    tau: int = 0                 # staleness (rounds); 0 = synchronous averaging
    exchange: str = "model"      # "model" | "gradient"
    schedule: SampleSchedule = SampleSchedule()   # s_i (global iterations)
    stepsize: StepSizeSchedule = StepSizeSchedule()

    def __post_init__(self):
        if self.exchange not in ("model", "gradient"):
            raise ValueError(f"unknown exchange mode {self.exchange!r}")
        if self.exchange == "gradient" and self.tau != 0:
            raise ValueError(
                "gradient exchange is synchronous SGD: every step is a "
                "collective, so delayed averaging (tau > 0) does not apply")


# --------------------------------------------------------------------------
# Building blocks
# --------------------------------------------------------------------------

def worker_mean(tree: PyTree) -> PyTree:
    """Average over the leading worker dim: the model exchange."""
    return tree_map(lambda a: a.mean(dim=0), tree)


def broadcast_to_workers(avg: PyTree, like: PyTree) -> PyTree:
    """``avg`` repeated along the worker dim of ``like`` (contiguous)."""
    return tree_map(lambda m, a: m.unsqueeze(0).expand(a.shape)
                    .to(a.dtype).contiguous(), avg, like)


def value_and_grad(loss_fn: Callable, params: PyTree, batch: PyTree):
    """(loss, grads) of ``loss_fn(params, batch)``: for worker-stacked
    params the losses [W] and each worker's gradient in its slice of the
    stacked grads (the gradient of the losses' sum). A param the loss
    does not use gets a zero gradient, as under ``jax.grad``."""
    with torch.enable_grad():
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        loss = loss_fn(p, batch)
        grads = torch.autograd.grad(loss.sum(), tree_leaves(p),
                                    allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def to_device(batches: PyTree, device) -> PyTree:
    """numpy (or tensor) leaves -> tensors on ``device``, one copy each."""
    return tree_map(lambda b: (b if isinstance(b, torch.Tensor) else
                               torch.from_numpy(np.require(b, requirements=(
                                   "C", "W")))).to(device), batches)


def local_sgd_round(loss_fn: Callable, optimizer: Optimizer,
                    stacked_params: PyTree, stacked_opt: PyTree,
                    batches: PyTree, lr):
    """One round: every worker runs H local steps.

    Args:
        loss_fn: (stacked params, batch with leaves [W, B, ...]) -> [W].
        stacked_params / stacked_opt: leading worker dim [W, ...].
        batches: nest with leaves [W, H, ...], worker-major microbatches.
        lr: the step size (bar-eta_i, constant within the round).

    Returns (new_stacked_params, new_stacked_opt, losses [W, H]). The
    caller applies the averaging policy (sync or stale).
    """
    H = tree_leaves(batches)[0].shape[1]
    losses = []
    for i in range(H):
        batch = tree_map(lambda b: b[:, i], batches)
        loss, grads = value_and_grad(loss_fn, stacked_params, batch)
        with torch.no_grad():
            updates, stacked_opt = optimizer.update(
                grads, stacked_opt, stacked_params, lr, workers=True)
            stacked_params = apply_updates(stacked_params, updates)
        losses.append(loss)
    return stacked_params, stacked_opt, torch.stack(losses, dim=1)


def sync_step(loss_fn: Callable, optimizer: Optimizer,
              stacked_params: PyTree, stacked_opt: PyTree,
              batches: PyTree, lr, exchange: str = "gradient"):
    """The synchronous baseline step across workers (batch leaves
    [W, B, ...]).

    exchange="gradient": average the workers' gradients, then update the
    (shared) model: classic distributed SGD. exchange="model": update
    locally, then average the models (the same for plain SGD; it differs
    under clipping or Adam, the paper's footnote-** comparison at H=1).
    """
    if exchange == "gradient":
        losses, grads = value_and_grad(loss_fn, stacked_params, batches)
        with torch.no_grad():
            gavg = worker_mean(grads)
            params0 = tree_map(lambda a: a[0], stacked_params)
            opt0 = tree_map(lambda a: a[0], stacked_opt)
            updates, opt0 = optimizer.update(gavg, opt0, params0, lr)
            params0 = apply_updates(params0, updates)
            return (broadcast_to_workers(params0, stacked_params),
                    broadcast_to_workers(opt0, stacked_opt), losses)
    batches1 = tree_map(lambda b: b[:, None], batches)
    p, o, losses = local_sgd_round(loss_fn, optimizer, stacked_params,
                                   stacked_opt, batches1, lr)
    with torch.no_grad():
        return broadcast_to_workers(worker_mean(p), p), o, losses[:, 0]


# --------------------------------------------------------------------------
# High-level trainer
# --------------------------------------------------------------------------

class AsyncLocalSGD:
    """Host-side round loop of the whole technique: linearly increasing
    rounds, diminishing step size, model exchange, optional delayed
    (stale) averaging, and communication accounting."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 config: LocalSGDConfig):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.cfg = config
        # (avg, snapshot, round index the average was computed at)
        self._avg_queue: list[tuple[PyTree, PyTree, int]] = []
        # accounting
        self.rounds_done = 0
        self.iterations_done = 0
        self.communications = 0
        self.loss_history: list[float] = []
        # Definition 1 audit trail: (round applied at, round averaged at),
        # i.e. each entry asserts "round r consumed the round r - tau avg"
        self.consumed_rounds: list[tuple[int, int]] = []

    def init(self, params: PyTree) -> tuple[PyTree, PyTree]:
        """Worker-stacked params and optimizer state: every worker starts
        from ``params`` and the optimizer's initial state."""
        W = self.cfg.n_workers
        return (stack_workers(params, W),
                stack_workers(self.optimizer.init(params), W))

    def local_steps_for_round(self, i: int) -> int:
        if self.cfg.exchange == "gradient":
            return 1             # paper footnote **: gradient exchange
            # communicates every iteration, so a "round" is one step
        s_i = self.cfg.schedule.round_size(i)
        return max(1, s_i // self.cfg.n_workers)

    def lr_for_round(self) -> float:
        return float(self.cfg.stepsize(self.iterations_done))

    def run_round(self, stacked_params: PyTree, stacked_opt: PyTree,
                  batches: PyTree) -> tuple[PyTree, PyTree, float]:
        """batches leaves: [W, H, ...] (numpy or tensors; moved to the
        params' device once per round) with H =
        local_steps_for_round(r + 1)."""
        lr = self.lr_for_round()
        device = tree_leaves(stacked_params)[0].device
        batches = to_device(batches, device)
        H = int(tree_leaves(batches)[0].shape[1])
        if self.cfg.exchange == "gradient":
            if H != 1:
                raise ValueError(
                    f"exchange='gradient' forces H == 1 (communicate every "
                    f"iteration); got a round of H = {H} local steps")
            batches1 = tree_map(lambda b: b[:, 0], batches)
            p, o, losses = sync_step(self.loss_fn, self.optimizer,
                                     stacked_params, stacked_opt, batches1,
                                     lr)
            self.iterations_done += self.cfg.n_workers
            self.rounds_done += 1
            self.communications += 1
            mean_loss = float(losses.mean())
            self.loss_history.append(mean_loss)
            return p, o, mean_loss
        p, o, losses = local_sgd_round(self.loss_fn, self.optimizer,
                                       stacked_params, stacked_opt, batches,
                                       lr)
        self.iterations_done += H * self.cfg.n_workers
        self.rounds_done += 1
        self.communications += 1

        with torch.no_grad():
            if self.cfg.tau == 0:
                p = broadcast_to_workers(worker_mean(p), p)
            else:
                # dispatch this round's average; apply the one from tau ago
                self._avg_queue.append((worker_mean(p), p, self.rounds_done))
                if len(self._avg_queue) > self.cfg.tau:
                    avg_old, snap_old, round_old = self._avg_queue.pop(0)
                    p = tree_map(
                        lambda a, w, s: (a.unsqueeze(0) + (w - s)).to(w.dtype),
                        avg_old, p, snap_old)
                    self.consumed_rounds.append((self.rounds_done,
                                                 round_old))
        mean_loss = float(losses.mean())
        self.loss_history.append(mean_loss)
        return p, o, mean_loss

    def model_bytes(self, params: PyTree) -> int:
        """Bytes of one worker's model."""
        return sum(a[0].numel() * a.element_size()
                   for a in tree_leaves(params))

    def communication_bytes(self, params: PyTree) -> int:
        """Total bytes exchanged so far (model up + model down per worker
        per round: the paper's communication-cost metric)."""
        return self.communications * 2 * self.cfg.n_workers * \
            self.model_bytes(params)
