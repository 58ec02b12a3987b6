"""Event-driven asynchronous distributed-learning simulator, the paper's
experiment (section IV): the port of ``repro.core.simulator``. n clients
with heterogeneous speeds run local SGD against a central server,
exchanging models asynchronously, with linearly increasing round sizes
and diminishing step sizes. Deterministic given seeds.

Server aggregation follows [27] (van Dijk et al., Algorithm 4): when a
client's round-r model arrives (possibly late), the server folds the
client's delta into the global model:

    w_global <- w_global + (w_client_end - w_client_start) / n

The client then pulls the current global model, which may already
contain other clients' newer contributions (bounded staleness;
Definition 1 is enforced by capping how far a client may run ahead,
``max_ahead``).

Virtual time: client c takes (iterations / speed_c) time units per round
plus network delays for upload and download; the server takes
``server_cost`` per aggregation (this produces the paper's speedup
saturation, Table II). Speedup = serial time of K iterations / parallel
makespan.

The event heap, the staleness guard, the ``NetworkDelay`` draws and the
numpy ``default_rng(cfg.seed)`` that feeds the client data generators
are the reference's, so the event order, the staleness log, the
makespan, the communications and the speedup are the reference's
exactly. A client's local steps are a Python loop of the port's
``value_and_grad``, the optimizer's ``update`` and ``apply_updates``:
on the card each step of the paper LSTM launches the LSTM layer kernel
and its backward once per layer and the EVL kernel once. No step writes
into a tensor: the global model, a client's params and its pulled
snapshot share tensors between rounds, as the reference's immutable
arrays do, and every update makes new ones.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.convert import params_to
from repro_torch.core.async_local_sgd import to_device, value_and_grad
from repro_torch.core.delay import NetworkDelay
from repro_torch.core.schedules import SampleSchedule, StepSizeSchedule
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_clients: int = 2
    total_iterations: int = 2000          # K
    schedule: SampleSchedule = SampleSchedule()      # s_i
    stepsize: StepSizeSchedule = StepSizeSchedule()  # eta_i
    batch_size: int = 32
    heterogeneous_speeds: bool = True     # speeds in [0.5, 1.5]
    net_delay: tuple[float, float] = (0.01, 0.05)    # upload/download time
    server_cost: float = 0.05             # aggregation cost per arrival
    max_ahead: int = 2                    # staleness cap (Def. 1 bound)
    eval_every_rounds: int = 5
    seed: int = 0


@dataclasses.dataclass
class _Client:
    cid: int
    params: PyTree
    opt_state: PyTree
    pulled_params: PyTree     # snapshot at pull time (for delta aggregation)
    speed: float
    round_idx: int = 0        # global round counter at pull time
    iters_done: int = 0
    time: float = 0.0


class AsyncSimulator:
    """Runs the full async protocol in virtual time on real steps on
    ``device``."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 init_params: PyTree, data_per_client: list,
                 cfg: SimConfig, eval_fn: Callable | None = None,
                 device="cuda"):
        """data_per_client[c] -> callable (rng, n, batch) yielding a
        stacked batches nest of numpy leaves [n, batch, ...];
        ``loss_fn(params, batch)`` gives one model's scalar loss.
        ``init_params`` are moved to ``device``."""
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.device = resolve_device(device)
        init_params = params_to(init_params, self.device)
        self.global_params = init_params
        self.data_per_client = data_per_client
        self.rng = np.random.default_rng(cfg.seed)
        self.net = NetworkDelay(lo=0, hi=1, seed=cfg.seed)

        speeds = (np.linspace(0.5, 1.5, cfg.n_clients)
                  if cfg.heterogeneous_speeds and cfg.n_clients > 1
                  else np.ones(cfg.n_clients))
        self.clients = [
            _Client(cid=c, params=init_params,
                    opt_state=optimizer.init(init_params),
                    pulled_params=init_params, speed=float(speeds[c]))
            for c in range(cfg.n_clients)]

        # accounting
        self.server_round = 0          # completed aggregations
        self.iterations = 0
        self.communications = 0
        self.makespan = 0.0
        self.staleness_log: list[int] = []
        self.eval_log: list[tuple[int, float]] = []   # (iterations, metric)

    def _local_steps(self, params, opt_state, batches, lr):
        """H local SGD steps, one per leading slice of ``batches``:
        (params, opt_state). (The reference's mean loss is unused by
        ``run`` and not computed.)"""
        for i in range(tree_leaves(batches)[0].shape[0]):
            batch = tree_map(lambda b: b[i], batches)
            _, grads = value_and_grad(self.loss_fn, params, batch)
            with torch.no_grad():
                upd, opt_state = self.optimizer.update(grads, opt_state,
                                                       params, lr)
                params = apply_updates(params, upd)
        return params, opt_state

    def _round_size(self, i: int) -> int:
        s_i = self.cfg.schedule.round_size(i)
        return max(1, s_i // self.cfg.n_clients)

    def run(self) -> dict:
        cfg = self.cfg
        # event queue: (time, seq, client_id); seq breaks ties deterministically
        events = [(0.0, c, c) for c in range(cfg.n_clients)]
        heapq.heapify(events)
        seq = cfg.n_clients
        rounds_started = 0

        while events and self.iterations < cfg.total_iterations:
            t, _, cid = heapq.heappop(events)
            cl = self.clients[cid]

            # staleness guard (Definition 1 / bounded delay): a client may
            # not run more than max_ahead rounds past the slowest client.
            min_round = min(c.round_idx for c in self.clients)
            if cl.round_idx - min_round > cfg.max_ahead:
                # requeue after a small wait (the client idles: this
                # models the bounded-delay constraint tau)
                heapq.heappush(events, (t + 0.1, seq, cid)); seq += 1
                continue

            rounds_started += 1
            round_i = rounds_started
            h = self._round_size(round_i)
            lr = float(cfg.stepsize(self.iterations))

            # local compute
            batches = to_device(
                self.data_per_client[cid](self.rng, h, cfg.batch_size),
                self.device)
            new_params, new_opt = self._local_steps(
                cl.params, cl.opt_state, batches, lr)
            compute_time = h / cl.speed
            up = cfg.net_delay[0] + (cfg.net_delay[1] - cfg.net_delay[0]) * \
                (self.net(seq) / 1.0)
            arrive = t + compute_time + up

            # server aggregation (delta rule of [27]), into new tensors
            n = cfg.n_clients
            with torch.no_grad():
                self.global_params = tree_map(
                    lambda g, e, s: g + (e - s) / n,
                    self.global_params, new_params, cl.pulled_params)
            self.server_round += 1
            self.communications += 1
            self.iterations += h
            self.staleness_log.append(cl.round_idx - min_round)

            # the client pulls the fresh global model and continues
            down = cfg.net_delay[0]
            finish = arrive + cfg.server_cost + down
            cl.params = self.global_params
            cl.pulled_params = self.global_params
            cl.opt_state = new_opt
            cl.round_idx += 1
            cl.iters_done += h
            cl.time = finish
            self.makespan = max(self.makespan, finish)

            if (self.eval_fn is not None
                    and self.server_round % cfg.eval_every_rounds == 0):
                self.eval_log.append(
                    (self.iterations, float(self.eval_fn(self.global_params))))

            heapq.heappush(events, (finish, seq, cid)); seq += 1

        if self.eval_fn is not None:
            self.eval_log.append(
                (self.iterations, float(self.eval_fn(self.global_params))))
        return self.summary()

    def summary(self) -> dict:
        cfg = self.cfg
        serial_time = cfg.total_iterations / 1.0   # unit-speed single node
        return {
            "n_clients": cfg.n_clients,
            "iterations": self.iterations,
            "communications": self.communications,
            "makespan": self.makespan,
            "speedup": serial_time / max(self.makespan, 1e-9),
            "mean_staleness": (float(np.mean(self.staleness_log))
                               if self.staleness_log else 0.0),
            "max_staleness": (int(np.max(self.staleness_log))
                              if self.staleness_log else 0),
            "eval_log": self.eval_log,
        }
