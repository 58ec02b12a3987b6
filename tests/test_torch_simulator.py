"""The port's event-driven simulator (``repro_torch.core.simulator``)
and delay models (``repro_torch.core.delay``) against the JAX
package's: the five tests of ``tests/test_simulator.py`` mirrored with
a torch quadratic loss (determinism, bounded staleness, Table II's
speedup structure, convergence, fewer communications under the linear
schedule); the paper LSTM (small widths, the JAX package's weights,
EVL on) through both simulators from one seed, with the event order,
staleness, makespan, communications and speedup exactly equal and the
evaluation losses within the LSTM tolerances; a check that the global
model moves with every aggregation (no step writes into a tensor that
the global model, a client and its pulled snapshot share); and the
delay models equal to the reference's."""

import jax
import numpy as np
import pytest
import torch

from repro.core import delay as jdelay
from repro.core import simulator as jsim
from repro.core.schedules import SampleSchedule as JSampleSchedule
from repro.data import load_stock, make_windows, train_test_split
from repro.data.sharding import client_splits
from repro.models import rnn as jrnn
from repro.optim.optimizers import sgd as jsgd
from repro.training import loop as jloop
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core import delay
from repro_torch.core.schedules import SampleSchedule
from repro_torch.core.simulator import AsyncSimulator, SimConfig
from repro_torch.models import rnn
from repro_torch.optim.optimizers import sgd
from repro_torch.training import loop
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-5, 1e-6      # tests/test_torch_local_sgd.py's tolerance


def quad_loss(params, batch):
    x, y = batch
    pred = x @ params["w"] + params["b"]
    return torch.mean((pred - y) ** 2)


def _setup(n_clients, k=300, seed=0, **kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((512, 3)).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5]) + 0.1).astype(np.float32)
    params = {"w": torch.zeros((3,)), "b": torch.zeros(())}

    def gen(r, h, b):
        idx = r.integers(0, 512, size=(h, b))
        return (x[idx], y[idx])

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    cfg = SimConfig(n_clients=n_clients, total_iterations=k, batch_size=16,
                    seed=seed, **kw)
    return AsyncSimulator(quad_loss, sgd(), params, [gen] * n_clients, cfg,
                          eval_fn=lambda p: quad_loss(p, (xt, yt)),
                          device="cpu")


def test_simulator_deterministic():
    s1 = _setup(3).run()
    s2 = _setup(3).run()
    assert s1["makespan"] == s2["makespan"]
    assert s1["communications"] == s2["communications"]
    assert s1["eval_log"] == s2["eval_log"]


def test_staleness_bounded():
    s = _setup(5, max_ahead=2).run()
    assert s["max_staleness"] <= 2 + 1  # bound + the in-flight round


def test_speedup_increases_with_clients():
    """Paper Table II structure: more nodes -> more speedup, with
    saturation below ideal (server aggregation cost)."""
    speedups = {n: _setup(n, k=400).run()["speedup"] for n in (1, 2, 5)}
    assert speedups[2] > speedups[1]
    assert speedups[5] > speedups[2]
    assert speedups[5] < 5.0  # saturation


def test_simulator_converges():
    s = _setup(2, k=600).run()
    first = s["eval_log"][0][1]
    last = s["eval_log"][-1][1]
    assert last < first * 0.5


def test_linear_schedule_fewer_communications():
    lin = _setup(2, k=400, schedule=SampleSchedule(a=10)).run()
    const = _setup(2, k=400, schedule=SampleSchedule(a=10, p=0.0)).run()
    # p=0: s_i = 10 constant -> ~40 rounds; linear: ~sqrt scaling
    assert lin["communications"] < const["communications"]


def test_every_aggregation_moves_the_global_model():
    """The aliasing trap: the global model, a client's params and its
    pulled snapshot are the same tensors after a pull. Had a local step
    written into them, the delta (end - start) / n would be zero (or
    doubled). Every round's aggregate differs from the one before, the
    initial params stay untouched, and a client's snapshot is the
    global model it pulled."""
    sim = _setup(3, k=120)
    init = [t.clone() for t in tree_leaves(sim.global_params)]
    start = tree_leaves(sim.global_params)
    seen = []
    sim.eval_fn = lambda p: (seen.append([t.clone() for t in
                                          tree_leaves(p)]), 0.0)[1]
    sim.cfg = SimConfig(**{**sim.cfg.__dict__, "eval_every_rounds": 1})
    sim.run()
    assert len(seen) == sim.server_round + 1
    for before, after in zip(seen, seen[1:-1]):
        assert any(not torch.equal(a, b) for a, b in zip(before, after))
    for a, b in zip(start, init):
        assert torch.equal(a, b)
    for cl in sim.clients:
        assert cl.params is cl.pulled_params


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_delay_models_match_reference(seed):
    for t in list(range(0, 300)) + [2 ** 40 + 7, 2 ** 63]:
        for lo, hi in ((0, 1), (0, 2), (3, 9)):
            assert delay.NetworkDelay(lo, hi, seed)(t) == \
                jdelay.NetworkDelay(lo, hi, seed)(t)
        assert delay.SqrtLogDelay(c=0.5 + seed)(t) == \
            jdelay.SqrtLogDelay(c=0.5 + seed)(t)
        assert delay.ConstantDelay(seed)(t) == jdelay.ConstantDelay(seed)(t)
    for applied, current, tau in ((3, 5, 2), (2, 5, 2), (0, 0, 0),
                                  (4, 9, 4), (5, 9, 4)):
        assert delay.check_consistent(applied, current, tau) == \
            jdelay.check_consistent(applied, current, tau)


# -- the paper LSTM through both simulators --------------------------------

CFG_J = jrnn.RNNConfig(input_dim=5, hidden=12, num_layers=2, fc_dims=(8, 4),
                       window=6, evl_head=True)
CFG = rnn.RNNConfig(input_dim=5, hidden=12, num_layers=2, fc_dims=(8, 4),
                    window=6, evl_head=True)


def _client_gens(train_ds, n, log):
    """``benchmarks/bench_speedup.py``'s client data: each client draws
    its batches from its iid split with the simulator's rng. Each draw
    appends (client, local steps) to ``log``: the order of the rounds."""
    def mk(cid, idx):
        def gen(rng, h, batch):
            log.append((cid, h))
            out = []
            for _ in range(h):
                b = rng.choice(idx, size=batch)
                out.append((train_ds.x[b], train_ds.y[b],
                            train_ds.v.astype(np.float32)[b],
                            np.ones(batch, np.float32)))
            return tuple(np.stack([o[i] for o in out]) for i in range(4))
        return gen
    return [mk(c, s) for c, s in
            enumerate(client_splits(len(train_ds), n, "iid"))]


@pytest.mark.parametrize("hetero", [True, False])
def test_lstm_simulation_matches_reference(hetero):
    """n = 3 clients, K = 48 (rounds of 3, 6, 10, 13 and 16 local steps
    a client), batch 8, EVL weight 0.5, from the JAX package's init."""
    ohlcv = load_stock("AAPL", n_days=260, seed=0)
    tr, te = train_test_split(ohlcv)
    train_ds, test_ds = make_windows(tr, window=6), make_windows(te, window=6)
    jparams = jrnn.init_rnn(jax.random.PRNGKey(0), CFG_J)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    beta = dict(beta0=0.9, beta1=0.1)
    kw = dict(n_clients=3, total_iterations=48, batch_size=8,
              heterogeneous_speeds=hetero, server_cost=0.02,
              net_delay=(0.005, 0.02), eval_every_rounds=2, seed=7)
    jorder, torder = [], []
    jref = jsim.AsyncSimulator(
        jloop.make_loss_fn(CFG_J, 0.5, **beta), jsgd(), jparams,
        _client_gens(train_ds, 3, jorder),
        jsim.SimConfig(schedule=JSampleSchedule(), **kw),
        eval_fn=lambda p: jloop.evaluate(p, CFG_J, test_ds)[0])
    want = jref.run()
    port = AsyncSimulator(
        loop.make_loss_fn(CFG, 0.5, **beta), sgd(), tparams,
        _client_gens(train_ds, 3, torder), SimConfig(**kw),
        eval_fn=lambda p: loop.evaluate(p, CFG, test_ds)[0], device="cpu")
    got = port.run()
    assert torder == jorder and len(set(c for c, _ in torder)) == 3
    assert port.staleness_log == jref.staleness_log
    for key in ("n_clients", "iterations", "communications", "makespan",
                "speedup", "mean_staleness", "max_staleness"):
        assert got[key] == want[key], key
    assert [i for i, _ in got["eval_log"]] == \
        [i for i, _ in want["eval_log"]]
    np.testing.assert_allclose([m for _, m in got["eval_log"]],
                               [m for _, m in want["eval_log"]],
                               rtol=RTOL, atol=ATOL)
