"""The port's registry persistence (``repro_torch.serving.registry``
save/load and their bytes forms) against the JAX package's: a round
trip keeps the config, the EVT tail, eps, gamma and the version, and
bumps the version when the key has moved on; a reduced zoo model keeps
its leaves' dtypes and predictions; a checkpoint from the JAX package's
``train --save`` serves in the port with predictions allclose to the
JAX registry's at the LSTM tolerances, and the port's own checkpoint
serves in the JAX package; the port's ``train --save`` and ``serve
--checkpoint`` CLIs on the CPU."""

import argparse

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.models import rnn as jrnn
from repro.serving import ModelRegistry as JaxRegistry
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.rnn import RNNConfig
from repro_torch.serving import (LSTMForecaster, ModelRegistry,
                                 build_zoo_forecaster)
from repro_torch.tree import tree_flatten_with_path

RTOL, ATOL = 1e-5, 1e-6      # tests/test_kernels.py's LSTM tolerance
CFG = RNNConfig(input_dim=5, hidden=12, num_layers=2, fc_dims=(8, 4),
                window=6, evl_head=True)
JCFG = jrnn.RNNConfig(input_dim=5, hidden=12, num_layers=2, fc_dims=(8, 4),
                      window=6, evl_head=True)


def _assert_same_leaves(got, want):
    """Leaf for leaf by path (key order may differ), dtype and bits."""
    want = dict(tree_flatten_with_path(want))
    pairs = tree_flatten_with_path(got)
    assert sorted(p for p, _ in pairs) == sorted(want)
    for path, a in pairs:
        assert a.dtype == want[path].dtype and torch.equal(a, want[path])


def _windows(n, cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.window, cfg.input_dim)).astype(np.float32)


def _forecaster():
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jrnn.init_rnn(jax.random.PRNGKey(3), JCFG)),
        device="cpu")
    fc = LSTMForecaster(cfg=CFG, params=params, gamma=4.0, device="cpu")
    return fc.calibrate(_windows(64, CFG))


def test_lstm_round_trip_keeps_config_calibration_and_version(tmp_path):
    fc = _forecaster()
    reg = ModelRegistry()
    reg.register("m", fc, version=5)
    path = str(tmp_path / "m.npz")
    reg.save("m", path)
    for loaded in (ModelRegistry().load(path, device="cpu"),
                   ModelRegistry().load_bytes(reg.save_bytes("m"),
                                              device="cpu")):
        assert loaded.kind == "lstm" and loaded.cfg == fc.cfg
        assert loaded.tail == fc.tail and loaded.eps == fc.eps
        assert loaded.gamma == 4.0 and loaded.version == 5
        _assert_same_leaves(loaded.params, fc.params)
        w = _windows(9, CFG, seed=1)
        for got, want in zip(loaded.predict(w), fc.predict(w)):
            np.testing.assert_array_equal(got, want)
    # registered at the saved version; a key that moved on is bumped
    other = ModelRegistry()
    assert other.load(path, key="m", device="cpu").version == 5
    assert other.version("m") == 5
    fresh = ModelRegistry()
    for _ in range(7):
        fresh.register("m", _forecaster())
    assert fresh.version("m") == 7
    fresh.load(path, key="m", device="cpu")
    assert fresh.version("m") == 8


def test_not_a_serving_checkpoint_raises(tmp_path):
    from repro_torch.checkpoint import save_checkpoint

    path = str(tmp_path / "plain.npz")
    save_checkpoint(path, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="not a serving checkpoint"):
        ModelRegistry().load(path, device="cpu")


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "mamba2-370m"])
def test_zoo_round_trip_keeps_dtypes_and_predictions(arch):
    """A reduced zoo model (fp32; the kind, arch and reduced flag ride
    along) rebuilds leaf for leaf, and one predict flush is bitwise the
    same before and after."""
    fc = build_zoo_forecaster(arch, seed=0, reduced=True, calibrate_batch=4,
                              device="cpu")
    reg = ModelRegistry()
    reg.register(arch, fc)
    loaded = ModelRegistry().load_bytes(reg.save_bytes(arch), key=arch,
                                        device="cpu")
    assert loaded.kind == "zoo" and loaded.cfg == fc.cfg
    assert loaded.tail == fc.tail and loaded.version == 1
    _assert_same_leaves(loaded.params, fc.params)
    tokens = np.random.default_rng(0).integers(0, fc.cfg.vocab, (3, 12))
    for got, ref in zip(loaded.predict(tokens), fc.predict(tokens)):
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """A serving checkpoint from the JAX package's ``train --save``
    (paper LSTM, 2 workers, 40 iterations, EVL on)."""
    path = str(tmp_path_factory.mktemp("jax") / "trained.npz")
    args = argparse.Namespace(
        ticker="AAPL", days=300, iterations=40, workers=2, tau=0, batch=32,
        seed=0, evl_weight=0.5, constant_rounds=0, save=path)
    res = jtrain.run_paper_lstm(args)
    return path, res


def test_jax_train_save_serves_in_the_port(jax_trained):
    path, res = jax_trained
    jfc = JaxRegistry().load(path)
    tfc = ModelRegistry().load(path, key="trained", device="cpu")
    assert tfc.version == jfc.version == max(res.communications, 1)
    assert tfc.tail == jfc.tail and tfc.eps == tuple(jfc.eps)
    w = _windows(40, tfc.cfg, seed=2)
    for got, want in zip(tfc.predict(w), jfc.predict(w)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_port_checkpoint_serves_in_the_jax_package(tmp_path):
    fc = _forecaster()
    reg = ModelRegistry()
    reg.register("m", fc, version=2)
    path = str(tmp_path / "t.npz")
    reg.save("m", path)
    jfc = JaxRegistry().load(path, key="m")
    assert jfc.version == 2 and jfc.tail == fc.tail
    assert tuple(jfc.eps) == fc.eps and jfc.cfg == JCFG
    w = _windows(11, CFG, seed=4)
    for got, want in zip(fc.predict(w), jfc.predict(w)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_train_save_then_serve_checkpoint_clis_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "ckpt.npz")
    res = train_cli.main(["--workers", "2", "--iterations", "40", "--days",
                          "300", "--evl-weight", "0.5", "--device", "cpu",
                          "--save", path])
    out = capsys.readouterr().out
    assert f"saved serving checkpoint v{res.communications} -> {path}" in out
    snap = serve_cli.main(["--checkpoint", path, "--requests", "24",
                           "--clients", "4", "--max-batch", "8", "--device",
                           "cpu"])
    out = capsys.readouterr().out
    assert f"(kind=lstm, v{res.communications})" in out
    assert "alert quality vs synthetic extreme labels" in out
    assert snap["traffic"]["requests"] == 24
