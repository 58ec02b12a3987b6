"""Serving a zoo arch with the port, against the JAX package: the
synthetic token streams (array-equal), ``ZooForecaster.predict`` on the
same weights and the same calibration tokens (greedy tokens equal,
``p_extreme`` allclose), token windows through ``ServingEngine`` (equal
to a direct ``predict`` of the same batch, bitwise), and the serve CLI
with ``--model qwen1.5-4b`` on the CPU.

``p_extreme`` is held at rtol 1e-4 / atol 1e-4: the surprisal carries
the forward's fp32 differences (see ``test_torch_zoo.py``) and the GEV
term (gamma 5) amplifies them."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.data.tokens import synthetic_token_batch as jtokens
from repro.serving.forecaster import ZooForecaster as JZooForecaster
from repro_torch.checkpoint.convert import zoo_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import reduced
from repro_torch.data.tokens import synthetic_token_batch
from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                 ServingEngine, ZooForecaster,
                                 build_zoo_forecaster)

RTOL, ATOL = 1e-4, 1e-4
ARCH = "qwen1.5-4b"
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("batch,seq,vocab,seed", [(8, 32, 1024, 0),
                                                  (3, 17, 151936, 5),
                                                  (64, 2048, 151936, 1)])
def test_synthetic_token_batch_equals_jax(batch, seq, vocab, seed):
    got = synthetic_token_batch(batch, seq, vocab, seed=seed)
    want = jtokens(batch, seq, vocab, seed=seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's forecaster on the same (noised) weights,
    each calibrated on the same token windows."""
    jcfg = jreduced(jget_config(ARCH))
    from repro.models.transformer import init_lm as jinit_lm

    rng = np.random.default_rng(7)

    def noise(path, a):
        a = np.asarray(a, np.float32)
        if jax.tree_util.keystr(path).endswith(("'bq']", "'bk']", "'bv']",
                                                "'w']")):
            a = a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(
        noise, jinit_lm(jcfg, jax.random.PRNGKey(3)))
    calib = jtokens(16, 32, jcfg.vocab, seed=11)
    ref = JZooForecaster(cfg=jcfg, params=params).calibrate(calib)
    cfg = reduced(get_config(ARCH))
    ours = ZooForecaster(cfg=cfg, params=zoo_params_from_numpy(
        cfg, params, device="cpu"), device="cpu").calibrate(calib)
    return ref, ours


def _ragged(n, seed):
    toks = synthetic_token_batch(n, 32, 1024, seed=seed)
    lens = np.random.default_rng(seed).integers(1, 33, n).astype(np.int32)
    for i, t in enumerate(lens):
        toks[i, t:] = 0
    return toks, lens


def test_predict_matches_jax(pair):
    ref, ours = pair
    for key in ("xi", "scale", "tail_at_xi"):
        np.testing.assert_allclose(ours.tail[key], ref.tail[key],
                                   rtol=RTOL, atol=ATOL)
    toks, lens = _ragged(12, seed=2)
    tok_j, p_j = ref.predict(toks, lens)
    tok, p = ours.predict(toks, lens)
    assert tok.dtype == np.float32 and tok.shape == (12,)
    np.testing.assert_array_equal(tok, tok_j)
    np.testing.assert_allclose(p, p_j, rtol=RTOL, atol=ATOL)
    assert np.all((p >= 0) & (p <= 1)) and np.any(p > 0)
    # full-length windows when no lengths are given
    tok_j, p_j = ref.predict(toks[:4])
    tok, p = ours.predict(toks[:4])
    np.testing.assert_array_equal(tok, tok_j)
    np.testing.assert_allclose(p, p_j, rtol=RTOL, atol=ATOL)


def test_engine_token_traffic_equals_direct_predict(pair):
    _, fc = pair
    registry = ModelRegistry()
    registry.register(ARCH, fc)
    toks, lens = _ragged(8, seed=3)
    cfg = BatcherConfig(max_batch=8, max_wait_ms=60_000.0,
                        length_buckets=(32,))
    with ServingEngine(registry, cfg) as engine:
        assert engine.warmup(ARCH, lengths=(32,)) == 4   # B in 1, 2, 4, 8
        futs = [engine.submit(ARCH, toks[i, :t], client_id=f"c{i}")
                for i, t in enumerate(lens)]
        got = [f.result(timeout=60) for f in futs]
        snap = engine.telemetry.snapshot()
    assert snap["requests"] == 8 and snap["batches"] == 1
    tok, p = fc.predict(toks, lens)
    assert got == [(float(tok[i]), float(p[i])) for i in range(8)]


def test_engine_rejects_feature_windows_and_steps_for_a_zoo_model(pair):
    _, fc = pair
    registry = ModelRegistry()
    registry.register(ARCH, fc)
    with ServingEngine(registry, BatcherConfig(max_batch=4)) as engine:
        with pytest.raises(ValueError, match=r"\[T>=1\]"):
            engine.submit(ARCH, np.zeros((32, 5), np.float32))
        with pytest.raises(ValueError, match=r"\[T>=1\]"):
            engine.submit(ARCH, np.zeros((0,), np.int32))
        with pytest.raises(ValueError, match="incremental"):
            engine.submit_step(ARCH, "c0", np.zeros((5,), np.float32))
        # the engine keeps serving after the rejects
        tok, p = engine.predict(ARCH, np.arange(5, dtype=np.int32))
    padded = np.zeros((1, 8), np.int32)      # the engine's bucket: 8
    padded[0, :5] = np.arange(5)
    want_tok, want_p = fc.predict(padded, [5])
    assert (tok, p) == (float(want_tok[0]), float(want_p[0]))


def test_with_params_serves_new_weights_with_the_calibration(pair):
    _, fc = pair
    fc.version = 3
    params = {**fc.params, "lm_head": -fc.params["lm_head"]}
    clone = fc.with_params(params)
    assert clone.version == 0 and clone.published_at is None
    assert clone.tail == fc.tail and clone._model is fc._model
    toks = synthetic_token_batch(4, 32, 1024, seed=4)
    assert not np.array_equal(clone.predict(toks)[0], fc.predict(toks)[0])


def test_build_zoo_forecaster_is_seeded_and_reduced_by_default():
    a = build_zoo_forecaster(ARCH, seed=0, device="cpu")
    b = build_zoo_forecaster(ARCH, seed=0, device="cpu")
    c = build_zoo_forecaster(ARCH, seed=1, device="cpu")
    assert a.cfg == reduced(get_config(ARCH)) and a.tail is not None
    assert a.window == 32 and a.feature_dim == 0 and a.kind == "zoo"
    toks = synthetic_token_batch(6, 32, a.cfg.vocab, seed=9)
    np.testing.assert_array_equal(a.predict(toks)[0], b.predict(toks)[0])
    assert a.tail == b.tail and a.tail != c.tail
    assert all(t.device.type == "cpu" for t in
               (a.params["embed"], a.params["layers"]["attn"]["wq"]))


def test_serve_cli_hosts_a_zoo_arch_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--model", ARCH,
         "--device", "cpu", "--requests", "16", "--max-batch", "8",
         "--prompt-len", "12"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"hosting '{ARCH}' on cpu" in out.stdout
    assert "16 req in" in out.stdout


def test_serve_cli_returns_the_zoo_traffic_snapshot():
    from repro_torch.launch import serve

    res = serve.main(["--model", ARCH, "--device", "cpu", "--requests", "8",
                      "--max-batch", "4", "--prompt-len", "9"])
    assert res["traffic"]["requests"] == 8 and res["sessions"] is None
