"""The port's online CLI (``repro_torch.launch.online``) on the CPU:
training and serving in one process end to end, with the reference's
lines, a final version of 1 + the publishes, and a ``--save`` file the
JAX package's registry serves; the mesh flags refused; published
weights that need no grad and share no storage with the trainer's; and
the launch identity the card checks, counted here on the plain versions
the wrappers run for CPU tensors."""

import threading

import numpy as np
import pytest

from repro.serving import ModelRegistry as JaxRegistry
from repro_torch.core.async_local_sgd import AsyncLocalSGD
from repro_torch.launch import online
from repro_torch.serving import ModelRegistry
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-5, 1e-6      # tests/test_kernels.py's LSTM tolerance
SMALL = ["--device", "cpu", "--workers", "2", "--iterations", "40",
         "--requests", "32", "--evl-weight", "0.5"]


def test_cli_end_to_end_and_the_save_serves_in_the_jax_package(
        tmp_path, capsys):
    path = str(tmp_path / "online.npz")
    out = online.main([*SMALL, "--save", path])
    text = capsys.readouterr().out
    snap, pub, registry = out["snapshot"], out["publisher"], out["registry"]
    final_v = registry.version(online.KEY)
    assert pub["published"] == out["result"].communications == 3
    assert final_v == 1 + pub["published"] == pub["last_version"]
    assert snap["swaps"] == pub["published"] and pub["skipped"] == 0
    assert out["served"] >= 32 and snap["requests"] == out["served"]
    assert sum(snap["requests_by_version"].values()) == out["served"]
    for line in ("AAPL: ", " test windows as client traffic",
                 f"served {out['served']} requests (",
                 "extreme alerts) while training ran",
                 f"swaps {pub['published']} (publisher: "
                 f"{pub['published']} published, 0 rate-limited) | final "
                 f"version v{final_v} | staleness at serve p50 ",
                 "requests by version: v1: ",
                 f"saved v{final_v} -> {path}"):
        assert line in text, line
    # the saved file serves in the JAX package as the final version does
    final = registry.get(online.KEY)
    loaded = JaxRegistry().load(path, key="m")
    assert loaded.version == final_v
    assert loaded.tail == pytest.approx(final.tail)
    w = out["data"][1].x[:48]
    for got, want in zip(loaded.predict(w), final.predict(w)):
        np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("flags", [["--shards", "2"], ["--processes"],
                                   ["--shards", "2", "--processes"]])
def test_mesh_flags_are_not_ported(flags):
    with pytest.raises(NotImplementedError, match="Mesh and durability"):
        online.main([*SMALL, *flags])


def test_published_leaves_need_no_grad_and_own_their_storage(monkeypatch):
    """Every version the trainer publishes holds tensors of its own: no
    leaf requires grad, and none shares storage with the worker-stacked
    params the trainer went on updating (all kept alive here, so no
    storage could be reused)."""
    stacked, swapped = [], []
    run_round, swap = AsyncLocalSGD.run_round, ModelRegistry.swap

    def keep_round(self, *a, **kw):
        out = run_round(self, *a, **kw)
        stacked.append(out[0])
        return out

    def keep_swap(self, key, forecaster, *a, **kw):
        swapped.append(forecaster)
        return swap(self, key, forecaster, *a, **kw)

    monkeypatch.setattr(AsyncLocalSGD, "run_round", keep_round)
    monkeypatch.setattr(ModelRegistry, "swap", keep_swap)
    out = online.run(online.parse_args(SMALL))
    assert len(swapped) == out["publisher"]["published"] == len(stacked) == 3
    assert out["registry"].get(online.KEY) is swapped[-1]
    live = {t.untyped_storage().data_ptr()
            for s in stacked for t in tree_leaves(s)}
    for fc in swapped:
        for leaf in tree_leaves(fc.params):
            assert not leaf.requires_grad
            assert leaf.untyped_storage().data_ptr() not in live


def test_launch_identity_on_the_plain_versions(monkeypatch):
    """What ``chip_smoke.py`` checks of the launches, on the plain
    versions the wrappers run for CPU tensors: counted from the engine's
    warmup on, over both threads, the LSTM layer's forward runs once per
    layer for each local step (all W workers at once), each publish's
    calibration predict, each serving flush and the final evaluate;
    EVL once per local step."""
    import repro_torch.kernels.evl.ops as evl_ops
    import repro_torch.kernels.lstm.ops as lstm_ops

    calls = {"lstm_layer": 0, "evl": 0}
    lock = threading.Lock()
    counting = []

    def counted(name, fn):
        def wrapper(*a, **kw):
            with lock:
                if counting:
                    calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(lstm_ops, "lstm_layer_ref", counted(
        "lstm_layer", lstm_ops.lstm_layer_ref))
    monkeypatch.setattr(evl_ops, "evl_loss_ref", counted(
        "evl", evl_ops.evl_loss_ref))
    args = online.parse_args([*SMALL, "--workers", "4", "--iterations",
                              "56"])
    out = online.run(args, on_serving=lambda: counting.append(True))
    res, snap = out["result"], out["snapshot"]
    steps = res.iterations // args.workers
    # rounds of 10, 20 and 30 iterations: 2 + 5 + 7 local steps of W 4
    assert res.iterations == 4 * steps == 56
    published, flushes = out["publisher"]["published"], snap["batches"]
    assert published == 3 and flushes >= 4
    n_layers = len(res.params["lstm"])
    assert calls == {"lstm_layer": n_layers * (steps + published + flushes
                                               + 1),
                     "evl": steps}
