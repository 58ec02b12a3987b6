"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports jax or anything of ``repro``, nor ``msgpack``
or ``ml_dtypes`` (which the card's Python may lack); every entry
point defaults to the card; and on a machine without one,
``chip_smoke.py`` and the serve, train and online CLIs fail instead of
carrying on on the CPU."""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint.convert import (params_from_numpy,
                                           zoo_params_from_numpy)
from repro_torch.core.simulator import AsyncSimulator
from repro_torch.launch import online, serve, train
from repro_torch.models.rnn import init_rnn
from repro_torch.serving.forecaster import (LSTMForecaster, ZooForecaster,
                                            build_lstm_forecaster,
                                            build_zoo_forecaster)
from repro_torch.serving.registry import ModelRegistry
from repro_torch.training.loop import train_rnn_local_sgd, train_rnn_serial

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [n for n in _imports(path)
           if n.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                  "ml_dtypes")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_package_is_complete():
    assert len(PORT_FILES) > 20
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES if "repro_torch" in p.parts}
    # the training slice's modules are among the files checked above
    assert {"kernels/evl/ops.py", "kernels/evl/kernel.py",
            "core/async_local_sgd.py", "core/schedules.py",
            "optim/optimizers.py", "training/loop.py", "training/metrics.py",
            "data/sharding.py", "extreme/evl.py", "launch/train.py",
            "tree.py"} <= names
    # the zoo serving slice's modules
    assert {"configs/base.py", "configs/qwen1_5_4b.py", "models/mlp.py",
            "models/attention.py", "models/transformer.py",
            "models/model_zoo.py", "data/tokens.py",
            "kernels/attention/ref.py", "kernels/attention/kernel.py",
            "kernels/attention/ops.py"} <= names
    # the Mamba2 serving slice's modules
    assert {"configs/mamba2_370m.py", "models/ssm.py", "kernels/ssd/ref.py",
            "kernels/ssd/kernel.py", "kernels/ssd/ops.py"} <= names
    # the checkpoint bridge's and the simulator's
    assert {"checkpoint/io.py", "checkpoint/_msgpack.py", "core/delay.py",
            "core/simulator.py", "extreme/resampling.py",
            "serving/registry.py"} <= names
    # the online path's: hot swap, metrics export, the online CLI
    assert {"serving/hotswap.py", "serving/telemetry.py", "obs/export.py",
            "obs/trace.py", "launch/online.py"} <= names
    # the MoE family's: its configs and moe_apply
    assert {"configs/mixtral_8x7b.py", "configs/qwen3_moe_235b_a22b.py",
            "models/mlp.py"} <= names
    # the audio family's: its config (the encoder, cross-attention and the
    # stub frames live in transformer.py, tokens.py and forecaster.py)
    assert "configs/whisper_medium.py" in names
    # zoo training's: the train step (lm_loss is in transformer.py)
    assert "launch/specs.py" in names
    for src in ("kernels/lstm/csrc/lstm_layer.cu",
                "kernels/lstm/csrc/lstm_layer_bwd.cu",
                "kernels/evl/csrc/evl.cu",
                "kernels/attention/csrc/flash_attention.cu",
                "kernels/attention/csrc/flash_attention_bwd.cu",
                "kernels/attention/csrc/flash_attention_bwd_wgmma.cu",
                "kernels/ssd/csrc/ssd_scan.cu"):
        assert (ROOT / "src/repro_torch" / src).is_file()


def test_entry_points_default_to_cuda():
    for fn in (build_lstm_forecaster, init_rnn, params_from_numpy,
               train_rnn_serial, train_rnn_local_sgd, build_zoo_forecaster,
               zoo_params_from_numpy, AsyncSimulator, ModelRegistry.load,
               ModelRegistry.load_bytes):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fc in (LSTMForecaster, ZooForecaster):
        assert fc.__dataclass_fields__["device"].default == "cuda"
    for cli in (serve, train, online):
        tree = ast.parse(inspect.getsource(cli))
        defaults = [kw.value.value for node in ast.walk(tree)
                    if isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value == "--device"
                    for kw in node.keywords if kw.arg == "default"]
        assert defaults == ["cuda"], cli.__name__


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_without_a_card_chip_smoke_and_cli_fail(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    out = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = _run([str(lone)], tmp_path)
    assert out.returncode != 0 and '"ok": true' not in out.stdout
    for cli in (["-m", "repro_torch.launch.serve", "--requests", "1"],
                ["-m", "repro_torch.launch.serve", "--model", "qwen1.5-4b",
                 "--requests", "1"],
                ["-m", "repro_torch.launch.train", "--iterations", "1"],
                ["-m", "repro_torch.launch.online", "--iterations", "1",
                 "--requests", "1"]):
        out = _run(cli, ROOT)
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr
