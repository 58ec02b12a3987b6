"""Training launcher, on the card unless ``--device cpu`` is given. Two
modes, as in ``repro.launch.train``:

  * ``--arch paper-lstm`` (the default): the paper's experiment,
    asynchronous local SGD on stock windows with n workers and the
    linear schedule;
  * ``--arch <zoo id>``: a zoo config (``--reduced`` for the CPU-sized
    variant) trained with Adam on synthetic tokens (``make_train_step``
    of ``launch.specs``), ``--steps`` steps of ``--batch`` x ``--seq``
    tokens at ``--lr``; the audio family also takes synthetic frames.
    On the card the ssm and hybrid families raise: their gradient needs
    the SSD scan's backward, not ported yet.

    # the paper's framework, 4 workers, EVL on the extreme-event head
    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lstm \
        --workers 4 --iterations 2000 --evl-weight 0.5

    # the serial baseline on the CPU (plain PyTorch path, no kernel)
    PYTHONPATH=src python -m repro_torch.launch.train --workers 1 \
        --iterations 200 --device cpu

    # save the trained model as a serving checkpoint, then serve it
    PYTHONPATH=src python -m repro_torch.launch.train --workers 4 \
        --iterations 200 --evl-weight 0.5 --save /tmp/ckpt.npz
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --checkpoint /tmp/ckpt.npz

    # a zoo model: the reduced Qwen1.5-4B on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --reduced --steps 3 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def run_paper_lstm(args, round_callback=None):
    """The paper's experiment; ``round_callback(round_idx, avg_params)``,
    when given, receives every round's worker-averaged params. Returns
    the TrainResult."""
    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.core.schedules import ConstantSchedule, SampleSchedule
    from repro_torch.data import load_stock, make_windows, train_test_split
    from repro_torch.training.loop import (train_rnn_local_sgd,
                                           train_rnn_serial)

    ohlcv = load_stock(args.ticker, n_days=args.days, seed=args.seed)
    tr, te = train_test_split(ohlcv)
    train_ds, test_ds = make_windows(tr), make_windows(te)
    print(f"{args.ticker}: {len(train_ds)} train / {len(test_ds)} test "
          f"windows; extreme fraction "
          f"{float(np.mean(train_ds.v != 0)):.3f}")

    t0 = time.time()
    if args.workers <= 1:
        res = train_rnn_serial(train_ds, test_ds, cfg=CONFIG,
                               iterations=args.iterations,
                               batch=args.batch, seed=args.seed,
                               evl_weight=args.evl_weight,
                               device=args.device)
    else:
        schedule = (ConstantSchedule(size=args.constant_rounds)
                    if args.constant_rounds else SampleSchedule())
        res = train_rnn_local_sgd(
            train_ds, test_ds, n_workers=args.workers, cfg=CONFIG,
            iterations=args.iterations, batch=args.batch,
            schedule=schedule, tau=args.tau, seed=args.seed,
            evl_weight=args.evl_weight, round_callback=round_callback,
            device=args.device)
    dt = time.time() - t0
    print(f"done in {dt:.1f}s: test MSE {res.test_mse:.5f}, "
          f"iterations {res.iterations}, communications "
          f"{res.communications}, comm bytes {res.comm_bytes/1e6:.2f} MB")
    if res.test_extreme:
        print("extreme-event:", res.test_extreme)
    if args.save:
        _save_serving_checkpoint(args.save, res, train_ds, args.device)
    return res


def _save_serving_checkpoint(path: str, res, train_ds, device) -> None:
    """Persist the trained model as a serving checkpoint: the
    EVT-calibrated forecaster with model-version metadata (the version
    is the number of cross-worker exchanges that produced the weights,
    so a registry that later loads it slots into the monotone version
    sequence)."""
    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.serving import LSTMForecaster, ModelRegistry

    fc = LSTMForecaster(cfg=CONFIG, params=res.params, device=device)
    fc.calibrate(train_ds.x)
    reg = ModelRegistry()
    reg.register("trained", fc, version=max(res.communications, 1))
    reg.save("trained", path)
    print(f"saved serving checkpoint v{reg.version('trained')} -> {path}")


def run_zoo(args) -> list[float]:
    """Train a zoo config on synthetic tokens: random weights from
    ``--seed``, then ``--steps`` Adam steps, step i on
    ``synthetic_token_batch(batch, seq, vocab, seed + i)`` (and the
    audio family's frames ``synthetic_embedding_batch(..., seed=i)``).
    Prints the JAX CLI's lines; returns the losses."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.data.tokens import (synthetic_embedding_batch,
                                         synthetic_token_batch)
    from repro_torch.device import resolve_device
    from repro_torch.launch.specs import make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = tfm.init_lm(cfg, torch.Generator(device=device).manual_seed(
        args.seed))
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params")
    step, opt = make_train_step(cfg, lr=args.lr)
    opt_state = opt.init(params)

    losses = []
    for i in range(args.steps):
        toks = torch.as_tensor(synthetic_token_batch(
            args.batch, args.seq, cfg.vocab, seed=args.seed + i),
            dtype=torch.long, device=device)
        frames = None
        if cfg.family == "audio":
            frames = torch.as_tensor(synthetic_embedding_batch(
                args.batch, cfg.n_frames, cfg.d_model, seed=i),
                device=device)
        params, opt_state, loss = step(params, opt_state, toks, frames)
        losses.append(float(loss))
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i}: loss {losses[-1]:.4f}", flush=True)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    if not np.isfinite(losses[-1]):
        raise FloatingPointError(f"{cfg.name}: final loss {losses[-1]}")
    return losses


def main(argv: list[str] | None = None):
    """Run the CLI; returns the TrainResult (paper-lstm) or the losses
    (a zoo arch)."""
    from repro_torch.configs import list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lstm",
                    choices=["paper-lstm"] + sorted(
                        a for a in list_archs() if a != "paper-lstm"),
                    help="the paper LSTM, or a zoo arch")
    ap.add_argument("--ticker", default="AAPL")
    ap.add_argument("--days", type=int, default=1430)
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--tau", type=int, default=0)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128,
                    help="tokens a sequence (zoo)")
    ap.add_argument("--steps", type=int, default=50,
                    help="optimizer steps (zoo)")
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="Adam's learning rate (zoo)")
    ap.add_argument("--reduced", action="store_true",
                    help="the zoo arch's reduced (CPU-sized) config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--evl-weight", type=float, default=0.0)
    ap.add_argument("--constant-rounds", type=int, default=0,
                    help="use constant local-SGD schedule of this size")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="save the trained paper model as a serving "
                    "checkpoint (EVT-calibrated, version metadata)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the hand-written kernels) or "
                    "cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.arch == "paper-lstm":
        return run_paper_lstm(args)
    return run_zoo(args)


if __name__ == "__main__":
    main()
