"""Training launcher: the paper's experiment, asynchronous local SGD on
stock windows with n workers and the linear schedule, on the card.

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

The port of ``repro.launch.train``'s ``paper-lstm`` path; the
model-zoo path (``--arch <zoo id>``) waits for a later slice.
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


def main(argv: list[str] | None = None):
    """Run the CLI; returns the TrainResult."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-lstm", choices=["paper-lstm"],
                    help="the model to train (the port trains the paper "
                    "LSTM so far)")
    ap.add_argument("--ticker", default="AAPL")
    ap.add_argument("--days", type=int, default=1430)
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--tau", type=int, default=0)
    ap.add_argument("--batch", type=int, default=32)
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
    return run_paper_lstm(args)


if __name__ == "__main__":
    main()
