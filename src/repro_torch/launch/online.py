"""Online-learning launcher: train and serve in ONE process on the card
(the port of ``repro.launch.online``).

A background thread runs the paper's asynchronous local SGD over
``data/sp500.py`` windows; after every cross-worker model exchange the
round's worker-averaged parameters are published into the live
``ModelRegistry`` (the EVT tail re-calibrated on the new weights) by a
``WeightPublisher``, and the serving engine picks the new version up
between micro-batch flushes: no request is dropped by a weight update.
The foreground thread plays client traffic against the engine the whole
time and reports the swap count, the staleness at serve time and the
requests served by each version.

    PYTHONPATH=src python -m repro_torch.launch.online --workers 4 \
        --iterations 400 --evl-weight 0.5 --requests 400 --rps 400

    # the same on the CPU (plain PyTorch path, no kernel)
    PYTHONPATH=src python -m repro_torch.launch.online --device cpu \
        --workers 2 --iterations 40 --requests 32

Two host threads launch on the card: the trainer (the LSTM layer
kernel, its backward and the EVL kernel; and the layer kernel again in
each publish's calibration predict) and the engine's flush thread (the
layer kernel). Every launch of this path goes to the default CUDA
stream (``run`` refuses a trainer thread on any other), so the
trainer's writes of a published version come before any later read of
it without an event between the threads. Moving the trainer to a side
stream of its own must add one: recorded on that stream after
``worker_mean``, waited on before the swap (see
``repro_torch.serving.hotswap``).

Single process only: the sharded mesh (``--shards > 1``) and its
process workers (``--processes``) raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import threading
import time

KEY = "paper-lstm"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticker", default="AAPL")
    ap.add_argument("--days", type=int, default=800)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--iterations", type=int, default=600)
    ap.add_argument("--tau", type=int, default=0)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--requests", type=int, default=400,
                    help="minimum client requests to play against the "
                    "engine; traffic keeps flowing until training ends")
    ap.add_argument("--rps", type=float, default=100.0,
                    help="client traffic rate (requests/s), paced so the "
                    "trace spans the whole training run")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--shards", type=int, default=1,
                    help="serve through a sharded mesh with this many "
                    "shards (not ported: only 1, a single engine, runs)")
    ap.add_argument("--processes", action="store_true",
                    help="with --shards > 1: one OS process per shard "
                    "(not ported)")
    ap.add_argument("--min-publish-interval-ms", type=float, default=0.0,
                    help="rate-limit weight publishes (0 = every round)")
    ap.add_argument("--calib-windows", type=int, default=64,
                    help="reference windows for per-publish EVT "
                    "re-calibration (0 disables re-calibration)")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="save the final published version as a serving "
                    "checkpoint on exit")
    ap.add_argument("--evl-weight", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve /metrics (Prometheus), /metrics.json and "
                    "/history on this port while training + serving run "
                    "(0 = ephemeral)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on (default: "
                    "the card; 'cpu' runs the plain PyTorch path)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, on_serving=None) -> dict:
    """Train and serve at once. ``on_serving()``, when given, runs after
    the engine's warmup and the telemetry reset, just before the trainer
    starts. An error of the trainer thread is raised after the join.

    Returns ``snapshot`` (the engine's telemetry), ``publisher`` (its
    ``published``, ``skipped`` and ``last_version`` counts), ``result``
    (the ``TrainResult``), ``registry``, ``served`` and ``alerts`` (the
    client side), ``wall_s``, ``train_s`` (the trainer thread's wall
    time, publishes included), ``publish_s`` (each publish's seconds:
    the successor's calibration and the swap), ``data`` ((train, test)
    windows) and ``calib`` (the calibration windows, or None). With
    ``--save`` the final version is saved as a serving checkpoint."""
    if args.shards > 1 or args.processes:
        from repro_torch.models.transformer import not_ported

        raise not_ported("the serving mesh (--shards > 1, --processes)",
                         "Mesh and durability")

    import torch

    from repro_torch.configs.paper_lstm import CONFIG
    from repro_torch.data import load_stock, make_windows, train_test_split
    from repro_torch.device import resolve_device
    from repro_torch.models.rnn import init_rnn
    from repro_torch.serving import (BatcherConfig, LSTMForecaster,
                                     ModelRegistry, ServingEngine,
                                     WeightPublisher)
    from repro_torch.training.loop import train_rnn_local_sgd

    device = resolve_device(args.device)
    ohlcv = load_stock(args.ticker, n_days=args.days, seed=args.seed)
    tr, te = train_test_split(ohlcv)
    train_ds, test_ds = make_windows(tr), make_windows(te)
    print(f"{args.ticker}: {len(train_ds)} train windows feeding the "
          f"trainer, {len(test_ds)} test windows as client traffic")

    # v1: freshly initialized paper model, calibrated on the train set,
    # what a cold-started service hosts before training catches up
    fc0 = LSTMForecaster(
        cfg=CONFIG, params=init_rnn(torch.Generator().manual_seed(args.seed),
                                    CONFIG, device=device), device=device)
    fc0.calibrate(train_ds.x[:max(args.calib_windows, 16)])
    registry = ModelRegistry()
    registry.register(KEY, fc0)

    calib = (train_ds.x[:args.calib_windows]
             if args.calib_windows else None)
    engine = ServingEngine(registry, BatcherConfig(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        length_buckets=(CONFIG.window,)))
    publisher = WeightPublisher(
        registry, KEY, calib_windows=calib,
        min_interval_s=args.min_publish_interval_ms * 1e-3,
        telemetry=engine.telemetry)
    publish_s: list[float] = []

    def publish(round_idx, avg_params):
        t0 = time.perf_counter()
        version = publisher(round_idx, avg_params)
        if version is not None:
            publish_s.append(time.perf_counter() - t0)
        return version

    metrics = None
    if args.metrics_port is not None:
        from repro_torch.obs import MetricsServer

        metrics = MetricsServer(engine.telemetry.snapshot,
                                port=args.metrics_port,
                                sample_interval_s=0.5).start()
        print(f"metrics: {metrics.url}/metrics (also /metrics.json, "
              f"/history)")

    trainer_err: list[BaseException] = []
    trained: list = []
    train_s: list[float] = []

    def train() -> None:
        try:
            if device.type == "cuda" and torch.cuda.current_stream(device) \
                    != torch.cuda.default_stream(device):
                raise RuntimeError("the online trainer must launch on the "
                                   "default CUDA stream")
            t0 = time.perf_counter()
            trained.append(train_rnn_local_sgd(
                train_ds, test_ds, n_workers=args.workers, cfg=CONFIG,
                iterations=args.iterations, batch=args.batch,
                tau=args.tau, seed=args.seed, evl_weight=args.evl_weight,
                round_callback=publish, device=device))
            train_s.append(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 - raised after the join
            trainer_err.append(e)

    try:
        with engine:
            engine.warmup(KEY, lengths=(CONFIG.window,))
            engine.telemetry.reset_clock()
            if on_serving is not None:
                on_serving()
            trainer = threading.Thread(target=train, name="online-trainer")
            t0 = time.time()
            trainer.start()
            served = 0
            alerts = 0
            burst = max(1, min(args.max_batch, 8))
            period = burst / max(args.rps, 1e-3)
            next_t = time.perf_counter()
            try:
                while trainer.is_alive() or served < args.requests:
                    now = time.perf_counter()
                    if now < next_t:
                        time.sleep(min(next_t - now, 0.05))
                        continue
                    futs = [engine.submit(
                        KEY, test_ds.x[(served + j) % len(test_ds)],
                        client_id=f"client-{(served + j) % 32}")
                        for j in range(burst)]
                    for f in futs:
                        _, p = f.result(timeout=60.0)
                        alerts += p >= 0.9
                    served += burst
                    next_t += period
                    if next_t < time.perf_counter() - 1.0:
                        # engine slower than --rps: shed schedule debt
                        # instead of bursting to catch up
                        next_t = time.perf_counter()
            finally:
                trainer.join()
            # a rate-limited final round must still reach the registry:
            # the served (and --save'd) model is never staler than the
            # trained one
            publisher.flush()
            wall = time.time() - t0
            snap = engine.telemetry.snapshot()
    finally:
        if metrics is not None:
            metrics.stop()
    if trainer_err:
        raise trainer_err[0]
    if args.save:
        registry.save(KEY, args.save)
    return {"snapshot": snap, "result": trained[0], "registry": registry,
            "publisher": {"published": publisher.published,
                          "skipped": publisher.skipped,
                          "last_version": publisher.last_version},
            "served": served, "alerts": int(alerts), "wall_s": wall,
            "train_s": train_s[0], "publish_s": publish_s,
            "data": (train_ds, test_ds), "calib": calib}


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns ``run``'s dict."""
    from repro_torch.serving import Telemetry

    args = parse_args(argv)
    out = run(args)
    snap, pub, registry = out["snapshot"], out["publisher"], out["registry"]
    print(f"served {out['served']} requests ({out['alerts']} extreme "
          f"alerts) while training ran, {out['wall_s']:.1f}s wall")
    print(Telemetry.format(snap))
    by_version = snap["requests_by_version"]
    print(f"swaps {snap['swaps']} (publisher: {pub['published']} "
          f"published, {pub['skipped']} rate-limited) | final version "
          f"v{registry.version(KEY)} | staleness at serve p50 "
          f"{snap['staleness_p50_s']*1e3:.0f} ms")
    print("requests by version: "
          + ", ".join(f"v{v}: {n}" for v, n in sorted(by_version.items())))
    if args.save:
        print(f"saved v{registry.version(KEY)} -> {args.save}")
    return out


if __name__ == "__main__":
    main()
