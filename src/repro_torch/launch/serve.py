"""Serving launcher: hosts the paper LSTM or a zoo arch behind the
micro-batching engine on the card and replays a simulated many-client
traffic trace against it.

    # stream stock windows from 32 synthetic clients, then 20 ticks of
    # O(1) session steps from 8 of them through the decode slots
    PYTHONPATH=src python -m repro_torch.launch.serve --model paper-lstm \
        --clients 32 --requests 128 --max-batch 32 --sessions

    # the same on the CPU (plain PyTorch path, no kernel)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

    # a trained serving checkpoint (``repro_torch.launch.train --save``,
    # or the JAX package's ``repro.launch.train --save``)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --checkpoint /tmp/ckpt.npz --requests 64

    # a zoo arch at full width on the card (Qwen1.5-4B, bf16), serving
    # next-token forecasts over synthetic 32-token prompts; without
    # --no-reduced it hosts the reduced (2-layer, CPU smoke) config
    PYTHONPATH=src python -m repro_torch.launch.serve --model qwen1.5-4b \
        --no-reduced --requests 64 --max-batch 8 --prompt-len 32

    # Mamba2-370M at full width on the card (bf16, every layer's scan
    # through the CUDA SSD kernel); on the CPU, reduced:
    PYTHONPATH=src python -m repro_torch.launch.serve --model mamba2-370m \
        --no-reduced --requests 64 --max-batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --model mamba2-370m \
        --device cpu --requests 32 --max-batch 8

    # Zamba2-2.7B, the hybrid, at full width on the card (bf16: 54 Mamba2
    # layers through the SSD kernel, the shared attention block after
    # every 6th through the flash kernel); on the CPU, reduced:
    PYTHONPATH=src python -m repro_torch.launch.serve --model zamba2-2.7b \
        --no-reduced --requests 64 --max-batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --model zamba2-2.7b \
        --device cpu --requests 32 --max-batch 8

    # Granite-20B at full width on the card (bf16, 52 layers, multi-query
    # attention: 48 query heads over one KV head through the flash
    # kernel); Nemotron-4-15B, Qwen2.5-32B and the VLM Chameleon-34B
    # serve the same way; on the CPU, reduced:
    PYTHONPATH=src python -m repro_torch.launch.serve --model granite-20b \
        --no-reduced --requests 16 --max-batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve --model granite-20b \
        --device cpu --requests 32 --max-batch 8

    # the MoE family: Mixtral-8x7B (8 experts top-2, its own 4096-key
    # window) and Qwen3-MoE-235B-A22B (128 experts top-8); neither fits
    # one 80 GB card at full depth (87.0 and 437.9 GiB in bf16), so the
    # CLI hosts them reduced, on the card or the CPU:
    PYTHONPATH=src python -m repro_torch.launch.serve --model mixtral-8x7b \
        --requests 16 --max-batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --model qwen3-moe-235b-a22b --device cpu --requests 32 --max-batch 8

    # Whisper-medium, the audio encoder-decoder, at full width on the card
    # (bf16, 24 + 24 layers over 1500 stub frames: the encoder, the
    # decoder's self-attention and its cross-attention each through the
    # flash kernel); on the CPU, reduced (2 + 2 layers, 16 frames):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --model whisper-medium --no-reduced --requests 16 --max-batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --model whisper-medium --device cpu --requests 32 --max-batch 8

Single process only; the sharded mesh, process workers, ensembles and
the durable state directory of ``repro.launch.serve`` wait for later
slices of the port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _traffic_datasets(n_clients: int, window: int, seed: int):
    """Per-client window datasets from the synthetic S&P500 generator
    (distinct ticker per client); ``.x`` feeds traffic, ``.v`` is the
    extreme-event label of each window's next step."""
    from repro_torch.data import load_stock, make_windows

    return [make_windows(load_stock(f"CLIENT{c}", n_days=window + 64,
                                    seed=seed + c), window=window)
            for c in range(n_clients)]


def _precision_recall(alerts: np.ndarray, labels: np.ndarray):
    tp = int(np.sum(alerts & (labels != 0)))
    fp = int(np.sum(alerts & (labels == 0)))
    fn = int(np.sum(~alerts & (labels != 0)))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    return precision, recall, tp, fp, fn


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns the traffic and session telemetry snapshots
    (``{"traffic": ..., "sessions": ... or None}``)."""
    from repro_torch.configs import list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="paper-lstm",
                    choices=["paper-lstm", *list_archs()],
                    help="the model to host: the paper LSTM or a zoo arch "
                    "the port runs (dense qwen1.5-4b, nemotron-4-15b, "
                    "granite-20b, qwen2.5-32b; VLM chameleon-34b; MoE "
                    "mixtral-8x7b, qwen3-moe-235b-a22b; SSM mamba2-370m; "
                    "hybrid zamba2-2.7b; audio whisper-medium)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="host a trained serving checkpoint (the output "
                    "of `-m repro_torch.launch.train --save`) under the "
                    "--model key instead of a freshly initialized model")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced (CPU smoke) zoo config; "
                    "--no-reduced hosts the full config")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="tokens per request of a zoo arch")
    ap.add_argument("--sessions", action="store_true",
                    help="also demo O(1) per-step session serving")
    ap.add_argument("--alert-threshold", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="record per-request trace spans (submit -> queue "
                    "-> flush -> ... -> reply) and print a span summary "
                    "of the slowest trace")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card; "
                    "'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    from repro_torch.obs import Tracer
    from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                     ServingEngine, Telemetry,
                                     build_lstm_forecaster,
                                     build_zoo_forecaster)

    registry = ModelRegistry()
    if args.checkpoint:
        fc = registry.load(args.checkpoint, key=args.model,
                           device=args.device)
        print(f"hosting checkpoint {args.checkpoint} as {args.model!r} "
              f"(kind={fc.kind}, v{registry.version(args.model)})")
    elif args.model == "paper-lstm":
        fc = build_lstm_forecaster(seed=args.seed, device=args.device)
    else:
        fc = build_zoo_forecaster(args.model, seed=args.seed,
                                  reduced=args.reduced, device=args.device)
    if args.model not in registry:
        registry.register(args.model, fc)
    print(f"hosting {args.model!r} on {fc.device}")

    labels = np.zeros((0,), np.int64)
    if fc.feature_dim:                      # window-stream (LSTM) traffic
        streams = _traffic_datasets(args.clients, fc.window, args.seed)
        payloads, labels_list = [], []
        for i in range(args.requests):
            ds = streams[i % args.clients]
            j = i % len(ds)
            payloads.append(ds.x[j])
            labels_list.append(int(ds.v[j]))
        labels = np.asarray(labels_list)
    else:                                   # token traffic for zoo archs
        from repro_torch.data.tokens import synthetic_token_batch
        payloads = list(synthetic_token_batch(
            args.requests, args.prompt_len, fc.cfg.vocab, seed=args.seed))

    # bucket exactly the lengths this trace contains: no padding waste
    lengths = tuple(sorted({p.shape[0] for p in payloads}))
    cfg = BatcherConfig(max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        length_buckets=lengths)
    tracer = Tracer(capacity=1024) if args.trace else None
    engine = ServingEngine(registry, cfg, tracer=tracer)
    session_snap = None
    with engine:
        engine.warmup(args.model, lengths=lengths)
        engine.telemetry.reset_clock()
        t0 = time.time()
        futures = [engine.submit(args.model, p,
                                 client_id=f"client-{i % args.clients}")
                   for i, p in enumerate(payloads)]
        results = [f.result(timeout=60.0) for f in futures]
        wall = time.time() - t0
        snap = engine.telemetry.snapshot()
        if args.sessions and fc.feature_dim:
            # engine-resident sessions over the decode slots: carries
            # stay in device lanes between ticks, and each tick's steps
            # flush as ONE generate instead of one call per client
            streams = _traffic_datasets(min(args.clients, 8), fc.window,
                                        args.seed + 1)
            t0s = time.time()
            n_steps = 0
            for step in range(fc.window):
                futs = [engine.submit_step(args.model, f"client-{c}",
                                           ds.x[0][step])
                        for c, ds in enumerate(streams)]
                for f in futs:
                    f.result(timeout=30.0)
                n_steps += len(futs)
            wall_s = time.time() - t0s
            session_snap = engine.telemetry.snapshot()
            print(f"sessions (batched decode): {n_steps} steps in "
                  f"{wall_s*1e3:.1f} ms "
                  f"({n_steps/max(wall_s,1e-9):.0f} steps/s); "
                  f"{session_snap['step_batches']} fused flushes, mean "
                  f"batch {session_snap['mean_step_batch']:.1f}, step p95 "
                  f"{session_snap['step_p95_ms']:.2f} ms")

    alert_mask = np.asarray([p >= args.alert_threshold
                             for _, p in results], dtype=bool)
    alerts = [(i, y, p) for i, (y, p) in enumerate(results)
              if p >= args.alert_threshold]
    print(f"{args.model}: {len(results)} requests in {wall*1e3:.1f} ms")
    print(Telemetry.format(snap))
    print(f"extreme alerts (p >= {args.alert_threshold}): {len(alerts)}"
          + (f", first: req {alerts[0][0]} forecast {alerts[0][1]:+.4f} "
             f"p {alerts[0][2]:.3f}" if alerts else ""))
    if labels.size:
        precision, recall, tp, fp, fn = _precision_recall(alert_mask,
                                                          labels)
        print(f"alert quality vs synthetic extreme labels: precision "
              f"{precision:.3f}  recall {recall:.3f}  (tp={tp} fp={fp} "
              f"fn={fn}, base rate {float(np.mean(labels != 0)):.3f})")
    if tracer is not None:
        done = tracer.traces()
        if done:
            slow = max(done, key=lambda t: t.duration)
            parts = "  ".join(
                f"{s.name} {s.dur*1e3:.2f}ms"
                for s in sorted(slow.spans, key=lambda s: s.t0))
            print(f"traces: {len(done)} recorded; slowest "
                  f"({slow.op}, {slow.duration*1e3:.2f} ms): {parts}")
    return {"traffic": snap, "sessions": session_snap}


if __name__ == "__main__":
    main()
