#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # from the repo root, on the card

It builds the hand-written CUDA kernels from the sources in the
checkout, holds each against its plain PyTorch version on the card,
checks the forecaster's bitwise step == replay == generate contract,
serves the paper LSTM (full width, random weights from seed 0) through
``ServingEngine`` and the ``repro_torch.launch.serve`` CLI, times each
kernel beside its plain version, ``torch.lstm_cell`` and its bound, and
reads the device's busy share while serving with ``torch.profiler``.
Any failed phase exits non-zero. The last two lines are a JSON
object per kernel and ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-6         # kernel vs plain, as tests/test_kernels.py
FC_RTOL, FC_ATOL = 1e-4, 1e-5   # card vs CPU over the whole model
# (B, I, H) the serving path gives the cell: the decode lane (B = 8),
# the slot state (64), the request batch (max_batch = 32); I = 5 for
# layer 1 and 64 for layer 2
PATH_SHAPES = [(8, 5, 64), (8, 64, 64), (32, 5, 64), (32, 64, 64),
               (64, 64, 64)]
# the odd shapes of the JAX package's kernel sweep
ODD_SHAPES = [(1, 5, 64), (13, 5, 64), (32, 7, 32), (8, 16, 128),
              (3, 9, 24), (7, 3, 40), (1, 1, 8), (9, 11, 48), (5, 5, 16)]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cell_inputs(B, I, H, seed=0):
    g = torch.Generator().manual_seed(seed * 1_000_003 + B * 10_007
                                      + I * 101 + H)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).cuda()

    return (r(B, I), r(B, H), r(B, H), r(I, 4 * H, scale=0.1),
            r(H, 4 * H, scale=0.1), r(4 * H, scale=0.1))


def cell_bound(B, I, H):
    """Least time (ms) for one cell at (B, I, H) and what bounds it:
    each input read once and each output written once (fp32), and the
    operations of the two products plus the gate math (each
    transcendental counted as one operation)."""
    nbytes = 4 * (B * I + 2 * B * H + I * 4 * H + H * 4 * H + 4 * H
                  + 2 * B * H)
    ops = 2 * B * 4 * H * (I + H) + 4 * B * H + 9 * B * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, inner=50, reps=21):
    """Median device time (ms) of one ``fn()`` call: ``inner`` calls are
    captured in a CUDA graph, the graph is replayed ``reps`` times
    between CUDA events. Host launch overhead is left out; the weights
    stay warm in L2, as in serving, which reuses them every step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def eager_ms(fn, n=200):
    """Time (ms) per eager ``fn()`` call, host launch overhead included:
    what one call costs the serving path."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def build_kernels() -> None:
    """Phase 1: build every kernel of the path from the checkout."""
    from repro_torch.kernels import build
    from repro_torch.kernels.lstm import kernel as lstm_kernel

    lib = build.library_path("lstm_cell", lstm_kernel.SOURCES)
    cached = lib.exists()
    t0 = time.perf_counter()
    lstm_kernel.smem_bytes(5, 64)          # builds and loads the library
    print(f"[build] lstm_cell: {'cached' if cached else 'built'} in "
          f"{time.perf_counter() - t0:.2f} s -> {lib.relative_to(ROOT)}")


def check_kernels() -> float:
    """Phase 2: each kernel against its plain version on the card, and
    the LSTM cell's per-row bits independent of B. Returns the largest
    |kernel - plain| seen."""
    from repro_torch.kernels.lstm.ops import lstm_cell
    from repro_torch.kernels.lstm.ref import lstm_cell_ref

    max_err = 0.0
    for B, I, H in PATH_SHAPES + ODD_SHAPES:
        args = cell_inputs(B, I, H)
        hk, ck = lstm_cell(*args)
        hr, cr = lstm_cell_ref(*args)
        torch.cuda.synchronize()
        err = max(float((hk - hr).abs().max()), float((ck - cr).abs().max()))
        max_err = max(max_err, err)
        ok = torch.allclose(hk, hr, rtol=RTOL, atol=ATOL) \
            and torch.allclose(ck, cr, rtol=RTOL, atol=ATOL)
        print(f"[check] lstm_cell B={B} I={I} H={H}: max |kernel - plain| "
              f"{err:.3e} (rtol {RTOL}, atol {ATOL}) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"lstm_cell kernel disagrees with its plain version at "
                  f"B={B} I={I} H={H}")
    for I in (5, 64):
        x, h, c, wx, wh, b = cell_inputs(64, I, 64, seed=1)
        h64, c64 = lstm_cell(x, h, c, wx, wh, b)
        for lo in range(0, 64, 8):
            h8, c8 = lstm_cell(x[lo:lo + 8].contiguous(),
                               h[lo:lo + 8].contiguous(),
                               c[lo:lo + 8].contiguous(), wx, wh, b)
            check(torch.equal(h8, h64[lo:lo + 8])
                  and torch.equal(c8, c64[lo:lo + 8]),
                  f"rows {lo}..{lo + 7} of a B=64 launch differ from a "
                  f"B=8 launch of the same rows (I={I})")
    print("[check] lstm_cell rows of B=8 launches == the same rows of a "
          "B=64 launch, bitwise (I=5 and I=64)")
    return max_err


def check_forecaster():
    """Phase 3: the paper LSTM on the card: step == replay == generate
    bitwise, and predict against the same port on the CPU. Returns the
    forecaster."""
    from repro_torch.checkpoint.convert import params_to
    from repro_torch.launch import serve
    from repro_torch.serving import LSTMForecaster, build_lstm_forecaster

    fc = build_lstm_forecaster(seed=0, device="cuda")
    check(fc.device.type == "cuda", f"forecaster on {fc.device}")
    streams = serve._traffic_datasets(3, fc.window, seed=7)
    w = np.stack([ds.x[0] for ds in streams])              # [3, 20, 5]
    carry = fc.init_carry(1)
    for t in range(fc.window):
        ys, ps, carry = fc.step(w[0:1, t], carry)
    yr, pr, cr = fc.replay(w[0:1])
    slots = fc.init_slots(64)
    lanes = (5, 17, 42)                 # three different lane chunks
    for lane in lanes:
        fc.insert(slots, lane, fc.init_carry(1))
    for t in range(fc.window):
        xs = np.zeros((slots.num_slots, fc.feature_dim), np.float32)
        for s, lane in enumerate(lanes):
            xs[lane] = w[s, t]
        yg, pg, _ = fc.generate(slots, xs, lanes=list(lanes))
    torch.cuda.synchronize()
    same = (np.array_equal(ys, yr) and np.array_equal(ps, pr)
            and ys[0] == yg[lanes[0]] and ps[0] == pg[lanes[0]])
    for (h1, c1), (h2, c2), (hs, cs) in zip(carry, cr, slots.carry):
        same = same and torch.equal(h1, h2) and torch.equal(c1, c2) \
            and torch.equal(h1[0], hs[lanes[0]]) \
            and torch.equal(c1[0], cs[lanes[0]])
    check(same, "step, replay and generate disagree bitwise on the card")
    for s in (1, 2):
        y1, p1, _ = fc.replay(w[s:s + 1])
        check(y1[0] == yg[lanes[s]] and p1[0] == pg[lanes[s]],
              f"generate lane {lanes[s]} != replay of its session")
    print(f"[forecaster] step == replay == generate bitwise on the card "
          f"(y {float(ys[0]):+.6f}, p {float(ps[0]):.6f})")
    windows = np.concatenate([ds.x[:16] for ds in streams])  # [48, 20, 5]
    y_gpu, p_gpu = fc.predict(windows)
    cpu = LSTMForecaster(cfg=fc.cfg, params=params_to(fc.params, "cpu"),
                         tail=fc.tail, eps=fc.eps, device="cpu")
    y_cpu, p_cpu = cpu.predict(windows)
    check(np.all(np.isfinite(y_gpu)) and np.all(np.isfinite(p_gpu))
          and y_gpu.shape == (48,), "predict on the card: bad output")
    dy = float(np.abs(y_gpu - y_cpu).max())
    dp = float(np.abs(p_gpu - p_cpu).max())
    check(np.allclose(y_gpu, y_cpu, rtol=FC_RTOL, atol=FC_ATOL)
          and np.allclose(p_gpu, p_cpu, rtol=FC_RTOL, atol=FC_ATOL),
          f"predict on the card vs on the CPU: max |dy| {dy}, |dp| {dp}")
    print(f"[forecaster] predict card vs CPU (plain path, same params), 48 "
          f"windows: max |dy| {dy:.3e}, |dp| {dp:.3e} (rtol {FC_RTOL}, "
          f"atol {FC_ATOL})")
    return fc


def serve_main_path(fc, tag: str):
    """Phase 4, the main path: 128 windowed requests from 32 clients,
    then 20 ticks of ``submit_step`` from 8 clients, through
    ``ServingEngine``. Kernel launch counts are zeroed just before and
    read just after. Returns (launches by shape, payloads, sessions)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.lstm import kernel as lstm_kernel
    from repro_torch.launch import serve
    from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                     ServingEngine)

    registry = ModelRegistry()
    registry.register("paper-lstm", fc)
    traffic = serve._traffic_datasets(32, fc.window, seed=0)
    payloads = [traffic[i % 32].x[i % len(traffic[i % 32])]
                for i in range(128)]
    sessions = serve._traffic_datasets(8, fc.window, seed=1)
    engine = ServingEngine(registry, BatcherConfig(
        max_batch=32, max_wait_ms=2.0, length_buckets=(fc.window,)))
    with engine:
        engine.warmup("paper-lstm", lengths=(fc.window,))
        engine.telemetry.reset_clock()
        lstm_kernel.LAUNCHES.reset()
        with dispatch.counting() as counts:
            t0 = time.perf_counter()
            futs = [engine.submit("paper-lstm", p,
                                  client_id=f"client-{i % 32}")
                    for i, p in enumerate(payloads)]
            results = [f.result(timeout=120.0) for f in futs]
            wall = time.perf_counter() - t0
            traffic_snap = engine.telemetry.snapshot()
            n_predict = lstm_kernel.LAUNCHES.total
            step_results = []
            t0s = time.perf_counter()
            for t in range(fc.window):
                futs = [engine.submit_step("paper-lstm", f"client-{c}",
                                           ds.x[0][t])
                        for c, ds in enumerate(sessions)]
                step_results.append([f.result(timeout=60.0) for f in futs])
            wall_s = time.perf_counter() - t0s
        launches = dict(lstm_kernel.LAUNCHES.by_shape)
    snap = engine.telemetry.snapshot()
    n_generate = sum(launches.values()) - n_predict
    flushes, step_flushes = traffic_snap["batches"], snap["step_batches"]
    check(len(results) == 128 and all(np.isfinite(v) for r in results
                                      for v in r),
          "a served request did not resolve to finite values")
    check(traffic_snap["requests"] == 128, "served request count")
    check(snap["step_requests"] == 8 * fc.window, "served step count")
    check(counts["predict"] == flushes,
          f"{counts['predict']} predict dispatches for {flushes} flushes")
    check(counts["slots_generate"] == step_flushes,
          f"{counts['slots_generate']} slots_generate for {step_flushes} "
          f"step flushes: not one per flush")
    check(counts["decode_many"] == 0 and counts["decode_step"] == 0,
          "step flushes left the slot path")
    check(n_predict > 0 and n_generate > 0,
          f"kernel launches: {n_predict} on predict, {n_generate} on "
          f"generate: the path did not run the kernel on both")
    y_ref, p_ref = fc.predict(np.stack(payloads))
    got = np.asarray(results, np.float32)
    check(np.allclose(got[:, 0], y_ref, rtol=FC_RTOL, atol=FC_ATOL)
          and np.allclose(got[:, 1], p_ref, rtol=FC_RTOL, atol=FC_ATOL),
          "served forecasts disagree with one predict of the same windows")
    for c, ds in enumerate(sessions):
        y1, p1, _ = fc.replay(ds.x[0][None])
        check(step_results[-1][c] == (float(y1[0]), float(p1[0])),
              f"session client-{c}: served steps != its replay, bitwise")
    print(f"[serve] {tag}: 128 requests from 32 clients in "
          f"{wall * 1e3:.1f} ms: {traffic_snap['throughput_rps']:.1f} req/s, "
          f"p50 {traffic_snap['p50_ms']:.3f} ms, p95 "
          f"{traffic_snap['p95_ms']:.3f} ms, {flushes} predict flushes, "
          f"{n_predict} kernel launches = {n_predict / flushes:.1f} per "
          f"predict flush")
    print(f"[serve] {tag}: {8 * fc.window} session steps from 8 clients in "
          f"{wall_s * 1e3:.1f} ms: {step_flushes} step flushes, "
          f"{counts['slots_generate']} slots_generate, step p50 "
          f"{snap['step_p50_ms']:.3f} ms p95 {snap['step_p95_ms']:.3f} ms, "
          f"{n_generate} kernel launches = {n_generate / step_flushes:.1f} "
          f"per generate flush; served steps == replay, bitwise")
    print(f"[serve] dispatch counts {counts.by_op()}; kernel launches by "
          f"(B, I, H) {launches}")
    return launches, payloads, sessions


def run_cli(window: int) -> None:
    """Phase 5: the serving CLI on the card."""
    from repro_torch.launch import serve

    out = serve.main(["--model", "paper-lstm", "--clients", "32",
                      "--requests", "128", "--max-batch", "32",
                      "--sessions", "--device", "cuda"])
    check(out["traffic"]["requests"] == 128
          and out["sessions"]["step_requests"] == 8 * window,
          "python -m repro_torch.launch.serve did not serve everything")
    print("[cli] repro_torch.launch.serve --sessions --device cuda: ok")


def time_kernels(launches: dict, tag: str) -> dict:
    """Phase 6: the cell's time at every shape of the path beside its
    plain version, ``torch.lstm_cell`` (the yardstick, never called by
    the port) and its bound. Returns a row per (B, I, H)."""
    from repro_torch.kernels.lstm.ops import lstm_cell
    from repro_torch.kernels.lstm.ref import lstm_cell_ref

    rows = {}
    for B, I, H in sorted(set(PATH_SHAPES) | set(launches) | {(1, 1, 8)}):
        x, h, c, wx, wh, b = cell_inputs(B, I, H, seed=2)
        wx_t, wh_t = wx.t().contiguous(), wh.t().contiguous()
        zero = torch.zeros_like(b)
        hl, cl = torch.lstm_cell(x, (h, c), wx_t, wh_t, b, zero)
        hr, cr = lstm_cell_ref(x, h, c, wx, wh, b)
        check(torch.allclose(hl, hr, rtol=RTOL, atol=ATOL)
              and torch.allclose(cl, cr, rtol=RTOL, atol=ATOL),
              f"torch.lstm_cell is not the same function at {B, I, H}")
        bound, by = cell_bound(B, I, H)
        rows[(B, I, H)] = {
            "ms": graph_ms(lambda: lstm_cell(x, h, c, wx, wh, b)),
            "plain_ms": graph_ms(lambda: lstm_cell_ref(x, h, c, wx, wh, b)),
            "library_ms": graph_ms(lambda: torch.lstm_cell(
                x, (h, c), wx_t, wh_t, b, zero)),
            "eager_ms": eager_ms(lambda: lstm_cell(x, h, c, wx, wh, b)),
            "bound_ms": bound, "bound_by": by}
    floor = rows[(1, 1, 8)]
    print(f"[time] {tag}: launch floor (kernel at B=1 I=1 H=8): "
          f"{floor['ms'] * 1e3:.2f} us per launch in a CUDA graph, "
          f"{floor['eager_ms'] * 1e3:.2f} us per eager wrapper call")
    for (B, I, H), r in rows.items():
        print(f"[time] {tag}: lstm_cell B={B} I={I} H={H}: kernel "
              f"{r['ms'] * 1e3:.2f} us (eager call {r['eager_ms'] * 1e3:.2f}"
              f" us), plain {r['plain_ms'] * 1e3:.2f} us, torch.lstm_cell "
              f"{r['library_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}); "
              f"{launches.get((B, I, H), 0)} launches on the main path")
    return rows


def profile_serving(fc, payloads, sessions, tag: str) -> None:
    """Phase 7, where the time goes: the device's busy share (kernel
    time from ``torch.profiler`` over wall time) while serving."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import (BatcherConfig, ModelRegistry,
                                     ServingEngine)

    def busy(label, drive):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = sorted(((e.self_device_time_total, e.count, e.key)
                          for e in prof.key_averages()
                          if e.self_device_time_total > 0), reverse=True)
        device_us = sum(k[0] for k in kernels)
        top = "; ".join(f"{us:.1f} us x{n} {key[:48]}"
                        for us, n, key in kernels[:4])
        print(f"[profile] {tag}: {label}: wall {wall_us:.0f} us, device "
              f"busy {device_us:.1f} us = {100 * device_us / wall_us:.2f} % "
              f"(idle {100 - 100 * device_us / wall_us:.2f} %); top: {top}")

    def ticks():
        for t in range(fc.window):
            for f in [engine.submit_step("paper-lstm", f"p{c}", ds.x[0][t])
                      for c, ds in enumerate(sessions)]:
                f.result(timeout=60.0)

    registry = ModelRegistry()
    registry.register("paper-lstm", fc)
    with ServingEngine(registry, BatcherConfig(
            max_batch=32, max_wait_ms=2.0,
            length_buckets=(fc.window,))) as engine:
        engine.warmup("paper-lstm", lengths=(fc.window,))
        busy("128 requests, 32 clients", lambda: [
            f.result(timeout=120.0) for f in
            [engine.submit("paper-lstm", p) for p in payloads]])
        busy("20 ticks of 8 session steps", ticks)


def kernel_entry(rows: dict, launches: dict, max_err: float) -> dict:
    """The cell's line of the report: times weighted by the main path's
    launches at each shape."""
    n = sum(launches.values())

    def weighted(key):
        return sum(k * rows[s][key] for s, k in launches.items()) / n

    return {
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/lstm/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm/kernel.py:21",
        "launches": n, "max_abs_err": max_err,
        "ms": weighted("ms"), "plain_ms": weighted("plain_ms"),
        "bound_ms": weighted("bound_ms"),
        "bound_by": rows[max(launches, key=launches.get)]["bound_by"],
        "library_ms": weighted("library_ms"),
        "shapes": {f"{B}x{I}x{H}": k for (B, I, H), k in launches.items()}}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    name = torch.cuda.get_device_name(0)
    tag = f"{name} | {card}"
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build_kernels()
    max_err = check_kernels()
    fc = check_forecaster()
    launches, payloads, sessions = serve_main_path(fc, tag)
    run_cli(fc.window)
    rows = time_kernels(launches, tag)
    profile_serving(fc, payloads, sessions, tag)
    print(card)
    print(json.dumps({"kernels": [kernel_entry(rows, launches, max_err)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
