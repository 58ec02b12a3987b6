"""One serving interface over the port's models: ``predict(windows,
lengths) -> (forecast, extreme_probability)``.

``LSTMForecaster`` serves the paper LSTM, with O(1) streaming by
explicit carries and device-resident decode slots besides.
``ZooForecaster`` serves a zoo arch (every family: the dense, vlm,
moe, ssm, hybrid and audio ones: Qwen1.5-4B, Nemotron-4-15B,
Granite-20B, Qwen2.5-32B, Chameleon-34B, Mixtral-8x7B,
Qwen3-MoE-235B-A22B, Mamba2-370M, Zamba2-2.7B, Whisper-medium) as
next-token prediction over right-padded token windows: the forecast is
the greedy next token and the extreme probability the EVT-calibrated
surprisal of it. Whisper's audio frontend is a stub: its encoder reads
``stub_frames``, random frame embeddings drawn on the device from a
generator seeded 0. On the card every attention (a dense layer's,
Zamba2's shared block after each stage, Whisper's encoder, decoder and
cross-attention) runs through the hand-written CUDA flash-attention
kernel, and every Mamba2 layer's scan through the hand-written CUDA SSD
kernel.

For the LSTM, the forecast is the next-step normalized close; the
extreme probability fuses the EVL sigmoid head with the EVT tail
machinery of ``repro_torch.extreme`` (eq. 3 GEV depth-into-tail) by
noisy-OR.

Every call runs eagerly on ``device`` (the card unless the caller asks
for the CPU). On the card every LSTM layer runs the hand-written CUDA
layer kernel: over the whole window in ``predict`` and ``replay``, at
T = 1 in each streaming step. The bitwise contracts of the JAX package
hold inside the port: a session's ``step``, its ``replay`` and its
slot-resident ``generate`` give the same bits. Three things carry that:

- every streaming step runs at ONE fixed batch width (``decode_width``,
  padded; larger batches chunk), so the FC head's matmuls and the
  elementwise ops always see the same shapes, whatever the path;
- the LSTM kernel's per-row result does not depend on B or on the row's
  place in the batch (a fixed per-row reduction order);
- a T-step launch of the layer kernel is T launches at T = 1 chained,
  bit for bit (one loop body), and ``replay`` applies the head to the
  kernel's contiguous hT, as each step does.

There are no donated buffers in PyTorch: ``insert`` and ``generate``
update the slot tensors IN PLACE (``generate`` only under its step
mask, so lanes it does not step come out unchanged), and ``extract``
returns a copy. Inputs are built on the host and copied once per call;
results come back in one device-to-host copy.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.convert import params_to
from repro_torch.device import resolve_device
from repro_torch.extreme.evt import fit_tail, gev_cdf
from repro_torch.extreme.indicators import quantile_thresholds
from repro_torch.kernels import dispatch
from repro_torch.models.rnn import (RNNConfig, init_rnn, init_rnn_carry,
                                    lstm_layer_apply, rnn_apply_padded,
                                    rnn_head, rnn_step, split_rnn_carry,
                                    stack_rnn_carries)
from repro_torch.tree import tree_leaves

PyTree = Any


def _fused_alert(score, head, xi, scale, active, gamma):
    """GEV depth-into-tail of ``score`` (zero when uncalibrated, i.e.
    ``active`` False), noisy-OR'ed with the learned head, in [0, 1]."""
    if active:
        p = gev_cdf((score - xi) / max(scale, 1e-8), gamma)
    else:
        p = torch.zeros_like(score)
    if head is not None:
        p = 1.0 - (1.0 - head) * (1.0 - p)
    return torch.clamp(p, 0.0, 1.0)


def _alert_probability(score, tail: dict | None, gamma: float, head=None):
    """Host-side twin of ``_fused_alert`` over a calibration dict:
    ``score`` is the magnitude judged, ``tail`` the ``fit_tail`` result
    (None: no EVT term), ``head`` an optional learned probability."""
    score = torch.as_tensor(score, dtype=torch.float32)
    if head is not None:
        head = torch.as_tensor(head, dtype=torch.float32)
    if tail is None:
        return _fused_alert(score, head, 0.0, 1.0, False, gamma)
    return _fused_alert(score, head, tail["xi"], tail["scale"], True, gamma)


def _pad_rows(t, width: int):
    """``t`` [n, ...] right-padded with zero rows to [width, ...]."""
    n = t.shape[0]
    if n == width:
        return t
    return torch.cat([t, t.new_zeros((width - n,) + tuple(t.shape[1:]))])


def _to_host(y, p):
    """(y, p) device vectors -> two float32 numpy arrays, one copy."""
    out = torch.stack((y, p)).cpu().numpy()
    return out[0], out[1]


@dataclasses.dataclass
class DecodeSlots:
    """Device-resident decode slot state: ``num_slots`` lanes of stacked
    (h, c) carries on the device, plus a host-side active-lane mask.
    ``num_slots`` is a multiple of the owning forecaster's
    ``decode_width`` (``init_slots`` rounds up), so ``generate`` walks
    the state in whole lane-width chunks."""

    carry: PyTree                # [num_slots, H] (h, c) per layer
    num_slots: int
    active: Any                  # np.ndarray bool [num_slots], host-side

    @property
    def n_active(self) -> int:
        return int(self.active.sum())


@dataclasses.dataclass
class LSTMForecaster:
    """Paper LSTM behind the serving interface. ``tail`` holds the
    ``fit_tail`` parameters over |forecast| scores; ``eps`` the eq. 1
    indicator thresholds. ``params`` are moved to ``device``."""

    cfg: RNNConfig
    params: PyTree
    tail: dict | None = None
    eps: tuple[float, float] = (0.01, 0.01)
    gamma: float = 5.0
    # stamped by ModelRegistry.register/swap
    version: int = 0
    published_at: float | None = None
    # every streaming step / replay / generate runs at this fixed batch
    # width (padded; larger batches chunk) - see the module docstring
    decode_width: int = 8
    device: Any = "cuda"
    kind: str = dataclasses.field(default="lstm", init=False)

    def __post_init__(self):
        if self.decode_width < 1:
            raise ValueError(
                f"decode_width must be >= 1, got {self.decode_width}")
        self.device = resolve_device(self.device)
        self.params = params_to(self.params, self.device)

    # -- batched serving ---------------------------------------------------
    @property
    def window(self) -> int:
        return self.cfg.window

    @property
    def feature_dim(self) -> int:
        return self.cfg.input_dim

    def _tail_args(self):
        """(xi, scale, active) for the fused alert."""
        if self.tail is None:
            return 0.0, 1.0, False
        return float(self.tail["xi"]), float(self.tail["scale"]), True

    def _host_rows(self, a, width: int | None = None):
        """Host array -> float32 device tensor in one copy, zero-padded
        along dim 0 to ``width`` rows on the host first."""
        a = np.asarray(a, np.float32)
        if width is not None and a.shape[0] != width:
            padded = np.zeros((width,) + a.shape[1:], np.float32)
            padded[:a.shape[0]] = a
            a = padded
        return torch.as_tensor(a, device=self.device)

    def _step(self, x_t, carry):
        """The per-step computation every streaming path shares: model
        step + fused alert, at whatever width it is given."""
        y, u, carry = rnn_step(self.params, x_t, carry, cfg=self.cfg)
        p = _fused_alert(torch.abs(y), u, *self._tail_args(), self.gamma)
        return y, p, carry

    def predict(self, windows, lengths=None):
        """windows [B, T, F] (right-padded), lengths [B] true lengths.
        Returns (forecast [B], p_extreme [B]) as float32 numpy arrays."""
        x = self._host_rows(windows)
        B, T = x.shape[0], x.shape[1]
        lens = np.full((B,), T, np.int64) if lengths is None \
            else np.asarray(lengths, np.int64)
        dispatch.record("predict", batch=B, hidden=self.cfg.hidden,
                        device=self.device)
        y, u = rnn_apply_padded(self.params, x,
                                torch.as_tensor(lens, device=self.device),
                                cfg=self.cfg)
        p = _fused_alert(torch.abs(y), u, *self._tail_args(), self.gamma)
        return _to_host(y, p)

    # -- incremental (session) serving ------------------------------------
    def init_carry(self, batch: int = 1):
        return init_rnn_carry(self.params, batch)

    def carry_nbytes(self, batch: int = 1) -> int:
        return sum(h.numel() * h.element_size() + c.numel()
                   * c.element_size() for h, c in self.init_carry(batch))

    def step(self, x_t, carry):
        """One O(1) streaming step: x_t [B, F]. Returns (forecast [B],
        p_extreme [B], new_carry), run at ``decode_width`` (padded;
        batches beyond the width chunk)."""
        x_t = np.asarray(x_t, np.float32)
        B = x_t.shape[0]
        W = self.decode_width
        if B > W:
            ys, ps, carries = [], [], []
            for lo in range(0, B, W):
                chunk = tuple((h[lo:lo + W], c[lo:lo + W]) for h, c in carry)
                y, p, c2 = self.step(x_t[lo:lo + W], chunk)
                ys.append(y), ps.append(p), carries.append(c2)
            return (np.concatenate(ys), np.concatenate(ps),
                    stack_rnn_carries(carries))
        dispatch.record("decode_step", batch=W, hidden=self.cfg.hidden,
                        device=self.device)
        cp = tuple((_pad_rows(h, W), _pad_rows(c, W)) for h, c in carry)
        y, p, c2 = self._step(self._host_rows(x_t, W), cp)
        y, p = _to_host(y, p)
        return y[:B], p[:B], tuple((h[:B], c[:B]) for h, c in c2)

    def step_many(self, xs, carries):
        """Batched streaming step for N independent sessions: xs [N, F],
        ``carries`` a list of N batch-1 carries. Returns (forecast [N],
        p_extreme [N], new_carries list), one lane-width step per
        ``decode_width`` sessions."""
        xs = np.asarray(xs, np.float32)
        N = len(carries)
        W = self.decode_width
        ys, ps, out = [], [], []
        for lo in range(0, N, W):
            chunk = list(carries[lo:lo + W])
            n = len(chunk)
            dispatch.record("decode_many", batch=W, hidden=self.cfg.hidden,
                            device=self.device)
            y, p, c2 = self._step(self._host_rows(xs[lo:lo + n], W),
                                  stack_rnn_carries(chunk, pad_to=W))
            y, p = _to_host(y, p)
            ys.append(y[:n])
            ps.append(p[:n])
            out.extend(split_rnn_carry(c2, n))
        return np.concatenate(ys), np.concatenate(ps), out

    def replay(self, window, carry=None):
        """Full-window recompute (what a cache miss executes), layer by
        layer at the decode-lane width like every step: one layer call
        over the window each (on the card one launch of the layer kernel,
        whose rows are bitwise its steps chained), then the head and the
        alert once, so cached incremental serving is bitwise-identical to
        it. window [B, T, F]; returns (forecast [B], p_extreme [B], carry)
        after the last step."""
        window = np.asarray(window, np.float32)
        B = window.shape[0]
        if carry is None:
            carry = self.init_carry(B)
        if window.shape[1] == 0:
            return None, None, carry
        W = self.decode_width
        if B > W:
            ys, ps, carries = [], [], []
            for lo in range(0, B, W):
                chunk = tuple((h[lo:lo + W], c[lo:lo + W]) for h, c in carry)
                y, p, c2 = self.replay(window[lo:lo + W], chunk)
                ys.append(y), ps.append(p), carries.append(c2)
            return (np.concatenate(ys), np.concatenate(ps),
                    stack_rnn_carries(carries))
        dispatch.record("decode_replay", batch=W, hidden=self.cfg.hidden,
                        device=self.device)
        h = self._host_rows(window, W)
        cp = []
        for lp, (h0, c0) in zip(self.params["lstm"], carry):
            h, layer_carry = lstm_layer_apply(lp, h, _pad_rows(h0, W),
                                              _pad_rows(c0, W))
            cp.append(layer_carry)
        # the head on the last layer's hT: contiguous [W, H], as every step
        # gives it, so that the head's matmuls see the same operands
        y, u = rnn_head(self.params, cp[-1][0], self.cfg)
        p = _fused_alert(torch.abs(y), u, *self._tail_args(), self.gamma)
        y, p = _to_host(y, p)
        return y[:B], p[:B], tuple((h[:B], c[:B]) for h, c in cp)

    # -- device-resident decode slots (prefill / insert / generate) --------
    def init_slots(self, num_slots: int) -> DecodeSlots:
        """Allocate the slot state: ``num_slots`` lanes of zero carries
        (rounded up to a ``decode_width`` multiple), all free."""
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        W = self.decode_width
        S = -(-int(num_slots) // W) * W
        return DecodeSlots(carry=init_rnn_carry(self.params, S),
                           num_slots=S, active=np.zeros((S,), bool))

    def prefill(self, window, carry=None):
        """Replay a session's window into a batch-1 carry ready for
        ``insert``: exactly ``replay``, so a prefilled lane is
        bitwise-equal to the step-by-step session it replaces."""
        return self.replay(window, carry)

    def insert(self, slots: DecodeSlots, lane: int, carry) -> DecodeSlots:
        """Write a batch-1 ``carry`` into ``lane``, in place on the
        device."""
        dispatch.record("slots_insert", batch=1, hidden=self.cfg.hidden,
                        device=self.device)
        for (sh, sc), (h, c) in zip(slots.carry, carry):
            sh[lane].copy_(h[0])
            sc[lane].copy_(c[0])
        slots.active[lane] = True
        return slots

    def extract(self, slots: DecodeSlots, lane: int):
        """A copy of ``lane``'s batch-1 carry (spill path); the lane is
        left intact."""
        dispatch.record("slots_extract", batch=1, hidden=self.cfg.hidden,
                        device=self.device)
        return tuple((h[lane:lane + 1].clone(), c[lane:lane + 1].clone())
                     for h, c in slots.carry)

    def release(self, slots: DecodeSlots, lane: int) -> None:
        """Mark ``lane`` free; its stale carry is overwritten by the next
        ``insert``."""
        slots.active[lane] = False

    def generate(self, slots: DecodeSlots, x, lanes=None):
        """Step the slot state: x [num_slots, F] (rows of lanes not
        stepped are ignored). ``lanes`` lists the lanes stepped (default:
        every active lane). Stepped lanes' carries are updated IN PLACE;
        every other lane comes out unchanged. Lane-width chunks holding
        no stepped lane are skipped. Returns (forecast [num_slots],
        p_extreme [num_slots], slots): read only the rows of ``lanes``."""
        x = np.asarray(x, np.float32)
        S = slots.num_slots
        if x.shape != (S, self.feature_dim):
            raise ValueError(f"generate expects x [{S}, "
                             f"{self.feature_dim}], got {x.shape}")
        mask = np.zeros((S,), bool)
        if lanes is None:
            mask[:] = slots.active
        else:
            mask[np.asarray(lanes, np.int64)] = True
        dispatch.record("slots_generate", batch=S, hidden=self.cfg.hidden,
                        device=self.device)
        W = self.decode_width
        xd = torch.as_tensor(x, device=self.device)
        md = torch.as_tensor(mask, device=self.device)[:, None]
        y = torch.zeros((S,), dtype=torch.float32, device=self.device)
        p = torch.zeros((S,), dtype=torch.float32, device=self.device)
        for lo in range(0, S, W):
            if not mask[lo:lo + W].any():
                continue
            chunk = tuple((h[lo:lo + W], c[lo:lo + W]) for h, c in slots.carry)
            yc, pc, stepped = self._step(xd[lo:lo + W], chunk)
            m = md[lo:lo + W]
            for (h, c), (h2, c2) in zip(chunk, stepped):
                h.copy_(torch.where(m, h2, h))
                c.copy_(torch.where(m, c2, c))
            y[lo:lo + W] = yc
            p[lo:lo + W] = pc
        y, p = _to_host(y, p)
        return y, p, slots

    def warm_slots(self, num_slots: int) -> int:
        """Run the slot lifecycle (insert / extract / generate) once
        against a throwaway slot state, off the serving path (on the card
        the first call builds the kernel). Returns #calls made."""
        slots = self.init_slots(num_slots)
        self.insert(slots, 0, self.init_carry(1))
        self.extract(slots, 0)
        self.generate(slots, np.zeros((slots.num_slots, self.feature_dim),
                                      np.float32), lanes=[0])
        return 3

    def warm_decode(self) -> int:
        """Run the decode-lane paths (single step, batched step,
        full-window replay) once off the serving path. Returns #calls."""
        F = self.feature_dim
        W = self.decode_width
        self.step(np.zeros((1, F), np.float32), self.init_carry(1))
        self.step_many(np.zeros((W, F), np.float32),
                       [self.init_carry(1) for _ in range(W)])
        self.replay(np.zeros((1, self.window, F), np.float32))
        return 3

    # -- calibration -------------------------------------------------------
    def calibrate(self, windows, quantile: float = 0.95) -> "LSTMForecaster":
        """Fit the EVT tail + indicator thresholds on this model's own
        forecast distribution over a reference window set."""
        y, _ = self.predict(windows)
        self.tail = fit_tail(np.abs(y), q=quantile)
        self.eps = quantile_thresholds(y, q=quantile)
        return self

    def with_params(self, params: PyTree) -> "LSTMForecaster":
        """Unpublished successor serving ``params`` with this model's
        calibration carried over (the hot-swap constructor)."""
        return dataclasses.replace(self, params=params, version=0,
                                   published_at=None)


def build_lstm_forecaster(seed: int = 0, cfg: RNNConfig | None = None,
                          params: PyTree | None = None,
                          calibrate_ticker: str | None = "AAPL",
                          n_days: int = 400,
                          device="cuda") -> LSTMForecaster:
    """Paper-config LSTM forecaster on ``device``: random weights from a
    ``torch.Generator`` seeded with ``seed`` unless ``params`` is given,
    EVT-calibrated on a synthetic reference series."""
    if cfg is None:
        from repro_torch.configs.paper_lstm import CONFIG
        cfg = CONFIG
    device = resolve_device(device)
    if params is None:
        params = init_rnn(torch.Generator().manual_seed(seed), cfg,
                          device=device)
    fc = LSTMForecaster(cfg=cfg, params=params, device=device)
    if calibrate_ticker is not None:
        from repro_torch.data import load_stock, make_windows
        ohlcv = load_stock(calibrate_ticker, n_days=n_days)
        ds = make_windows(ohlcv, window=cfg.window)
        fc.calibrate(ds.x)
    return fc


def stub_frames(cfg, batch: int, device) -> torch.Tensor:
    """The stubbed audio frontend's output a served audio forward reads:
    float32 [batch, n_frames, d_model] standard normals from a
    ``torch.Generator`` seeded 0 on ``device``, drawn there (no host
    copy). The JAX package draws ``jax.random.normal(PRNGKey(0), ...)``,
    whose bits torch cannot give, so the two packages serve Whisper on
    different frames; a parity test hands this function the JAX
    package's frames."""
    g = torch.Generator(device=device).manual_seed(0)
    return torch.randn((batch, cfg.n_frames, cfg.d_model), generator=g,
                       device=device)


@dataclasses.dataclass
class ZooForecaster:
    """A zoo arch behind the serving interface
    (``repro.serving.forecaster.ZooForecaster``): the forecast is the
    greedy next token after each window, the extreme probability its
    surprisal judged against the EVT tail fitted by ``calibrate``.
    ``params`` are moved to ``device``."""

    cfg: Any                     # repro_torch.configs.base.ArchConfig
    params: PyTree
    tail: dict | None = None
    gamma: float = 5.0
    version: int = 0
    published_at: float | None = None
    device: Any = "cuda"
    kind: str = dataclasses.field(default="zoo", init=False)

    def __post_init__(self):
        from repro_torch.models.model_zoo import build_model

        self.device = resolve_device(self.device)
        self.params = params_to(self.params, self.device)
        self._model = build_model(self.cfg)

    @property
    def window(self) -> int:
        return 32                # default serving context bucket

    @property
    def feature_dim(self) -> int:
        return 0                 # token ids, no feature axis

    def _forward(self, windows, lengths):
        """(greedy token [B], surprisal [B]) on the device for int token
        windows [B, T] (right-padded) and their true lengths. Like the
        JAX package, the log-softmax runs in the logits' dtype over the
        real vocab (padding ids sliced off) at each row's last real
        position."""
        tokens = torch.as_tensor(np.asarray(windows, np.int64),
                                 device=self.device)
        B, T = tokens.shape
        lens = np.full((B,), T, np.int64) if lengths is None \
            else np.asarray(lengths, np.int64)
        last_pos = torch.as_tensor(lens - 1, device=self.device)
        frames = stub_frames(self.cfg, B, self.device) \
            if self.cfg.family == "audio" else None
        logits, _ = self._model.forward(self.params, tokens, frames)
        last = logits[torch.arange(B, device=self.device), last_pos]
        last = last[:, :self.cfg.vocab]
        logp = torch.log_softmax(last, dim=-1)
        tok = torch.argmax(last, dim=-1)
        surprisal = -torch.gather(logp, 1, tok[:, None])[:, 0]
        return tok, surprisal

    def predict(self, windows, lengths=None):
        """windows int [B, T] token ids (right-padded), lengths [B] true
        lengths. Returns (next_token [B] as float32, p_extreme [B]) as
        numpy arrays, in one device-to-host copy."""
        tok, surprisal = self._forward(windows, lengths)
        p = _alert_probability(surprisal, self.tail, self.gamma)
        return _to_host(tok.to(torch.float32), p)

    def calibrate(self, windows, quantile: float = 0.95) -> "ZooForecaster":
        """Fit the EVT tail on this model's surprisal over full-length
        reference windows."""
        _, surprisal = self._forward(windows, None)
        self.tail = fit_tail(surprisal.to(torch.float32).cpu(), q=quantile)
        return self

    def with_params(self, params: PyTree) -> "ZooForecaster":
        """Unpublished successor serving ``params`` with this model's
        calibration carried over (the hot-swap constructor): a shallow
        copy sharing the model handle."""
        clone = copy.copy(self)
        clone.params = params_to(params, self.device)
        clone.version = 0
        clone.published_at = None
        return clone


def build_zoo_forecaster(arch: str, seed: int = 0, reduced: bool = True,
                         calibrate_batch: int = 8,
                         device="cuda") -> ZooForecaster:
    """A zoo arch (any the port registers: the dense ``qwen1.5-4b``,
    ``nemotron-4-15b``, ``granite-20b`` and ``qwen2.5-32b``, the VLM
    ``chameleon-34b``, the MoE ``mixtral-8x7b`` and
    ``qwen3-moe-235b-a22b``, the SSM ``mamba2-370m``, the hybrid
    ``zamba2-2.7b``, the audio ``whisper-medium``) served on
    ``device``: the full config, or its reduced CPU-smoke variant;
    random weights drawn from a ``torch.Generator``
    on ``device`` seeded with ``seed`` (on the card the model is drawn
    there, with no copy on the host; the CPU and the card give different
    weights for one seed); EVT-calibrated on ``calibrate_batch``
    synthetic token windows. Prints the init's seconds and the drawn
    tree's parameters (``cfg.param_count()`` is the roofline's estimate:
    for Zamba2 it counts the shared MLP as gated)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced as reduce_cfg
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.models.model_zoo import build_model

    cfg = get_config(arch)
    if reduced:
        cfg = reduce_cfg(cfg)
    device = resolve_device(device)
    t0 = time.perf_counter()
    params = build_model(cfg).init(
        torch.Generator(device=device).manual_seed(seed))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"init {cfg.name} ({n_params / 1e6:.1f} M params, "
          f"{cfg.dtype}) on {device}: {time.perf_counter() - t0:.2f} s")
    fc = ZooForecaster(cfg=cfg, params=params, device=device)
    if calibrate_batch:
        fc.calibrate(synthetic_token_batch(calibrate_batch, fc.window,
                                           cfg.vocab, seed=seed))
    return fc
