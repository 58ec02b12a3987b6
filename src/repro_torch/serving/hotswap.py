"""Online learning bridge: the asynchronous local-SGD round loop publishes
each cross-worker average straight into the serving registry (the port
of ``repro.serving.hotswap``).

``WeightPublisher`` is what the "retrain on the stream while serving
forecasts" scenario needs: after every round the trainer hands it the
worker-averaged parameters; the publisher builds the next forecaster
version (``with_params`` of the version it replaces), optionally
refreshes the EVT tail calibration on a reference window set, and
atomically swaps it into the ``ModelRegistry``. The serving engine keeps
draining its queue throughout: an in-flight micro-batch completes on the
old weights, the next flush resolves the new reference, and no request
is dropped. ``stop_the_world_swap`` is the baseline it replaces.

Two host threads, one card. The trainer thread calls the publisher (its
``worker_mean``, and the calibration predict, run there), while the
engine's flush thread runs predicts on the version it resolved. Every
launch of both threads goes to the default CUDA stream, the one each
thread starts on: the kernels' bindings launch on the calling thread's
current stream and nothing here changes it. So the averaged weights
are written before any later launch of either thread reads them, with
no event between the threads. A trainer on a side stream of its own
would have to record an event on that stream after ``worker_mean`` and
make the swap wait on it (the engine's stream waiting on the event)
before a published tensor may be read.

A published version owns its tensors: ``worker_mean`` makes new ones
(no storage shared with the trainer's stacked params, which the next
local step replaces), and ``publish`` detaches them, so a served model
never records an autograd graph. Successive versions share only the
frozen ``cfg``; ``calibrate`` rebinds the successor's ``tail`` and
``eps``, it does not mutate the dicts its predecessor may still read.
"""

from __future__ import annotations

import time
from typing import Any

from repro_torch.core.async_local_sgd import worker_mean
from repro_torch.tree import tree_map

PyTree = Any


class WeightPublisher:
    """Publishes trainer-averaged parameters as new model versions.

    Args:
        registry: the ``ModelRegistry`` serving traffic.
        key: model key to publish under. If the key is not hosted yet the
            first publish registers it.
        template: a forecaster whose ``with_params`` builds each
            published version (its config and calibration carried
            over); when None, the currently hosted forecaster is the
            template.
        calib_windows: optional [N, T, F] reference windows: when given,
            every publish refreshes the EVT tail + indicator thresholds on
            the new weights' own forecast distribution.
        quantile: calibration quantile for ``fit_tail``.
        min_interval_s: rate limit; publishes inside the interval are
            skipped (returns None) so a fast trainer cannot thrash the
            registry lock or starve serving with calibration work.
        telemetry: optional ``Telemetry``: each successful publish
            records one swap.
    """

    def __init__(self, registry, key: str, template=None,
                 calib_windows=None, quantile: float = 0.95,
                 min_interval_s: float = 0.0, telemetry=None,
                 clock=time.perf_counter):
        self.registry = registry
        self.key = key
        self._template = template
        self.calib_windows = calib_windows
        self.quantile = quantile
        self.min_interval_s = min_interval_s
        self.telemetry = telemetry
        self._clock = clock
        self._last_publish: float | None = None
        self._pending: tuple[PyTree, int | None] | None = None
        self.published = 0
        self.skipped = 0
        self.last_version: int | None = None
        self.last_round: int | None = None

    def _resolve_template(self):
        if self._template is not None:
            return self._template
        return self.registry.get(self.key)

    # -- publishing --------------------------------------------------------
    def publish(self, params: PyTree, round_idx: int | None = None
                ) -> int | None:
        """Publish one parameter nest (already worker-averaged) as the
        next version of ``key``. Returns the new version, or None when
        rate-limited: rate-limited params are remembered so ``flush()``
        can publish the freshest ones (e.g. the final training round)."""
        now = self._clock()
        if self._last_publish is not None and self.min_interval_s > 0 \
                and now - self._last_publish < self.min_interval_s:
            self.skipped += 1
            self._pending = (params, round_idx)
            return None
        return self._publish_now(params, round_idx)

    def flush(self) -> int | None:
        """Publish the most recent rate-limited params, bypassing the
        rate limit; call after training ends so the served model never
        stays behind the trained one. Returns the new version, or None
        when nothing is pending."""
        if self._pending is None:
            return None
        params, round_idx = self._pending
        return self._publish_now(params, round_idx)

    def _publish_now(self, params: PyTree, round_idx: int | None) -> int:
        fc = self._resolve_template().with_params(
            tree_map(lambda a: a.detach(), params))
        if self.calib_windows is not None:
            fc.calibrate(self.calib_windows, self.quantile)
        if self.key in self.registry:
            version = self.registry.swap(self.key, fc)
        else:
            self.registry.register(self.key, fc)
            version = self.registry.version(self.key)
        self._last_publish = self._clock()
        self._pending = None
        self.published += 1
        self.last_version = version
        self.last_round = round_idx
        if self.telemetry is not None:
            self.telemetry.record_swap()
        return version

    def publish_stacked(self, stacked_params: PyTree,
                        round_idx: int | None = None) -> int | None:
        """Publish from trainer-side stacked params [W, ...]: averages
        over the worker dim (the paper's model exchange) first."""
        return self.publish(worker_mean(stacked_params), round_idx)

    # the exact signature of the training loop's round callback
    def __call__(self, round_idx: int, avg_params: PyTree) -> int | None:
        return self.publish(avg_params, round_idx)


def stop_the_world_swap(engine, registry, key: str, forecaster,
                        reload_s: float = 0.0) -> int:
    """The baseline weight update: halt the engine, replace the model,
    restart. While the engine is stopped every ``submit`` raises (those
    are the dropped requests the hot-swap path avoids) and queued work
    waits out the reload."""
    engine.stop()
    try:
        if reload_s > 0:
            time.sleep(reload_s)   # simulated checkpoint reload cost
        version = registry.swap(key, forecaster)
    finally:
        engine.start()
    return version
