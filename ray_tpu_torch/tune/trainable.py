"""Trainable protocol (analog of reference python/ray/tune/trainable/
trainable.py:69 — class API with setup/step/save_checkpoint/load_checkpoint —
and trainable/function_trainable.py — function API reporting via
``tune.report``).

A trial actor hosts exactly one Trainable. The class API is stepwise and
synchronous; the function API runs the user function on a thread and converts
each ``tune.report`` call into one step result.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
import traceback

from ray_tpu_torch.air.checkpoint import Checkpoint

RESULT_DONE = "done"
TRAINING_ITERATION = "training_iteration"


class _TuneSession:
    def __init__(self, checkpoint: Checkpoint | None):
        self.result_queue: queue.Queue = queue.Queue()
        self.continue_event = threading.Event()
        self.checkpoint = checkpoint
        self.stop_requested = False


_thread_local = threading.local()


def _set_session(s: _TuneSession | None):
    _thread_local.session = s


def get_session() -> _TuneSession | None:
    return getattr(_thread_local, "session", None)


def report(metrics: dict, checkpoint: Checkpoint | None = None) -> None:
    """Report one step's metrics (and optionally a checkpoint) from inside a
    function trainable. Blocks until the controller consumes the result, which
    gives schedulers a synchronous decision point (reference
    function_trainable semantics)."""
    s = get_session()
    if s is None:
        # Inside a TorchTrainer worker the air session owns reporting.
        from ray_tpu_torch.air import session as air_session

        if air_session.in_session():
            air_session.report(metrics, checkpoint=checkpoint)
            return
        raise RuntimeError("tune.report() called outside a tune session")
    s.continue_event.clear()
    s.result_queue.put((dict(metrics), checkpoint))
    s.continue_event.wait()
    if s.stop_requested:
        raise StopIteration("trial stopped by scheduler")


def get_checkpoint() -> Checkpoint | None:
    s = get_session()
    if s is not None:
        return s.checkpoint
    from ray_tpu_torch.air import session as air_session

    if air_session.in_session():
        return air_session.get_checkpoint()
    return None


class Trainable:
    """Stepwise trainable (class API)."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self.iteration = 0
        self._start = time.time()
        self._trial_resources: dict = {}
        self.setup(self.config)

    @property
    def trial_resources(self) -> dict:
        """Resources currently allocated to this trial (reference:
        Trainable.trial_resources). Updated by the controller on every
        actor (re)start, so a ResourceChangingScheduler resize is visible
        from step() after the restart — read it there, not in setup()."""
        return self._trial_resources

    # -- subclass surface ---------------------------------------------------
    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self) -> Checkpoint | None:
        return None

    def load_checkpoint(self, checkpoint: Checkpoint) -> None:
        pass

    def reset_config(self, new_config: dict) -> bool:
        """Reuse this instance for a new config (PBT exploit). Return True if
        supported; False forces actor recreation."""
        return False

    def cleanup(self) -> None:
        pass

    # -- controller surface -------------------------------------------------
    def train(self) -> dict:
        result = self.step() or {}
        self.iteration += 1
        result.setdefault(TRAINING_ITERATION, self.iteration)
        result.setdefault("time_total_s", time.time() - self._start)
        result.setdefault(RESULT_DONE, False)
        return result

    def save(self) -> Checkpoint | None:
        ckpt = self.save_checkpoint()
        if ckpt is not None:
            ckpt.metadata.setdefault(TRAINING_ITERATION, self.iteration)
        return ckpt

    def restore(self, checkpoint: Checkpoint) -> None:
        self.load_checkpoint(checkpoint)
        it = checkpoint.metadata.get(TRAINING_ITERATION) if checkpoint else None
        if it is not None:
            self.iteration = int(it)

    def stop(self) -> None:
        self.cleanup()


class FunctionTrainable(Trainable):
    """Adapts ``fn(config)`` (optionally ``fn(config, checkpoint)``) to the
    stepwise protocol: each ``tune.report`` inside fn is one step."""

    _fn = None  # subclass or instance attribute

    def __init__(self, config: dict | None = None, fn=None, checkpoint: Checkpoint | None = None):
        if fn is not None:
            self._fn = fn
        self._session = _TuneSession(checkpoint)
        self._thread: threading.Thread | None = None
        self._error: str | None = None
        self._last_checkpoint: Checkpoint | None = checkpoint
        super().__init__(config)

    def _runner(self):
        _set_session(self._session)
        try:
            fn = self._fn
            params = inspect.signature(fn).parameters
            if len(params) >= 2 and "checkpoint" in params:
                fn(self.config, checkpoint=self._session.checkpoint)
            else:
                fn(self.config)
        except StopIteration:
            pass
        except BaseException:
            self._error = traceback.format_exc()
        finally:
            self._session.result_queue.put(None)  # sentinel: thread finished

    def step(self) -> dict:
        if self._thread is None:
            self._thread = threading.Thread(target=self._runner, daemon=True)
            self._thread.start()
        item = self._session.result_queue.get()
        if item is None:
            if self._error:
                raise RuntimeError(f"trial function failed:\n{self._error}")
            return {RESULT_DONE: True}
        metrics, ckpt = item
        if ckpt is not None:
            self._last_checkpoint = ckpt
        self._session.continue_event.set()
        metrics.setdefault(RESULT_DONE, False)
        return metrics

    def save_checkpoint(self) -> Checkpoint | None:
        return self._last_checkpoint

    def load_checkpoint(self, checkpoint: Checkpoint) -> None:
        self._session.checkpoint = checkpoint
        self._last_checkpoint = checkpoint

    def cleanup(self) -> None:
        self._session.stop_requested = True
        self._session.continue_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def wrap_function(fn) -> type:
    """Build a FunctionTrainable subclass bound to ``fn`` (so it pickles as a
    class for the trial actor)."""

    class _Wrapped(FunctionTrainable):
        pass

    _Wrapped._fn = staticmethod(fn)
    _Wrapped.__name__ = getattr(fn, "__name__", "fn")
    return _Wrapped
