"""Model multiplexing.

Analog of the reference's serve.multiplexed / get_multiplexed_model_id
(python/ray/serve/multiplex.py, api.py): one deployment serves many models;
each replica LRU-caches up to ``max_num_models_per_replica`` loaded models,
and the router pins a given model id to a stable replica so repeat traffic
hits a warm cache.

Model switching on a card costs a weight upload, so affinity matters: the
router uses a stable hash of the model id over the replica list.
"""

from __future__ import annotations

import collections
import contextvars
import threading

_current_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default=""
)

# Guards lazy wrapper creation. Module-level so deployment classes carrying
# the descriptor stay picklable (a closure-captured lock would be serialized
# by value with the class and locks cannot be pickled).
_CREATION_LOCK = threading.Lock()


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id this request was routed with
    (reference: serve.get_multiplexed_model_id)."""
    return _current_model_id.get()


def _set_multiplexed_model_id(model_id: str):
    _current_model_id.set(model_id or "")


class _MultiplexWrapper:
    """Bound-method wrapper: LRU of loaded models keyed by model id."""

    def __init__(self, fn, instance, max_num_models_per_replica: int):
        self._fn = fn
        self._instance = instance
        self._max = max_num_models_per_replica
        self._models: "collections.OrderedDict[str, object]" = collections.OrderedDict()
        self._lock = threading.Lock()
        # Per-model-id load locks so concurrent misses for the same id load
        # once; different ids still load in parallel.
        self._load_locks: dict[str, threading.Lock] = {}

    def load_model(self, model_id: str):
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
            load_lock = self._load_locks.setdefault(model_id, threading.Lock())
        with load_lock:
            with self._lock:
                if model_id in self._models:  # loaded while we waited
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
            args = (self._instance, model_id) if self._instance is not None else (model_id,)
            model = self._fn(*args)
            with self._lock:
                self._models[model_id] = model
                self._models.move_to_end(model_id)
                # Evicted models are dropped from the cache; their device
                # memory is released when the last in-flight reference dies
                # (never call __del__ on a model a request may still hold).
                while len(self._models) > self._max:
                    evicted_id, _ = self._models.popitem(last=False)
                    self._load_locks.pop(evicted_id, None)
        return model

    __call__ = load_model

    @property
    def loaded_model_ids(self) -> list:
        with self._lock:
            return list(self._models)


def multiplexed(fn=None, *, max_num_models_per_replica: int = 3):
    """Decorator for a model-loader method: ``model = await/call
    self.get_model(model_id)`` with per-replica LRU caching."""

    def wrap(loader):
        class _Descriptor:
            def __set_name__(self, owner, name):
                self._name = name

            def __get__(self, instance, owner=None):
                if instance is None:
                    return loader
                cache_attr = f"__multiplex_{loader.__name__}"
                wrapper = getattr(instance, cache_attr, None)
                if wrapper is None:
                    # Serialized creation: concurrent first requests must
                    # share ONE wrapper/cache, or models load twice.
                    from ray_tpu_torch.serve import multiplex as _mx

                    with _mx._CREATION_LOCK:
                        wrapper = getattr(instance, cache_attr, None)
                        if wrapper is None:
                            wrapper = _MultiplexWrapper(
                                loader, instance, max_num_models_per_replica
                            )
                            setattr(instance, cache_attr, wrapper)
                return wrapper

        return _Descriptor()

    if fn is not None:
        return wrap(fn)
    return wrap
