"""Distributed tracing.

Analog of the reference's util/tracing/tracing_helper.py (560 LoC of OTel
wrapping): opt-in span propagation across task/actor boundaries. Instead of
requiring OpenTelemetry, span context (trace id, span id, parent id) rides
inside every TaskSpec, each task execution records its span into the task
event log, and ``export_spans()`` reconstructs the trace tree from the GCS. An OTel exporter
can be layered on top by walking ``export_spans()``.

Enable with ``RAY_TPU_TORCH_TRACING=1`` (or ``enable_tracing()`` before submitting).
"""

from __future__ import annotations

import contextvars
import os
import uuid

_enabled: bool | None = None
# (trace_id, span_id) of the currently-executing task in this process.
_current: contextvars.ContextVar = contextvars.ContextVar("ray_tpu_trace", default=None)


def tracing_enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RAY_TPU_TORCH_TRACING", "0") == "1"
    return _enabled


def enable_tracing():
    """Enable tracing cluster-wide. The flag is stored in the GCS KV so
    workers on EVERY node pick it up at startup (a plain env var would only
    reach workers forked by a same-process raylet)."""
    global _enabled
    _enabled = True
    os.environ["RAY_TPU_TORCH_TRACING"] = "1"
    _publish_flag_if_connected()


def _publish_flag_if_connected():
    from ray_tpu_torch._private import worker_context

    cw = worker_context.get_core_worker_if_initialized()
    if cw is None:
        return
    try:
        cw.gcs.call("kv_put", {"key": "tracing:enabled", "value": b"1", "overwrite": True})
    except Exception:
        pass


def get_current_span_context() -> dict | None:
    """(driver or inside a task) the active span context, if tracing."""
    cur = _current.get()
    if cur is None:
        return None
    return {"trace_id": cur[0], "span_id": cur[1]}


def child_span_context() -> dict:
    """Build the span context to attach to an outgoing task submission."""
    cur = _current.get()
    if cur is None:
        # Root: new trace originating at this driver/task.
        return {"trace_id": uuid.uuid4().hex, "span_id": uuid.uuid4().hex[:16], "parent_id": ""}
    return {"trace_id": cur[0], "span_id": uuid.uuid4().hex[:16], "parent_id": cur[1]}


def set_task_context(trace_ctx: dict | None):
    """Called by the worker as a task starts executing. Always sets (clearing
    for untraced tasks so a reused worker can't leak the previous task's
    span); returns a token for contextvars reset."""
    if trace_ctx:
        return _current.set((trace_ctx.get("trace_id"), trace_ctx.get("span_id")))
    return _current.set(None)


def reset_task_context(token):
    _current.reset(token)


def export_spans(address=None) -> list[dict]:
    """Spans from the task-event log need the state API (``util/state``),
    which is not ported with the dashboard (ROADMAP A5, what remains)."""
    raise NotImplementedError("export_spans needs the state API, not ported (ROADMAP A5, what remains)")
