"""Resident channel loop — the worker side of compiled execution.

From ``ray_tpu/experimental/channel/resident_loop.py``.

Installed on an actor worker by ``channel_loop_install`` (worker_main.py)
and run on a DEDICATED daemon thread (the analog of the reference running
accelerated-DAG loops on a background execution thread): the actor's main
exec queue stays free, so classic method calls keep working while the actor
participates in a compiled graph. Classic calls and compiled stages may
therefore run concurrently on the actor instance — the same hazard class as
``max_concurrency > 1``, opted into by mixing the two paths.

Per iteration, for each bound stage in topological order: block on the
stage's input channels -> execute the bound method on the live actor
instance -> write the result envelope to every output channel. No task
spec is decoded, no ObjectRef is allocated and no raylet RPC is issued —
the loop touches only channel memory and the doorbell pipe.

Device payloads (the MPMD pipeline's microbatch stream): a ``KIND_DEVICE``
input slot resolves through ``device_envelope.resolve`` (live array /
eager-pushed inbox payload / pull fallback) before the method runs, and on
an actor created with ``tensor_transport=`` a top-level plain tensor
result is emitted as a descriptor slot with the payload streamed out of
band — no tensor crosses the host ring between stages. Per-stage
stall/busy/resolve counters feed the ``ray_tpu_pipeline_*`` instruments
(plain ints; ``channel_loop_stats`` RPC exposes the per-stage split for
bubble-fraction measurement) and loop exit reclaims any channel payloads
this loop still holds (``reclaim_scope`` — no leaked device buffers).

Error flow: an application exception becomes an error envelope for THAT
iteration only (it forwards stage-to-stage to the driver, which re-raises
it from ``CompiledDAGRef.get()``; the loop keeps running). A sticky poison
envelope (actor death, planted by the driver's monitor) likewise forwards
downstream, and a descriptor whose holder died resolves to the typed
``DeviceObjectLostError``/``ActorDiedError``. ``ChannelClosedError`` —
teardown or the loop's stop event — exits the loop and its thread.
"""

from __future__ import annotations

import logging
import threading
import time

from ray_tpu_torch._private import serialization
from ray_tpu_torch.experimental.channel.channel import (
    KIND_DEVICE,
    KIND_ERROR,
    KIND_VALUE,
    PIPELINE_STATS,
    ChannelClosedError,
    ChannelReader,
    ChannelWriter,
)
from ray_tpu_torch.exceptions import TaskError

logger = logging.getLogger(__name__)


class _BoundStage:
    """One compiled DAG node bound to this actor: resolved method, input
    readers / constant args, and output writers."""

    def __init__(self, cw, wire: dict):
        self.label = wire["label"]
        self.hop_key = wire.get("hop_key") or self.label
        self.method = getattr(cw._actor_instance, wire["method"])
        # Positional args then sorted kwargs — the deterministic read order
        # both endpoints agree on (each arg has its own channel, so only
        # blocking order matters, not data ordering).
        self.args: list = []  # ("c", ChannelReader) | ("v", constant)
        for spec in wire["args"]:
            if spec[0] == "c":
                self.args.append(("c", ChannelReader(spec[1], cw)))
            else:
                self.args.append(("v", serialization.deserialize(spec[1])))
        self.kwargs: list = []  # (name, same spec shape)
        for name in sorted(wire.get("kwargs") or {}):
            spec = wire["kwargs"][name]
            if spec[0] == "c":
                self.kwargs.append((name, ("c", ChannelReader(spec[1], cw))))
            else:
                self.kwargs.append((name, ("v", serialization.deserialize(spec[1]))))
        self.writers = [ChannelWriter(desc, cw) for desc in wire["outputs"]]
        # Plain-int per-stage accounting (ns): read by channel_loop_stats
        # for bubble-fraction measurement, folded into the process-wide
        # PIPELINE_STATS for the ray_tpu_pipeline_* instruments. stall_ns
        # includes descriptor-resolve waits (upstream payload latency IS
        # pipeline stall); resolve_ns is the of-which breakdown. reset_ns
        # marks the last stats reset so an interval straddling it (a loop
        # blocked in read() when the driver resets) only charges its
        # post-reset portion to the new measurement window.
        self.stall_ns = 0
        self.busy_ns = 0
        self.resolve_ns = 0
        self.iters = 0
        self.reset_ns = 0

    def channel_ids(self) -> list[str]:
        cids = [ep.cid for kind, ep in self.args if kind == "c"]
        cids += [spec[1].cid for _, spec in self.kwargs if spec[0] == "c"]
        cids += [w.cid for w in self.writers]
        return cids

    def stats_dict(self) -> dict:
        return {
            "label": self.label,
            "iters": self.iters,
            "stall_ns": self.stall_ns,
            "busy_ns": self.busy_ns,
            "resolve_ns": self.resolve_ns,
        }


class ChannelLoop:
    """The resident loop for one compiled DAG on one actor worker."""

    def __init__(self, cw, loop_id: str, stages_wire: list):
        self.cw = cw
        self.loop_id = loop_id
        self._stop = threading.Event()
        self.stages = [_BoundStage(cw, wire) for wire in stages_wire]
        self.channel_ids = [cid for s in self.stages for cid in s.channel_ids()]
        # Device-payload emission is the actor-level tensor_transport
        # opt-in: a plain actor's tensor results keep riding
        # the ring as serialized envelopes.
        self.device_outputs = bool(getattr(cw, "_tensor_transport", ""))
        # Completion signal for rpc_channel_loop_stop (set threadsafe from
        # the exec thread when run() returns). Created on the IO loop.
        import asyncio

        self.exited = asyncio.Event()

    def stop(self):
        """Any-thread: ask the loop to exit; readers/writers observe the
        stop event within one poll interval."""
        self._stop.set()

    def run(self):
        """Dedicated-thread entry; runs until stop/teardown/close. The CUDA
        device is per thread: this one takes the device the actor's own
        thread made current, so the stage's tensors and kernels land where
        its parameters live."""
        try:
            if self.cw._cuda_device is not None:
                import torch

                torch.cuda.set_device(self.cw._cuda_device)
            while not self._stop.is_set():
                for stage in self.stages:
                    self._run_stage(stage)
        except ChannelClosedError:
            pass  # teardown / stop: the normal exit path
        except BaseException:  # noqa: BLE001 — must not kill the exec queue
            logger.exception("compiled channel loop %s crashed", self.loop_id[:8])
        finally:
            # Reclaim channel payloads this loop created whose releases
            # never arrived (dead consumer, torn connection, teardown
            # mid-iteration): no leaked device buffers across teardown.
            try:
                from ray_tpu_torch.experimental.device_object.manager import active_manager

                mgr = active_manager()
                if mgr is not None:
                    mgr.reclaim_scope(self.loop_id)
            except Exception:
                logger.exception("channel-payload reclaim failed")
            loop = self.cw._io.loop
            loop.call_soon_threadsafe(self.exited.set)

    def _read_input(self, stage: _BoundStage, reader: ChannelReader):
        """Read one input channel; returns (value, error_data, hop). A
        KIND_DEVICE slot resolves out of band; a resolution failure becomes
        this iteration's error (typed loss / death error serialized)."""
        t0 = time.perf_counter_ns()
        ekind, data, ehop = reader.read(stop=self._stop)
        now = time.perf_counter_ns()
        stage.stall_ns += now - max(t0, stage.reset_ns)
        PIPELINE_STATS.stall_ns += now - t0
        if ekind == KIND_ERROR:
            return None, data, ehop
        if ekind == KIND_DEVICE:
            from ray_tpu_torch.experimental.channel import device_envelope

            t1 = time.perf_counter_ns()
            try:
                value = device_envelope.resolve(
                    self.cw,
                    data,
                    cid=reader.cid,
                    seq=reader.last_seq,
                    gate=reader.gate,
                    stop=self._stop,
                    consumer_release=not reader.shm,
                )
            except ChannelClosedError:
                raise
            except BaseException as e:  # noqa: BLE001 — typed loss flows on
                if self._stop.is_set():
                    raise ChannelClosedError(
                        f"channel {reader.label} stopped mid-resolve"
                    ) from None
                err = serialization.serialize(e).to_bytes()
                return None, err, ehop
            finally:
                # Resolve waits are upstream latency, i.e. stall — without
                # this a pipeline bottlenecked on payload delivery would
                # report a small bubble. resolve_ns is the of-which split.
                t2 = time.perf_counter_ns()
                dt = t2 - max(t1, stage.reset_ns)
                stage.resolve_ns += dt
                stage.stall_ns += dt
                PIPELINE_STATS.stall_ns += t2 - t1
            return value, None, ehop
        return serialization.deserialize(data), None, ehop

    def _run_stage(self, stage: _BoundStage):
        hop: dict | None = None
        error_data = None
        args = []
        kwargs = {}
        for kind, payload in stage.args:
            if kind == "v":
                args.append(payload)
                continue
            value, err, ehop = self._read_input(stage, payload)
            if ehop:
                hop = {**(hop or {}), **ehop}
            if err is not None:
                error_data = error_data or err
            args.append(value)
        for name, (kind, payload) in stage.kwargs:
            if kind == "v":
                kwargs[name] = payload
                continue
            value, err, ehop = self._read_input(stage, payload)
            if ehop:
                hop = {**(hop or {}), **ehop}
            if err is not None:
                error_data = error_data or err
            kwargs[name] = value
        if error_data is not None:
            # Upstream error (application failure or death poison): forward
            # it through every output channel without executing this stage.
            for w in stage.writers:
                w.write(KIND_ERROR, error_data, hop, stop=self._stop)
            return
        if hop is not None:
            hop[f"{stage.hop_key}_recv"] = time.monotonic()
        value = None
        data = None
        t_exec = time.perf_counter_ns()
        try:
            value = stage.method(*args, **kwargs)
            import inspect

            if inspect.iscoroutine(value):
                # Async actor methods run on the per-actor async loop, same
                # as classic calls (core_worker._run_actor_coroutine).
                value = self.cw._run_actor_coroutine(value)
            out_kind = KIND_VALUE
        except ChannelClosedError:
            raise
        except BaseException as e:  # noqa: BLE001 — app errors flow downstream
            out_kind = KIND_ERROR
            data = serialization.serialize(
                TaskError.from_exception(e, task_name=stage.label)
            ).to_bytes()
        stage.busy_ns += time.perf_counter_ns() - max(t_exec, stage.reset_ns)
        stage.iters += 1
        PIPELINE_STATS.microbatches += 1
        if hop is not None:
            hop[f"{stage.hop_key}_exec"] = time.monotonic()
        if out_kind == KIND_VALUE:
            from ray_tpu_torch._private.core_worker import _is_device_tensor

            # Result publication failures (unserializable return value,
            # device-payload registration) are THIS iteration's error, not
            # a loop crash — the DAG keeps serving, like app exceptions.
            try:
                if self.device_outputs and _is_device_tensor(value):
                    from ray_tpu_torch.experimental.channel import device_envelope

                    device_envelope.emit(
                        self.cw, value, stage.writers, scope=self.loop_id,
                        hop=hop, stop=self._stop,
                    )
                    return
                data = serialization.serialize(value).to_bytes()
            except ChannelClosedError:
                raise
            except BaseException as e:  # noqa: BLE001
                out_kind = KIND_ERROR
                data = serialization.serialize(
                    TaskError.from_exception(e, task_name=stage.label)
                ).to_bytes()
        for w in stage.writers:
            w.write(out_kind, data, hop, stop=self._stop)
