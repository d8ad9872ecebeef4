"""Compiled execution graphs (``dag.experimental_compile()``).

From ``ray_tpu/dag/compiled.py``; the port carries no hop timing (ROADMAP A5,
5j), so envelopes ride with no hop stamps.

Classic ``dag.execute()`` walks the graph and pays the full control plane
per node per call: task-spec encode, ObjectRef allocation, owner
bookkeeping, raylet/actor RPCs. A training step loop or a multi-stage
inference pipeline runs exactly the same static graph millions of times,
so ``experimental_compile()`` does the control-plane work ONCE:

- validates a static DAG of actor-method nodes (one ``InputNode``, every
  stage transitively fed by it, terminals at the root);
- resolves the actor gang through the same per-DAG actor cache classic
  execution uses (``ClassNode.resolve_actor_handle``);
- allocates one shm ``Channel`` per edge (``experimental/channel/``) via
  the raylet's arena bindings;
- installs a resident channel loop on each participating worker
  (``channel_loop_install`` -> ``experimental/channel/resident_loop.py``).

Steady state, ``CompiledDAG.execute(x)`` writes the input channel(s) and
returns a ``CompiledDAGRef`` whose ``get()`` reads the output channel:
zero raylet RPCs, zero task specs, zero ObjectRef allocations per
iteration.

Robustness is part of the subsystem: ``teardown()`` stops the resident
loops, drains and frees every channel back to the arena; a participating
actor dying mid-loop plants typed-error poison through all downstream
channels so ``get()`` raises ``ActorDiedError`` naming the dead stage
instead of hanging; unconsumed results past ``max_buffered_results``
backpressure ``execute()``; ``get(timeout=...)`` raises GetTimeoutError.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time

from ray_tpu_torch._private import serialization
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    _DAGInputData,
)
from ray_tpu_torch.exceptions import ActorDiedError, GetTimeoutError, TaskError
from ray_tpu_torch.experimental.channel.channel import (
    _OFF_CLOSED,
    KIND_DEVICE,
    KIND_ERROR,
    KIND_VALUE,
    ChannelClosedError,
    ChannelReader,
    ChannelTimeoutError,
    ChannelWriter,
    make_descriptor,
    pack_envelope,
    ring_bytes,
)

logger = logging.getLogger(__name__)

_GET_SLICE_S = 0.1

# Staged-slot markers for device-envelope resolution (_drain_next): a
# resolved slot must be memoized so a get(timeout=) expiring on a LATER
# output channel cannot re-resolve (and double-release) this one.
_RESOLVED = -2
_RESOLVE_ERR = -3


class CompiledDAGRef:
    """Handle to one compiled iteration's result. NOT an ObjectRef — no
    owner bookkeeping, no reference counting, no store entry."""

    __slots__ = ("_dag", "_idx", "_outcome")

    def __init__(self, dag: "CompiledDAG", idx: int):
        self._dag = dag
        self._idx = idx
        self._outcome = None  # ("val", v) | ("err", exc) once consumed

    @property
    def execution_index(self) -> int:
        return self._idx

    def get(self, timeout: float | None = None):
        if self._outcome is None:
            self._outcome = self._dag._get_result(self._idx, timeout)
        kind, payload = self._outcome
        if kind == "err":
            raise payload
        return payload

    def __repr__(self):
        return f"CompiledDAGRef(idx={self._idx})"


class _Stage:
    """Compile-time view of one ClassMethodNode."""

    def __init__(self, sid: int, node: ClassMethodNode, actor_id: str):
        self.sid = sid
        self.node = node
        self.actor_id = actor_id
        self.method = node._method_name
        self.label = f"{sid}:{node._method_name}"
        self.arg_specs: list = []    # ["c", desc] | ["v", bytes]
        self.kwarg_specs: dict = {}
        self.out_descs: list = []
        self.has_input = False


class CompiledDAG:
    def __init__(
        self,
        root: DAGNode,
        *,
        max_buffered_results: int = 16,
        slot_size_bytes: int = 64 * 1024,
        submit_timeout_s: float = 30.0,
    ):
        from ray_tpu_torch._private import worker_context

        if max_buffered_results < 1:
            raise ValueError("max_buffered_results must be >= 1")
        self._cw = worker_context.get_core_worker()
        self._root = root
        self._num_slots = int(max_buffered_results)
        self._slot_size = max(4096, int(slot_size_bytes))
        self._submit_timeout = submit_timeout_s
        self._dag_id = os.urandom(8).hex()

        self._next_idx = 0
        self._next_out_seq = 0
        # Envelopes already consumed from SOME output readers of the
        # in-progress iteration: a get(timeout=) that expires halfway through
        # a multi-output drain must not lose them (the ring read is
        # destructive) or every later result would pair mismatched
        # iterations.
        self._staged: list = []
        self._results: dict[int, tuple] = {}
        self._consume_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._error: BaseException | None = None
        self._torn_down = False

        self._input_writers: list[tuple] = []    # (projection key, writer)
        self._output_readers: list[ChannelReader] = []
        self._all_descs: list[dict] = []
        self._allocs: list[tuple] = []           # (raylet_addr|None, cid)
        self._actor_addrs: dict[str, tuple] = {}
        self._actor_outputs: dict[str, list] = {}  # actor_id -> [(label, desc)]
        self._dead_actors: set[str] = set()

        # Channel payloads this driver creates (device-resident tensor
        # inputs routed as descriptor slots) reclaim under this scope at
        # teardown if a consumer's release never arrived.
        self._payload_scope = f"dag:{self._dag_id}"

        try:
            self._stages = self._plan()
            self._staged = [None] * len(self._output_readers)
            # Input writers grouped by projection key: one serialized body
            # (or one device payload entry) per key per execute, fanned to
            # every writer fed by that key.
            groups: dict = {}
            key_order: list = []
            for key, writer in self._input_writers:
                if key not in groups:
                    groups[key] = []
                    key_order.append(key)
                groups[key].append(writer)
            self._writers_by_key = [(k, groups[k]) for k in key_order]
            self._install()
        except BaseException:
            # Channels may already be allocated (validation interleaves with
            # edge allocation) and loops partially installed: release both so
            # a failed compile leaks nothing.
            self._torn_down = True
            self._release_channels(list(self._actor_addrs))
            raise
        self._monitor_stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="compiled-dag-monitor", daemon=True
        )
        self._monitor.start()

    # ------------------------------------------------------------------
    # Compilation: validate -> resolve actors -> allocate channels
    # ------------------------------------------------------------------

    def _plan(self) -> list[_Stage]:
        cw = self._cw
        order = self._root.topological_order()
        input_nodes = [n for n in order if isinstance(n, InputNode)]
        if any(isinstance(n, FunctionNode) for n in order):
            raise ValueError(
                "experimental_compile() supports actor-method nodes only; "
                "FunctionNode tasks keep the classic execute() path"
            )
        if len(input_nodes) != 1:
            raise ValueError(
                "a compiled DAG needs exactly one InputNode "
                f"(found {len(input_nodes)})"
            )
        method_nodes = [n for n in order if isinstance(n, ClassMethodNode)]
        if not method_nodes:
            raise ValueError("a compiled DAG needs at least one actor-method node")
        if isinstance(self._root, MultiOutputNode):
            terminals = list(self._root._bound_args[0])
            if not all(isinstance(t, ClassMethodNode) for t in terminals):
                raise ValueError(
                    "every MultiOutputNode output of a compiled DAG must be "
                    "an actor-method node"
                )
            self._multi_output = True
        elif isinstance(self._root, ClassMethodNode):
            terminals = [self._root]
            self._multi_output = False
        else:
            raise ValueError(
                f"a compiled DAG must terminate in an actor-method node or a "
                f"MultiOutputNode of them, not {type(self._root).__name__}"
            )

        # Resolve the actor gang (shared resolution with classic execute():
        # the per-DAG actor cache on ClassNode).
        stage_by_node: dict[int, _Stage] = {}
        stages: list[_Stage] = []
        for node in method_nodes:
            class_node = node._class_node
            if class_node._children():
                raise ValueError(
                    "compiled DAGs require static actor constructor arguments "
                    "(no DAG nodes bound into the ClassNode)"
                )
            handle = class_node.resolve_actor_handle()
            stage = _Stage(len(stages), node, handle.actor_id)
            stage_by_node[id(node)] = stage
            stages.append(stage)

        # Actor placement (address + node) for channel-mode decisions.
        actor_nodes: dict[str, str] = {}
        for stage in stages:
            aid = stage.actor_id
            if aid in self._actor_addrs:
                continue
            self._actor_addrs[aid] = tuple(cw._resolve_actor(aid))
            resp = cw.gcs.call("get_actor", {"actor_id": aid})
            if not resp.get("found"):
                raise ActorDiedError(f"actor {aid[:8]} not found during compile")
            actor_nodes[aid] = resp["info"].get("node_id") or ""
        cluster_nodes = cw.gcs.call("get_nodes").get("nodes", {})

        consumers = {s.sid: 0 for s in stages}

        def classify_arg(stage: _Stage, arg):
            """Build the wire arg spec for one top-level bound arg."""
            if isinstance(arg, (InputNode, InputAttributeNode)):
                key = arg._key if isinstance(arg, InputAttributeNode) else None
                desc = self._alloc_channel(
                    writer_node=cw.node_id,
                    reader_node=actor_nodes[stage.actor_id],
                    reader_addr=self._actor_addrs[stage.actor_id],
                    cluster_nodes=cluster_nodes,
                    label=f"input->{stage.label}",
                )
                self._input_writers.append((key, ChannelWriter(desc, cw)))
                stage.has_input = True
                return ["c", desc]
            if isinstance(arg, ClassMethodNode):
                producer = stage_by_node[id(arg)]
                desc = self._alloc_channel(
                    writer_node=actor_nodes[producer.actor_id],
                    reader_node=actor_nodes[stage.actor_id],
                    reader_addr=self._actor_addrs[stage.actor_id],
                    cluster_nodes=cluster_nodes,
                    label=f"{producer.label}->{stage.label}",
                )
                producer.out_descs.append(desc)
                self._actor_outputs.setdefault(producer.actor_id, []).append(
                    (producer.label, desc)
                )
                consumers[producer.sid] += 1
                stage.has_input = stage.has_input or producer.has_input
                return ["c", desc]
            if isinstance(arg, ClassNode):
                # An actor handle as a constant argument.
                return ["v", serialization.serialize(arg.resolve_actor_handle()).to_bytes()]
            if isinstance(arg, DAGNode):
                raise ValueError(
                    f"compiled DAGs cannot bind {type(arg).__name__} as a "
                    "stage argument"
                )
            return ["v", serialization.serialize(arg).to_bytes()]

        for stage in stages:
            node = stage.node
            top_level = [a for a in node._bound_args] + list(node._bound_kwargs.values())
            nested = [
                c
                for c in node._children()
                if c is not node._class_node and not any(c is a for a in top_level)
            ]
            if nested:
                raise ValueError(
                    f"stage {stage.label}: DAG nodes nested inside "
                    "lists/dicts/tuples are not supported by "
                    "experimental_compile(); bind them as top-level arguments"
                )
            stage.arg_specs = [classify_arg(stage, a) for a in node._bound_args]
            stage.kwarg_specs = {
                k: classify_arg(stage, v) for k, v in node._bound_kwargs.items()
            }
            if not stage.has_input:
                raise ValueError(
                    f"stage {stage.label} is not (transitively) fed by the "
                    "InputNode; a free-running stage would spin unboundedly"
                )

        # Driver-facing output channels, one per terminal occurrence.
        for t in terminals:
            stage = stage_by_node[id(t)]
            desc = self._alloc_channel(
                writer_node=actor_nodes[stage.actor_id],
                reader_node=cw.node_id,
                reader_addr=cw.address,
                cluster_nodes=cluster_nodes,
                label=f"{stage.label}->output",
            )
            stage.out_descs.append(desc)
            self._actor_outputs.setdefault(stage.actor_id, []).append(
                (stage.label, desc)
            )
            self._output_readers.append(ChannelReader(desc, cw))
            consumers[stage.sid] += 1
        dangling = [s.label for s in stages if consumers[s.sid] == 0]
        if dangling:
            raise ValueError(
                f"stage(s) {dangling} produce results nobody consumes; add "
                "them to a MultiOutputNode or drop them from the graph"
            )
        return stages

    def _alloc_channel(self, *, writer_node, reader_node, reader_addr,
                       cluster_nodes, label) -> dict:
        """One ring per edge. shm mode when both endpoints share a node's
        arena (allocated through that node's raylet); otherwise a
        descriptor with no arena — both endpoints take the RPC fallback."""
        cw = self._cw
        cid = os.urandom(12).hex()
        size = ring_bytes(self._num_slots, self._slot_size)
        arena = None
        offset = 0
        if writer_node == reader_node:
            if reader_node == cw.node_id:
                raylet, arena = cw.raylet, cw.store.arena.name
            else:
                info = cluster_nodes.get(reader_node) or {}
                arena = info.get("arena_name")
                raylet = (
                    cw._owner_client(tuple(info["address"]))
                    if arena and info.get("address")
                    else None
                )
            if arena and raylet is not None:
                # Short per-attempt ack, more retries: channel_create is
                # idempotent on the raylet (an existing ring is returned),
                # so a silently lost reply costs one 5s slice instead of a
                # 30s stall; transport exhaustion surfaces as the TYPED
                # channel error naming the node, not a bare TimeoutError.
                try:
                    resp = raylet.call(
                        "channel_create", {"channel_id": cid, "size": size},
                        timeout=5, retries=6,
                    )
                except Exception as e:
                    from ray_tpu_torch.experimental.channel.channel import ChannelError

                    raise ChannelError(
                        f"could not allocate channel {label or cid[:8]} on "
                        f"node {reader_node[:8]}: {type(e).__name__}: {e}"
                    ) from e
                offset = resp["offset"]
                self._allocs.append((raylet, cid))
            else:
                arena = None
        desc = make_descriptor(
            cid,
            arena=arena,
            offset=offset,
            num_slots=self._num_slots,
            slot_size=self._slot_size,
            reader_addr=reader_addr,
            label=label,
        )
        self._all_descs.append(desc)
        return desc

    def _install(self):
        """Ship each actor its resident-loop program (stages in topo order)."""
        cw = self._cw
        by_actor: dict[str, list] = {}
        for stage in self._stages:
            by_actor.setdefault(stage.actor_id, []).append(
                {
                    "label": stage.label,
                    "hop_key": f"s{stage.sid}",
                    "method": stage.method,
                    "args": stage.arg_specs,
                    "kwargs": stage.kwarg_specs,
                    "outputs": stage.out_descs,
                }
            )
        for actor_id, stage_wires in by_actor.items():
            client = cw._owner_client(self._actor_addrs[actor_id])
            resp = client.call(
                "channel_loop_install",
                {"loop_id": self._dag_id, "stages": stage_wires},
                timeout=30,
            )
            if resp.get("error"):
                raise ValueError(
                    f"compiling DAG on actor {actor_id[:8]} failed: "
                    f"{resp['error']}"
                )

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------

    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        """Write the input channel(s); returns a CompiledDAGRef. Blocks
        (then raises ChannelTimeoutError) when ``max_buffered_results``
        iterations are in flight and unconsumed. Not thread-safe: one
        submitting thread per CompiledDAG."""
        if self._torn_down:
            raise ValueError("this CompiledDAG has been torn down")
        err = self._error
        if err is not None:
            raise err
        # Reserve space on EVERY input channel before writing ANY: a full
        # ring discovered halfway through the fan-out would otherwise leave
        # the written channels one iteration ahead of the rest, pairing
        # mismatched iterations forever after a retried execute().
        for _, writer in self._input_writers:
            writer.wait_writable(timeout=self._submit_timeout)
        idx = self._next_idx
        from ray_tpu_torch._private.core_worker import _is_device_tensor

        for key, writers in self._writers_by_key:
            value = self._project_input(args, kwargs, key)
            if _is_device_tensor(value):
                # A tensor must not be msgpack-serialized through the host
                # ring (a silent device-to-host copy per iteration):
                # the driver is the holder — route a descriptor slot and
                # stream the payload out of band (device_envelope).
                from ray_tpu_torch.experimental.channel import device_envelope

                device_envelope.emit(
                    self._cw, value, writers, scope=self._payload_scope,
                    timeout=self._submit_timeout,
                )
                continue
            data = serialization.serialize(value).to_bytes()
            for writer in writers:
                writer.write(KIND_VALUE, data, timeout=self._submit_timeout)
        self._next_idx += 1
        return CompiledDAGRef(self, idx)

    @staticmethod
    def _project_input(args, kwargs, key):
        if key is None:
            if len(args) == 1 and not kwargs:
                return args[0]
            return _DAGInputData(args, kwargs)
        if len(args) == 1 and not kwargs:
            value = args[0]
            try:
                return value[key]
            except (TypeError, KeyError, IndexError):
                if isinstance(key, str):
                    return getattr(value, key)
                raise
        return _DAGInputData(args, kwargs)[key]

    def _get_result(self, idx: int, timeout: float | None) -> tuple:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._consume_lock:
            while idx not in self._results:
                if self._torn_down:
                    raise ValueError("this CompiledDAG has been torn down")
                self._drain_next(deadline)
            return self._results.pop(idx)

    def _drain_next(self, deadline):
        """Read the next iteration's envelope from every output channel (in
        execution order) and record its outcome. Partially-consumed
        iterations stage in self._staged so a timeout raised halfway never
        loses a destructively-read envelope (the retry resumes where this
        attempt stopped instead of pairing mismatched iterations)."""
        for i, reader in enumerate(self._output_readers):
            if self._staged[i] is None:
                self._staged[i] = self._read_sliced(reader, deadline)
        # Device descriptor slots resolve out of band; the outcome is
        # memoized into the staged slot (resolution releases the consumer
        # pin on the holder — it must happen exactly once even when a
        # get(timeout=) expires while resolving a LATER output channel).
        for i, reader in enumerate(self._output_readers):
            kind, data, hop = self._staged[i]
            if kind != KIND_DEVICE:
                continue
            from ray_tpu_torch.experimental.channel import device_envelope

            try:
                value = device_envelope.resolve(
                    self._cw, data, cid=reader.cid, seq=reader.last_seq,
                    gate=reader.gate, deadline=deadline,
                    consumer_release=not reader.shm,
                )
            except GetTimeoutError:
                raise  # staged slot keeps the unresolved envelope; retryable
            except ChannelClosedError:
                raise ValueError(
                    "this CompiledDAG was torn down while results were pending"
                ) from None
            except BaseException as e:  # noqa: BLE001 — typed loss/death
                self._staged[i] = (_RESOLVE_ERR, e, hop)
            else:
                self._staged[i] = (_RESOLVED, value, hop)
        envs, self._staged = self._staged, [None] * len(self._output_readers)
        seq = self._next_out_seq
        self._next_out_seq += 1
        error = None
        values = []
        for kind, data, _hop in envs:
            if kind == _RESOLVED:
                values.append(data)
            elif kind == _RESOLVE_ERR:
                if error is None:
                    error = data
                values.append(None)
            elif kind == KIND_ERROR:
                err = serialization.deserialize(data)
                if error is None:
                    error = err
                values.append(None)
            else:
                values.append(serialization.deserialize(data))
        if error is not None:
            if isinstance(error, TaskError) and isinstance(error.cause, ActorDiedError):
                error = error.cause
            self._results[seq] = ("err", error)
        else:
            self._results[seq] = ("val", values if self._multi_output else values[0])
        if len(self._results) > self._num_slots:
            # Skipped refs would otherwise grow this buffer without bound,
            # silently defeating the max_buffered_results backpressure the
            # ring enforces (reference semantics: consuming out of order is
            # fine, abandoning results is an error).
            raise ValueError(
                f"more than max_buffered_results={self._num_slots} compiled "
                "results are buffered driver-side; get() earlier "
                "CompiledDAGRefs before executing further"
            )

    def _read_sliced(self, reader: ChannelReader, deadline):
        """Short read slices so a death detected by the monitor surfaces as
        its typed error even if poison delivery itself failed."""
        while True:
            try:
                return reader.read(timeout=_GET_SLICE_S)
            except ChannelTimeoutError:
                err = self._error
                if err is not None and reader.gate.sticky is None:
                    raise err
                if deadline is not None and time.monotonic() >= deadline:
                    raise GetTimeoutError(
                        "CompiledDAGRef.get() timed out"
                    ) from None
            except ChannelClosedError:
                raise ValueError(
                    "this CompiledDAG was torn down while results were pending"
                ) from None

    # ------------------------------------------------------------------
    # Failure propagation + teardown
    # ------------------------------------------------------------------

    def _monitor_loop(self):
        cw = self._cw
        while not self._monitor_stop.wait(0.25):
            if cw._shutdown:
                return  # driver exiting without teardown: nothing to watch
            for aid in list(self._actor_addrs):
                if aid in self._dead_actors:
                    continue
                try:
                    resp = cw.gcs.call("get_actor", {"actor_id": aid}, timeout=5)
                except Exception:
                    continue  # GCS hiccup: re-check next tick
                info = resp.get("info") if resp.get("found") else None
                state = (info or {}).get("state")
                if info is None or state in ("DEAD", "RESTARTING"):
                    cause = (info or {}).get("death_cause") or state or "actor gone"
                    self._on_actor_dead(aid, cause)

    def _on_actor_dead(self, actor_id: str, cause: str):
        """Plant typed-error poison through every channel the dead actor
        produced; downstream resident loops forward it edge-by-edge until
        it reaches the driver's output reader."""
        self._dead_actors.add(actor_id)
        stage_outputs = self._actor_outputs.get(actor_id, [])
        labels = sorted({label for label, _ in stage_outputs})
        err = ActorDiedError(
            f"compiled DAG stage(s) {labels} died: actor {actor_id[:8]} "
            f"({cause})",
            actor_id=actor_id,
        )
        with self._state_lock:
            if self._error is None:
                self._error = err
        env = pack_envelope(
            KIND_ERROR, serialization.serialize(err).to_bytes(), None
        )
        cw = self._cw
        for _, desc in stage_outputs:
            reader_addr = tuple(desc["reader_addr"])
            if reader_addr == tuple(cw.address):
                cw.channels.gate(desc["cid"]).poison(env)
                continue
            try:
                cw._owner_client(reader_addr).call(
                    "channel_poison", {"cid": desc["cid"], "env": env}, timeout=5
                )
            except Exception:
                logger.warning(
                    "poisoning channel %s after actor death failed",
                    desc["cid"][:8],
                )

    def teardown(self):
        """Stop the resident loops, close every channel (blocked readers and
        writers raise instead of hanging) and release the channel slots back
        to the arena. Idempotent."""
        with self._state_lock:
            if self._torn_down:
                return
            self._torn_down = True
        self._monitor_stop.set()
        self._release_channels(list(self._actor_addrs))
        # Reclaim driver-created channel payloads whose consumer releases
        # never arrived (dead stage, torn connection): no leaked device
        # buffers across teardown.
        from ray_tpu_torch.experimental.device_object.manager import active_manager

        mgr = active_manager()
        if mgr is not None:
            mgr.reclaim_scope(self._payload_scope)
        if self._monitor.is_alive():
            self._monitor.join(timeout=2)

    def _release_channels(self, actor_ids):
        cw = self._cw
        # 1. Stop resident loops first so no endpoint is mid-slot while the
        # arena blocks are freed. A loop that cannot be CONFIRMED stopped
        # (stop timed out, or the worker is unreachable but not known dead)
        # forbids freeing: a still-running loop writing into a reallocated
        # arena block would corrupt an unrelated object for every reader on
        # the node — leaking the rings is the safe failure.
        confirmed = True
        for actor_id in actor_ids:
            if actor_id in self._dead_actors:
                continue  # loop died with the process; endpoints are gone
            try:
                resp = cw._owner_client(self._actor_addrs[actor_id]).call(
                    "channel_loop_stop", {"loop_id": self._dag_id}, timeout=20
                )
                if not resp.get("ok"):
                    confirmed = False
            except Exception:
                if not self._actor_gone(actor_id):
                    confirmed = False
        # 2. Close: shm rings get their closed word set (any still-blocked
        # local endpoint observes it within a poll); every reader gate is
        # closed so remote-mode endpoints unblock too.
        arena = cw.store.arena
        local_cids = []
        # A dead actor's gates died with it: a close frame to its address
        # would only grind through the connect retries (~40 s a channel).
        dead = {self._actor_addrs[a] for a in self._dead_actors if a in self._actor_addrs}
        for desc in self._all_descs:
            if desc.get("arena") and desc["arena"] == getattr(arena, "name", None):
                struct.pack_into(
                    "<Q", arena.view, desc["offset"] + _OFF_CLOSED, 1
                )
            reader_addr = tuple(desc["reader_addr"])
            if reader_addr == tuple(cw.address):
                local_cids.append(desc["cid"])
            elif reader_addr not in dead:
                try:
                    cw._owner_client(reader_addr).call(
                        "channel_close", {"cid": desc["cid"]}, timeout=5
                    )
                except Exception:
                    pass
        cw.channels.drop(local_cids)
        # Eager payloads pushed at the driver that were never taken must
        # not sit in the inbox until the age sweep.
        for cid in local_cids:
            cw.p2p_inbox.purge_prefix(f"chdev/{cid}/")
        # 3. Release the arena blocks (no leaked shm) — only once every
        # live endpoint is confirmed out of them (the closed words set in
        # step 2 stop an unconfirmed loop within one poll, but "within one
        # poll" is not "now").
        if not confirmed:
            logger.warning(
                "a resident channel loop could not be confirmed stopped; "
                "leaking %d channel ring(s) instead of freeing memory a "
                "live loop may still write",
                len(self._allocs),
            )
            return
        for raylet, cid in self._allocs:
            try:
                raylet.call("channel_free", {"channel_id": cid}, timeout=10)
            except Exception:
                logger.warning("channel_free(%s) failed", cid[:8])
        self._allocs.clear()

    def _actor_gone(self, actor_id: str) -> bool:
        """True only when the GCS confirms the actor's process is gone (its
        channel endpoints died with it, so freeing their rings is safe)."""
        try:
            resp = self._cw.gcs.call("get_actor", {"actor_id": actor_id}, timeout=5)
        except Exception:
            return False  # unknowable: treat as live, leak instead of free
        info = resp.get("info") if resp.get("found") else None
        return info is None or info.get("state") in ("DEAD", "RESTARTING")

    def __del__(self):
        try:
            if not self._torn_down and not self._cw._shutdown:
                self.teardown()
        except Exception:
            pass
