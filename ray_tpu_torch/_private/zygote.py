"""Worker fork-server ("zygote").

The answer to the reference's worker-pool startup latency problem
(src/ray/raylet/worker_pool.cc:426 prestarts whole processes): instead of
paying a fresh interpreter boot + ~170ms of imports per worker, the raylet
keeps ONE warm process that has already imported the worker runtime and
``os.fork()``s it per worker. On the single-core hosts of the scalability
envelope this turns worker spawn from ~200-300ms of serialized CPU into a
few ms, which is what makes the 40k-actor envelope shape reachable.

Fork-safety rules enforced here:
- the zygote is single-threaded (plain blocking socket + select loop, no
  asyncio, no EventLoopThread) so a fork can never duplicate a held lock;
- nothing device-touching is imported pre-fork: ``torch`` stays lazy in
  workers (the runtime imports it only where a tensor is serialized), and
  the raylet only uses the zygote on nodes without a GPU resource, so no
  CUDA context can be inherited across a fork;
- children only inherit imported MODULES, never live sockets (all fds above
  stdio are closed post-fork) or RNG state (ids.py draws from os.urandom).

Protocol (length-prefixed msgpack over one unix-socket control connection
from the raylet):
  -> {"op": "spawn", "req_id": n, "env": {k: v}, "log_out": p, "log_err": p}
  <- {"req_id": n, "pid": pid}            (spawn reply)
  <- {"exit": pid, "returncode": rc}      (async child-exit notification)
Control-connection EOF means the raylet is gone; workers notice on their own
(worker_main's raylet watchdog) so the zygote just exits.
"""

from __future__ import annotations

import os
import select
import socket
import sys

import msgpack


def _pack(msg) -> bytes:
    body = msgpack.packb(msg, use_bin_type=True)
    return len(body).to_bytes(4, "big") + body


class _FrameReader:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""

    def read_available(self) -> list:
        """Drain readable bytes; return complete frames. MSG_DONTWAIT keeps
        the READ side non-blocking while the socket itself stays blocking —
        sendall() on a non-blocking socket raises on a full buffer, which
        once killed the zygote under an exit-notification burst."""
        try:
            chunk = self.sock.recv(1 << 16, socket.MSG_DONTWAIT)
        except BlockingIOError:
            return []
        if not chunk:
            raise EOFError
        self.buf += chunk
        frames = []
        while len(self.buf) >= 4:
            length = int.from_bytes(self.buf[:4], "big")
            if len(self.buf) < 4 + length:
                break
            frames.append(msgpack.unpackb(self.buf[4 : 4 + length], raw=False))
            self.buf = self.buf[4 + length :]
        return frames


def _child_exec(req: dict):
    """Post-fork path: become a regular worker process. Never returns."""
    try:
        # Stdio to the per-worker log files the raylet chose (same layout as
        # Popen-spawned workers — the log pipeline tails these).
        out_fd = os.open(req["log_out"], os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        err_fd = os.open(req["log_err"], os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        os.dup2(out_fd, 1)
        os.dup2(err_fd, 2)
        # Close everything else we inherited (listener, control conn, the
        # just-dup2'd originals).
        os.closerange(3, 1024)
        for key, value in (req.get("env") or {}).items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[str(key)] = str(value)
        # PYTHONPATH is only read at interpreter boot, which a forked child
        # never does — apply it to sys.path by hand (the driver ships its
        # sys.path so unpickled-by-reference functions import).
        pythonpath = os.environ.get("PYTHONPATH", "")
        for p in reversed([p for p in pythonpath.split(os.pathsep) if p]):
            if p not in sys.path:
                sys.path.insert(0, p)
        from ray_tpu_torch._private import worker_main

        worker_main.main()
        os._exit(0)
    except SystemExit as e:
        os._exit(int(e.code or 0))
    except BaseException:
        import traceback

        traceback.print_exc()
        os._exit(97)


def main(socket_path: str):
    # Warm the import graph BEFORE accepting spawns: this is the entire
    # point of the zygote. worker_main's heavy imports live inside main()
    # (they would otherwise run at module import), so pull the real stack
    # explicitly: core_worker -> rpc/serialization -> numpy/msgpack/
    # cloudpickle; ray_tpu_torch's public API is what unpickled user functions
    # reference. torch stays lazy — see module docstring.
    import ray_tpu_torch  # noqa: F401
    import ray_tpu_torch._private.core_worker  # noqa: F401
    import ray_tpu_torch._private.worker_context  # noqa: F401
    import ray_tpu_torch._private.worker_main  # noqa: F401
    import ray_tpu_torch.util.tracing  # noqa: F401

    # dlopen'd native libs survive fork: pre-load the shm arena/index so a
    # child's StoreClient attach is two mmaps, not a build-freshness check +
    # CDLL load (~15ms of its ~20ms boot).
    from ray_tpu_torch._private.store import arena as _arena
    from ray_tpu_torch._private.store import index as _index

    _arena._load_lib()
    _index._load_lib()

    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        os.unlink(socket_path)
    except OSError:
        pass
    listener.bind(socket_path)
    listener.listen(1)
    # Readiness handshake: the raylet waits for this byte-on-connect.
    conn, _ = listener.accept()
    conn.sendall(_pack({"ready": True}))
    reader = _FrameReader(conn)
    children: set[int] = set()

    def _send(frame) -> bool:
        """Blocking send; False means the raylet is gone. The raylet's
        reader task drains continuously, so a full buffer only ever stalls
        briefly."""
        try:
            conn.sendall(_pack(frame))
            return True
        except (BrokenPipeError, ConnectionResetError, OSError):
            return False

    while True:
        readable, _, _ = select.select([conn], [], [], 0.2)
        if readable:
            try:
                frames = reader.read_available()
            except EOFError:
                os._exit(0)  # raylet is gone
            for req in frames:
                if req.get("op") == "spawn":
                    pid = os.fork()
                    if pid == 0:
                        listener.close()
                        conn.close()
                        _child_exec(req)  # never returns
                    children.add(pid)
                    if not _send({"req_id": req["req_id"], "pid": pid}):
                        os._exit(0)
                elif req.get("op") == "shutdown":
                    os._exit(0)
        # Reap exited children; report so the raylet sees real return codes
        # (a zygote child is not the raylet's child — it cannot waitpid it).
        while children:
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                children.clear()
                break
            if pid == 0:
                break
            children.discard(pid)
            rc = -(status & 0x7F) if (status & 0x7F) else (status >> 8)
            if not _send({"exit": pid, "returncode": rc}):
                os._exit(0)


async def _aread_frame(reader):
    header = await reader.readexactly(4)
    body = await reader.readexactly(int.from_bytes(header, "big"))
    return msgpack.unpackb(body, raw=False)


class ZygoteWorkerProc:
    """Popen-alike for a zygote-forked worker. The worker is the ZYGOTE's
    child, not ours, so there is no waitpid: liveness comes from kill(0) and
    real exit codes arrive via the zygote's exit notifications."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: int | None = None

    def poll(self):
        if self.returncode is None:
            try:
                os.kill(self.pid, 0)
            except (ProcessLookupError, PermissionError):
                self.returncode = -9  # vanished without a notification
        return self.returncode

    def _signal(self, sig):
        try:
            os.kill(self.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass

    def terminate(self):
        import signal as _signal

        self._signal(_signal.SIGTERM)

    def kill(self):
        import signal as _signal

        self._signal(_signal.SIGKILL)

    def wait(self, timeout: float | None = None):
        import subprocess as _subprocess
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and _time.monotonic() > deadline:
                raise _subprocess.TimeoutExpired(f"pid {self.pid}", timeout)
            _time.sleep(0.02)
        return self.returncode


class ZygoteClient:
    """Raylet-side handle to the fork-server. All methods run on the raylet's
    IO loop. The zygote process is started lazily on first spawn and
    restarted transparently if it dies; callers fall back to Popen on
    failure (see Raylet._start_worker)."""

    def __init__(self, session_dir: str, base_env: dict, on_exit):
        self.session_dir = session_dir
        self.socket_path = os.path.join(session_dir, f"zyg_{os.getpid()}_{os.urandom(3).hex()}.sock")
        self.base_env = base_env
        self.on_exit = on_exit  # callback(pid, returncode), IO-loop context
        self.proc = None
        self._writer = None
        self._read_task = None
        self._pending: dict[int, object] = {}
        self._req_id = 0
        self._lock = None  # created lazily on the running loop

    async def _start(self):
        import asyncio
        import subprocess
        import time as _time

        log_dir = os.path.join(self.session_dir, "logs")

        def _spawn():
            # fork+exec plus the log-file open are milliseconds of syscalls —
            # off-loop so a slow disk can't stall every RPC on the raylet's
            # loop while the fork-server boots (graftlint:
            # blocking/subprocess-in-async).
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, "zygote.log"), "ab") as log:
                return subprocess.Popen(
                    [sys.executable, "-m", "ray_tpu_torch._private.zygote", self.socket_path],
                    env=self.base_env,
                    stdout=log,
                    stderr=subprocess.STDOUT,
                    cwd=os.getcwd(),
                )

        self.proc = await asyncio.get_event_loop().run_in_executor(None, _spawn)
        deadline = _time.monotonic() + 30.0
        while True:
            try:
                reader, writer = await asyncio.open_unix_connection(self.socket_path)
                break
            except OSError:
                if self.proc.poll() is not None:
                    raise RuntimeError(
                        f"zygote exited with code {self.proc.returncode} before listening"
                    )
                if _time.monotonic() > deadline:
                    raise RuntimeError("zygote did not come up within 30s")
                await asyncio.sleep(0.02)
        ready = await _aread_frame(reader)
        if not ready.get("ready"):
            raise RuntimeError(f"unexpected zygote handshake: {ready!r}")
        self._writer = writer
        self._read_task = asyncio.ensure_future(self._read_loop(reader))

    async def _read_loop(self, reader):
        try:
            while True:
                frame = await _aread_frame(reader)
                if "req_id" in frame:
                    fut = self._pending.pop(frame["req_id"], None)
                    if fut is not None and not fut.done():
                        fut.set_result(frame["pid"])
                    else:
                        # Reply for an abandoned spawn (caller timed out and
                        # fell back to Popen): the forked child is an
                        # untracked orphan — reap it.
                        try:
                            os.kill(frame["pid"], 9)
                        except (ProcessLookupError, PermissionError):
                            pass
                elif "exit" in frame:
                    try:
                        self.on_exit(frame["exit"], frame["returncode"])
                    except Exception:
                        pass
        except (EOFError, OSError, Exception):
            pass
        finally:
            self._writer = None
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(RuntimeError("zygote connection lost"))
            self._pending.clear()

    async def spawn(self, env_delta: dict, log_out: str, log_err: str, timeout=60.0) -> int:
        import asyncio

        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            if self._writer is None or (self.proc is not None and self.proc.poll() is not None):
                await self._start()
            self._req_id += 1
            rid = self._req_id
            fut = asyncio.get_event_loop().create_future()
            self._pending[rid] = fut
            self._writer.write(
                _pack(
                    {
                        "op": "spawn",
                        "req_id": rid,
                        "env": env_delta,
                        "log_out": log_out,
                        "log_err": log_err,
                    }
                )
            )
            await self._writer.drain()
        import asyncio as _a

        try:
            return await _a.wait_for(fut, timeout)
        except BaseException:
            # Leave no pending entry behind: a late reply for this req_id
            # must be treated as an orphan (killed in _read_loop), not
            # delivered to a future nobody awaits.
            self._pending.pop(rid, None)
            raise

    def close(self):
        if self._read_task is not None:
            self._read_task.cancel()
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2)
            except Exception:
                self.proc.kill()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass


if __name__ == "__main__":
    main(sys.argv[1])
