"""Object serialization.

From ``ray_tpu/_private/serialization.py`` (analog of the reference's
SerializationContext, python/ray/_private/serialization.py:107): cloudpickle
for arbitrary Python objects, pickle protocol 5 out-of-band buffers for
zero-copy numpy arrays (the buffers land directly in the shm arena and
deserialize as memoryview-backed arrays without a copy), and out-of-band
ObjectRef tracking for refs nested inside task args/returns.

Tensors take the place of the JAX package's ``jax.Array`` reducers: a
``torch.Tensor`` leaves the process as a numpy view of its host memory (a
CUDA tensor through one device-to-host copy, with its device index), and
comes back as a fresh tensor of the same dtype, bit for bit, on the CPU or
on ``cuda:<index>`` (on the CPU in a process pinned there by
:func:`pin_to_host`). A sharded ``DTensor`` raises: one process of a torch
gang sees only its own shards, and the store does not gather them (ROADMAP
A9f).

Wire layout: msgpack header {p: pickle_len, b: [buffer sizes]} then the
pickle bytes, then each out-of-band buffer 64-byte aligned.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import cloudpickle
import msgpack
import pickle

_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


class _SerializationThreadContext(threading.local):
    def __init__(self):
        self.contained_refs = None


_thread_ctx = _SerializationThreadContext()


def record_contained_ref(ref) -> None:
    """Called from ObjectRef.__reduce__ while a serialize() is in flight."""
    if _thread_ctx.contained_refs is not None:
        _thread_ctx.contained_refs.append(ref)


@dataclass
class SerializedObject:
    pickled: bytes  # payload: pickle bytes
    buffers: list  # list of buffer-protocol objects
    contained_refs: list = field(default_factory=list)

    @property
    def header(self) -> bytes:
        h = {
            "p": len(self.pickled),
            "b": [len(memoryview(b)) for b in self.buffers],
        }
        return msgpack.packb(h, use_bin_type=True)

    @property
    def total_size(self) -> int:
        header = self.header
        size = 4 + len(header)
        size = _align(size) + len(self.pickled)
        for b in self.buffers:
            size = _align(size) + len(memoryview(b))
        return size

    def write_to(self, view: memoryview) -> int:
        """Write the full wire format into view; returns bytes written."""
        header = self.header
        pos = 0
        view[pos : pos + 4] = len(header).to_bytes(4, "big")
        pos += 4
        view[pos : pos + len(header)] = header
        pos += len(header)
        pos = _align(pos)
        view[pos : pos + len(self.pickled)] = self.pickled
        pos += len(self.pickled)
        for b in self.buffers:
            mv = memoryview(b).cast("B")
            pos = _align(pos)
            view[pos : pos + len(mv)] = mv
            pos += len(mv)
        return pos

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_size)
        n = self.write_to(memoryview(out))
        return bytes(out[:n])


# Tensors: a torch.Tensor leaves the process as a numpy view of its host
# memory, which rides the out-of-band buffer path like any numpy array.
# dtypes numpy has no counterpart for (bfloat16, the float8 kinds) travel as
# an unsigned-integer view of the same width and are restored bit for bit.
_NUMPY_DTYPES = frozenset(
    "float16 float32 float64 complex64 complex128 int8 int16 int32 int64 uint8 bool".split()
)
_BITS_VIEW = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def is_tensor(obj) -> bool:
    """True iff obj is a torch.Tensor, without importing torch for other
    values (the module-name probe keeps cold paths torch-free)."""
    if not type(obj).__module__.startswith("torch"):
        return False
    import torch

    return isinstance(obj, torch.Tensor)


def tensor_to_numpy(t) -> tuple:
    """(numpy view of a tensor's host bytes, its dtype's name). A CUDA tensor
    is copied to the host first; a dtype numpy has no counterpart for travels
    as an unsigned-integer view of the same width (bfloat16 as uint16)."""
    import torch

    host = t.detach().to("cpu").contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if name in _NUMPY_DTYPES:
        return host.numpy(), name
    width = host.element_size()
    return host.view(getattr(torch, _BITS_VIEW[width])).numpy().view(f"u{width}"), name


def tensor_from_numpy(array, dtype_name: str):
    """A fresh, writable CPU tensor with ``array``'s bytes as ``dtype_name``
    (the inverse of ``tensor_to_numpy``, bit for bit)."""
    import torch

    if dtype_name in _NUMPY_DTYPES:
        return torch.from_numpy(array.copy())
    return torch.from_numpy(array.view(f"i{array.itemsize}").copy()).view(getattr(torch, dtype_name))


class _HostPin:
    """Whether this process is pinned to the CPU (see :func:`pin_to_host`)."""

    pinned = False


def pin_to_host() -> None:
    """Pin this process to the CPU: from here on a CUDA tensor it receives
    is rebuilt as a CPU tensor, and receiving one makes no CUDA context. For
    processes that hold no card on a machine that has one (rollout workers:
    the JAX package pins them to its CPU platform the same way)."""
    _HostPin.pinned = True


def _rebuild_tensor(host, dtype_name: str, device_index, requires_grad: bool):
    """Reconstructor of a reduced tensor. ``host`` is the numpy array as it
    arrived (a read-only view of the object's buffer); it is copied into a
    fresh, writable tensor. A CUDA tensor goes back onto ``cuda:<index>``
    unless this process is pinned to the CPU; where this process has no such
    device, this raises."""
    import torch

    t = tensor_from_numpy(host, dtype_name)
    if device_index is not None and not _HostPin.pinned:
        if not torch.cuda.is_available() or device_index >= torch.cuda.device_count():
            raise RuntimeError(
                f"a CUDA tensor from cuda:{device_index} cannot be restored here: this process "
                f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0} CUDA device(s)"
            )
        t = t.to(f"cuda:{device_index}")
    return t.requires_grad_(requires_grad) if requires_grad else t


def _reduce_tensor(t):
    """A plain tensor (or Parameter) -> (reconstructor, args): its host bytes
    as a numpy view, its dtype's name, its CUDA device index (None on the
    CPU) and requires_grad."""
    import torch

    if type(t).__name__ == "DTensor":
        raise NotImplementedError(
            "a sharded DTensor cannot be put into the object store yet: each rank "
            "holds only its own shards (ROADMAP A9f); put dtensor.full_tensor() or "
            "to_local() instead"
        )
    if type(t) not in (torch.Tensor, torch.nn.Parameter):
        return NotImplemented  # other subclasses: torch's own reducers
    device_index = None
    if t.device.type == "cuda":
        device_index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    elif t.device.type != "cpu":
        raise NotImplementedError(f"tensors on {t.device.type} devices cannot be serialized")
    return (_rebuild_tensor, (*tensor_to_numpy(t), device_index, t.requires_grad))


class _Pickler(cloudpickle.CloudPickler):
    def reducer_override(self, obj):
        # Tensors: pulled to host once; the payload then rides the zero-copy
        # buffer path like any numpy array.
        if is_tensor(obj):
            reduced = _reduce_tensor(obj)
            if reduced is not NotImplemented:
                return reduced
        # Delegate to cloudpickle's own reducer_override — it implements
        # by-value pickling of local/lambda functions and dynamic classes.
        return super().reducer_override(obj)


def serialize(obj) -> SerializedObject:
    import io

    buffers: list = []
    prev = _thread_ctx.contained_refs
    _thread_ctx.contained_refs = []
    try:
        sio = io.BytesIO()
        pickler = _Pickler(sio, protocol=5, buffer_callback=lambda b: buffers.append(b.raw()))
        pickler.dump(obj)
        pickled = sio.getvalue()
        refs = _thread_ctx.contained_refs
    finally:
        _thread_ctx.contained_refs = prev
    return SerializedObject(pickled=pickled, buffers=buffers, contained_refs=refs)


def deserialize(view) -> object:
    """Deserialize from a buffer (memoryview over shm => zero-copy arrays)."""
    view = memoryview(view).cast("B")
    header_len = int.from_bytes(view[:4], "big")
    header = msgpack.unpackb(view[4 : 4 + header_len], raw=False)
    pos = _align(4 + header_len)
    payload = view[pos : pos + header["p"]]
    pos += header["p"]
    if header.get("f") is not None:
        raise NotImplementedError(
            f"object format {header['f']!r} is a cross-language object: the port has no "
            "C++ workers (ROADMAP A5, what remains)"
        )
    buffers = []
    for size in header["b"]:
        pos = _align(pos)
        buffers.append(pickle.PickleBuffer(view[pos : pos + size]))
        pos += size
    return pickle.loads(payload, buffers=buffers)


def dumps(obj) -> bytes:
    """One-shot serialize to bytes (for RPC payload embedding)."""
    return serialize(obj).to_bytes()


def loads(data) -> object:
    return deserialize(data)
