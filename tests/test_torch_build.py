"""The ctypes table of the port's CUDA library against its sources, on the CPU.

``ops/_build.py`` loads ``libray_tpu_torch_kernels.so`` with ``ctypes`` and
declares each ``extern "C"`` function's arguments in ``_SIGNATURES``. A
function missing there would be called with ctypes' defaults, which pass a
Python int as a 32-bit C int: a pointer is cut without an error. So every
``extern "C"`` function of ``ops/csrc/*.cu`` must be in the table, with as
many arguments as the source declares and each of the matching kind
(pointer: ``c_void_p``, ``int``: ``c_int``, ``float``: ``c_float``), and its
return type (``_RESTYPES``, else ``c_int``). The sources are only read here.
"""

import ctypes
import re

import pytest

from ray_tpu_torch.ops import _build

_EXTERN_C = re.compile(r'extern "C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{')


def _entry_points() -> dict[str, tuple[str, list[str]]]:
    """{name: (return type, [argument declarations])} of every extern "C"
    function defined in csrc/*.cu."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, args in _EXTERN_C.findall(src.read_text()):
            assert name not in found, f"{name} defined twice"
            found[name] = (" ".join(ret.split()), [" ".join(a.split()) for a in args.split(",") if a.strip()])
    return found


def _ctype(decl: str):
    """The ctypes type a C declaration ("const void* q", "int D", "float
    scale", or a return type) must be declared as."""
    if "*" in decl:
        return ctypes.c_char_p if decl.replace(" ", "").startswith("constchar*") else ctypes.c_void_p
    kind = decl.split()[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


def test_every_entry_point_is_in_the_table():
    found = _entry_points()
    assert found, "no extern \"C\" function found in ops/csrc/*.cu"
    assert set(found) == set(_build._SIGNATURES)
    assert set(_build._RESTYPES) <= set(found)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_the_source(name):
    ret, args = _entry_points()[name]
    declared = _build._SIGNATURES[name]
    assert len(declared) == len(args), f"{name}: source takes {len(args)} arguments, table has {len(declared)}"
    for i, (decl, ctype) in enumerate(zip(args, declared)):
        assert ctype is _ctype(decl), f"{name} argument {i} ({decl!r}) declared as {ctype.__name__}"
    assert _build._RESTYPES.get(name, ctypes.c_int) is _ctype(ret), f"{name} returns {ret!r}"


def test_the_parser_reads_pointers_ints_and_floats():
    """The checks above rest on the parser; hold it to one known entry."""
    ret, args = _entry_points()["rtt_flash_fwd"]
    assert ret == "int"
    assert [_ctype(a) for a in args[:5]] == [ctypes.c_void_p] * 5
    assert args[5] == "int is_bf16" and args[11] == "float scale" and args[-1] == "void* stream"


_RACER = r"""
import os, sys, time
from pathlib import Path
from ray_tpu_torch.ops import _build

csrc, build_dir, log, go = (Path(a) for a in sys.argv[1:5])


def slow_compile(csrc, out):
    # What _compile does, slowly: write the library under another name, then
    # move it into place; count each compile in `log`.
    with open(log, "a") as f:
        f.write(f"{os.getpid()}\n")
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        for _ in range(8):
            f.write(b"\x7fELF" * 32768)
            f.flush()
            time.sleep(0.1)
    os.replace(tmp, out)
    return "compiled"


_build._compile = slow_compile
while not go.exists():  # start together
    time.sleep(0.005)
lib, text, seconds = _build.ensure_built(csrc, build_dir)
print(text or "cached", lib.stat().st_size)
"""


def test_concurrent_builds_compile_once(tmp_path):
    """Two processes that find no library build it once: the second waits on
    the lock, then finds the stamp and the complete file."""
    import os
    import subprocess
    import sys
    import time

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('extern "C" int k() { return 0; }\n')
    build_dir, log, go = tmp_path / "build", tmp_path / "compiles.log", tmp_path / "go"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen([sys.executable, "-c", _RACER, str(csrc), str(build_dir), str(log), str(go)],
                         cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    time.sleep(1.0)  # both interpreters up and waiting
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    full = 8 * 4 * 32768
    assert sorted(out.split()[0] for out, _ in outs) == ["cached", "compiled"]
    assert all(int(out.split()[1]) == full for out, _ in outs)
    assert len(log.read_text().split()) == 1
    assert (build_dir / (_build.LIB_NAME + ".sha256")).read_text() == _build._digest(csrc)
    assert (build_dir / _build.LIB_NAME).stat().st_size == full
