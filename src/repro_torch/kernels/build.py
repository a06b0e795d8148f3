"""Build, load and count the CUDA kernels of ``src/repro_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The sources need
only the CUDA toolkit's own headers (CUB's block radix sort in the sorted-tile
kernels: the edge megakernel, edge_reduce and stratified_stats); flash attention's TMA tensor maps are encoded through the
runtime's driver entry point query, so no library links the driver.  Libraries go
into ``_build/<hash>/`` inside the package (listed in ``.gitignore``),
keyed by a hash of every source and header (``csrc/*.cuh``, shared device
code) and the compiler flags, so a changed source or header rebuilds and an
unchanged one loads at once.  Nothing is compiled
when a module is imported: the first launch of a kernel builds it, and
:func:`build_all` builds every kernel at once with one ``nvcc`` process per
source, all started together.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one right after its kernel launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

KERNELS = ("geohash", "sample_mask", "edge_reduce", "edge_megakernel", "stratified_stats",
           "flash_attention")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# C entry points and their argument types, per library; the first entry is
# the one ``kernel(name)`` returns
_SIGNATURES = {
    "geohash": {"geohash_encode_launch": [_P, _P, _P, _L, _F, _F, _I, _I, _I, _I, _I, _P]},
    "sample_mask": {"sample_mask_launch": [_P, _P, _P, _L, _I, _P, _P, _I, _I, _P]},
    "edge_reduce": {"edge_reduce_launch": [_P, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P]},
    "edge_megakernel": {
        "edge_megakernel_launch": [
            _P, _I, _I, _L, _I, _P, _L, _P, _L, _P, _I, _P, _L, _P, _P, _P, _I,
            _F, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _P, _P,
        ],
    },
    "stratified_stats": {
        "stratified_stats_launch": [_P, _P, _P, _I, _I, _I, _L, _I, _I, _I, _P, _P, _P, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _F, _I,
            _I, _P,
        ],
    },
}

_loaded: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build_dir() -> Path:
    """``_build/<hash>``: the hash covers every source, header and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library is (or will be) built."""
    return build_dir() / f"lib{name}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build the {name} kernel:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names=KERNELS) -> None:
    """Build every missing kernel library, one nvcc per source in parallel."""
    todo = [n for n in names if not library_path(n).exists()]
    started = [(n, *_start(n)) for n in todo]
    errors = []
    for name, proc, tmp, out in started:
        try:
            _finish(name, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def kernel(name: str, entry: str | None = None):
    """The ctypes entry point ``entry`` (default: the first) of kernel
    ``name``'s library, building the library if needed."""
    entries = _SIGNATURES[name]
    entry = entry or next(iter(entries))
    fn = _loaded.get((name, entry))
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes = entries[entry]
        fn.restype = ctypes.c_int
        _loaded[(name, entry)] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def stream_handle(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def num_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
