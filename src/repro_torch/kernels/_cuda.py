"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``build/kernels/<name>-<hash>.so`` at the repository root
(``.gitignore`` lists ``build/``), then loaded with ``ctypes``.  The
hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edit rebuilds and a rerun reuses.  Nothing is built when a module is imported: :func:`library`
builds on the first launch, :func:`build` builds several sources at
once (one ``nvcc`` per source, all started together).

Every launch function returns ``cudaGetLastError()``; :func:`check`
raises when it is not ``cudaSuccess``, because a refused launch (too
much shared memory, too many threads) never runs and a later
``synchronize`` does not report it.

``LAUNCHES`` counts launches per kernel wrapper: each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels.  Under CUDA-graph capture a
wrapper records its launch instead of running it:
:func:`recorded_launches` takes what a capture counted back out, and
:func:`add_launches` adds it once per replay, so the counts stay the
launches that ran.

:func:`zeroed_scratch` hands out the int32 buffers that a kernel leaves
zeroed after every launch (split-K workspaces, split tickets), one per
(device, stream), so that the wrappers are safe on several streams and
under CUDA-graph capture; :func:`captured_scratch` gives a captured
graph's buffers to its owner, to be freed with the graph.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

__all__ = ["SOURCES", "LAUNCHES", "launch_counts", "reset_launch_counts",
           "recorded_launches", "add_launches",
           "build", "library", "check", "stream_of", "sm_count", "BUILD_LOG",
           "zeroed_scratch", "captured_scratch", "SCRATCH"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"qmatmul": CSRC / "qmatmul.cu",
           "paged_attention": CSRC / "paged_attention.cu",
           "lut_activation": CSRC / "lut_activation.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "flash_attention_bwd": CSRC / "flash_attention_bwd.cu",
           "quantize_rows": CSRC / "quantize_rows.cu",
           "qmatmul_bwd": CSRC / "qmatmul_bwd.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

#: kernel wrapper name -> launches since the last reset
LAUNCHES: Dict[str, int] = {"qmatmul": 0, "paged_attention_unsplit": 0,
                            "paged_attention_split": 0, "lut_activation": 0,
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "lut_gated_mul": 0, "quantize_rows": 0,
                            "lut_activation_bwd": 0, "lut_gated_mul_bwd": 0,
                            "quantize_rows_bwd": 0, "qmatmul_bwd": 0}
#: source name -> {"seconds", "ptxas"} of the builds made or reused by this
#: process (a reused build's ptxas lines come from the log beside it)
BUILD_LOG: Dict[str, dict] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
#: C signatures: every pointer and the stream as c_void_p (never a bare
#: int, which ctypes would pass as 32 bits and cut the pointer)
SIGNATURES = {
    "qmatmul": {
        "qmatmul_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                           _F, _I, _I, _I, _I, _P, _P, _P],
        "qmatmul_tma_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _F, _F, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P, _P, _P],
    },
    "paged_attention": {
        "paged_attention_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _F, _I, _P],
    },
    "lut_activation": {
        "lut_activation_launch": [_P, _P, _P, _L, _I, _F, _F, _I, _I, _I,
                                  _P],
        "lut_gated_mul_launch": [_P, _P, _P, _P, _L, _I, _F, _F, _I, _I, _I,
                                 _P],
        "lut_activation_bwd_launch": [_P, _P, _P, _P, _L, _I, _F, _F, _I, _I,
                                      _I, _P],
        "lut_gated_mul_bwd_launch": [_P, _P, _P, _P, _P, _P, _L, _I, _F, _F,
                                     _I, _I, _I, _P],
    },
    "flash_attention": {
        "flash_attention_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _F, _I, _I, _I, _I, _P],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                       _I, _I, _I, _P],
    },
    "quantize_rows": {
        "quantize_rows_launch": [_P, _P, _P, _I, _I, _F, _F, _F, _I, _I,
                                 _P],
        "quantize_rows_bwd_launch": [_P, _P, _P, _I, _I, _F, _I, _P],
    },
    "qmatmul_bwd": {
        "qmatmul_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _I,
                               _P],
    },
}


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def recorded_launches():
    """Around a CUDA-graph capture: yields a dict that, on exit, holds the
    launches the wrappers counted inside the block (recorded into the
    graph, not run), and puts ``LAUNCHES`` back as it was on entry (also
    when the capture raised)."""
    before = dict(LAUNCHES)
    recorded: Dict[str, int] = {}
    try:
        yield recorded
    finally:
        for k in LAUNCHES:
            recorded[k] = LAUNCHES[k] - before[k]
            LAUNCHES[k] = before[k]


def add_launches(counts: Dict[str, int]) -> None:
    """Count a replay of a graph that recorded ``counts``."""
    for k, v in counts.items():
        LAUNCHES[k] += v


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "/usr/local/cuda and PATH); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile the named sources in parallel (skipping up-to-date ones)."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo: List[tuple] = []
    for name in names:
        out = _target(name)
        if out.exists():
            if name not in BUILD_LOG and out.with_suffix(".log").exists():
                BUILD_LOG[name] = {"seconds": 0.0, "ptxas": out.with_suffix(
                    ".log").read_text().splitlines()}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in todo:
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": [ln for ln in log.splitlines()
                                     if "ptxas info" in ln
                                     or "bytes spill" in ln]}
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{SOURCES[name].name}:\n{log}")
        else:
            out.with_suffix(".log").write_text(
                "\n".join(BUILD_LOG[name]["ptxas"]))
            os.replace(tmp, out)     # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _target(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch function returned an error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({msg})")


def stream_of(tensor) -> int:
    """PyTorch's current stream on ``tensor``'s device, as an address."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device (asked once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


#: (name, device, stream address) -> int32 buffer of zeros that the
#: kernels leave zeroed after every launch; grown, never shrunk
SCRATCH: Dict[tuple, torch.Tensor] = {}
#: buffers handed out under CUDA-graph capture: a graph keeps their
#: addresses, so they are held for the life of the process, unless a
#: :func:`captured_scratch` block hands them to the graph's owner
_CAPTURED: List[torch.Tensor] = []


@contextlib.contextmanager
def captured_scratch():
    """Collect the scratch buffers that captures inside the block hand
    out: they move from the process-wide list to the yielded list, which
    the caller keeps as long as it keeps the graph (and frees with it)."""
    n0 = len(_CAPTURED)
    held: List[torch.Tensor] = []
    try:
        yield held
    finally:
        held.extend(_CAPTURED[n0:])
        del _CAPTURED[n0:]


def zeroed_scratch(name: str, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros for a kernel that leaves them zeroed.

    Eager calls share one buffer per ``(name, device, current stream)``:
    launches on one stream run in order, and two streams never share.
    Under CUDA-graph capture every call gets a buffer of its own, zeroed
    inside the graph, that no eager call touches and that is never freed,
    since a replay writes to it long after the capture returned (and
    after eager calls may have grown and dropped the stream's buffer).
    """
    if torch.cuda.is_current_stream_capturing():
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _CAPTURED.append(buf)
        return buf
    key = (name, device, torch.cuda.current_stream(device).cuda_stream)
    buf = SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = SCRATCH[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf
