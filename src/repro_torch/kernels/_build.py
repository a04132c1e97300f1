"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"``), so it
compiles with nvcc alone into its own shared library in seconds; PyTorch's
headers never enter the build. Libraries are built at first use into
``build/repro_torch/`` at the repository root (``REPRO_TORCH_BUILD_DIR``
overrides it), under a name keyed on a hash of the source and the flags,
so an edited source rebuilds and an unchanged one is reused.
:func:`build` starts one nvcc per source and waits for all of them.

:func:`bind` loads a library and sets its entry point's argument types
once, so a launch pays one dictionary lookup for it. Every C entry point
returns ``cudaGetLastError()`` after its launches; :func:`finish_launch` raises on a nonzero status and otherwise adds one
to that kernel's launch count (:data:`LAUNCHES`), the record a run reads
to show that its path went through the kernels. A launch made while a
CUDA graph is being captured reaches the card only when the graph is
replayed: the graph's owner takes such launches back out of the counts
and adds them once per replay (:func:`add_launches`;
``repro_torch.sim.capture``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from repro_torch.obs.trace import span

KERNELS = ("sparse_mix", "fused_row_update", "graph_mix", "dp_clip_noise", "ssm_chunk")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Launches per kernel since the last reset_launch_counts(): one per call
# of a kernel's CUDA wrapper that reached the card.
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_LOADED: dict[str, ctypes.CDLL] = {}
_BOUND: dict = {}  # kernel name -> its bound C entry point


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` to the launch counts: a replayed graph's launches,
    which make no Python call (or, negative, a capture's, which make no
    launch)."""
    for name, k in counts.items():
        LAUNCHES[name] += k


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the repository root.
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to build the kernels")
    path = Path(CUDA_HOME) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found at {path}: set CUDA_HOME to the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS, ptxas_info: bool = False) -> dict[str, str]:
    """Build every library of ``names`` that is missing, in parallel.

    Returns ``{name: compiler output}`` for the sources compiled by this
    call (``ptxas_info`` adds each kernel's registers, shared memory and
    spills to it). Raises with nvcc's output if any compile fails.
    """
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return {}
    with span("kernels.build", kernels=todo):
        build_dir().mkdir(parents=True, exist_ok=True)
        tool = nvcc()
        extra = ("-Xptxas", "-v") if ptxas_info else ()
        jobs = []
        for name in todo:
            out = library_path(name)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [tool, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs.append((name, proc, tmp, out))
        logs, failed = {}, []
        for name, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        build((name,))
        with span("kernels.load", kernel=name):
            lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of kernel ``name``: loaded (built first
    if missing) and given its argument types on the first call, returned
    as it is on every later one."""
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


def on_device(device: torch.device):
    """A context making ``device`` the current CUDA device for a launch;
    it switches nothing when ``device`` already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_tensor(t, name: str, *, dtype, ndim: int, device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``ndim``
    (and ``shape``, where given) on ``device`` — all the kernels take."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel runs on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vector_loads(t) -> bool:
    """Whether a kernel may read the rows of the contiguous matrix ``t`` 16
    bytes at a time: rows of a multiple of 16 bytes (4 float32, 8 bf16) and
    a start on a 16-byte boundary (a contiguous view at any other storage
    offset is not). The wrappers launch their scalar instances otherwise."""
    return t.shape[1] * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0


def stream_of(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the C entry points take it."""
    return torch.cuda.current_stream(device).cuda_stream


def finish_launch(name: str, status: int) -> None:
    """Raise if the launch was refused; otherwise count it."""
    if status != 0:
        msg = _LOADED[name].kernel_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status} ({msg})")
    LAUNCHES[name] += 1
