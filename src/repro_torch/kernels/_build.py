"""Build, load and count the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` at first
use: one object per ``.cu`` file, each in its own ``nvcc`` process and all
started together (so the build takes as long as its slowest source, however
many kernels are added), then linked into one shared library with a plain C
interface that ``ctypes`` loads. The library is
keyed by a hash of the sources and flags and kept under ``build/repro_torch/``
at the repository root, so a second process reuses it. A failed build raises
with nvcc's output; nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launch (one
that launches nothing, a CUDA error code);
:func:`check` raises on a nonzero code. ``launches`` counts, per kernel, the
launches its wrapper made, and ``plans`` the launch plans the K2/K3 wrappers
built. ``spans`` times the K2/K3 wrappers from inside,
in phases, only while a ``torch.profiler`` records, and the library's first
load (``repro_torch.library``) always; the LM path records its prefill, MLA
and MoE spans and the MoE's counters there under the same gate, the host's
waits on the card counted by :func:`host_syncs`;
``repro_torch.obs.tracing`` re-exports it. A build by nvcc writes one line on stderr, so a process that compiled
says so.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# name -> argtypes; every pointer and the stream are c_void_p.
_SIGNATURES = {
    # x, out, m, f, row_stride, shift, mean, impl, stream
    "global_agg_launch": [_P, _P, _I, _I, _L, _I, _I, _I, _P],
    # q, k, v, o, bh, s, t, d, causal, window, scale, bf16, stream
    "flash_attn_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                          _P],
    # x, w, bias, out, m, k, n, shift, relu, out_int8, stream
    "mm_int8_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # w, b, meta, k0, block_rows, stride, smem_bytes, device, &plan
    "cascade_mlp_plan_new": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # plan, x, out, rows, stream
    "cascade_mlp_plan_launch": [_P, _P, _P, _I, _P],
    "cascade_mlp_plan_free": [_P],
    # pack, pack_bytes, phi_meta, rho_meta, k0, stride, xraw, warp_bytes,
    # events, device, &plan
    "deepsets_plan_new": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # plan, x, out, batch, m, stream
    "deepsets_plan_launch": [_P, _P, _P, _I, _I, _P],
    "deepsets_plan_free": [_P],
}

# Shared memory one block may use on sm_90 (227 KB).
MAX_SMEM_BYTES = 232448


class LaunchCounts:
    """Launches per kernel, counted by the wrappers where they launch."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n: Dict[str, int] = {}

    def add(self, name: str) -> None:
        with self._lock:
            self._n[name] = self._n.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._n.clear()

    def get(self, name: str) -> int:
        with self._lock:
            return self._n.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)


launches = LaunchCounts()
#: Launch plans built, per kernel (``cascade_mlp/ops.py``): one a model (K2)
#: or a (phi, rho) pair (K3), so a process's launches less its builds are the
#: calls that found their plan built.
plans = LaunchCounts()

#: True while a torch profiler records: the one query a wrapper's call makes
#: for tracing when none does.
recording = torch._C._autograd._profiler_enabled
# A profiler range: the fast one where this torch has it (record_function
# costs about fifteen times as much a range).
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or \
    torch.autograd.profiler.record_function
_clock = time.perf_counter_ns


class CallSpan:
    """One wrapper call while a profiler records, in flat phases: each is a
    profiler range, nested in the caller's ranges, that starts where the last
    one ended, so the clock is read once a boundary."""

    __slots__ = ("_owner", "_phase", "_done")

    def __init__(self, owner: "HotSpans", phase: str) -> None:
        self._owner = owner
        self._done: List[Tuple[str, int]] = []
        self._open(phase, _clock())

    def _open(self, name: str, t: int) -> None:
        rng = _Range(name)
        rng.__enter__()
        self._phase = (name, rng, t)

    def _close(self, t: int) -> None:
        name, rng, t_open = self._phase
        rng.__exit__(None, None, None)
        self._done.append((name, t - t_open))
        self._phase = None

    def phase(self, name: Optional[str]) -> None:
        """Ends the current phase, if any, and starts ``name`` (None: the
        rest of the call is in no phase)."""
        t = _clock()
        if self._phase is not None:
            self._close(t)
        if name is not None:
            self._open(name, t)

    def end(self) -> None:
        if self._phase is not None:
            self._close(_clock())
        self._owner.add_all(self._done)


class HotSpans:
    """Count and host nanoseconds by span name, for spans on the port's hot
    path. :meth:`begin` returns None unless a profiler records; a span kept
    whatever runs (a once-a-process set-up) goes to :meth:`add`. Beside the
    spans, counters (:meth:`count`): how many values were added under a
    name, and their sum; a caller counts only where its :meth:`begin` gave
    a span, so that nothing is counted with no profiler."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._totals: Dict[str, List[int]] = {}
        self._counts: Dict[str, List[float]] = {}

    def begin(self, phase: str) -> Optional[CallSpan]:
        """A wrapper's call, its first phase ``phase`` open, or None where no
        profiler records (then nothing else is done)."""
        if not recording():
            return None
        return CallSpan(self, phase)

    def add(self, name: str, ns: int) -> None:
        self.add_all(((name, ns),))

    def add_all(self, items) -> None:
        with self._lock:
            for name, ns in items:
                tot = self._totals.setdefault(name, [0, 0])
                tot[0] += 1
                tot[1] += ns

    def totals(self) -> Dict[str, Tuple[int, int]]:
        """name -> (spans, host nanoseconds)."""
        with self._lock:
            return {k: (n, ns) for k, (n, ns) in self._totals.items()}

    def mean_us(self, name: str) -> Optional[float]:
        """Host microseconds a span of ``name``; None where there was
        none."""
        n, ns = self.totals().get(name, (0, 0))
        return ns / n * 1e-3 if n else None

    def count(self, name: str, value: float = 1) -> None:
        with self._lock:
            c = self._counts.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += value

    def counts(self) -> Dict[str, Tuple[int, float]]:
        """name -> (values added, their sum)."""
        with self._lock:
            return {k: (n, v) for k, (n, v) in self._counts.items()}


#: What torch's sync debug mode warns at each call that makes the host wait
#: on a CUDA device (``c10::cuda::warn_or_error_on_sync``).
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def host_syncs(device: torch.device):
    """Counts the times the host waits on ``device`` while entered (a copy
    to the host, ``.item()``, ``.tolist()``, ``nonzero``, a ``bincount``
    that sizes its output...): yields a one-entry list that holds the count
    on exit. On a CUDA device torch's sync debug mode is set to warn, and
    its warnings are counted instead of shown (others are shown as they
    came); the mode is restored on exit. On another device nothing waits,
    and the count is 0. Costs a mode switch and a warnings filter: a traced
    call's."""
    box = [0]
    if device.type != "cuda":
        yield box
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    for w in caught:
        if SYNC_WARNING in str(w.message):
            box[0] += 1
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)


#: The port's one recorder: ``cascade_mlp/ops.py`` (K2, K3), :func:`library`,
#: ``steps.make_prefill``, ``models.attention`` (MLA) and ``models.moe``
#: record into it.
spans = HotSpans()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, headers = _sources()
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels build only where the CUDA toolkit is")
    return path


def _run_all(cmds):
    """Runs the commands at once; raises with the stderr of any that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{err}{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def build() -> Path:
    """Compiles csrc/ into the shared library unless it is built already."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cus]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", str(p),
                          "-o", o] for p, o in zip(cus, objs)])
        logs += _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                           os.path.join(tmp, LIB_NAME)]])
        (out_dir / "build.log").write_text("\n".join(logs))
        os.replace(os.path.join(tmp, LIB_NAME), lib_path)
    print(f"repro_torch: built {lib_path} with nvcc in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device")
            t0 = time.perf_counter_ns()
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
            spans.add("repro_torch.library", time.perf_counter_ns() - t0)
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_of(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device in the calling thread: the handle
    ``torch.cuda.current_stream(t.device).cuda_stream`` holds, read without
    making a ``Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain versions run), False
    when every one lies on one CUDA device (the kernel launches); raises on
    anything else."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}: the kernels take CUDA "
                     "tensors and the plain versions CPU tensors")


def require_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
