"""Build the port's CUDA kernels with ``nvcc`` and load them via ctypes.

Each ``csrc/<source>.cu`` compiles on its own into a shared library
with plain ``extern "C"`` entry points, one per kernel it holds (no
PyTorch headers, so a build takes seconds).  Libraries land in
``build/repro_torch_kernels/`` at the repo root
(``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of their
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.  Nothing is built at import: the first call of a kernel builds
it, and :func:`build` builds several in parallel ahead of time (callers
that time work build first, so the build never lands on their clock).

``LAUNCHES`` counts kernel launches by name; each CUDA wrapper adds one
where it launches, and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
# kernel (its C entry point and launch counter) -> the source holding it
SOURCES = {
    "decode_attention_paged": "decode_attention_paged",
    "decode_attention_paged_q8": "decode_attention_paged",
    "decode_attention": "decode_attention",
    "decode_attention_q8": "decode_attention",
    "flash_attention": "flash_attention",
    "flash_attention_fwd_lse": "flash_attention_bwd",
    "flash_attention_dq": "flash_attention_bwd",
    "flash_attention_dkv": "flash_attention_bwd",
    "ssd_scan": "ssd_scan",
    "ssd_scan_bwd": "ssd_scan_bwd",
    "anneal": "anneal",
}
KERNELS = tuple(SOURCES)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes: every pointer and the stream as c_void_p, so ctypes never cuts
# a 64-bit address to a 32-bit int
SIGNATURES = {
    # bf16 q: + the split partials (acc, m, l) and num_splits, split_len
    "decode_attention_paged": [_P] * 9 + [_I] * 11 + [_P],
    "decode_attention_paged_q8": [_P] * 11 + [_I] * 11 + [_P],
    "decode_attention": [_P] * 8 + [_I] * 8 + [_P],
    "decode_attention_q8": [_P] * 10 + [_I] * 8 + [_P],
    "flash_attention": [_P] * 4 + [_I] * 8 + [_P],
    "flash_attention_fwd_lse": [_P] * 5 + [_I] * 8 + [_P],
    "flash_attention_dq": [_P] * 7 + [_I] * 8 + [_P],
    "flash_attention_dkv": [_P] * 8 + [_I] * 8 + [_P],
    # + the C·Bᵀ workspace, and the plan's slices
    "ssd_scan": [_P] * 9 + [_I] * 7 + [_P],
    # x, dt, A, B, C, init_state, dy, dfinal, the C·Bᵀ and states
    # workspaces, dx, the ddt / dA / dB / dC partials, dinit; b, s, nh,
    # hd, ds, and the plan's slices and head group
    "ssd_scan_bwd": [_P] * 16 + [_I] * 7 + [_P],
    # reqc, n_valid, draws, the three outputs, the workspace; the shapes,
    # iters and the scoring path; T0, T_thres, tau
    "anneal": [_P] * 7 + [_I] * 7 + [_F] * 3 + [_P],
}
# entry points beside a kernel's that launch nothing: name -> (the kernel
# whose library holds it, argtypes, restype)
HELPERS = {
    # bytes of global workspace an anneal of (instances, chains, N,
    # max_batch, incremental) needs; 0 when its state fits on chip
    "anneal_workspace_bytes": ("anneal", [_I] * 5, ctypes.c_longlong),
    # the launch plan at (N, max_batch, incremental): threads a block and
    # where the request rows and the state sit
    "anneal_plan": ("anneal", [_I] * 3, ctypes.c_int),
    # the SSD backward's clusters in flight at (nh, ds, slices, group, b)
    "ssd_scan_bwd_clusters": ("ssd_scan_bwd", [_I] * 5, ctypes.c_int),
}

LAUNCHES: "collections.Counter[str]" = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, "ctypes._CFuncPtr"] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch_kernels"


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    """The library built from ``csrc/<source>.cu``."""
    h = hashlib.sha1((CSRC / f"{source}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{source}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile the sources of the named kernels whose library is missing,
    one ``nvcc`` per source, all started together.  Returns the wall
    seconds of the whole build and writes each compiler log
    (``-Xptxas=-v``: registers, shared memory, spills) beside its
    library."""
    sources = dict.fromkeys(SOURCES[n] for n in names)
    todo = [s for s in sources if not library_path(s).exists()]
    t0 = time.perf_counter()
    if todo:
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        exe = nvcc()
        procs = []
        for n in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [exe, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for n, tmp, proc in procs:
            log, _ = proc.communicate()
            final = library_path(n)
            final.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{n}:\n{log}")
            else:
                os.replace(tmp, final)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": len(todo)}


def kernel_label(mangled: str) -> str:
    """A kernel's mangled name as ``flash_dq_tc_kernel<128, 2>``: its
    last name component and its template arguments (integers, ``float``,
    ``int8_t`` or a named type such as ``__nv_bfloat16``); the name
    itself if it does not parse."""
    m = re.match(r"_ZN?", mangled)
    if m is None:
        return mangled
    i, names, vals = m.end(), [], []

    def length_prefixed(i):
        n = re.match(r"\d+", mangled[i:]).group()
        start = i + len(n)
        return mangled[start:start + int(n)], start + int(n)

    while i < len(mangled) and mangled[i].isdigit():
        name, i = length_prefixed(i)
        names.append(name)
    if not names:
        return mangled
    if not mangled.startswith("I", i):
        return names[-1]
    i += 1
    while i < len(mangled) and mangled[i] != "E":
        m = re.match(r"L[a-z](-?\d+)E|f|a|\d", mangled[i:])
        if m is None:
            return names[-1]
        if m.group().isdigit():
            val, i = length_prefixed(i)
        else:
            val = m.group(1) or {"f": "float", "a": "int8_t"}[m.group()]
            i += m.end()
        vals.append(val)
    return f"{names[-1]}<{', '.join(vals)}>"


def compiler_log(source: str) -> List[str]:
    """One line per kernel function of the source's last build: its
    ptxas registers, barriers and shared memory, then its stack and
    spills."""
    log = library_path(source).with_suffix(".log")
    if not log.exists():
        return []
    lines, fn, spill = [], None, ""
    for ln in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn, spill = kernel_label(m.group(1)), ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif fn and "Used" in ln and "registers" in ln:
            used = ln[ln.index("Used"):].strip()
            lines.append(f"{fn}: {used}; {spill}")
            fn = None
    return lines


def load(name: str):
    """The C entry point of the named kernel (or of a helper in
    ``HELPERS``), its library built at first use."""
    with _LOCK:
        fn = _FNS.get(name)
        if fn is None:
            kernel, argtypes, restype = HELPERS.get(
                name, (name, SIGNATURES.get(name), ctypes.c_int))
            source = SOURCES[kernel]
            lib = _LIBS.get(source)
            if lib is None:
                build([kernel])
                lib = _LIBS[source] = ctypes.CDLL(str(library_path(source)))
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
            _FNS[name] = fn
        return fn


def check(name: str, err: int):
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           "(cudaError_t)")
