"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point, which may
include shared ``csrc/*.cuh`` headers. At first use it is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``fisco_bcos_tpu_torch/build/``, named by the hash of the source
together with every header it includes (:func:`source_digest`, so an edited
source or header is rebuilt), and loaded with ``ctypes``. Nothing here runs
at import: the CPU tests import every module.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = {
    "secp256k1_recover": CSRC / "secp256k1_recover.cu",
    "secp256k1_verify": CSRC / "secp256k1_verify.cu",
    "sm2_verify": CSRC / "sm2_verify.cu",
    "keccak256": CSRC / "keccak256.cu",
    "sm3": CSRC / "sm3.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, stack and spills per kernel, into the build log
]

LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME)")
    return str(path)


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def source_digest(src: Path) -> str:
    """Hash of a source and, recursively, of every quoted ``#include`` it
    names (resolved beside the including file, as nvcc resolves them)."""
    h = hashlib.sha256()
    seen: set[Path] = set()

    def feed(path: Path) -> None:
        path = path.resolve()
        if path in seen:
            return
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        for inc in _INCLUDE.findall(text):
            feed(path.parent / inc.decode())

    feed(src)
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(SOURCES[name])}.so"


def build(name: str) -> dict:
    """Compile kernel `name` unless its library is already built. Returns
    {"seconds", "log"}: nvcc's wall time and output (ptxas -v included),
    0.0 and "" when there was nothing to build."""
    out = library_path(name)
    if out.exists():
        return {"seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")  # renamed into place when whole
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return {"seconds": time.perf_counter() - t0, "log": proc.stdout}


@lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    lib.fisco_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fisco_cuda_error_string.restype = ctypes.c_char_p
    return lib


def geometry(name: str, lanes: int) -> dict:
    """Launch geometry of kernel `name` for `lanes` lanes, as its C entry
    point computes it: threads a block, blocks, dynamic shared bytes."""
    fn = getattr(_library(name), f"{name}_geometry")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 3)()
    fn(lanes, out)
    return {"threads": out[0], "blocks": out[1], "dynamic_shared_bytes": out[2]}


def _check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        msg = lib.fisco_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def _require(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# z, r, s, v, comb, qx, qy, ok pointers; lanes; CUDA device index; stream
_RECOVER_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def secp256k1_recover(z, r, s, v, comb):
    """Launch the recover kernel: z, r, s [B, 16] int32 16-bit limbs, v [B]
    int32, comb [60, 8] int32 (uint32 words of the G / 2^128·G combs), all
    on one CUDA device. Returns (qx, qy [B, 16] int32, ok bool[B])."""
    dev = z.device
    if dev.type != "cuda":
        raise ValueError(f"secp256k1_recover needs CUDA tensors, got {dev}")
    b = z.shape[0]
    for what, t, dt, shape in (
        ("z", z, torch.int32, (b, 16)),
        ("r", r, torch.int32, (b, 16)),
        ("s", s, torch.int32, (b, 16)),
        ("v", v, torch.int32, (b,)),
        ("comb", comb, torch.int32, (60, 8)),
    ):
        _require(t, what, dt, shape, dev)
    qx = torch.empty((b, 16), dtype=torch.int32, device=dev)
    qy = torch.empty((b, 16), dtype=torch.int32, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return qx, qy, ok
    lib = _library("secp256k1_recover")
    lib.secp256k1_recover_launch.argtypes = _RECOVER_ARGTYPES
    lib.secp256k1_recover_launch.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = lib.secp256k1_recover_launch(
            z.data_ptr(), r.data_ptr(), s.data_ptr(), v.data_ptr(), comb.data_ptr(),
            qx.data_ptr(), qy.data_ptr(), ok.data_ptr(), b, dev.index, _stream(dev),
        )
    _check_launch(lib, "secp256k1_recover", err)
    LAUNCHES["secp256k1_recover"] += 1
    return qx, qy, ok


def _require_verify_args(
    name: str, inputs: dict, comb, comb_rows: int, dtype=torch.int32, width: int = 16
) -> tuple[torch.device, int]:
    """Checks of a verify kernel's inputs: [B, width] tensors of `dtype`
    ([B, 16] int32 limbs for SM2, [B, 160] uint8 rows for secp256k1) and a
    [comb_rows, 8] int32 comb, contiguous, on one CUDA device."""
    first = next(iter(inputs.values()))
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    b = first.shape[0]
    for what, t in inputs.items():
        _require(t, what, dtype, (b, width), dev)
    _require(comb, "comb", torch.int32, (comb_rows, 8), dev)
    return dev, b


# rows, comb, ok pointers; lanes; CUDA device index; stream
_SECP_VERIFY_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def secp256k1_verify(rows, comb):
    """Launch the secp256k1 verify kernel: rows [B, 160] uint8, z ‖ r ‖ s ‖
    qx ‖ qy big-endian a lane, 16-byte aligned; comb [64, 8] int32 (uint32
    words of the G / 2^128·G combs, c = 1..16); both on one CUDA device.
    Returns ok bool[B]."""
    dev, b = _require_verify_args(
        "secp256k1_verify", {"rows": rows}, comb, 64, dtype=torch.uint8, width=160
    )
    if rows.data_ptr() % 16:
        raise ValueError("secp256k1_verify: rows must be 16-byte aligned (read in 16-byte quads)")
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return ok
    lib = _library("secp256k1_verify")
    lib.secp256k1_verify_launch.argtypes = _SECP_VERIFY_ARGTYPES
    lib.secp256k1_verify_launch.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = lib.secp256k1_verify_launch(
            rows.data_ptr(), comb.data_ptr(), ok.data_ptr(), b, dev.index, _stream(dev),
        )
    _check_launch(lib, "secp256k1_verify", err)
    LAUNCHES["secp256k1_verify"] += 1
    return ok


# e, r, s, qx, qy, comb, ok pointers; lanes; CUDA device index; stream
_SM2_VERIFY_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def sm2_verify(e, r, s, qx, qy, comb):
    """Launch the SM2 verify kernel: e, r, s, qx, qy [B, 16] int32 16-bit
    limbs (plain domain), comb [30, 8] int32 (uint32 words of the
    Montgomery-domain affine c·G), all on one CUDA device. Returns ok
    bool[B]."""
    dev, b = _require_verify_args(
        "sm2_verify", {"e": e, "r": r, "s": s, "qx": qx, "qy": qy}, comb, 30
    )
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return ok
    lib = _library("sm2_verify")
    lib.sm2_verify_launch.argtypes = _SM2_VERIFY_ARGTYPES
    lib.sm2_verify_launch.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = lib.sm2_verify_launch(
            e.data_ptr(), r.data_ptr(), s.data_ptr(), qx.data_ptr(), qy.data_ptr(),
            comb.data_ptr(), ok.data_ptr(), b, dev.index, _stream(dev),
        )
    _check_launch(lib, "sm2_verify", err)
    LAUNCHES["sm2_verify"] += 1
    return ok


# data, starts, lengths, out pointers; messages; bytes of data; CUDA device index; stream
_HASH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _packed_hash(name: str, data, starts, lengths):
    """Launch hash kernel `name` over a packed batch: message i is
    data[starts[i] : starts[i] + lengths[i]]. data uint8 [N], starts int64
    [B], lengths int32 [B], contiguous, on one CUDA device; every range must
    lie inside data (the kernel reads no byte outside it and gives a lane
    whose range does not a zero digest). Returns the digests, [B, 32] uint8."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    b = starts.shape[0]
    _require(data, "data", torch.uint8, (data.numel(),), dev)
    _require(starts, "starts", torch.int64, (b,), dev)
    _require(lengths, "lengths", torch.int32, (b,), dev)
    out = torch.empty((b, 32), dtype=torch.uint8, device=dev)
    if b == 0:
        return out
    lib = _library(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = _HASH_ARGTYPES
    launch.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = launch(
            data.data_ptr(), starts.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, data.numel(), dev.index, _stream(dev),
        )
    _check_launch(lib, name, err)
    LAUNCHES[name] += 1
    return out


def keccak256_packed(data, starts, lengths):
    """keccak-256 of each message of a packed batch on the card ([B, 32]
    uint8); see :func:`_packed_hash`."""
    return _packed_hash("keccak256", data, starts, lengths)


def sm3_packed(data, starts, lengths):
    """SM3 of each message of a packed batch on the card ([B, 32] uint8);
    see :func:`_packed_hash`."""
    return _packed_hash("sm3", data, starts, lengths)
