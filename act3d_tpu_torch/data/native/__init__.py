"""Native (C++) blosc codec of the episode loader, built on demand with g++.

A copy of ``act3d_tpu/data/native`` for the port.  ``bloscdec.cpp`` is
compiled at first use into ``act3d_tpu_torch/_build/`` (listed in
.gitignore), named by a hash of the source and the flags, as the CUDA
kernels are (``kernels/_build.py``); nothing is written beside the source
and nothing runs at import.  ``decompress`` prefers the hand-written
decoder and falls back to the system libblosc (if present) for codecs it
does not implement; ``compress`` writes blosclz through libblosc when it is
present and the portable memcpy container otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_SOURCE = Path(__file__).resolve().parent / "bloscdec.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB: Optional[ctypes.CDLL] = None
_SYSTEM_BLOSC: Optional[ctypes.CDLL] = None
_SYSTEM_BLOSC_PROBED = False


def library_path() -> Path:
    """The codec's library, named by a hash of the source and the flags."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"bloscdec-{h.hexdigest()[:16]}.so"


def _build_lib() -> Path:
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SOURCE)], check=True,
                   capture_output=True)
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build_lib()))
        lib.blosc_portable_info.restype = ctypes.c_int
        lib.blosc_portable_decompress.restype = ctypes.c_int
        lib.blosc_portable_pack_memcpy.restype = ctypes.c_int64
        _LIB = lib
    return _LIB


def _system_blosc() -> Optional[ctypes.CDLL]:
    global _SYSTEM_BLOSC, _SYSTEM_BLOSC_PROBED
    if not _SYSTEM_BLOSC_PROBED:
        _SYSTEM_BLOSC_PROBED = True
        for name in ("libblosc.so.1", "libblosc.so"):
            try:
                _SYSTEM_BLOSC = ctypes.CDLL(name)
                break
            except OSError:
                continue
    return _SYSTEM_BLOSC


def container_info(data: bytes):
    """(nbytes, cbytes, flags, typesize, blocksize) of a blosc1 container."""
    nbytes = ctypes.c_int64()
    cbytes = ctypes.c_int64()
    flags = ctypes.c_int()
    typesize = ctypes.c_int()
    blocksize = ctypes.c_int64()
    rc = _lib().blosc_portable_info(
        data, ctypes.c_int64(len(data)),
        ctypes.byref(nbytes), ctypes.byref(cbytes), ctypes.byref(flags),
        ctypes.byref(typesize), ctypes.byref(blocksize),
    )
    if rc != 0:
        raise ValueError(f"invalid blosc container (rc={rc})")
    return nbytes.value, cbytes.value, flags.value, typesize.value, blocksize.value


def decompress(data: bytes) -> bytes:
    """Decompress a blosc1 container (drop-in for blosc.decompress)."""
    nbytes = container_info(data)[0]
    out = ctypes.create_string_buffer(max(nbytes, 1))
    rc = _lib().blosc_portable_decompress(data, ctypes.c_int64(len(data)), out,
                                          ctypes.c_int64(nbytes))
    if rc == 0:
        return out.raw[:nbytes]
    sysb = _system_blosc()  # codecs the portable decoder does not implement
    if sysb is not None:
        n = sysb.blosc_decompress_ctx(data, out, ctypes.c_size_t(nbytes), ctypes.c_int(1))
        if n == nbytes:
            return out.raw[:nbytes]
    raise ValueError(f"blosc decompression failed (rc={rc})")


def pack_memcpy(data: bytes, typesize: int = 8) -> bytes:
    """Wrap raw bytes in a memcpy-mode blosc1 container (python-blosc
    readable)."""
    out = ctypes.create_string_buffer(16 + len(data))
    n = _lib().blosc_portable_pack_memcpy(data, ctypes.c_int64(len(data)),
                                          ctypes.c_int(typesize), out)
    return out.raw[:n]


def compress(data: bytes, typesize: int = 8, clevel: int = 9) -> bytes:
    """Compress into a blosc1 container: blosclz + shuffle through the
    system libblosc (the reference's python-blosc output), or the portable
    memcpy container when libblosc is absent.  Either output is readable by
    both this loader and python-blosc."""
    sysb = _system_blosc()
    if sysb is not None and len(data) > 0:
        dest = ctypes.create_string_buffer(len(data) + 1024)
        n = sysb.blosc_compress_ctx(
            ctypes.c_int(clevel), ctypes.c_int(1), ctypes.c_size_t(typesize),
            ctypes.c_size_t(len(data)), data, dest,
            ctypes.c_size_t(len(dest)), b"blosclz",
            ctypes.c_size_t(0), ctypes.c_int(1),
        )
        if n > 0:
            return dest.raw[:n]
    return pack_memcpy(data, typesize)
