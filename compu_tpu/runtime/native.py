"""Loader for the native host runtime (csrc/compu_runtime.cpp).

Compiles the shared library on first use (g++, cached beside the source)
and exposes ctypes wrappers; every entry point has a pure-Python/numpy
fallback elsewhere in the package, so absence of a toolchain only costs
host-side speed. A cached library that does not load (built on another
machine) is rebuilt; :func:`load_status` says what happened.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

_CSRC = pathlib.Path(__file__).resolve().parent.parent.parent / "csrc"
_SRC = _CSRC / "compu_runtime.cpp"
_SRCS = [_SRC, _CSRC / "compu_inflate.cpp", _CSRC / "compu_deflate.cpp",
         _CSRC / "compu_parse.cpp", _CSRC / "compu_zstd.cpp",
         _CSRC / "compu_brotli.cpp", _CSRC / "compu_zstd_enc.cpp",
         _CSRC / "compu_brotli_enc.cpp", _CSRC / "compu_brotli_enc2.cpp",
         _CSRC / "compu_zstd_enc2.cpp"]
_SO = _SRC.with_name("libcompu_runtime.so")
_lock = threading.Lock()
_lib = None
_tried = False
_status = "not loaded"


def _build(so: pathlib.Path, srcs, extra) -> None:
    """Compile to a private name, then rename over ``so`` (atomic, so a
    concurrent loader never maps a half-written file)."""
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    subprocess.run(
        ["g++", "-O3", "-shared", "-fPIC", *extra,
         "-o", str(tmp), *map(str, srcs)],
        check=True,
        capture_output=True,
        timeout=120,
    )
    os.replace(tmp, so)


def load_status() -> str:
    """How the native runtime came up: "loaded", "built", "rebuilt" (a
    cached library failed to load) or "unavailable: <reason>"."""
    _load()
    return _status


def _load():
    global _lib, _tried, _status
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            srcs = [p for p in _SRCS if p.exists()]
            # COMPU_NATIVE_CFLAGS (e.g. "-fsanitize=address,undefined" in
            # the CI asan job — the valgrind analogue of the reference's
            # rust.yml:83-88) appends to the compile line and switches the
            # cache filename so sanitized/plain builds never collide.
            extra = os.environ.get("COMPU_NATIVE_CFLAGS", "").split()
            so = _SO if not extra else _SO.with_name("libcompu_runtime_san.so")
            status = "loaded"
            if not so.exists() or any(
                so.stat().st_mtime < p.stat().st_mtime for p in srcs
            ):
                _build(so, srcs, extra)
                status = "built"
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                _build(so, srcs, extra)
                lib = ctypes.CDLL(str(so))
                status = "rebuilt"
            lib.compu_crc32.restype = ctypes.c_uint32
            lib.compu_crc32.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
            lib.compu_adler32.restype = ctypes.c_uint32
            lib.compu_adler32.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
            lib.compu_xxh64.restype = ctypes.c_uint64
            lib.compu_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64]
            lib.compu_malloc.restype = ctypes.c_void_p
            lib.compu_malloc.argtypes = [ctypes.c_size_t]
            lib.compu_free.argtypes = [ctypes.c_void_p]
            lib.compu_alloc_size.restype = ctypes.c_size_t
            lib.compu_alloc_size.argtypes = [ctypes.c_void_p]
            if hasattr(lib, "compu_deflate_new"):
                lib.compu_deflate_new.restype = ctypes.c_void_p
                lib.compu_deflate_new.argtypes = [ctypes.c_int]
                lib.compu_deflate_free.argtypes = [ctypes.c_void_p]
                lib.compu_deflate_reset.argtypes = [ctypes.c_void_p]
                lib.compu_deflate_set_hash_bits.argtypes = [
                    ctypes.c_void_p, ctypes.c_int]
                lib.compu_deflate_run.restype = ctypes.c_size_t
                lib.compu_deflate_run.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.c_int, ctypes.c_int,
                ]
            if hasattr(lib, "compu_optimal_parse"):
                lib.compu_optimal_parse.restype = ctypes.c_int64
                lib.compu_optimal_parse.argtypes = [
                    ctypes.c_char_p, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int32,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ]
            if hasattr(lib, "compu_zstd_new"):
                lib.compu_zstd_new.restype = ctypes.c_void_p
                lib.compu_zstd_new.argtypes = [ctypes.c_int]
                lib.compu_zstd_free.argtypes = [ctypes.c_void_p]
                lib.compu_zstd_reset.argtypes = [ctypes.c_void_p]
                lib.compu_zstd_run.restype = ctypes.c_int
                lib.compu_zstd_run.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.POINTER(ctypes.c_size_t),
                    ctypes.POINTER(ctypes.c_size_t),
                ]
            if hasattr(lib, "compu_brotli_new"):
                lib.compu_brotli_new.restype = ctypes.c_void_p
                lib.compu_brotli_free.argtypes = [ctypes.c_void_p]
                lib.compu_brotli_reset.argtypes = [ctypes.c_void_p]
                lib.compu_brotli_set_tables.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t,
                    ctypes.c_char_p, ctypes.c_size_t,
                    ctypes.c_char_p, ctypes.c_size_t]
                lib.compu_brotli_run.restype = ctypes.c_int
                lib.compu_brotli_run.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_size_t, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.POINTER(ctypes.c_size_t),
                    ctypes.POINTER(ctypes.c_size_t),
                ]
            if hasattr(lib, "compu_zstd_seq_bitstream"):
                lib.compu_zstd_seq_from_tokens.restype = ctypes.c_longlong
                lib.compu_zstd_seq_from_tokens.argtypes = [
                    ctypes.c_char_p, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
                ]
                lib.compu_zstd_resolve_offsets.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
                lib.compu_zstd_seq_bitstream.restype = ctypes.c_longlong
                lib.compu_zstd_seq_bitstream.argtypes = (
                    [ctypes.c_longlong]
                    + [ctypes.c_void_p] * 3
                    + [ctypes.c_void_p] * 6
                    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int] * 3
                    + [ctypes.c_void_p, ctypes.c_longlong]
                )
                lib.compu_huf_encode_stream.restype = ctypes.c_longlong
                lib.compu_huf_encode_stream.argtypes = [
                    ctypes.c_char_p, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_longlong,
                ]
                lib.compu_fse_pair_stream.restype = ctypes.c_longlong
                lib.compu_fse_pair_stream.argtypes = [
                    ctypes.c_char_p, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_longlong,
                ]
                lib.compu_zstd_optimal_parse.restype = ctypes.c_longlong
                lib.compu_zstd_optimal_parse.argtypes = [
                    ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_double,
                    ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ]
                lib.compu_zstd_promote_rep.argtypes = [
                    ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_void_p,
                ]
                lib.compu_find_matches_k.restype = ctypes.c_longlong
                lib.compu_find_matches_k.argtypes = [
                    ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
                lib.compu_greedy_cover.restype = ctypes.c_longlong
                lib.compu_greedy_cover.argtypes = [
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                lib.compu_find_matches.argtypes = [
                    ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
            if hasattr(lib, "compu_brotli_emit_commands"):
                lib.compu_brotli_commands_from_tokens.restype = ctypes.c_longlong
                lib.compu_brotli_commands_from_tokens.argtypes = [
                    ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p,
                ]
                lib.compu_brotli_plan_distances.restype = ctypes.c_longlong
                lib.compu_brotli_plan_distances.argtypes = [
                    ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ]
                lib.compu_brotli_emit_commands.restype = ctypes.c_longlong
                lib.compu_brotli_emit_commands.argtypes = [
                    ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p,
                    ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_uint64, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_void_p,
                ]
            if hasattr(lib, "compu_inflate_new"):
                lib.compu_inflate_new.restype = ctypes.c_void_p
                lib.compu_inflate_free.argtypes = [ctypes.c_void_p]
                lib.compu_inflate_reset.argtypes = [ctypes.c_void_p]
                lib.compu_inflate_run.restype = ctypes.c_int
                lib.compu_inflate_run.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.POINTER(ctypes.c_size_t),
                    ctypes.POINTER(ctypes.c_size_t),
                ]
                if hasattr(lib, "compu_zstd2_new"):
                    lib.compu_zstd2_new.restype = ctypes.c_void_p
                    lib.compu_zstd2_new.argtypes = [ctypes.c_int] * 3
                    lib.compu_zstd2_free.argtypes = [ctypes.c_void_p]
                    lib.compu_zstd2_reset.argtypes = [ctypes.c_void_p]
                    lib.compu_zstd2_run.restype = ctypes.c_longlong
                    lib.compu_zstd2_run.argtypes = [
                        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                    ]
                if hasattr(lib, "compu_brenc2_new"):
                    lib.compu_brenc2_new.restype = ctypes.c_void_p
                    lib.compu_brenc2_new.argtypes = [ctypes.c_int, ctypes.c_int]
                    lib.compu_brenc2_free.argtypes = [ctypes.c_void_p]
                    lib.compu_brenc2_reset.argtypes = [ctypes.c_void_p]
                    lib.compu_brenc2_run.restype = ctypes.c_longlong
                    lib.compu_brenc2_run.argtypes = [
                        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                    ]
                if hasattr(lib, "compu_inflate_set_check"):
                    lib.compu_inflate_set_check.argtypes = [
                        ctypes.c_void_p, ctypes.c_int]
                    lib.compu_inflate_get_check.restype = ctypes.c_uint32
                    lib.compu_inflate_get_check.argtypes = [ctypes.c_void_p]
            _lib = lib
            _status = status
        except Exception as exc:
            _lib = None
            _status = f"unavailable: {type(exc).__name__}: {exc}"
        return _lib


def native_available() -> bool:
    return _load() is not None


def crc32(data, value: int = 0) -> int | None:
    lib = _load()
    if lib is None:
        return None
    return int(lib.compu_crc32(bytes(data), len(data), value & 0xFFFFFFFF))


def adler32(data, value: int = 1) -> int | None:
    lib = _load()
    if lib is None:
        return None
    return int(lib.compu_adler32(bytes(data), len(data), value & 0xFFFFFFFF))


def xxh64(data, seed: int = 0) -> int | None:
    lib = _load()
    if lib is None:
        return None
    return int(lib.compu_xxh64(bytes(data), len(data), seed))


def find_matches_k(data, max_dist, K, depth, nice, deflate_heuristics,
                   hash_bits):
    """Native pareto-candidate chain matcher; None when the library is
    absent. Returns (lens_k, dists_k) int64 (n, K) arrays — identical to
    the numpy reference (deflate_encode.find_matches_k)."""
    lib = _load()
    if lib is None or not hasattr(lib, "compu_find_matches_k"):
        return None
    import numpy as np

    n = len(data)
    lens_k = np.zeros((n, K), dtype=np.int64)
    dists_k = np.zeros((n, K), dtype=np.int64)
    lib.compu_find_matches_k(
        bytes(data), n, max_dist, K, depth, nice,
        1 if deflate_heuristics else 0, hash_bits,
        lens_k.ctypes.data, dists_k.ctypes.data)
    return lens_k, dists_k


def find_matches(data, max_dist, depth, nice, hash_bits, patience,
                 hash6_depth, filtered):
    """Native best-match chain walk; None when the library is absent.
    Identical to the numpy reference (deflate_encode.find_matches)."""
    lib = _load()
    if lib is None or not hasattr(lib, "compu_find_matches"):
        return None
    import numpy as np

    n = len(data)
    lens = np.zeros(n, dtype=np.int64)
    dists = np.zeros(n, dtype=np.int64)
    lib.compu_find_matches(
        bytes(data), n, max_dist, depth, nice, hash_bits, patience,
        hash6_depth, 1 if filtered else 0,
        lens.ctypes.data, dists.ctypes.data)
    return lens, dists


def optimal_parse(data, lens, dists, litcost, lcost, dcost, cands):
    """Native Zopfli-style squeeze DP; None when the library is absent.
    Returns (tok_pos, tok_len, tok_dist) int64 arrays (len 0 = literal)."""
    lib = _load()
    if lib is None or not hasattr(lib, "compu_optimal_parse"):
        return None
    import numpy as np

    n = len(data)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    dists64 = np.ascontiguousarray(dists, dtype=np.int64)
    litc = np.ascontiguousarray(litcost, dtype=np.float64)
    lc = np.ascontiguousarray(lcost, dtype=np.float64)
    dc = np.ascontiguousarray(dcost, dtype=np.float64)
    cands32 = np.ascontiguousarray(cands, dtype=np.int32)
    tp = np.empty(n, dtype=np.int32)
    tl = np.empty(n, dtype=np.int32)
    td = np.empty(n, dtype=np.int32)
    assert litc.size == 256 and lc.size == 256 and dc.size == n
    t = lib.compu_optimal_parse(
        bytes(data), n,
        lens64.ctypes.data, dists64.ctypes.data,
        litc.ctypes.data, lc.ctypes.data, dc.ctypes.data,
        cands32.ctypes.data, len(cands32),
        tp.ctypes.data, tl.ctypes.data, td.ctypes.data,
    )
    if t < 0:
        return None
    return (tp[:t].astype(np.int64), tl[:t].astype(np.int64),
            td[:t].astype(np.int64))
