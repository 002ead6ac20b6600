"""Native host runtime: C++ stream indexer / dense symbol decoder (ctypes).

Builds ``build/libdcsnative-<key>.so`` on demand from ``src/*.cpp`` with a
generated table header.  The key hashes the sources, the compiler's version
and the host CPU, so a library built with ``-march=native`` on one machine
is never loaded on another: a copied checkout rebuilds on first use.
Python threads fan the (GIL-releasing) C calls out across cores for batch
workloads.  Falls back to None if no compiler is available (``build_error``
says why); callers then use the pure-Python prescan.
"""

import ctypes as C
import fcntl
import hashlib
import os
import platform
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_BUILD = os.path.join(_REPO, "build")
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_SOURCES = ("dcs_native.cpp", "flac.cpp", "mp3.cpp", "vorbis.cpp",
            "adsp2105.cpp", "encoder94.cpp", "encoder93.cpp", "tracer.cpp")
_lib = None
_tried = False
build_error = None


def _host_cpu():
    """The host CPU's model and feature flags (what -march=native sees)."""
    try:
        with open("/proc/cpuinfo") as f:
            keep = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(keep)))
    except OSError:
        return platform.processor()


def lib_path():
    """The library's path for these sources, this compiler and this CPU."""
    h = hashlib.sha256()
    for name in _SOURCES + ("mp3_tables.h", "vorbis_tables.h"):
        path = os.path.join(_SRC, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                h.update(f.read())
    with open(os.path.join(os.path.dirname(_SRC), "gen_tables.py"), "rb") as f:
        h.update(f.read())
    try:
        h.update(subprocess.run(["g++", "--version"], capture_output=True,
                                check=True).stdout)
    except (OSError, subprocess.CalledProcessError):
        h.update(b"no g++")
    h.update((platform.machine() + _host_cpu()).encode())
    return os.path.join(_BUILD, f"libdcsnative-{h.hexdigest()[:16]}.so")


def _build(path):
    from . import gen_tables
    hdr = os.path.join(_BUILD, "native_inc", "dcs_tables.h")
    gen_tables.emit(hdr)
    # built under a private name and renamed into place, so no process
    # ever finds a half-written library at the final path
    tmp = f"{path}.{os.getpid()}.tmp"
    # -march=native vectorizes the encoder search loops (~15% on the
    # enc94 bench); -ffp-contract=off keeps strict per-op IEEE double
    # semantics so the float twins (encoder93's error sums) stay
    # byte-identical to numpy even where the ISA has FMA.  Fall back to
    # plain -O3 if the host compiler rejects the arch.
    base = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
            f"-I{os.path.dirname(hdr)}",
            *[os.path.join(_SRC, n) for n in _SOURCES], "-o", tmp]
    try:
        subprocess.run(base[:2] + ["-march=native", "-ffp-contract=off"]
                       + base[2:], check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError:
        subprocess.run(base, check=True, capture_output=True, text=True)
    os.replace(tmp, path)


def get_lib():
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = lib_path()
    try:
        if not os.path.exists(path):
            os.makedirs(_BUILD, exist_ok=True)
            # one process builds; the others (test workers, spawned
            # encoder workers) wait for it instead of compiling too
            with open(path + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(path):
                    _build(path)
        lib = C.CDLL(path)
    except (subprocess.CalledProcessError, OSError) as e:
        build_error = f"{type(e).__name__}: {getattr(e, 'stderr', '') or e}"
        return None
    lib.dcs94_frame_count.restype = C.c_int
    lib.dcs94_frame_count.argtypes = [C.c_char_p, C.c_int, C.c_int]
    lib.dcs94_decode_dense.restype = C.c_int
    lib.dcs94_decode_dense.argtypes = [
        C.c_char_p, C.c_int, C.c_int,
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p]
    lib.dcs93_index.restype = C.c_int
    lib.dcs93_index.argtypes = [C.c_char_p, C.c_int, C.c_int] + [C.c_void_p] * 11
    lib.dcs93a_index.restype = C.c_int
    lib.dcs93a_index.argtypes = [C.c_char_p, C.c_int, C.c_int] + [C.c_void_p] * 5
    lib.flac_info.restype = C.c_int
    lib.flac_info.argtypes = [C.c_char_p, C.c_int64, C.c_void_p, C.c_void_p]
    lib.flac_decode.restype = C.c_int64
    lib.flac_decode.argtypes = [C.c_char_p, C.c_int64, C.c_void_p, C.c_int64]
    lib.mp3_info.restype = C.c_int
    lib.mp3_info.argtypes = [C.c_char_p, C.c_int64, C.c_void_p]
    lib.mp3_decode.restype = C.c_int64
    lib.mp3_decode.argtypes = [C.c_char_p, C.c_int64, C.c_void_p, C.c_int64]
    lib.vorbis_probe.restype = C.c_int
    lib.vorbis_probe.argtypes = [C.c_char_p, C.c_int64, C.c_void_p]
    lib.vorbis_decode.restype = C.c_int64
    lib.vorbis_decode.argtypes = [C.c_char_p, C.c_int64, C.c_void_p,
                                  C.c_int64]
    lib.vorbis_imdct_selftest.restype = C.c_double
    lib.vorbis_imdct_selftest.argtypes = [C.c_int, C.c_void_p, C.c_void_p,
                                          C.c_void_p]
    lib.dcs_pack_bits.restype = C.c_int64
    lib.dcs_pack_bits.argtypes = [C.c_void_p, C.c_void_p, C.c_int64,
                                  C.c_void_p, C.c_int64]
    lib.dcs94_encode_search.restype = C.c_int64
    lib.dcs94_encode_search.argtypes = (
        [C.c_void_p, C.c_int, C.c_int, C.c_int]
        + [C.c_void_p] * 7
        + [C.c_void_p, C.c_int, C.c_int, C.c_void_p]
        + [C.c_int, C.c_int] + [C.c_void_p] * 6
        + [C.c_void_p, C.c_int64, C.c_void_p])
    lib.dcstr_create.restype = C.c_void_p
    lib.dcstr_create.argtypes = [C.c_int] * 5
    lib.dcstr_destroy.argtypes = [C.c_void_p]
    lib.dcstr_add_chip.argtypes = [C.c_void_p, C.c_int, C.c_char_p,
                                   C.c_int64]
    lib.dcstr_set_catalog.argtypes = [C.c_void_p, C.c_int64, C.c_int64,
                                      C.c_int, C.c_int]
    lib.dcstr_soft_boot.argtypes = [C.c_void_p]
    lib.dcstr_full_reset.argtypes = [C.c_void_p]
    lib.dcstr_load_stream.argtypes = [C.c_void_p, C.c_int, C.c_uint,
                                      C.c_int, C.c_int]
    lib.dcstr_write_port.argtypes = [C.c_void_p, C.c_int]
    lib.dcstr_trace.restype = C.c_int
    lib.dcstr_trace.argtypes = [C.c_void_p, C.c_int, C.c_void_p, C.c_void_p,
                                C.c_int] + [C.c_void_p] * 4
    lib.dcstr_trace_rows.restype = C.c_int
    lib.dcstr_trace_rows.argtypes = [C.c_void_p, C.c_int, C.c_void_p,
                                     C.c_void_p, C.c_int, C.c_void_p,
                                     C.c_void_p, C.c_int] + [C.c_void_p] * 3
    lib.dcstr_trace_segs.restype = C.c_int
    lib.dcstr_trace_segs.argtypes = [C.c_void_p, C.c_int, C.c_void_p,
                                     C.c_void_p, C.c_int, C.c_void_p,
                                     C.c_void_p, C.c_int, C.c_int,
                                     C.c_int] + [C.c_void_p] * 5
    lib.dcstr_trace_segs_batch.restype = C.c_int
    lib.dcstr_trace_segs_batch.argtypes = (
        [C.c_void_p, C.c_int, C.c_int] + [C.c_void_p] * 3
        + [C.c_void_p, C.c_void_p, C.c_int, C.c_int, C.c_int]
        + [C.c_void_p] * 5)
    lib.dcstr_read_host.restype = C.c_int
    lib.dcstr_read_host.argtypes = [C.c_void_p, C.c_void_p, C.c_int]
    lib.dcs93_encode_body.restype = C.c_int64
    lib.dcs93_encode_body.argtypes = (
        [C.c_void_p, C.c_int, C.c_int, C.c_int]
        + [C.c_void_p] * 7 + [C.c_void_p, C.c_int64])
    lib.dcs93_encode_stream.restype = C.c_int64
    lib.dcs93_encode_stream.argtypes = (
        [C.c_void_p, C.c_int, C.c_int, C.c_int]
        + [C.c_void_p] * 3 + [C.c_double]
        + [C.c_void_p] * 2 + [C.c_void_p, C.c_int64])
    lib.dcs94_emit_with_codes.restype = C.c_int64
    lib.dcs94_emit_with_codes.argtypes = (
        [C.c_void_p, C.c_int, C.c_int]
        + [C.c_void_p] * 4
        + [C.c_int, C.c_void_p, C.c_int, C.c_int]
        + [C.c_void_p] * 6
        + [C.c_void_p, C.c_int64])
    _lib = lib
    return _lib


def pack_bits(values, bits):
    """MSB-first pack of variable-width symbols via the native packer.

    values/bits: int32 arrays of equal size.  Returns bytes, or None if
    the native library is unavailable (caller falls back to numpy)."""
    lib = get_lib()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.int32).reshape(-1)
    bits = np.ascontiguousarray(bits, dtype=np.int32).reshape(-1)
    cap = int(bits.sum()) // 8 + 8
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.dcs_pack_bits(values.ctypes.data_as(C.c_void_p),
                          bits.ctypes.data_as(C.c_void_p),
                          values.size, out.ctypes.data_as(C.c_void_p), cap)
    if n < 0:
        raise RuntimeError("bit packer capacity exceeded")
    return out[:n].tobytes()


def encode94_search(ci, formats, bands_keep, thr, sil_max):
    """Run the native stream-format search (src/encoder94.cpp): the full
    decision pipeline for every FormatSetup candidate, keeping the smallest.

    ci [F, 255] int32; formats: list of core94.FormatSetup; thr [16] int32.
    Returns (winner_index, body_bytes), or None if the native library is
    unavailable (caller falls back to the numpy core)."""
    lib = get_lib()
    if lib is None:
        return None
    from ..encoder import core94 as c94
    NF = len(formats)
    ci = np.ascontiguousarray(ci, dtype=np.int32)
    F = ci.shape[0]
    stack = lambda key: np.ascontiguousarray(
        np.stack([getattr(fs, key) for fs in formats]), dtype=np.int32)
    w_lut, sf_lut = stack("w_lut"), stack("sf_lut")
    amin, amax = stack("amin_lut"), stack("amax_lut")
    pip = stack("pidx_of_prev")
    dep = np.ascontiguousarray(
        [fs.fmt_type == 1 for fs in formats], dtype=np.int32)
    n_p = np.ascontiguousarray([fs.n_p for fs in formats], dtype=np.int32)
    thr = np.ascontiguousarray(thr, dtype=np.int32)
    bsz = np.ascontiguousarray(c94.BAND_SIZES, dtype=np.int32)
    dval = np.ascontiguousarray(c94.DELTA_VAL, dtype=np.int32)
    dbits = np.ascontiguousarray(c94.DELTA_BITS, dtype=np.int32)
    cbc = np.ascontiguousarray(c94.CB_CODE, dtype=np.int32)
    cbb = np.ascontiguousarray(c94.CB_BITS, dtype=np.int32)
    tzc = np.ascontiguousarray(c94.TZ_CODE, dtype=np.int32)
    tzb = np.ascontiguousarray(c94.TZ_BITS, dtype=np.int32)
    cap = F * 600 + 64
    out = np.zeros(cap, dtype=np.uint8)
    winner = np.zeros(1, dtype=np.int32)
    p = lambda a: a.ctypes.data_as(C.c_void_p)
    n = lib.dcs94_encode_search(
        p(ci), F, NF, int(c94.PMAX), p(w_lut), p(sf_lut), p(amin), p(amax),
        p(pip), p(dep), p(n_p), p(thr), int(bands_keep), int(sil_max),
        p(bsz), int(c94.DELTA_LO), int(dval.size), p(dval), p(dbits),
        p(cbc), p(cbb), p(tzc), p(tzb), p(out), cap, p(winner))
    if n < 0:
        raise RuntimeError(f"native encode failed: {n}")
    return int(winner[0]), out[:n].tobytes()


def encode93_body(q0all, fmt_type, bands_keep, counts, bstart,
                  best_full, best_no15, allzero, huff_cw, huff_nb):
    """Emit a 1993-format stream body with the native frame loop
    (src/encoder93.cpp), the C++ twin of encoder93._emit_body93.

    q0all [F, 256] int64 quantized samples (transmit layout); best_full /
    best_no15 [16, F] int32; allzero [16, F] uint8.  Returns body bytes,
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    q0all = np.ascontiguousarray(q0all, dtype=np.int64)
    F = q0all.shape[0]
    arrs = [np.ascontiguousarray(counts, dtype=np.int32),
            np.ascontiguousarray(bstart, dtype=np.int32),
            np.ascontiguousarray(best_full, dtype=np.int32),
            np.ascontiguousarray(best_no15, dtype=np.int32),
            np.ascontiguousarray(allzero, dtype=np.uint8),
            np.ascontiguousarray(huff_cw, dtype=np.int32),
            np.ascontiguousarray(huff_nb, dtype=np.int32)]
    cap = F * 600 + 64
    out = np.zeros(cap, dtype=np.uint8)
    p = lambda a: a.ctypes.data_as(C.c_void_p)
    n = lib.dcs93_encode_body(p(q0all), F, int(fmt_type), int(bands_keep),
                              *[p(a) for a in arrs], p(out), cap)
    if n < 0:
        raise RuntimeError(f"native 93 encode failed: {n}")
    return out[:n].tobytes()


def encode93_stream(tx, fmt_type, bands_keep, counts, bstart, scales,
                    max_err, huff_cw, huff_nb):
    """Full-stream native 1993 encode (src/encoder93.cpp): quantization,
    the subtype-0 width search, and the body emission in one call —
    byte-identical to the numpy-precompute + encode93_body path.

    tx [F, 256] float64 transmit-position coefficients; scales [16]
    float64.  Returns body bytes, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tx = np.ascontiguousarray(tx, dtype=np.float64)
    F = tx.shape[0]
    arrs = [np.ascontiguousarray(counts, dtype=np.int32),
            np.ascontiguousarray(bstart, dtype=np.int32),
            np.ascontiguousarray(scales, dtype=np.float64)]
    tail = [np.ascontiguousarray(huff_cw, dtype=np.int32),
            np.ascontiguousarray(huff_nb, dtype=np.int32)]
    cap = F * 600 + 64
    out = np.zeros(cap, dtype=np.uint8)
    p = lambda a: a.ctypes.data_as(C.c_void_p)
    n = lib.dcs93_encode_stream(
        p(tx), F, int(fmt_type), int(bands_keep), *[p(a) for a in arrs],
        float(max_err), *[p(a) for a in tail], p(out), cap)
    if n < 0:
        raise RuntimeError(f"native 93 encode failed: {n}")
    return out[:n].tobytes()


def emit94_with_codes(ci, fs, codes, pidx, bands_keep):
    """Emit + pack one stream for the winning format given its per-frame
    band-type codes (the device twin's return, encoder/device94.py).

    ci [F, 255] int32; fs: core94.FormatSetup; codes/pidx [F, 16].
    Returns body bytes, or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..encoder import core94 as c94
    ci = np.ascontiguousarray(ci, dtype=np.int32)
    F = ci.shape[0]
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    pidx = np.ascontiguousarray(pidx, dtype=np.int8)
    wl = np.ascontiguousarray(fs.w_lut, dtype=np.int32)
    sl = np.ascontiguousarray(fs.sf_lut, dtype=np.int32)
    bsz = np.ascontiguousarray(c94.BAND_SIZES, dtype=np.int32)
    dval = np.ascontiguousarray(c94.DELTA_VAL, dtype=np.int32)
    dbits = np.ascontiguousarray(c94.DELTA_BITS, dtype=np.int32)
    cbc = np.ascontiguousarray(c94.CB_CODE, dtype=np.int32)
    cbb = np.ascontiguousarray(c94.CB_BITS, dtype=np.int32)
    tzc = np.ascontiguousarray(c94.TZ_CODE, dtype=np.int32)
    tzb = np.ascontiguousarray(c94.TZ_BITS, dtype=np.int32)
    cap = F * 600 + 64
    out = np.zeros(cap, dtype=np.uint8)
    p = lambda a: a.ctypes.data_as(C.c_void_p)
    n = lib.dcs94_emit_with_codes(
        p(ci), F, int(c94.PMAX), p(wl), p(sl), p(codes), p(pidx),
        int(bands_keep), p(bsz), int(c94.DELTA_LO), int(dval.size),
        p(dval), p(dbits), p(cbc), p(cbb), p(tzc), p(tzb), p(out), cap)
    if n < 0:
        raise RuntimeError(f"native emit failed: {n}")
    return out[:n].tobytes()


class NativeDecode:
    """Result arrays of a native dense decode."""

    __slots__ = ("n_frames", "header", "fmt_type", "sub_type", "error_frame",
                 "max_symbols", "start_bit", "end_bit", "band_type",
                 "band_type_prev", "dense", "scale", "fb_idx", "valid")


def decode_dense(stream, pos=0, want_controls=True):
    """Index + densely decode a 1994+ stream with the native runtime.

    Returns a NativeDecode, or None if the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    buf = bytes(stream)
    F = lib.dcs94_frame_count(buf, len(buf), pos)
    if F < 0:
        raise ValueError("stream too short")
    r = NativeDecode()
    r.n_frames = F
    r.header = np.zeros(16, dtype=np.uint8)
    meta = np.zeros(4, dtype=np.int32)
    r.start_bit = np.zeros(F, dtype=np.int64)
    r.end_bit = np.zeros(F, dtype=np.int64)
    r.band_type = np.zeros((F, 16), dtype=np.int32)
    r.band_type_prev = np.zeros((F, 16), dtype=np.int32)
    if want_controls:
        r.dense = np.zeros((F, 256), dtype=np.int32)
        r.scale = np.zeros((F, 256), dtype=np.int32)
        r.fb_idx = np.zeros((F, 256), dtype=np.int16)
        r.valid = np.zeros((F, 256), dtype=np.uint8)
    else:
        r.dense = r.scale = r.fb_idx = r.valid = None

    def p(a):
        return a.ctypes.data_as(C.c_void_p) if a is not None else None

    rc = lib.dcs94_decode_dense(
        buf, len(buf), pos, p(r.header), p(meta),
        p(r.start_bit), p(r.end_bit), p(r.band_type), p(r.band_type_prev),
        p(r.dense), p(r.scale), p(r.fb_idx), p(r.valid))
    if rc != 0:
        raise RuntimeError(f"native decode failed: {rc}")
    r.fmt_type, r.sub_type, r.error_frame, r.max_symbols = (
        int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3]))
    return r


def index93(stream, pos=0):
    """Index a 93-format stream natively; field-identical to
    ops/decode93.prescan93.  Returns None if unavailable or if the walker
    bails on a garbage bit width (caller falls back to Python)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = bytes(stream) + b"\xff" * 8
    F = lib.dcs94_frame_count(buf, len(buf), pos)
    if F < 0:
        raise ValueError("stream too short")
    meta = np.zeros(1, dtype=np.int32)
    z32 = lambda: np.zeros((F, 16), dtype=np.int32)
    kind, width, n_samp = z32(), z32(), z32()
    out_start, out_inc, scale = z32(), z32(), z32()
    prv_in, prv_dl = z32(), z32()
    bit_start = np.zeros((F, 16), dtype=np.int64)
    end_bit = np.zeros(F, dtype=np.int64)

    def p(a):
        return a.ctypes.data_as(C.c_void_p)

    rc = lib.dcs93_index(buf, len(buf), pos, p(meta), p(kind), p(width),
                         p(n_samp), p(bit_start), p(out_start), p(out_inc),
                         p(scale), p(prv_in), p(prv_dl), p(end_bit))
    if rc == -2:
        return None
    if rc != 0:
        raise RuntimeError(f"native 93 index failed: {rc}")
    from ..ops.decode93 import Stream93Index
    to64 = lambda a: a.astype(np.int64)
    return Stream93Index(
        n_frames=F, fmt_type=int(meta[0]), kind=to64(kind),
        width=to64(width), n_samp=to64(n_samp), bit_start=bit_start,
        out_start=to64(out_start), out_inc=to64(out_inc), scale=to64(scale),
        prv_in=to64(prv_in), prv_dl=to64(prv_dl), end_bit=end_bit)


def index93a(stream, pos=0):
    """Index an OS93a Type-1 stream natively; field-identical to
    ops/decode93a.prescan93a."""
    lib = get_lib()
    if lib is None:
        return None
    buf = bytes(stream) + b"\xff" * 8
    F = lib.dcs94_frame_count(buf, len(buf), pos)
    if F < 0:
        raise ValueError("stream too short")
    meta = np.zeros(1, dtype=np.int32)
    bits = np.zeros((F, 18), dtype=np.int32)
    scale32 = np.zeros((F, 18), dtype=np.int32)
    bit_start = np.zeros((F, 18), dtype=np.int64)
    end_bit = np.zeros(F, dtype=np.int64)

    def p(a):
        return a.ctypes.data_as(C.c_void_p)

    rc = lib.dcs93a_index(buf, len(buf), pos, p(meta), p(bits), p(bit_start),
                          p(scale32), p(end_bit))
    if rc != 0:
        raise RuntimeError(f"native 93a index failed: {rc}")
    from ..ops.decode93a import Stream93aIndex
    return Stream93aIndex(
        n_frames=F, selector=int(meta[0]), bits=bits.astype(np.int64),
        bit_start=bit_start,
        scale32=scale32.astype(np.int64) & 0xFFFFFFFF, end_bit=end_bit)


def flac_decode(data):
    """Decode a FLAC file with the native runtime (native/src/flac.cpp).

    Returns (samples [N, channels] int32, rate, bits) or None if the native
    library is unavailable.  Raises ValueError on malformed input."""
    lib = get_lib()
    if lib is None:
        return None
    buf = bytes(data)
    meta = np.zeros(4, dtype=np.int32)
    total = np.zeros(1, dtype=np.int64)
    rc = lib.flac_info(buf, len(buf), meta.ctypes.data_as(C.c_void_p),
                       total.ctypes.data_as(C.c_void_p))
    if rc != 0:
        raise ValueError(f"malformed FLAC file (error {rc})")
    rate, nch, bits, _ = (int(x) for x in meta)
    cap = int(total[0]) * nch if total[0] else 0
    if cap == 0:
        cap = max(len(buf) * 4, 1 << 20)   # unknown length: generous bound
    for _ in range(4):
        out = np.zeros(cap, dtype=np.int32)
        n = lib.flac_decode(buf, len(buf), out.ctypes.data_as(C.c_void_p),
                            cap)
        if n == -3:
            cap *= 4
            continue
        if n < 0:
            raise ValueError(f"malformed FLAC file (error {n})")
        # the frame walker stops at the first bad sync; if STREAMINFO
        # recorded a length, a short decode means corruption, not EOF
        if total[0] and n != int(total[0]) * nch:
            raise ValueError(
                f"truncated or corrupt FLAC: decoded {n // max(nch, 1)} of "
                f"{int(total[0])} samples")
        return out[:n].reshape(-1, nch), rate, bits
    raise ValueError("FLAC decode exceeded the output bound")


def decode_dense_batch(streams, workers=None):
    """Decode many streams in parallel host threads (C calls drop the GIL)."""
    if get_lib() is None:
        return None
    workers = workers or min(16, os.cpu_count() or 4)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(decode_dense, streams))


def mp3_decode(data):
    """Decode an MPEG-1 Layer III file with the native runtime
    (native/src/mp3.cpp).

    Returns (samples [N, channels] int16, rate) or None if the native
    library is unavailable.  Raises ValueError on malformed/unsupported
    input."""
    lib = get_lib()
    if lib is None:
        return None
    buf = bytes(data)
    meta = np.zeros(4, dtype=np.int32)
    rc = lib.mp3_info(buf, len(buf), meta.ctypes.data_as(C.c_void_p))
    if rc == -2:
        raise ValueError("unsupported MPEG flavor (MPEG-1 Layer III only)")
    if rc != 0:
        raise ValueError(f"malformed MP3 file (error {rc})")
    rate, nch, frames, _ = (int(x) for x in meta)
    cap = (frames + 2) * 1152 * nch
    out = np.zeros(cap, dtype=np.int16)
    n = lib.mp3_decode(buf, len(buf), out.ctypes.data_as(C.c_void_p), cap)
    if n < 0:
        raise ValueError(f"malformed MP3 file (error {n})")
    return out[:n].reshape(-1, nch), rate


def vorbis_decode(data):
    """Decode an Ogg Vorbis file with the from-scratch native decoder
    (native/src/vorbis.cpp).

    Returns (samples [N, channels] float32, rate) or None if the native
    library is unavailable.  Raises ValueError on malformed input."""
    lib = get_lib()
    if lib is None:
        return None
    buf = bytes(data)
    meta = np.zeros(4, dtype=np.int32)
    rc = lib.vorbis_probe(buf, len(buf), meta.ctypes.data_as(C.c_void_p))
    if rc != 0:
        raise ValueError("malformed Ogg Vorbis file")
    rate, nch = int(meta[0]), int(meta[1])
    total = lib.vorbis_decode(buf, len(buf), None, 0)
    if total < 0:
        raise ValueError("malformed Ogg Vorbis file")
    out = np.zeros(int(total) * nch, dtype=np.float32)
    n = lib.vorbis_decode(buf, len(buf), out.ctypes.data_as(C.c_void_p),
                          total)
    if n < 0:
        raise ValueError("malformed Ogg Vorbis file")
    return out[:int(n) * nch].reshape(-1, nch), rate
