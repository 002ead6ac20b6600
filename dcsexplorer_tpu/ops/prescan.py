"""Host-side stream prescan: index frame boundaries and band types.

DCS frames are variable-length bit strings with no length prefix; frame f+1's
position is only known after walking every Huffman symbol of frame f, and the
band-type header is differential across frames.  That dependency chain is the
one truly serial part of the codec, so it runs ONCE on the host (this module;
a C++ fast path lives in native/), producing a tiny per-frame index:

  start_bit[f]       absolute bit offset of the first sample symbol
  band_type[f, 16]   absolute band types for frame f (post-delta)
  band_type_prev[f]  band types before frame f's deltas (for the type-1
                     scale pre-adjustment of bands 0..2)

Given the index, every frame of every stream decodes **in parallel** on
device (ops/band_decode.py): the per-sample Huffman value decode, dequant,
scale/mix, IFFT, and overlap-add all happen on the device.

Frame layout semantics being indexed: reference DCSDecoderNative.cpp:1679-2261.
"""

from dataclasses import dataclass

import numpy as np

from ..format import tables as T
from ..refdec.bitreader import BitReader, PaddedView


@dataclass
class StreamIndex:
    n_frames: int
    header: np.ndarray          # [16] uint8 stream header (zero-padded copy)
    fmt_type: int               # 0 or 1 (header bit $80)
    sub_type: int               # 0..3
    start_bit: np.ndarray       # [F] int64: first sample symbol bit offset
    band_type: np.ndarray       # [F, 16] int32
    band_type_prev: np.ndarray  # [F, 16] int32
    end_bit: np.ndarray         # [F] int64: one past the frame's last bit
    n_symbols: np.ndarray       # [F] int32: sample symbols in the frame
    error_frame: int            # first frame with a stream error, or -1


def _cursor(bit: BitReader) -> int:
    return bit.pos * 8 - bit.nbits




def prescan94(mem, pos=0, prefer_native=True):
    """Index a 1994+ format stream starting at ``pos`` (U16 frame count).

    Uses the C++ host runtime when available (same index, ~50× faster);
    streams with errors fall back to the Python walker so the garbage
    handling stays byte-identical."""
    if prefer_native:
        try:
            from .. import native
            raw = mem.mem if isinstance(mem, PaddedView) else mem
            nd = native.decode_dense(bytes(raw) + b"\xff" * 8, pos,
                                     want_controls=False)
        except Exception:
            nd = None
        if nd is not None and nd.error_frame < 0:
            return StreamIndex(
                n_frames=nd.n_frames,
                header=np.asarray(nd.header, dtype=np.int64),
                fmt_type=nd.fmt_type, sub_type=nd.sub_type,
                start_bit=nd.start_bit.astype(np.int64),
                band_type=nd.band_type, band_type_prev=nd.band_type_prev,
                end_bit=nd.end_bit.astype(np.int64),
                n_symbols=None, error_frame=-1)
    mem = PaddedView(mem)
    n_frames = (int(mem[pos]) << 8) | int(mem[pos + 1])
    hdr_pos = pos + 2
    header = np.zeros(16, dtype=np.int64)
    for i in range(16):
        header[i] = int(mem[hdr_pos + i])
    fmt_type = (int(header[0]) & 0x80) >> 7
    sub_type = (((int(header[1]) & 0x80) >> 6)
                | ((int(header[2]) & 0x80) >> 7))

    bit = BitReader(mem, hdr_pos + 16)
    tree = T.HUFFTREE94
    preadj_map = T.PREADJ0 if sub_type == 0 else T.PREADJ3

    band_type = np.zeros(16, dtype=np.int64)
    start_bit = np.zeros(n_frames, dtype=np.int64)
    end_bit = np.zeros(n_frames, dtype=np.int64)
    bt = np.zeros((n_frames, 16), dtype=np.int32)
    btp = np.zeros((n_frames, 16), dtype=np.int32)
    n_symbols = np.zeros(n_frames, dtype=np.int32)
    error_frame = -1

    # active header slots (terminator $7F ends both loops)
    n_hdr = 16
    for i in range(16):
        if (int(header[i]) & 0x7F) == 0x7F:
            n_hdr = i
            break

    for f in range(n_frames):
        btp[f] = band_type

        # band-type delta header
        for i in range(n_hdr):
            node = 0
            while True:
                b = bit.get(1)
                node += int(tree[node]) if b else 1
                if tree[node] & 0x8000:
                    break
            band_type[i] = (band_type[i] + (int(tree[node]) & 0xFF) - 0x2E) & 0xFFFF

        bt[f] = band_type
        start_bit[f] = _cursor(bit)
        n_sym = 0

        # walk the sample symbols of each band
        for band in range(n_hdr):
            cur_hdr = int(header[band]) & 0x7F
            out_count = int(T.BAND_OUTPUT_COUNT[band])
            if cur_hdr & 0x40:
                out_count //= 2
            code = int(band_type[band])
            if code == 0:
                continue
            if fmt_type != 0:
                xlat = (T.XLAT02 if band < 3 else
                        T.XLAT35 if band < 6 else T.XLAT6F)
                if code > 15:
                    error_frame = f if error_frame < 0 else error_frame
                    code = code & 0xF
                code = int(xlat[code][0])
            if code == 0:
                if error_frame < 0:
                    error_frame = f
                break
            if code <= 6:
                book = T.CODEBOOKS[code]
                maxw = int(T.MAX_BIT_WIDTH[code])
                i = out_count
                while i != 0:
                    entry = int(book[bit.peek(maxw)])
                    bit.get(entry >> 8)
                    n_sym += 1
                    if entry & 0x80:
                        if i >= 2:
                            i -= 1
                        else:
                            if error_frame < 0:
                                error_frame = f
                            i = 1
                    i -= 1
            else:
                for _ in range(out_count):
                    bit.get(code if code <= 17 else 17)
                n_sym += out_count

        n_symbols[f] = n_sym
        end_bit[f] = _cursor(bit)

    return StreamIndex(n_frames=n_frames, header=header, fmt_type=fmt_type,
                       sub_type=sub_type, start_bit=start_bit, band_type=bt,
                       band_type_prev=btp, end_bit=end_bit,
                       n_symbols=n_symbols, error_frame=error_frame)


def _band_geometry(idx: StreamIndex):
    import numpy as np
    header = np.asarray(idx.header, dtype=np.int64)
    active = np.ones(16, dtype=bool)
    for i in range(16):
        if (int(header[i]) & 0x7F) == 0x7F:
            active[i:] = False
            break
    counts = np.asarray(T.BAND_OUTPUT_COUNT).copy()
    halved = (header & 0x40) != 0
    out_inc = np.where(halved, 2, 1)
    counts = np.where(halved, counts // 2, counts)
    return active, counts, out_inc


def dense_totals(idx: StreamIndex):
    """Per-frame dense output slot counts (data-independent, from band
    types) — the hybrid path's native stage emits this many values."""
    import numpy as np
    active, counts, _ = _band_geometry(idx)
    per_band = np.where(active[None, :] & (idx.band_type != 0),
                        counts[None, :], 0)
    return per_band.sum(axis=1).astype(np.int32)


def scan_totals(idx: StreamIndex):
    """Per-frame POSITION counts (frame-buffer span of all active bands).

    The device scan length must cover max(scan_totals) — the scan axis is
    the frame-buffer position axis (ops/band_decode.decode_frames94).
    """
    import numpy as np
    active, counts, out_inc = _band_geometry(idx)
    adv = np.where(active[None, :] & (idx.band_type != 0),
                   (counts * out_inc)[None, :],
                   np.where(active[None, :], counts[None, :], 0))
    return adv.sum(axis=1).astype(np.int32)
