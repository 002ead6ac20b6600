"""ROM set generator: lay out catalog, track programs, DI tables, and audio
streams into flashable U2..U9 images and a PinMame-style zip.

Mirrors the reference compiler's output contract (DCSCompiler.cpp:2064-2923):
- catalog at $3000/$4000 (original DCS) or $6000 (DCS-95) leading with the
  9-entry chip index (size in 4KB units, bank select, POST checksum);
  catalog+$40/$43 hold U24 pointers to the track index and deferred-indirect
  index; catalog+$46 holds the U16 track count
- 3-byte track index entries (linear ROM addresses; $FFxxxx = unpopulated)
- track byte-code programs and streams first-fit across chips
- U2's checksum forced to $0000 via a balancer byte pair (FindCatalog
  requires it: the index lists checksum 0 for U2)
- a synthesized boot block carrying the opcode signatures the version /
  channel-count detectors look for, so generated ROMs classify identically
  in this framework and in the reference

This is a from-scratch design: the input is a programmatic RomSpec (the
script front end in compiler/script.py builds one from DCS scripts).
"""

import io
import struct
import zipfile
from dataclasses import dataclass, field

from ..refdec.decoder import OS93A, OS93B, OS94, OS95

CHIP_SIZES = (512 * 1024, 1024 * 1024)


@dataclass
class TrackSpec:
    number: int
    type: int = 1                  # 1=program, 2=deferred, 3=deferred indirect
    channel: int = 0
    defer_code: int = 0            # for types 2/3
    steps: list = field(default_factory=list)
    # steps: list of (delay, opcode, operand_bytes) tuples, or high-level
    # helpers below can build them


@dataclass
class RomSpec:
    os_version: int = OS94
    signature: str = "dcsexplorer synthetic ROM  01/01/26"
    chip_size: int = 512 * 1024
    max_chips: int = 8
    num_channels: int = 6
    tracks: list = field(default_factory=list)       # TrackSpec
    streams: dict = field(default_factory=dict)      # name -> stream bytes
    di_tables: dict = field(default_factory=dict)    # table id -> [track numbers]


def op_play(channel, stream_name, repeat=1, delay=0):
    return (delay, 0x01, ("stream", channel, stream_name, repeat))

def op_stop_channel(channel, delay=0):
    return (delay, 0x02, bytes([channel]))

def op_queue(track, delay=0):
    return (delay, 0x03, struct.pack(">H", track))

def op_write_port(b, delay=0):
    return (delay, 0x04, bytes([b]))

def op_write_port93a(b, counter=0, delay=0):
    """1993a op $04: data byte + 16-bit repeat counter arming the
    channel's host-event timer (refdec _exec_track, OS93A branch)."""
    return (delay, 0x04, bytes([b]) + struct.pack(">H", counter))

def op_start_deferred(channel, delay=0):
    return (delay, 0x05, bytes([channel]))

def op_set_var(var, val, delay=0):
    return (delay, 0x06, bytes([var, val]))

def op_mix(mode, channel, level, delay=0):
    # mode: 0=set 1=up 2=down; level: signed byte (×64 applied by decoder)
    return (delay, 0x07 + mode, bytes([channel, level & 0xFF]))

def op_mix_fade(mode, channel, level, steps, delay=0):
    return (delay, 0x0A + mode, bytes([channel, level & 0xFF]) + struct.pack(">H", steps))

def op_nop(delay=0):
    return (delay, 0x0D, b"")

def op_loop_start(count, delay=0):
    return (delay, 0x0E, bytes([count]))

def op_loop_end(delay=0):
    return (delay, 0x0F, b"")

def op_end(delay=0):
    return (delay, 0x00, b"")

def op_wait_forever():
    return (0xFFFF, 0x0D, b"")


class _Chip:
    def __init__(self, index, size):
        self.index = index
        self.size = size
        self.data = bytearray([0xFF]) * 0 + bytearray(b"\xff" * size)
        self.cursor = 0

    def reserve(self, n, at=None):
        if at is not None:
            self.cursor = max(self.cursor, at + n)
            return at
        ofs = self.cursor
        if ofs + n > self.size:
            return None
        self.cursor += n
        return ofs

    def write(self, ofs, data):
        self.data[ofs:ofs + len(data)] = data


class RomBuilder:
    """Build ROM images from a RomSpec."""

    def __init__(self, spec: RomSpec):
        self.spec = spec
        self.is95 = spec.os_version == OS95
        self.catalog_ofs = 0x6000 if self.is95 else (
            0x3000 if spec.os_version == OS93B else 0x4000)
        self.addr_shift = 21 if self.is95 else 20
        self.chips = [_Chip(0, spec.chip_size)]

    def _linear(self, chip, ofs):
        return (chip << self.addr_shift) | ofs

    def _alloc(self, n):
        """First-fit allocation across chips (U2 first, then U3..U9)."""
        for ch in self.chips:
            ofs = ch.reserve(n)
            if ofs is not None:
                return ch, ofs
        if len(self.chips) >= self.spec.max_chips:
            raise MemoryError("ROM capacity exceeded")
        ch = _Chip(len(self.chips), self.spec.chip_size)
        # U3+ images lead with the "[SU]<n> ... MM/DD/YY" signature that zip
        # loaders match on (reference: DCSDecoderZipLoader.cpp:159-203)
        sig = f"U{ch.index + 2} Sound  01/01/26".encode() + b"\x00"
        ch.write(0, sig)
        ch.reserve(len(sig) + 1)
        self.chips.append(ch)
        ofs = ch.reserve(n)
        return ch, ofs

    # ------------------------------------------------------------------
    def _boot_block(self, u2):
        spec = self.spec
        # RESET vector: JUMP (identifies U2 for loaders; $18xxxF pattern)
        u2.write(0x0000, bytes([0x18, 0x00, 0x0F, 0xFF]))
        sig = spec.signature.encode("ascii", "replace")[:119] + b"\x00"
        u2.write(0x0004, sig)
        # Soft-boot program at $1000.  OS94 and OS95 ROMs carry the full
        # synthesized *decoding* firmware (compiler/firmware94.py, built
        # for the matching board map): boot block + PM overlay + decoder
        # tables, so the emulator backend plays their audio, bit-exact
        # against the native decoder.  OS93b and OS93a ROMs carry the
        # 1993-format decoding firmware (compiler/firmware93.py; the 93a
        # variant adds the Type-1 decompressor, 1-byte Type-1 headers,
        # host-event timers and the $7FFF mixing base).  The first
        # boot word is the JUMP the U2 identification heuristics look
        # for.  ($2000 keeps a JUMP for DCS-95-style layouts.)
        from .firmware import build_firmware, encode_boot_block
        if spec.os_version in (OS94, OS95):
            from . import firmware94 as fw94
            boot, overlay, _ = fw94.build_decoder_firmware(
                catalog_ofs=self.catalog_ofs,
                hw_version=3 if self.is95 else 2)
            u2.write(0x1000, encode_boot_block(boot))
            u2.write(fw94.OVERLAY_ROM_ADDR, fw94.overlay_blob(overlay))
            u2.write(fw94.TABLES_ROM_ADDR, fw94.table_blob())
            self._fw_reserve_end = fw94.FW_RESERVE[1]
        elif spec.os_version == OS93B:
            from . import firmware93 as fw93
            boot, overlay, _ = fw93.build_decoder_firmware(
                catalog_ofs=self.catalog_ofs)
            u2.write(0x1000, encode_boot_block(boot))
            u2.write(fw93.OVERLAY_ROM_ADDR, fw93.overlay_blob(overlay))
            u2.write(fw93.TABLES_ROM_ADDR, fw93.table_blob())
            self._fw_reserve_end = fw93.FW_RESERVE[1]
        elif spec.os_version == OS93A:
            from . import firmware93 as fw93
            boot, overlay, _ = fw93.build_decoder_firmware(
                catalog_ofs=self.catalog_ofs, os93a=True)
            u2.write(0x1000, encode_boot_block(boot))
            u2.write(fw93.OVERLAY_ROM_ADDR, fw93.overlay_blob(overlay))
            u2.write(fw93.TABLES_ROM_ADDR, fw93.table_blob_93a())
            self._fw_reserve_end = fw93.FW_RESERVE_93A[1]
        else:
            u2.write(0x1000, encode_boot_block(
                build_firmware(3 if self.is95 else 2)))
        u2.write(0x2000, bytes([0x18, 0x00, 0x0F, 0xFF]))

        def put_ops(ofs, words):
            for i, w in enumerate(words):
                u2.write(ofs + i * 4,
                         bytes([(w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF, 0xFF]))

        # version-detection opcode signatures (see rom/image.py check()):
        if spec.os_version in (OS93A, OS93B):
            put_ops(0x1000 + 0x100 * 4, [0x380026, 0x3C1005, 0x0C00C0])
        if spec.os_version == OS93A:
            put_ops(0x2000 + 0x200 * 4, [0x47FFF2, 0x47C946])
        if self.is95:
            # 55C2/C3 handler shape carrying the nominal version 1.06
            v = 0x0106
            put_ops(0x2000 + 0x300 * 4, [
                0x400000 | (v << 4) | 0xE, 0x0F16F8, 0x93300E, 0x18000F,
                0x400000 | (v << 4) | 0xE, 0x0F1608, 0x0F16F8, 0x93300E,
                0x18000F])
        # channel-count detection signature
        n = spec.num_channels
        mask = (1 << n) - 1
        put_ops(0x2400, [0x22200F, 0x400004 | (n << 4), 0x26E20F, 0x221800,
                         0x90000A, 0x80000A, 0x400004 | (mask << 4),
                         0x26E20F, 0x180001])

    def build(self):
        spec = self.spec
        u2 = self.chips[0]
        self._boot_block(u2)

        # reserve the fixed-layout region: boot block + catalog area
        # (+ the decoding firmware's overlay/table blobs when present)
        n_tracks = (max(t.number for t in spec.tracks) + 1) if spec.tracks else 0
        u2.reserve(0, at=self.catalog_ofs + 0x48)
        if getattr(self, "_fw_reserve_end", 0):
            u2.reserve(0, at=self._fw_reserve_end)
        track_index_ofs = u2.reserve(n_tracks * 3)
        di_ids = sorted(spec.di_tables)
        di_index_ofs = u2.reserve((max(di_ids) + 1) * 3 if di_ids else 3)

        # deferred-indirect tables
        di_table_ofs = {}
        for tid in di_ids:
            tbl = spec.di_tables[tid]
            ch, ofs = self._alloc(len(tbl) * 2)
            assert ch is u2 or True
            di_table_ofs[tid] = self._linear(ch.index, ofs)
            ch.write(ofs, b"".join(struct.pack(">H", t) for t in tbl))

        # streams
        stream_addr = {}
        for name, data in spec.streams.items():
            ch, ofs = self._alloc(len(data))
            stream_addr[name] = self._linear(ch.index, ofs)
            ch.write(ofs, bytes(data))

        # track programs
        index = bytearray(b"\xff" * (n_tracks * 3))
        for t in spec.tracks:
            body = bytearray([t.type, t.channel])
            if t.type in (2, 3):
                body += struct.pack(">H", t.defer_code)
            else:
                for (delay, op, operands) in t.steps:
                    body += struct.pack(">H", delay) + bytes([op])
                    if isinstance(operands, tuple) and operands[0] == "stream":
                        _, ch_no, name, repeat = operands
                        body += bytes([ch_no])
                        body += struct.pack(">I", stream_addr[name])[1:]
                        body += bytes([repeat])
                    else:
                        body += operands
            ch, ofs = self._alloc(len(body))
            addr = self._linear(ch.index, ofs)
            ch.write(ofs, body)
            index[t.number * 3:t.number * 3 + 3] = struct.pack(">I", addr)[1:]
        u2.write(track_index_ofs, index)

        # DI index
        di_index = bytearray(b"\xff" * ((max(di_ids) + 1) * 3 if di_ids else 3))
        for tid in di_ids:
            di_index[tid * 3:tid * 3 + 3] = struct.pack(">I", di_table_ofs[tid])[1:]
        u2.write(di_index_ofs, di_index)

        # catalog pointers + track count
        co = self.catalog_ofs
        u2.write(co + 0x40, struct.pack(">I", self._linear(0, track_index_ofs))[1:])
        u2.write(co + 0x43, struct.pack(">I", self._linear(0, di_index_ofs))[1:])
        u2.write(co + 0x46, struct.pack(">H", n_tracks))

        # chip index: entries for each populated chip, then terminator
        from ..rom.image import checksum as rom_checksum
        entries = bytearray()
        for ch in self.chips:
            sel = ch.index << (9 if self.is95 else 8)
            ck = 0 if ch.index == 0 else rom_checksum(ch.data)
            entries += struct.pack(">HHH", ch.size // 4096, sel, ck)
        entries += struct.pack(">HHH", 0, 0, 0)
        u2.write(co, entries)

        # force U2's checksum to $0000 with a balancer byte pair
        bal_ofs = u2.reserve(2)
        u2.write(bal_ofs, b"\x00\x00")
        ck = rom_checksum(u2.data)
        even_fix = (-(ck >> 8)) & 0xFF
        odd_fix = (-(ck & 0xFF)) & 0xFF
        u2.write(bal_ofs, bytes([even_fix, odd_fix] if bal_ofs % 2 == 0
                                else [odd_fix, even_fix]))
        assert rom_checksum(u2.data) == 0

        return [bytes(ch.data) for ch in self.chips]

    def build_zip(self, rom_prefix="sound_"):
        """Build the ROM images and pack them as a PinMame-style zip.

        rom_prefix names the zip entries "<prefix>u<N>.rom" (counterpart of
        the reference's --rom-prefix option, DCSEncoder/Main.cpp:100-103)."""
        images = self.build()
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for i, img in enumerate(images):
                zf.writestr(f"{rom_prefix}u{i + 2}.rom", img)
        return buf.getvalue()
