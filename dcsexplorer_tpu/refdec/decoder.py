"""Scalar reference decoder — the complete DCS player runtime, bit-exact.

This is the framework's host-side oracle and the semantic specification for
the device pipeline: channels, track byte-code VM, mixing matrix with fades,
master/channel volume, data-port protocol, boot state machine, and the frame
decode/transform dispatch.  It mirrors the behavior of the reference's native
decoder (DCSDecoder/DCSDecoderNative.{h,cpp} + DCSDecoder.cpp) while being
organized for reuse: the VM/mixer state computed here also drives the batched
device decode path in ``models/``.
"""

from ..format import tables as T
from .bitreader import BitReader, PaddedView
from .fixed import M16, M32, M64, calc_exp32, s16, u16
from .frames import (StreamState, decompress_frame_93,
                     decompress_frame_93a_type1, decompress_frame_94x)
from .transform import transform_frame_93, transform_frame_94x

# OS version codes (match tests/oracle)
OS93A, OS93B, OS94, OS95 = 1, 2, 3, 4

MAX_CHANNELS = T.MAX_CHANNELS


class ResetError(Exception):
    """Simulates the hardware self-reset on invalid track data
    (reference: DCSDecoder.h:1148-1159)."""


class Pointer:
    """Pointer into a ROM chip image or raw stream buffer
    (reference ROMPointer: DCSDecoder.h:730-785)."""

    __slots__ = ("mem", "pos", "chip")

    def __init__(self, mem=None, pos=0, chip=0):
        self.mem = mem
        self.pos = pos
        self.chip = chip

    def clone(self):
        return Pointer(self.mem, self.pos, self.chip)

    @property
    def is_null(self):
        return self.mem is None

    def u8(self):
        v = self.mem[self.pos]
        self.pos += 1
        return int(v)

    def u16(self):
        v = (int(self.mem[self.pos]) << 8) | int(self.mem[self.pos + 1])
        self.pos += 2
        return v

    def u24(self):
        v = ((int(self.mem[self.pos]) << 16)
             | (int(self.mem[self.pos + 1]) << 8)
             | int(self.mem[self.pos + 2]))
        self.pos += 3
        return v

    def peek_u8(self):
        return int(self.mem[self.pos])


class MixingControl:
    __slots__ = ("cur_level", "fade_target", "fade_delta", "fade_steps")

    def __init__(self):
        self.reset()
        self.fade_delta = 0

    def reset(self):
        self.cur_level = 0
        self.fade_target = 0
        self.fade_steps = 0


class HostEventTimer:
    __slots__ = ("data", "interval", "counter")

    def __init__(self):
        self.data = 0
        self.interval = 0
        self.counter = 0

    def set(self, data, interval):
        self.data = data
        self.interval = self.counter = interval

    def clear(self):
        self.interval = self.counter = 0

    def update(self):
        if self.interval != 0:
            self.counter = (self.counter - 1) & M16
            if self.counter == 0:
                self.counter = self.interval
                return True
        return False


class Channel:
    def __init__(self):
        self.track_ptr = None          # Pointer or None
        self.track_counter = 0
        self.next_track_type = 0
        self.next_track_link = 0
        self.stop = False
        self.stream = StreamState()
        self.source_channel = -1
        self.mixer = [MixingControl() for _ in range(MAX_CHANNELS)]
        self.max_mixing_override = False
        self.mixing_multiplier = 0x7FFF
        self.host_event_timer = HostEventTimer()
        self.channel_volume = 0xFF
        self.loop_stack = []           # list of [counter, Pointer]


# decoder states
ST_HARD_BOOT, ST_BONG, ST_RUNNING, ST_FATAL, ST_INIT_ERROR = range(5)


class ListHost:
    """Default host: collects DCS→host data-port bytes."""

    def __init__(self):
        self.rx = []

    def receive_data_port(self, b):
        self.rx.append(b)

    def clear_data_port(self):
        self.rx.clear()

    def boot_timer_control(self, on):
        pass


class ReferenceDecoder:
    """Bit-exact scalar DCS decoder (standalone streams or full ROM sets)."""

    def __init__(self, host=None):
        self.host = host if host is not None else ListHost()
        self.os_version = 0
        self.hw_version = 0
        self.nominal_version = 0
        self.game_id = None
        self.rom_set = None            # rom.image.RomSet for ROM-based play
        self.default_volume = 0x67
        self.fast_boot = False
        self.reported_version = 0x0106

        self.state = ST_HARD_BOOT
        self.mode_sample_counter = 0
        self.bong_count = 0
        self.bong = _Bong()

        self.frame_buffer = [0] * T.FRAME_BUFFER_SIZE
        self.output_buffer = [0] * T.FRAME_SAMPLES
        self.overlap = [0] * 16

        self.nominal_volume = 0x67
        self.volume_multiplier = 0x0391

        self.channels = [Channel() for _ in range(MAX_CHANNELS)]
        self.channel_mask = 0
        self.variables = [0] * 0x100

        self.command_queue = []
        self.data_port_queue = []
        self.last_data_port_byte = 0
        self.data_port_word = 0
        self.data_port_ext = 0
        self.n_data_port_bytes = 0
        self.data_port_timeout = 0

    # ------------------------------------------------------------------
    # setup / boot (reference: DCSDecoder.cpp:1233-1558, DCSDecoderNative.cpp:32-59)

    def init_standalone(self, os_version):
        self.os_version = os_version
        self.hw_version = 2 if os_version in (OS93A, OS93B, OS94) else 3

    def load_rom_set(self, rom_set):
        """Attach a rom.image.RomSet (catalog + version already parsed)."""
        self.rom_set = rom_set
        self.os_version = rom_set.os_version
        self.hw_version = rom_set.hw_version
        self.nominal_version = rom_set.nominal_version
        self.game_id = rom_set.game_id

    def make_rom_pointer(self, linear):
        return self.rom_set.make_pointer(linear)

    def hard_boot(self):
        self.state = ST_HARD_BOOT
        self.clear_data_port()
        self.mode_sample_counter = 0
        self.host.boot_timer_control(True)

    def start_self_tests(self):
        self.host.boot_timer_control(False)
        if self.state == ST_HARD_BOOT:
            post = self.rom_set.check() if self.rom_set is not None else 2
            self.host.receive_data_port(0x79)
            self.host.receive_data_port(post)
            if self.fast_boot:
                self.soft_boot()
            else:
                self.bong.start()
                self.state = ST_BONG
                self.mode_sample_counter = 0
                self.bong_count = post

    def soft_boot(self):
        self.host.boot_timer_control(False)
        self.mode_sample_counter = 30000
        # detect the system version if it hasn't been established yet
        # (reference: DCSDecoder.cpp:1528-1533)
        if self.rom_set is not None and not self.hw_version:
            self.rom_set.check()
            self.load_rom_set(self.rom_set)
        ok = self._initialize()
        # backends may return False to flag an unusable ROM
        # (reference: DCSDecoder.cpp:1536-1539)
        self.state = ST_RUNNING if ok is not False else ST_INIT_ERROR

    def _initialize(self):
        # select the frame decoder implementation family
        # (reference: DCSDecoderNative.cpp:3143-3214)
        for ch in self.channels:
            ch.stop = False
            ch.channel_volume = 0xFF
        self.set_master_volume(self.default_volume)
        # clear the decoder's own incoming queue (NOT the host-bound port)
        self.data_port_queue.clear()
        self.last_data_port_byte = 0
        self.n_data_port_bytes = 0

    # ------------------------------------------------------------------
    # volume (reference: DCSDecoderNative.cpp:3250-3291)

    def set_master_volume(self, vol):
        self.nominal_volume = 255 if vol > 255 else 0 if vol < 0 else vol
        if vol != 0:
            s = vol & M16
            x, y = 0x3FFF, 0x7D98
            for _ in range(8):
                if (s & 1) == 0:
                    x = ((x * y) >> 15) & M16
                y = ((y * y) >> 15) & M16
                s >>= 1
            self.volume_multiplier = (x << 1) & M16
        else:
            self.volume_multiplier = 0

    def set_channel_volume(self, ch, level):
        if 0 <= ch < MAX_CHANNELS:
            self.channels[ch].channel_volume = level & 0xFF

    # ------------------------------------------------------------------
    # data port (reference: DCSDecoder.cpp:1542-1577, DCSDecoderNative.cpp:3297-3437)

    def write_data_port(self, b):
        if self.state == ST_HARD_BOOT:
            self.soft_boot()
            return
        self.data_port_queue.append(b & 0xFF)

    def clear_data_port(self):
        self.data_port_queue.clear()
        self.last_data_port_byte = 0

    def _read_data_port(self):
        if self.data_port_queue:
            self.last_data_port_byte = self.data_port_queue.pop(0)
        return self.last_data_port_byte

    def irq2_handler(self):
        data = self._read_data_port()
        if self.data_port_timeout >= 13:
            self.n_data_port_bytes = 0

        n = self.n_data_port_bytes
        if n == 0:
            self.data_port_word = (data & 0xFF) << 8
            self.n_data_port_bytes = 1
        elif n == 1:
            w = self.data_port_word | (data & 0xFF)
            self.data_port_word = w
            if (0x55AA <= w <= 0x55B2) or (0x55BA <= w <= 0x55C1):
                self.data_port_ext = w
                self.n_data_port_bytes = 2
            elif 0x55B2 < w < 0x55BA:
                self.n_data_port_bytes = 0
            elif w in (0x55C2, 0x55C3):
                v = (self.reported_version >> 8) if w == 0x55C2 else self.reported_version
                self.host.receive_data_port(v & 0xFF)
                self.n_data_port_bytes = 0
            elif w & 0x8000:
                self.n_data_port_bytes = 0
            elif w == 0x03E7 and self.game_id == "TOTAN":
                # replicates the original TOTAN ROM's hard-coded IRQ2 hack
                # (reference: DCSDecoderNative.cpp:3352-3373)
                self.host.receive_data_port(0x11)
                self.n_data_port_bytes = 0
            else:
                self.command_queue.append(w)
                self.n_data_port_bytes = 0
        elif n == 2:
            self.data_port_word = data & 0xFF
            self.n_data_port_bytes = 3
        else:
            if self.data_port_word == (data ^ 0xFF):
                ext = self.data_port_ext
                if ext == 0x55AA:
                    self.set_master_volume(self.data_port_word & 0xFF)
                elif ext <= 0x55B2:
                    self.set_channel_volume(ext - 0x55AB, self.data_port_word & 0xFF)
                # 55BA..C1 set never-used mystery params; ignored here
            self.n_data_port_bytes = 0

        self.data_port_timeout = 0

    # ------------------------------------------------------------------
    # sample source (reference: DCSDecoder.cpp:1579-1728)

    def get_next_sample(self):
        st = self.state
        if st == ST_HARD_BOOT:
            self.mode_sample_counter += 1
            if self.mode_sample_counter >= 7812:
                self.start_self_tests()
            return 0
        if st == ST_BONG:
            self.mode_sample_counter += 1
            if self.mode_sample_counter >= 23437:
                self.bong_count -= 1
                if self.bong_count <= 0:
                    self.soft_boot()
                else:
                    self.bong.start()
                    self.mode_sample_counter = 0
            return self.bong.next_sample()
        if st == ST_RUNNING:
            while self.data_port_queue:
                self.irq2_handler()
            retries = 0
            while self.mode_sample_counter >= T.FRAME_SAMPLES:
                try:
                    self.main_loop()
                    self.mode_sample_counter = 0
                    break
                except ResetError:
                    retries += 1
                    if retries > 3:
                        self.state = ST_FATAL
                        return 0
            sample = self.output_buffer[self.mode_sample_counter]
            self.mode_sample_counter += 1
            return s16(sample)
        return 0

    def next_samples(self, n):
        """Convenience: decode n samples into a list of ints (int16 range)."""
        return [self.get_next_sample() for _ in range(n)]

    # ------------------------------------------------------------------
    # main frame loop (reference: DCSDecoderNative.cpp:89-306)

    def main_loop(self):
        fb = self.frame_buffer
        for i in range(T.FRAME_BUFFER_SIZE):
            fb[i] = 0

        # forced-stop flags
        for ch in self.channels:
            if ch.stop:
                ch.stop = False
                if ch.stream.playing:
                    ch.stream.bit = None
                    self._reset_mixing_levels(self.channels.index(ch))
                ch.host_event_timer.clear()
                ch.track_ptr = None

        # pending commands → track loads
        while self.command_queue:
            cmd = self.command_queue.pop(0)
            if self.rom_set is None or cmd >= self.rom_set.n_tracks:
                continue
            track_ofs = self.rom_set.track_index_u24(cmd)
            if (track_ofs & 0xFF0000) == 0xFF0000:
                continue
            p = self.make_rom_pointer(track_ofs)
            ttype = p.u8()
            chno = p.u8()
            if ttype == 1:
                self._load_track(chno, p)
            elif ttype <= 3:
                self.channels[chno].next_track_type = ttype
                self.channels[chno].next_track_link = p.u16()
            else:
                raise ResetError()

        # run all track byte-code programs to quiescence
        all_done = (1 << MAX_CHANNELS) - 1
        self.channel_mask = 0
        chno = 0
        while self.channel_mask != all_done:
            if not (self.channel_mask & (1 << chno)):
                self._exec_track(chno)
                self.channel_mask |= 1 << chno
            chno = (chno + 1) % MAX_CHANNELS

        # global volume headroom (volShift) from Σ(mix × master volume)
        mixing_sum = 0
        for ch in self.channels:
            if ch.max_mixing_override:
                mixing_sum += ch.mixing_multiplier * 0x7FFE
            elif ch.stream.playing:
                mixing_sum += ch.mixing_multiplier * self.volume_multiplier
        mixing_sum >>= 2
        vol_shift = -(calc_exp32(mixing_sum & M32) + 3)
        vol_shift = 0 if vol_shift < 0 else 8 if vol_shift > 8 else vol_shift

        for ch in self.channels:
            v = 0x7FFE if ch.max_mixing_override else self.volume_multiplier
            m = (ch.mixing_multiplier * v) << 1
            ch.mixing_multiplier = ((m << vol_shift) >> 16) & M16

        # decode one frame from every active stream and transform to PCM
        # (overridable: the device pipeline's control tracer records the per-frame
        # control vectors here instead of doing the numeric work on host)
        self._decode_and_transform(vol_shift)

        self._update_mixing_levels()

        self.data_port_timeout += 1
        if self.data_port_timeout > 13:
            self.data_port_timeout = 13

    def _decode_and_transform(self, vol_shift):
        """Decode every active channel's frame and transform to PCM."""
        for i in range(MAX_CHANNELS):
            self._decode_stream(i)
        if self.os_version in (OS93A, OS93B):
            transform_frame_93(self.frame_buffer, self.overlap,
                               self.output_buffer, vol_shift)
        else:
            transform_frame_94x(self.frame_buffer, self.overlap,
                                self.output_buffer, vol_shift)

    # ------------------------------------------------------------------
    # streams (reference: DCSDecoderNative.cpp:1387-1641)

    def load_audio_stream(self, chno, mem, pos=0, mixing_level=0x64):
        """Public: play a stream directly (standalone or extracted)."""
        if 0 <= chno < MAX_CHANNELS:
            ch = self.channels[chno]
            ch.track_ptr = None
            self._load_audio_stream(chno, chno, 1, mem, pos)
            m = ch.mixer[chno]
            m.reset()
            m.cur_level = m.fade_target = mixing_level << 6

    def is_stream_playing(self, chno):
        return self.channels[chno].stream.playing

    def clear_tracks(self):
        """Stop all track programs and streams (reference: ClearTracks,
        DCSDecoderNative.cpp:1466-1473)."""
        for ch in self.channels:
            ch.track_ptr = None
            ch.stream.bit = None

    def _load_audio_stream(self, stream_ch, source_ch, loop_count, mem, pos):
        self._init_channel_stream(self.channels[stream_ch], mem, pos)
        st = self.channels[stream_ch].stream
        if st.num_frames == 0:
            return
        st.loop_counter = loop_count
        old_src = self.channels[stream_ch].source_channel
        if old_src >= 0 and old_src != source_ch:
            self.channels[stream_ch].mixer[old_src].reset()
        self.channels[stream_ch].source_channel = source_ch

    def _init_channel_stream(self, ch, mem, pos):
        st = ch.stream
        if not isinstance(mem, PaddedView):
            mem = PaddedView(mem)
        st.mem = mem
        n_frames = (int(mem[pos]) << 8) | int(mem[pos + 1])
        pos += 2
        st.num_frames = n_frames
        st.frame_counter = n_frames
        st.header_pos = pos
        st.header_len = (1 if (self.os_version == OS93A
                               and (int(mem[pos]) & 0x80) != 0) else 16)
        st.start_pos = pos + st.header_len
        st.bit = BitReader(mem, st.start_pos)

    def _init_stream_playback(self, ch):
        st = ch.stream
        for i in range(16):
            st.header[i] = (int(st.mem[st.header_pos + i])
                            if i < st.header_len else 0)
        st.band_type = [0] * 16

    def _decompress_frame(self, ch):
        """Dispatch to the right frame decompressor family."""
        st = ch.stream
        mix = ch.mixing_multiplier
        if self.os_version == OS93A:
            if int(st.mem[st.header_pos]) & 0x80:
                return decompress_frame_93a_type1(st, self.frame_buffer, mix)
            return decompress_frame_93(st, self.frame_buffer, mix)
        if self.os_version == OS93B:
            return decompress_frame_93(st, self.frame_buffer, mix)
        return decompress_frame_94x(st, self.frame_buffer, mix)

    def _decode_stream(self, chno):
        ch = self.channels[chno]
        st = ch.stream
        if not st.playing:
            return
        if st.bit.pos == st.start_pos and st.bit.nbits == 0:
            self._init_stream_playback(ch)
        if not self._decompress_frame(ch):
            ch.stop = True
        st.frame_counter = (st.frame_counter - 1) & M16
        if st.frame_counter != 0:
            return
        st.frame_counter = st.num_frames
        st.bit = BitReader(st.mem, st.start_pos)
        if st.loop_counter == 0:
            return
        st.loop_counter = (st.loop_counter - 1) & M16
        if st.loop_counter != 0:
            return
        st.bit = None
        ch.source_channel = -1

    def get_stream_info(self, mem, pos=0):
        """Decode a whole stream to measure it (reference: GetStreamInfo,
        DCSDecoderNative.cpp:1486-1537)."""
        ch = Channel()
        self._init_channel_stream(ch, mem, pos)
        self._init_stream_playback(ch)
        saved_fb = self.frame_buffer
        self.frame_buffer = [0] * T.FRAME_BUFFER_SIZE
        try:
            st = ch.stream
            for _ in range(st.num_frames):
                mix = ch.mixing_multiplier
                if self.os_version == OS93A and (int(st.mem[st.header_pos]) & 0x80):
                    decompress_frame_93a_type1(st, self.frame_buffer, mix)
                elif self.os_version in (OS93A, OS93B):
                    decompress_frame_93(st, self.frame_buffer, mix)
                else:
                    decompress_frame_94x(st, self.frame_buffer, mix)
        finally:
            self.frame_buffer = saved_fb
        st = ch.stream
        n_bytes = st.bit.pos - pos
        stype = 1 if (st.header[0] & 0x80) else 0
        subtype = 0
        if self.os_version in (OS94, OS95):
            subtype = ((st.header[1] & 0x80) >> 6) | ((st.header[1] & 0x80) >> 7)
        return {"n_frames": st.num_frames, "n_bytes": n_bytes,
                "type": stype, "subtype": subtype,
                "header": bytes(st.header[:st.header_len])}

    # ------------------------------------------------------------------
    # track byte-code VM (reference: DCSDecoderNative.cpp:826-1371)

    def _load_track(self, chno, p):
        ch = self.channels[chno]
        ch.track_ptr = p.clone()
        ch.stream.bit = None
        ch.track_counter = 0
        ch.host_event_timer.clear()
        ch.loop_stack = []
        self.channel_mask &= ~(1 << chno)
        self._reset_mixing_levels(chno)

    def _exec_track(self, cur):
        chan = self.channels[cur]
        if chan.track_ptr is None:
            return
        p = chan.track_ptr.clone()
        while True:
            count_prefix = p.u16()
            if count_prefix == 0xFFFF or chan.track_counter != count_prefix:
                p.pos -= 2
                chan.track_ptr = p
                return
            chan.track_counter = 0
            op = p.u8()
            if op == 0x00:
                chan.track_ptr = None
                chan.stream.bit = None
                chan.loop_stack = []
                chan.host_event_timer.clear()
                self._reset_mixing_levels(cur)
                return
            elif op == 0x01:
                stream_ch = p.u8()
                if stream_ch == 5:
                    self.channels[5].max_mixing_override = False
                sp = self.make_rom_pointer(p.u24())
                loop_count = p.u8()
                self._load_audio_stream(stream_ch, cur, loop_count, sp.mem, sp.pos)
            elif op == 0x02:
                target = p.u8()
                tc = self.channels[target]
                if tc.stream.playing:
                    tc.stream.bit = None
                    self._reset_mixing_levels(target)
                tc.track_ptr = None
                tc.host_event_timer.clear()
                if chan.track_ptr is None:
                    return
            elif op == 0x03:
                self.command_queue.append(p.u16())
            elif op == 0x04:
                if self.os_version == OS93A:
                    cmd_byte = p.u8()
                    counter = p.u16()
                    timer = chan.host_event_timer
                    if cmd_byte == 0:
                        timer.clear()
                    else:
                        self.host.receive_data_port(cmd_byte)
                        if counter != 0:
                            timer.set(cmd_byte, counter)
                        else:
                            timer.clear()
                else:
                    b = p.u8()
                    self.host.receive_data_port(b)
                    if self.nominal_version == 0x0105:
                        if b == 0x69:
                            self.channels[5].max_mixing_override = True
                        elif b == 0x6A:
                            self.channels[5].max_mixing_override = False
            elif op == 0x05:
                target = p.u8()
                tc = self.channels[target]
                ttype = tc.next_track_type
                if ttype == 0:
                    continue
                tc.next_track_type = 0
                if ttype == 2:
                    self.command_queue.append(tc.next_track_link)
                elif ttype == 3:
                    link = tc.next_track_link
                    lo, hi = link & 0xFF, (link >> 8) & 0xFF
                    var = self.variables[hi]
                    tbl = self.make_rom_pointer(
                        self.rom_set.indirect_index_u24(lo))
                    tbl.pos += var * 2
                    self.command_queue.append(tbl.u16())
            elif op == 0x06:
                if self.os_version in (OS93A, OS93B):
                    pass  # no-op with no operands in the 1993 software
                else:
                    idx = p.u8()
                    self.variables[idx] = p.u8()
            elif op in (0x07, 0x08, 0x09):
                self._mixing_level_op(cur, p, op - 0x07, False)
            elif op in (0x0A, 0x0B, 0x0C):
                self._mixing_level_op(cur, p, op - 0x0A, True)
            elif op == 0x0D:
                pass
            elif op == 0x0E:
                loop_counter = p.u8()
                chan.loop_stack.append([loop_counter, p.clone()])
            elif op == 0x0F:
                if chan.loop_stack:
                    c = chan.loop_stack[-1][0]
                    if c == 0:
                        p = chan.loop_stack[-1][1].clone()
                    elif c == 1:
                        chan.loop_stack.pop()
                    else:
                        chan.loop_stack[-1][0] = c - 1
                        p = chan.loop_stack[-1][1].clone()
            elif op == 0x10:
                p.u8()
                p.u8()
            elif op in (0x11, 0x12):
                p.u8()
                p.u8()
                p.u16()
            else:
                raise ResetError()

    def _mixing_level_op(self, cur, p, mode, fade):
        target = p.u8()
        raw = p.u8()
        param = (raw - 0x100 if raw & 0x80 else raw) << 6
        steps = p.u16() if fade else 0
        mixer = self.channels[target].mixer[cur]
        mixer.fade_steps = steps
        old = mixer.cur_level
        if mode == 0:
            new = param
        elif mode == 1:
            new = old + param
        else:
            new = old - param
        delta = new - old
        if new > 8191:
            new = 8191
        elif new < -8191:
            new = -8191
        mixer.fade_target = new
        if steps != 0:
            # C integer division truncates toward zero
            q = abs(delta) // steps
            mixer.fade_delta = -q if delta < 0 else q
        else:
            mixer.cur_level = new

    def _reset_mixing_levels(self, chno):
        for ch in self.channels:
            ch.mixer[chno].reset()

    # ------------------------------------------------------------------
    # mixing levels (reference: DCSDecoderNative.cpp:3042-3135)

    def _update_mixing_levels(self):
        for ch in self.channels:
            for m in ch.mixer:
                if m.fade_steps == 1:
                    m.fade_steps = 0
                    m.cur_level = m.fade_target
                elif m.fade_steps > 1:
                    m.fade_steps -= 1
                    m.cur_level += m.fade_delta
                    if m.cur_level > 8191:
                        m.cur_level = 8191
                    elif m.cur_level < -8191:
                        m.cur_level = -8191

        for ch in self.channels:
            mixer_sum = sum(m.cur_level for m in ch.mixer)
            if mixer_sum > 8191:
                mixer_sum = 8191
            elif mixer_sum < -8191:
                mixer_sum = -8191
            mixer_exp = ((mixer_sum >> 6) & 0x3FF) + 0x80
            if self.os_version == OS93A:
                multiplier = 0x7FFF
            else:
                multiplier = (ch.channel_volume << 7) & M16
            if ch.max_mixing_override:
                multiplier = (0xFF << 7) & M16
            prod = 0x7C94
            bit = 1
            for _ in range(8):
                if (mixer_exp & bit) == 0:
                    multiplier = ((multiplier * prod) >> 15) & M16
                prod = ((prod * prod) >> 15) & M16
                bit <<= 1
            ch.mixing_multiplier = (multiplier << 1) & M16

        for ch in self.channels:
            ch.track_counter = (ch.track_counter + 1) & M16
            if ch.host_event_timer.update():
                self.host.receive_data_port(ch.host_event_timer.data)


class _Bong:
    """Startup bong: 195 Hz square with exponential decay
    (reference: DCSDecoder.cpp:1697-1728)."""

    def __init__(self):
        self.cycles = 0
        self.envelope_samples = 0
        self.sign_samples = 0
        self.level = 0
        self.sign = -1

    def start(self):
        self.cycles = 0
        self.envelope_samples = 0
        self.sign_samples = 0
        self.level = 0x0FFF

    def next_sample(self):
        if self.envelope_samples >= 31:
            self.level = (((self.level * 0x7F80) << 1) >> 16) & M16
            self.envelope_samples = 0
            self.cycles += 1
        else:
            self.envelope_samples += 1
        if self.sign_samples >= 80:
            self.sign = -self.sign
            self.sign_samples = 0
        else:
            self.sign_samples += 1
        return self.sign * s16(self.level)
