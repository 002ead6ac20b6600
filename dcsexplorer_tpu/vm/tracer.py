"""ControlTracer: the track byte-code VM run alone, numerics stubbed.

The VM implementation itself lives inside the runtime decoder
(refdec/decoder.py ``_exec_track``, ``irq2_handler``, the command queue and
the boot state machine) because it shares per-channel state with stream
playback, exactly as in the reference (DCSDecoderNative.cpp:848-1228).

This module is the host half of the device pipeline split (SURVEY.md §7): run
the branchy, pointer-chasing runtime — commands, track programs, fades,
volume, stream lifecycle — on the host with every per-sample computation
skipped, and record per-frame control vectors (which stream frame plays on
which channel at what mixing multiplier, plus the global volume shift) for
the device numeric pipeline to consume.
"""

from ..refdec import decoder as rd


class ControlTracer(rd.ReferenceDecoder):
    """ReferenceDecoder with the numeric work stubbed out: runs the full VM
    (commands, track programs, fades, volume, stream lifecycle) and records
    per-frame control vectors for the device pipeline."""

    def __init__(self, host=None):
        super().__init__(host)
        self.trace_vol_shift = []
        self.trace_entries = []   # per frame: list of (ch, stream_key, frame_idx, mix)

    def _stream_key(self, st):
        mem = st.mem.mem if isinstance(st.mem, rd.PaddedView) else st.mem
        return (id(mem), st.header_pos - 2)

    def _decompress_frame(self, ch):
        return True

    def _decode_and_transform(self, vol_shift):
        entries = []
        for i in range(rd.MAX_CHANNELS):
            ch = self.channels[i]
            st = ch.stream
            if st.playing and st.num_frames > 0:
                frame_idx = (st.num_frames - st.frame_counter) % st.num_frames
                entries.append((i, self._stream_key(st), frame_idx,
                                ch.mixing_multiplier))
            self._decode_stream(i)
        self.trace_vol_shift.append(vol_shift)
        self.trace_entries.append(entries)

    def trace_frames(self, n, events=None):
        """Run n frames of the VM.  ``events`` maps frame index -> callable
        invoked before that frame (e.g. to write data-port bytes)."""
        for f in range(n):
            if events and f in events:
                events[f](self)
            while self.data_port_queue:
                self.irq2_handler()
            self.main_loop()
