// Golden-oracle shim: C ABI wrapper around the *reference* implementation at
// /root/reference (read-only, compiled out-of-tree at test time).  This is not
// part of the framework; it exists solely so the test suite can obtain
// bit-exact golden vectors (encoded DCS streams and decoded PCM) to validate
// the from-scratch JAX implementation against.
//
// Reference usage mirrored here: DCSEncoderTester/EncoderTester.cpp:73-140
// (standalone decoder + LoadAudioStream), DCSEncoder/DCSEncoder.h:26-34
// (OpenStream/WriteStream/CloseStream).

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <unordered_map>

#include "DCSDecoder.h"
#include "DCSDecoderNative.h"
#include "DCSEncoder.h"

namespace {

struct OracleHost : DCSDecoder::Host {
    std::vector<uint8_t> rx;
    void ReceiveDataPort(uint8_t d) override { rx.push_back(d); }
    void ClearDataPort() override { rx.clear(); }
    void BootTimerControl(bool) override {}
};

struct OracleDecoder {
    OracleHost host;
    DCSDecoderNative dec;
    std::list<DCSDecoder::ZipFileData> zipData;
    OracleDecoder() : dec(&host) {}
};

DCSDecoder::OSVersion OsFromCode(int os) {
    switch (os) {
    case 1: return DCSDecoder::OSVersion::OS93a;
    case 2: return DCSDecoder::OSVersion::OS93b;
    case 3: return DCSDecoder::OSVersion::OS94;
    case 4: return DCSDecoder::OSVersion::OS95;
    default: return DCSDecoder::OSVersion::Unknown;
    }
}

}  // namespace

extern "C" {

// ---- standalone decoder (stream-level oracle) ----

void* dcsref_create(int osCode, int defaultVolume) {
    auto* h = new OracleDecoder();
    h->dec.InitStandalone(OsFromCode(osCode));
    h->dec.SetDefaultVolume(defaultVolume);
    h->dec.SoftBoot();
    return h;
}

void dcsref_destroy(void* vh) { delete static_cast<OracleDecoder*>(vh); }

// Load a stream (raw DCS stream bytes: U16 frame count + header + bit data)
// into a channel with the given track-program mixing level (signed byte).
void dcsref_load_stream(void* vh, int channel, const uint8_t* data, int mixingLevel) {
    auto* h = static_cast<OracleDecoder*>(vh);
    DCSDecoder::ROMPointer rp(0, data);
    h->dec.LoadAudioStream(channel, rp, mixingLevel);
}

int dcsref_is_playing(void* vh, int channel) {
    return static_cast<OracleDecoder*>(vh)->dec.IsStreamPlaying(channel) ? 1 : 0;
}

void dcsref_next_samples(void* vh, int16_t* out, int n) {
    auto* h = static_cast<OracleDecoder*>(vh);
    for (int i = 0; i < n; ++i) out[i] = h->dec.GetNextSample();
}

void dcsref_write_data_port(void* vh, uint8_t b) {
    static_cast<OracleDecoder*>(vh)->dec.WriteDataPort(b);
}

void dcsref_set_master_volume(void* vh, int vol) {
    static_cast<OracleDecoder*>(vh)->dec.SetMasterVolume(vol);
}

// drain the DCS->host data-port bytes captured since the last call
int dcsref_read_host_bytes(void* vh, uint8_t* out, int cap) {
    auto* h = static_cast<OracleDecoder*>(vh);
    int n = static_cast<int>(h->host.rx.size());
    if (n > cap) n = cap;
    memcpy(out, h->host.rx.data(), n);
    h->host.rx.erase(h->host.rx.begin(), h->host.rx.begin() + n);
    return n;
}

// stream metadata: returns frame count, byte size, type, subtype
int dcsref_stream_info(void* vh, const uint8_t* data,
                       int* nFrames, int* nBytes, int* type, int* subType) {
    auto* h = static_cast<OracleDecoder*>(vh);
    DCSDecoder::ROMPointer rp(0, data);
    auto info = h->dec.GetStreamInfo(rp);
    *nFrames = info.nFrames;
    *nBytes = info.nBytes;
    *type = info.formatType;
    *subType = info.formatSubType;
    return 0;
}

// ---- ROM-based decoder (full-pipeline oracle) ----

void* dcsref_create_rom(const uint8_t* const* roms, const uint32_t* sizes,
                        int defaultVolume, int fastBoot) {
    auto* h = new OracleDecoder();
    for (int i = 0; i < 8; ++i) {
        if (roms[i] != nullptr && sizes[i] != 0)
            h->dec.AddROM(i + 2, roms[i], sizes[i]);
    }
    h->dec.SetDefaultVolume(defaultVolume);
    h->dec.SetFastBootMode(fastBoot != 0);
    return h;
}

int dcsref_check_roms(void* vh) {
    return static_cast<OracleDecoder*>(vh)->dec.CheckROMs();
}

void dcsref_hard_boot(void* vh) { static_cast<OracleDecoder*>(vh)->dec.HardBoot(); }
void dcsref_soft_boot(void* vh) { static_cast<OracleDecoder*>(vh)->dec.SoftBoot(); }
int dcsref_is_ok(void* vh) { return static_cast<OracleDecoder*>(vh)->dec.IsOK() ? 1 : 0; }

// version info: returns (hw << 24) | (os << 16) | nominalVersion
// hw: 0=unknown 1=invalid 2=DCS93 3=DCS95; os: 0=unknown 1=invalid 2=93a 3=93b 4=94 5=95
unsigned dcsref_version_info(void* vh) {
    auto* h = static_cast<OracleDecoder*>(vh);
    DCSDecoder::HWVersion hw;
    DCSDecoder::OSVersion os;
    h->dec.GetVersionInfo(&hw, &os);
    unsigned hwc = 0, osc = 0;
    switch (hw) {
    case DCSDecoder::HWVersion::Invalid: hwc = 1; break;
    case DCSDecoder::HWVersion::DCS93: hwc = 2; break;
    case DCSDecoder::HWVersion::DCS95: hwc = 3; break;
    default: break;
    }
    switch (os) {
    case DCSDecoder::OSVersion::Invalid: osc = 1; break;
    case DCSDecoder::OSVersion::OS93a: osc = 2; break;
    case DCSDecoder::OSVersion::OS93b: osc = 3; break;
    case DCSDecoder::OSVersion::OS94: osc = 4; break;
    case DCSDecoder::OSVersion::OS95: osc = 5; break;
    default: break;
    }
    return (hwc << 24) | (osc << 16)
        | static_cast<unsigned>(h->dec.GetVersionNumber() & 0xFFFF);
}

int dcsref_num_channels(void* vh) {
    return static_cast<OracleDecoder*>(vh)->dec.GetNumChannels();
}

int dcsref_max_track(void* vh) {
    return static_cast<OracleDecoder*>(vh)->dec.GetMaxTrackNumber();
}

// track info: fills [address, channel, type, deferCode, time, looping]
int dcsref_track_info(void* vh, int trackNo, uint32_t* out6) {
    auto* h = static_cast<OracleDecoder*>(vh);
    DCSDecoder::TrackInfo ti;
    if (!h->dec.GetTrackInfo(static_cast<uint16_t>(trackNo), ti)) return 0;
    out6[0] = ti.address;
    out6[1] = static_cast<uint32_t>(ti.channel);
    out6[2] = static_cast<uint32_t>(ti.type);
    out6[3] = ti.deferCode;
    out6[4] = ti.time;
    out6[5] = ti.looping ? 1 : 0;
    return 1;
}

// ---- encoder (stream-generation oracle) ----

// Encode PCM (at 31,250 Hz) into a DCS stream.  Returns byte count, or
// negative on error.  fmtType/fmtSubType: -1 means search (reference default).
int dcsref_encode(const int16_t* pcm, int nSamples, int sampleRate,
                  int fmtType, int fmtSubType, int targetBitRate,
                  float powerBandCutoff, float maxQuantErr,
                  uint8_t* out, int outCap, int* nFrames) {
    DCSEncoder enc;
    enc.compressionParams.streamFormatType = fmtType;
    enc.compressionParams.streamFormatSubType = fmtSubType;
    if (targetBitRate > 0) enc.compressionParams.targetBitRate = targetBitRate;
    if (powerBandCutoff > 0) enc.compressionParams.powerBandCutoff = powerBandCutoff;
    if (maxQuantErr > 0) enc.compressionParams.maximumQuantizationError = maxQuantErr;

    std::string err;
    auto* s = enc.OpenStream(sampleRate, err);
    if (s == nullptr) return -1;
    // Use the float overload: the reference's int16 WriteStream overload has a
    // double-increment bug (DCSEncoder.cpp:638) that its own CLI never hits
    // (EncodeFile feeds floats).
    std::vector<float> f(static_cast<size_t>(nSamples));
    for (int i = 0; i < nSamples; ++i) f[i] = pcm[i] / 32768.0f;
    enc.WriteStream(s, f.data(), f.size());
    DCSEncoder::DCSAudio obj;
    if (!enc.CloseStream(s, obj, err)) return -2;
    if (static_cast<int>(obj.nBytes) > outCap) return -3;
    memcpy(out, obj.data.get(), obj.nBytes);
    *nFrames = obj.nFrames;
    return static_cast<int>(obj.nBytes);
}

}  // extern "C"

// ---- disassembler oracle ----
extern unsigned adsp2100_dasm(char* buffer, unsigned long op);

extern "C" int dcsref_dasm(unsigned op, char* buf, int cap) {
    char tmp[512];
    adsp2100_dasm(tmp, op);
    int n = static_cast<int>(strlen(tmp));
    if (n >= cap) n = cap - 1;
    memcpy(buf, tmp, n);
    buf[n] = 0;
    return n;
}

// ---- ADSP-21xx CPU core oracle ----------------------------------------
// Differential-test access to the reference interpreter: set the full
// register file + memories, single-step, read everything back.

#include "adsp2100/adsp2100.h"

static uint32_t g_pm[0x4000];
static uint16_t g_dm[0x4000];
static uint32_t g_port_in = 0;      // value read at PM($3000)
static uint32_t g_port_out = 0;     // last value written to PM($3000)
static int g_port_writes = 0;

uint32_t* adsp2100_op_rom = g_pm;
uint32_t adsp2100_host_read_dm(uint32_t addr) {
    return g_dm[addr & 0x3fff];
}
void adsp2100_host_write_dm(uint32_t addr, uint32_t data) {
    g_dm[addr & 0x3fff] = (uint16_t)data;
}
uint32_t adsp2100_host_read_pm(uint32_t addr) {
    return g_port_in;
}
void adsp2100_host_write_pm(uint32_t addr, uint32_t data) {
    g_port_out = data;
    ++g_port_writes;
}

static uint16_t cpu_lmask(uint32_t l) {
    l &= 0x3fff;
    if (l > 0x2000) return 0x0000;
    uint16_t m = 0x3fff;
    uint32_t size = 1;
    while (size < l) { size <<= 1; m = (m << 1) & 0x3fff; }
    return m;
}

static void core_to_vec(const ADSPCORE& c, uint64_t* v) {
    v[0] = c.ax0.u; v[1] = c.ax1.u; v[2] = c.ay0.u; v[3] = c.ay1.u;
    v[4] = c.ar.u;  v[5] = c.af.u;  v[6] = c.mx0.u; v[7] = c.mx1.u;
    v[8] = c.my0.u; v[9] = c.my1.u; v[10] = c.mr.mr; v[11] = c.mf.u;
    v[12] = c.si.u; v[13] = c.se.u; v[14] = c.sb.u; v[15] = c.sr.sr;
}

static void vec_to_core(ADSPCORE& c, const uint64_t* v) {
    c.ax0.u = (uint16_t)v[0]; c.ax1.u = (uint16_t)v[1];
    c.ay0.u = (uint16_t)v[2]; c.ay1.u = (uint16_t)v[3];
    c.ar.u = (uint16_t)v[4];  c.af.u = (uint16_t)v[5];
    c.mx0.u = (uint16_t)v[6]; c.mx1.u = (uint16_t)v[7];
    c.my0.u = (uint16_t)v[8]; c.my1.u = (uint16_t)v[9];
    c.mr.mr = v[10];          c.mf.u = (uint16_t)v[11];
    c.si.u = (uint16_t)v[12]; c.se.u = (uint16_t)v[13];
    c.sb.u = (uint16_t)v[14]; c.sr.sr = (uint32_t)v[15];
    c.zero.u = 0;
}

extern "C" {

void dcsref_cpu_init() {
    adsp2105_init();
    adsp2105_reset(nullptr);
}

void dcsref_cpu_reset() { adsp2105_reset(nullptr); }

void dcsref_cpu_get_state(uint64_t* v) {
    adsp2100_Regs& r = adsp2100_get_regs();
    core_to_vec(r.core, v);
    core_to_vec(r.alt, v + 16);
    for (int k = 0; k < 8; ++k) v[32 + k] = r.i[k];
    for (int k = 0; k < 8; ++k) v[40 + k] = (uint32_t)r.m[k];
    for (int k = 0; k < 8; ++k) v[48 + k] = r.l[k];
    v[56] = r.px; v[57] = r.pc; v[58] = r.ppc; v[59] = r.loop;
    v[60] = r.loop_condition; v[61] = r.cntr; v[62] = r.astat;
    v[63] = r.sstat; v[64] = r.mstat; v[65] = r.astat_clear & 0xff;
    v[66] = r.idle;
    for (int k = 0; k < 4; ++k) v[67 + k] = r.loop_stack[k];
    for (int k = 0; k < 4; ++k) v[71 + k] = r.cntr_stack[k];
    for (int k = 0; k < 16; ++k) v[75 + k] = r.pc_stack[k];
    for (int k = 0; k < 4; ++k)
        for (int j = 0; j < 3; ++j) v[91 + 3 * k + j] = r.stat_stack[k][j];
    v[103] = (uint32_t)r.pc_sp; v[104] = (uint32_t)r.cntr_sp;
    v[105] = (uint32_t)r.stat_sp; v[106] = (uint32_t)r.loop_sp;
    v[107] = r.flagout; v[108] = r.flagin;
    v[109] = r.fl0; v[110] = r.fl1; v[111] = r.fl2;
    v[112] = r.imask; v[113] = r.icntl; v[114] = r.ifc;
    for (int k = 0; k < 5; ++k) v[115 + k] = r.irq_latch[k];
    for (int k = 0; k < 5; ++k) v[120 + k] = r.irq_state[k];
}

void dcsref_cpu_set_state(const uint64_t* v) {
    adsp2100_Regs& r = adsp2100_get_regs();
    vec_to_core(r.core, v);
    vec_to_core(r.alt, v + 16);
    for (int k = 0; k < 8; ++k) r.i[k] = (uint32_t)v[32 + k] & 0x3fff;
    for (int k = 0; k < 8; ++k) r.m[k] = (int32_t)(uint32_t)v[40 + k];
    for (int k = 0; k < 8; ++k) {
        r.l[k] = (uint32_t)v[48 + k] & 0x3fff;
        r.lmask[k] = cpu_lmask(r.l[k]);
        r.base[k] = r.i[k] & r.lmask[k];
    }
    r.px = (uint8_t)v[56]; r.pc = (uint32_t)v[57]; r.ppc = (uint32_t)v[58];
    r.loop = (uint32_t)v[59]; r.loop_condition = (uint32_t)v[60];
    r.cntr = (uint32_t)v[61]; r.astat = (uint32_t)v[62];
    r.sstat = (uint32_t)v[63]; r.mstat = (uint32_t)v[64];
    r.astat_clear = (uint32_t)v[65]; r.idle = (uint32_t)v[66];
    for (int k = 0; k < 4; ++k) r.loop_stack[k] = (uint32_t)v[67 + k];
    for (int k = 0; k < 4; ++k) r.cntr_stack[k] = (uint32_t)v[71 + k];
    for (int k = 0; k < 16; ++k) r.pc_stack[k] = (uint32_t)v[75 + k];
    for (int k = 0; k < 4; ++k)
        for (int j = 0; j < 3; ++j)
            r.stat_stack[k][j] = (uint8_t)v[91 + 3 * k + j];
    r.pc_sp = (int32_t)v[103]; r.cntr_sp = (int32_t)v[104];
    r.stat_sp = (int32_t)v[105]; r.loop_sp = (int32_t)v[106];
    r.flagout = (uint8_t)v[107]; r.flagin = (uint8_t)v[108];
    r.fl0 = (uint8_t)v[109]; r.fl1 = (uint8_t)v[110]; r.fl2 = (uint8_t)v[111];
    r.imask = (uint8_t)v[112]; r.icntl = (uint8_t)v[113];
    r.ifc = (uint16_t)v[114];
    for (int k = 0; k < 5; ++k) r.irq_latch[k] = (uint8_t)v[115 + k];
    for (int k = 0; k < 5; ++k) r.irq_state[k] = (uint8_t)v[120 + k];
    r.interrupt_cycles = 0;
}

int dcsref_cpu_step(int cycles) { return adsp2105_execute(cycles); }

void dcsref_cpu_invoke_irq(int which, int indx, int cycles) {
    adsp2100_host_invoke_irq(which, indx, cycles);
}

void dcsref_cpu_set_pm(const uint32_t* w, int start, int n) {
    for (int k = 0; k < n; ++k) g_pm[(start + k) & 0x3fff] = w[k] & 0xffffff;
}
void dcsref_cpu_get_pm(uint32_t* w, int start, int n) {
    for (int k = 0; k < n; ++k) w[k] = g_pm[(start + k) & 0x3fff];
}
void dcsref_cpu_set_dm(const uint16_t* w, int start, int n) {
    for (int k = 0; k < n; ++k) g_dm[(start + k) & 0x3fff] = w[k];
}
void dcsref_cpu_get_dm(uint16_t* w, int start, int n) {
    for (int k = 0; k < n; ++k) w[k] = g_dm[(start + k) & 0x3fff];
}
void dcsref_cpu_set_port(uint32_t v) { g_port_in = v; }
uint32_t dcsref_cpu_get_port_out() { return g_port_out; }
int dcsref_cpu_get_port_writes() { return g_port_writes; }

}  // extern "C"
