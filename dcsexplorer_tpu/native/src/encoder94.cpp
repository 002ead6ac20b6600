// Native single-stream encoder core for the 1994+ DCS format family.
//
// Scalar C++ twin of the integer-canonical decision pipeline in
// encoder/core94.py: decision tables -> wrap refinement -> sequential
// band-type scan -> symbol emission -> bit packing, for every stream-format
// candidate, keeping the smallest.  All arithmetic is integer, so the output
// is byte-identical to the numpy core and the batched JAX device twin
// (verified in tests/test_encoder_native.py).  The format/stream setup (band
// cutoff, header scale codes, per-format LUTs) stays in Python
// (core94.setup94); this entry receives the derived LUTs.
//
// Reference semantics anchors: DCSEncoder.cpp:784-853 (format search),
// :1502-1621 (band encoding search), :876-956 (bit allocation).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int NBANDS = 16;
constexpr int NPOS = 255;
constexpr int WRAP_CMAX = 6;
constexpr int64_t D_CLAMP = 5793;   // per-sample |diff| clamp (core94.py)

// round-half-away-from-zero integer division (core94.rdiv)
inline int64_t rdiv(int64_t a, int64_t s) {
    int64_t q = (2 * (a < 0 ? -a : a) + s) / (2 * s);
    return a < 0 ? -q : q;
}

inline int64_t isqrt64(int64_t v) {
    if (v <= 0) return 0;
    int64_t r = static_cast<int64_t>(__builtin_sqrt(static_cast<double>(v)));
    while (r * r > v) --r;
    while ((r + 1) * (r + 1) <= v) ++r;
    return r;
}

struct Packer {
    std::vector<uint8_t> out;
    uint64_t acc = 0;
    int nacc = 0;
    int64_t nbits = 0;

    void put(uint32_t val, int nb) {
        if (nb <= 0) return;
        nbits += nb;
        acc = (acc << nb) | (static_cast<uint64_t>(val) & ((1ull << nb) - 1));
        nacc += nb;
        while (nacc >= 8) {
            nacc -= 8;
            out.push_back(static_cast<uint8_t>((acc >> nacc) & 0xFF));
        }
        acc &= (1ull << nacc) - 1;
    }
    void flush() {
        if (nacc > 0) {
            out.push_back(static_cast<uint8_t>((acc << (8 - nacc)) & 0xFF));
            nacc = 0;
        }
    }
};

// symbol emission + packing for one format given the per-frame band-type
// codes (core94.emit94_np / pack_bits semantics); shared by the full
// search below and the dcs94_emit_with_codes entry used by the device
// twin (which sends only the winner's codes back from the device)
static int emit_stream(
    const int32_t* ci, int F, int PMAX,
    const int32_t* wl, const int32_t* sl,
    const int8_t* codes, const int8_t* pidxs,
    int bands_keep, const int* band_start, const int32_t* band_sizes,
    int delta_lo, int delta_len,
    const int32_t* delta_val, const int32_t* delta_bits,
    const int32_t* cb_code, const int32_t* cb_bits,
    const int32_t* tz_code, const int32_t* tz_bits,
    Packer& pk) {
    pk.out.reserve(static_cast<size_t>(F) * 128);
    for (int f = 0; f < F; ++f) {
        const int8_t* crow = codes + static_cast<size_t>(f) * NBANDS;
        const int8_t* prow = f > 0 ? crow - NBANDS : nullptr;
        for (int b = 0; b < bands_keep; ++b) {
            const int delta = crow[b] - (prow ? prow[b] : 0);
            const int di = delta - delta_lo;
            if (di < 0 || di >= delta_len) return -2;
            pk.put(static_cast<uint32_t>(delta_val[di]), delta_bits[di]);
        }
        const int32_t* row = ci + static_cast<size_t>(f) * NPOS;
        for (int b = 0; b < bands_keep; ++b) {
            const int c = crow[b];
            const int pi = pidxs[f * NBANDS + b];
            const int64_t bw = wl[(b * NBANDS + c) * PMAX + pi];
            if (c == 0 || bw == 0) continue;
            const int64_t sf = sl[(b * NBANDS + c) * PMAX + pi];
            const bool is_cb = bw >= 1 && bw <= 6;
            const int bwc = static_cast<int>(is_cb ? bw : (bw < 0 ? 0 : 6));
            const int64_t ref = is_cb ? (int64_t(1) << (bw - 1)) : 0;
            const int64_t mask = (int64_t(1) << bw) - 1;
            const bool tz = is_cb && tz_bits[bwc] > 0;
            const int s0b = band_start[b], nb = band_sizes[b];
            for (int i = 0; i < nb; ++i) {
                const int64_t q = rdiv(row[s0b + i], sf);
                if (tz && q == 0 && i + 1 < nb
                    && rdiv(row[s0b + i + 1], sf) == 0) {
                    pk.put(static_cast<uint32_t>(tz_code[bwc]),
                           tz_bits[bwc]);
                    ++i;   // pair consumed
                    continue;
                }
                const int64_t stored = (q + ref) & mask;
                if (is_cb) {
                    const int idx = bwc * 64 + static_cast<int>(stored & 63);
                    pk.put(static_cast<uint32_t>(cb_code[idx]),
                           cb_bits[idx]);
                } else {
                    pk.put(static_cast<uint32_t>(stored),
                           static_cast<int>(bw));
                }
            }
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// Encode one stream across n_formats candidates, keep the smallest.
// ci [F*255] canonical int32 coefficients; per-format LUTs are stacked on a
// leading format axis.  Returns the winner's body byte count (bits after the
// 16-byte header) or a negative error; *winner_out = winning format index.
long long dcs94_encode_search(
    const int32_t* ci, int F,
    int NF, int PMAX,
    const int32_t* w_lut,      // [NF,16,16,PMAX]
    const int32_t* sf_lut,     // [NF,16,16,PMAX]
    const int32_t* amin,       // [NF,16,16,PMAX]
    const int32_t* amax,       // [NF,16,16,PMAX]
    const int32_t* pip,        // [NF,16]   preadj column of prev code
    const int32_t* fmt_dep,    // [NF]      1 if type-1 (bands 0-2 dep)
    const int32_t* fmt_np,     // [NF]      live preadj columns
    const int32_t* thr,        // [16]      per-band error-sum threshold
    int bands_keep, int sil_max,
    const int32_t* band_sizes, // [16]
    int delta_lo, int delta_len,
    const int32_t* delta_val, const int32_t* delta_bits,
    const int32_t* cb_code,    // [7*64]
    const int32_t* cb_bits,    // [7*64]
    const int32_t* tz_code,    // [7]
    const int32_t* tz_bits,    // [7]
    uint8_t* out, long long out_cap, int32_t* winner_out) {

    if (F <= 0 || NF <= 0) return -1;

    int band_start[NBANDS];
    {
        int acc = 0;
        for (int b = 0; b < NBANDS; ++b) {
            band_start[b] = acc;
            acc += band_sizes[b];
        }
        if (acc != NPOS) return -1;
    }

    // per-(frame, band) min/max and silence (shared across formats)
    std::vector<int32_t> mn(static_cast<size_t>(F) * NBANDS);
    std::vector<int32_t> mx(static_cast<size_t>(F) * NBANDS);
    std::vector<uint8_t> silent(static_cast<size_t>(F) * NBANDS);
    for (int f = 0; f < F; ++f) {
        const int32_t* row = ci + static_cast<size_t>(f) * NPOS;
        for (int b = 0; b < NBANDS; ++b) {
            int32_t lo = row[band_start[b]], hi = lo;
            for (int i = 1; i < band_sizes[b]; ++i) {
                int32_t v = row[band_start[b] + i];
                if (v < lo) lo = v;
                if (v > hi) hi = v;
            }
            mn[f * NBANDS + b] = lo;
            mx[f * NBANDS + b] = hi;
            silent[f * NBANDS + b] = (hi - lo) <= sil_max;
        }
    }

    std::vector<Packer> packers(NF);
    std::vector<int64_t> sizes(NF);
    // per-format scratch: out15/out14 [F, bands_keep, n_p], codes/pidx [F,16]
    std::vector<int8_t> out15, out14;
    std::vector<int8_t> codes(static_cast<size_t>(F) * NBANDS);
    std::vector<int8_t> pidxs(static_cast<size_t>(F) * NBANDS);

    for (int k = 0; k < NF; ++k) {
        const int dep = fmt_dep[k];
        const int n_p = fmt_np[k];
        const size_t fk = static_cast<size_t>(k) * NBANDS * NBANDS * PMAX;
        const int32_t* wl = w_lut + fk;
        const int32_t* sl = sf_lut + fk;
        const int32_t* an = amin + fk;
        const int32_t* ax = amax + fk;

        out15.assign(static_cast<size_t>(F) * bands_keep * n_p, 0);
        out14.assign(out15.size(), 0);

        for (int b = 0; b < bands_keep; ++b) {
            const int np_b = (dep && b < 3) ? n_p : 1;
            const int64_t thr_b = thr[b];
            const int64_t cape = thr_b + 1 < (1 << 25) ? thr_b + 1 : (1 << 25);
            const int64_t d = isqrt64(thr_b) + 1;
            const int s0 = band_start[b], n = band_sizes[b];

            for (int pi = 0; pi < np_b; ++pi) {
                const int32_t* anr = an + (b * NBANDS) * PMAX + pi;
                const int32_t* axr = ax + (b * NBANDS) * PMAX + pi;
                const int32_t* wlr = wl + (b * NBANDS) * PMAX + pi;
                const int32_t* slr = sl + (b * NBANDS) * PMAX + pi;
                // candidate prefilter: wrap-error floor within budget
                // (core94._wrap_refine_np's conservative skip)
                int cand_c[WRAP_CMAX], n_cand = 0;
                for (int c = 1; c <= WRAP_CMAX; ++c) {
                    int64_t w = wlr[c * PMAX], sf = slr[c * PMAX];
                    if (w < 1) continue;
                    int64_t floor_err = (int64_t(1) << w) * sf - sf / 2;
                    if (floor_err * floor_err > thr_b) continue;
                    cand_c[n_cand++] = c;
                }

                for (int f = 0; f < F; ++f) {
                    const int32_t lo = mn[f * NBANDS + b];
                    const int32_t hi = mx[f * NBANDS + b];
                    // first code whose coefficient window fits the range
                    int fit = 15;
                    for (int c = 1; c <= 15; ++c) {
                        if (lo >= anr[c * PMAX] && hi <= axr[c * PMAX]) {
                            fit = c;
                            break;
                        }
                    }
                    // wrap refinement: lexicographic-min (width, code) among
                    // the fitting code and in-budget narrower candidates
                    int candmin = 1 << 14;
                    for (int j = 0; j < n_cand; ++j) {
                        const int c = cand_c[j];
                        if (c >= fit) break;   // cand_c ascending
                        const int64_t w = wlr[c * PMAX];
                        const int64_t sf = slr[c * PMAX];
                        const int64_t half = (int64_t(1) << (w - 1)) * sf;
                        // feasibility window (frames outside provably fail)
                        if (hi > half - sf + d || lo < -half - d) continue;
                        const int64_t ref = int64_t(1) << (w - 1);
                        const int64_t mask = (int64_t(1) << w) - 1;
                        int64_t es = 0;
                        const int32_t* row = ci + static_cast<size_t>(f) * NPOS + s0;
                        for (int i = 0; i < n; ++i) {
                            int64_t a = row[i];
                            int64_t stored = (rdiv(a, sf) + ref) & mask;
                            int64_t diff = (stored - ref) * sf - a;
                            if (diff < 0) diff = -diff;
                            if (diff > D_CLAMP) diff = D_CLAMP;
                            int64_t e = diff * diff;
                            es += e < cape ? e : cape;
                            if (es > thr_b) break;
                        }
                        if (es <= thr_b) {
                            int key = static_cast<int>(w) * 16 + c;
                            if (key < candmin) candmin = key;
                        }
                    }
                    const int key15 = static_cast<int>(wlr[fit * PMAX]) * 16 + fit;
                    const int new15 =
                        (candmin < key15 ? candmin : key15) & 15;
                    int new14 = new15;
                    if (fit == 15) {
                        const int key14 =
                            static_cast<int>(wlr[14 * PMAX]) * 16 + 14;
                        new14 = (candmin < key14 ? candmin : key14) & 15;
                    }
                    const size_t o = (static_cast<size_t>(f) * bands_keep + b)
                                     * n_p + pi;
                    out15[o] = static_cast<int8_t>(new15);
                    out14[o] = static_cast<int8_t>(new14);
                }
            }
        }

        // sequential band-type scan (core94.scan_codes_np)
        std::memset(codes.data(), 0, codes.size());
        std::memset(pidxs.data(), 0, pidxs.size());
        const int32_t* pip_k = pip + static_cast<size_t>(k) * NBANDS;
        for (int b = 0; b < bands_keep; ++b) {
            const int np_b = (dep && b < 3) ? n_p : 1;
            int prev = 0;
            for (int f = 0; f < F; ++f) {
                const int pi = (dep && b < 3) ? pip_k[prev] : 0;
                int c;
                if (silent[f * NBANDS + b]) {
                    c = 0;
                } else {
                    const size_t o = (static_cast<size_t>(f) * bands_keep + b)
                                     * n_p + (pi < np_b ? pi : 0);
                    c = (prev == 0) ? out14[o] : out15[o];
                }
                codes[f * NBANDS + b] = static_cast<int8_t>(c);
                pidxs[f * NBANDS + b] = static_cast<int8_t>(pi);
                prev = c;
            }
        }

        // symbol emission + packing (core94.emit94_np / pack_bits)
        Packer& pk = packers[k];
        const int rc = emit_stream(ci, F, PMAX, wl, sl, codes.data(),
                                   pidxs.data(), bands_keep, band_start,
                                   band_sizes, delta_lo, delta_len,
                                   delta_val, delta_bits, cb_code, cb_bits,
                                   tz_code, tz_bits, pk);
        if (rc != 0) return rc;
        sizes[k] = 18 + (pk.nbits + 7) / 8;
    }

    int best = 0;
    for (int k = 1; k < NF; ++k)
        if (sizes[k] < sizes[best]) best = k;
    packers[best].flush();
    const long long n = static_cast<long long>(packers[best].out.size());
    if (n > out_cap) return -3;
    std::memcpy(out, packers[best].out.data(), n);
    *winner_out = best;
    return n;
}

// Emit + pack one stream for a single format whose per-frame band-type
// codes were decided elsewhere (the device twin, encoder/device94.py).  The
// decisions are canonical integers, so this byte-matches the full search's
// emission for the same codes.  Returns body bytes or a negative error.
long long dcs94_emit_with_codes(
    const int32_t* ci, int F, int PMAX,
    const int32_t* w_lut,      // [16,16,PMAX] — the winning format's LUTs
    const int32_t* sf_lut,
    const int8_t* codes,       // [F,16]
    const int8_t* pidx,        // [F,16]
    int bands_keep,
    const int32_t* band_sizes, // [16]
    int delta_lo, int delta_len,
    const int32_t* delta_val, const int32_t* delta_bits,
    const int32_t* cb_code, const int32_t* cb_bits,
    const int32_t* tz_code, const int32_t* tz_bits,
    uint8_t* out, long long out_cap) {
    if (F <= 0) return -1;
    int band_start[NBANDS];
    {
        int acc = 0;
        for (int b = 0; b < NBANDS; ++b) {
            band_start[b] = acc;
            acc += band_sizes[b];
        }
        if (acc != NPOS) return -1;
    }
    Packer pk;
    const int rc = emit_stream(ci, F, PMAX, w_lut, sf_lut, codes, pidx,
                               bands_keep, band_start, band_sizes,
                               delta_lo, delta_len, delta_val, delta_bits,
                               cb_code, cb_bits, tz_code, tz_bits, pk);
    if (rc != 0) return rc;
    pk.flush();
    const long long n = static_cast<long long>(pk.out.size());
    if (n > out_cap) return -3;
    std::memcpy(out, pk.out.data(), n);
    return n;
}

}  // extern "C"
