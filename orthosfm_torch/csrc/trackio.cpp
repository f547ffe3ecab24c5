// Native tracks.txt parser: the host-runtime IO component for the
// checkpoint/resume path (--calculated-tracks).
//
// Format (reference: src/matching/matching_io.cpp:16-95): one line per track,
// semicolon-separated `count;viewID;localID;globalID;x;y;r;g;b;...`.
// Real datasets produce 100k+ tracks x 16 features; the Python field-by-field
// parse costs seconds there, this single-pass C parser costs milliseconds.
//
// Plain C ABI, consumed via ctypes (no pybind11 dependency):
//   osfm_tracks_load(path, &n_tracks, &n_feats) -> opaque handle (or null)
//   osfm_tracks_fill(handle, counts, vid, lid, gid, xy, rgb)
//   osfm_tracks_free(handle)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Parsed {
    std::vector<int64_t> counts;   // per-track feature count
    std::vector<int32_t> vid, lid; // per-feature
    std::vector<int64_t> gid;
    std::vector<float> xy;         // per-feature x, y interleaved
    std::vector<uint8_t> rgb;      // per-feature r, g, b interleaved
};

// Strict single-pass field scanner over the whole buffer. Fields are
// separated by ';' within a line; lines end the track.
bool parse(const char* data, size_t len, Parsed& out) {
    const char* p = data;
    const char* end = data + len;
    while (p < end) {
        // Skip blank lines
        while (p < end && (*p == '\n' || *p == '\r')) ++p;
        if (p >= end) break;
        char* next = nullptr;
        long long n = std::strtoll(p, &next, 10);
        if (next == p || n < 0) return false;
        p = next;
        out.counts.push_back(n);
        for (long long i = 0; i < n; ++i) {
            long long v[3];
            for (int k = 0; k < 3; ++k) {
                if (p >= end || *p != ';') return false;
                ++p;
                v[k] = std::strtoll(p, &next, 10);
                if (next == p) return false;
                p = next;
            }
            float f[2];
            for (int k = 0; k < 2; ++k) {
                if (p >= end || *p != ';') return false;
                ++p;
                f[k] = std::strtof(p, &next);
                if (next == p) return false;
                p = next;
            }
            long long c[3];
            for (int k = 0; k < 3; ++k) {
                if (p >= end || *p != ';') return false;
                ++p;
                c[k] = std::strtoll(p, &next, 10);
                if (next == p) return false;
                p = next;
            }
            out.vid.push_back(static_cast<int32_t>(v[0]));
            out.lid.push_back(static_cast<int32_t>(v[1]));
            out.gid.push_back(v[2]);
            out.xy.push_back(f[0]);
            out.xy.push_back(f[1]);
            out.rgb.push_back(static_cast<uint8_t>(c[0]));
            out.rgb.push_back(static_cast<uint8_t>(c[1]));
            out.rgb.push_back(static_cast<uint8_t>(c[2]));
        }
        // Anything else on the line must be whitespace/newline
        while (p < end && *p != '\n') {
            if (*p != '\r' && *p != ' ' && *p != '\t') return false;
            ++p;
        }
    }
    return true;
}

}  // namespace

extern "C" {

void* osfm_tracks_load(const char* path, int64_t* n_tracks, int64_t* n_feats) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
    std::fclose(f);
    buf[got] = '\0';

    auto* out = new Parsed();
    if (!parse(buf.data(), got, *out)) {
        delete out;
        return nullptr;
    }
    *n_tracks = static_cast<int64_t>(out->counts.size());
    *n_feats = static_cast<int64_t>(out->vid.size());
    return out;
}

void osfm_tracks_fill(void* handle, int64_t* counts, int32_t* vid,
                      int32_t* lid, int64_t* gid, float* xy, uint8_t* rgb) {
    auto* p = static_cast<Parsed*>(handle);
    std::memcpy(counts, p->counts.data(), p->counts.size() * sizeof(int64_t));
    std::memcpy(vid, p->vid.data(), p->vid.size() * sizeof(int32_t));
    std::memcpy(lid, p->lid.data(), p->lid.size() * sizeof(int32_t));
    std::memcpy(gid, p->gid.data(), p->gid.size() * sizeof(int64_t));
    std::memcpy(xy, p->xy.data(), p->xy.size() * sizeof(float));
    std::memcpy(rgb, p->rgb.data(), p->rgb.size() * sizeof(uint8_t));
}

void osfm_tracks_free(void* handle) {
    delete static_cast<Parsed*>(handle);
}

}  // extern "C"
