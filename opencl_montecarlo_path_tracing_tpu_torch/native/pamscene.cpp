// Native runtime: PAM (P7) image IO + scene text-format parsers.
//
// The reference implements these in header-only C (pamalign.h, and the
// parse*FromFile functions duplicated in every host program, e.g.
// CLSuperPathTracer/CLSuperPathTracer.c:62-139).  This library is the
// framework's native equivalent: a small C++ core exposed through a C ABI
// and bound via ctypes (opencl_montecarlo_path_tracing_tpu_torch/utils/native.py).
// The pure-Python implementations remain as the always-available fallback
// and as the semantics oracle; tests assert byte-for-byte agreement.
//
// Built at first use by utils/native.py (g++ -O2 -fPIC -std=c++17 -shared).

#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PAM (P7) writer - header field order matches pamalign.h:218-224

static const char* tuplname(uint32_t channels) {
    switch (channels) {
        case 1: return "GRAYSCALE";
        case 2: return "GRAYSCALE_ALPHA";
        case 3: return "RGB";
        case 4: return "RGB_ALPHA";
        default: return "BLACKANDWHITE";
    }
}

// data: flat samples, 4-channel stride when channels == 3 (pad dropped on
// disk, pamalign.h:226-234). depth 8 or 16 (big-endian on disk).
int pam_write(const char* path, uint32_t width, uint32_t height,
              uint32_t channels, uint32_t maxval, uint32_t depth,
              const void* data) {
    if (channels < 1 || channels > 4 || (depth != 8 && depth != 16))
        return 1;
    FILE* fp = std::fopen(path, "wb");
    if (!fp) return 1;
    std::fprintf(fp, "P7\nWIDTH %u\nHEIGHT %u\nDEPTH %u\nMAXVAL %u\n"
                     "TUPLTYPE %s\nENDHDR\n",
                 width, height, channels, maxval, tuplname(channels));
    const uint64_t npix = (uint64_t)width * height;
    const uint32_t mem_stride = channels + (channels == 3);
    if (depth == 8) {
        const uint8_t* d = (const uint8_t*)data;
        if (mem_stride == channels) {
            std::fwrite(d, 1, npix * channels, fp);
        } else {
            for (uint64_t p = 0; p < npix; ++p)
                std::fwrite(d + p * mem_stride, 1, channels, fp);
        }
    } else {
        const uint16_t* d = (const uint16_t*)data;
        std::vector<uint8_t> row(2 * channels);
        for (uint64_t p = 0; p < npix; ++p) {
            for (uint32_t c = 0; c < channels; ++c) {
                uint16_t v = d[p * mem_stride + c];
                row[2 * c] = (uint8_t)(v >> 8);
                row[2 * c + 1] = (uint8_t)(v & 0xFF);
            }
            std::fwrite(row.data(), 1, row.size(), fp);
        }
    }
    int err = std::ferror(fp);
    std::fclose(fp);
    return err ? 1 : 0;
}

// Reader: parses the header, fills dims, writes samples into out (padded to
// 4 channels in memory when channels == 3, pamalign.h:187).  Two-call
// protocol: pass out=null to query sizes.
int pam_read(const char* path, uint32_t* width, uint32_t* height,
             uint32_t* channels, uint32_t* maxval, void* out,
             uint64_t out_bytes) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return 1;
    char magic[3];
    if (std::fread(magic, 1, 3, fp) != 3 || std::memcmp(magic, "P7\n", 3)) {
        std::fclose(fp);
        return 1;
    }
    char line[256];
    uint32_t w = 0, h = 0, ch = 0, mv = 0;
    while (std::fgets(line, sizeof line, fp)) {
        if (!std::strncmp(line, "ENDHDR", 6)) break;
        char keyword[64];
        unsigned value = 0;
        if (std::sscanf(line, "%63s %u", keyword, &value) >= 1) {
            if (!std::strcmp(keyword, "WIDTH")) w = value;
            else if (!std::strcmp(keyword, "HEIGHT")) h = value;
            else if (!std::strcmp(keyword, "DEPTH")) ch = value;
            else if (!std::strcmp(keyword, "MAXVAL")) mv = value;
        }
    }
    if (!w || !h || ch < 1 || ch > 4 || !mv) {
        std::fclose(fp);
        return 1;
    }
    *width = w;
    *height = h;
    *channels = ch;
    *maxval = mv;
    if (!out) {  // size query
        std::fclose(fp);
        return 0;
    }
    const uint32_t depth = mv > 255 ? 16 : 8;
    const uint32_t mem_stride = ch + (ch == 3);
    const uint64_t need = (uint64_t)w * h * mem_stride * (depth / 8);
    if (out_bytes < need) {
        std::fclose(fp);
        return 2;
    }
    const uint64_t npix = (uint64_t)w * h;
    if (depth == 8) {
        uint8_t* d = (uint8_t*)out;
        for (uint64_t p = 0; p < npix; ++p) {
            if (std::fread(d + p * mem_stride, 1, ch, fp) != ch) break;
            if (mem_stride != ch) d[p * mem_stride + ch] = 0;
        }
    } else {
        uint16_t* d = (uint16_t*)out;
        uint8_t buf[8];
        for (uint64_t p = 0; p < npix; ++p) {
            if (std::fread(buf, 1, 2 * ch, fp) != 2 * ch) break;
            for (uint32_t c = 0; c < ch; ++c)
                d[p * mem_stride + c] =
                    (uint16_t)((buf[2 * c] << 8) | buf[2 * c + 1]);
            if (mem_stride != ch) d[p * mem_stride + ch] = 0;
        }
    }
    std::fclose(fp);
    return 0;
}

// ---------------------------------------------------------------------------
// scene text parsers (formats in SURVEY.md section 2.9)

// 9-int bitmap file -> out[9]
int scene_parse_bitmap(const char* path, int64_t out[9]) {
    FILE* fp = std::fopen(path, "r");
    if (!fp) return 1;
    char line[256];
    for (int i = 0; i < 9; ++i) out[i] = 0;
    for (int i = 0; i < 9 && std::fgets(line, sizeof line, fp); ++i)
        out[i] = std::strtoll(line, nullptr, 10);
    std::fclose(fp);
    return 0;
}

// triangles: 13-line frames (9 coordinate lines + separators); a final
// frame with all coordinates but missing trailing separators is accepted.
// out: (max_triangles * 9) floats; returns count (or -1 on open failure).
int scene_parse_triangles(const char* path, float* out, int max_triangles) {
    FILE* fp = std::fopen(path, "r");
    if (!fp) return -1;
    std::vector<std::string> lines;
    char buf[512];
    while (std::fgets(buf, sizeof buf, fp)) lines.emplace_back(buf);
    std::fclose(fp);
    int count = 0;
    size_t pos = 0;
    while (pos < lines.size() && count < max_triangles) {
        float coords[9];
        size_t p = pos;
        bool ok = true;
        for (int v = 0; v < 3 && ok; ++v) {
            if (p + 3 > lines.size()) { ok = false; break; }
            for (int c = 0; c < 3; ++c)
                coords[v * 3 + c] = std::strtof(lines[p + c].c_str(), nullptr);
            p += 3;
            if (v < 2) p += 1;  // separator (may be absent at EOF)
        }
        if (!ok) break;
        std::memcpy(out + count * 9, coords, sizeof coords);
        ++count;
        pos = p + 2;  // trailing separators
    }
    return count;
}

// lights: 4 lines per light (x, y, z, intensity), up to max_lights.
// out: (max_lights * 4) floats; returns count.
int scene_parse_lights(const char* path, float* out, int max_lights) {
    FILE* fp = std::fopen(path, "r");
    if (!fp) return -1;
    std::vector<std::string> lines;
    char buf[512];
    while (std::fgets(buf, sizeof buf, fp)) lines.emplace_back(buf);
    std::fclose(fp);
    int count = 0;
    size_t pos = 0;
    while (pos + 4 <= lines.size() && count < max_lights) {
        for (int c = 0; c < 4; ++c)
            out[count * 4 + c] = std::strtof(lines[pos + c].c_str(), nullptr);
        pos += 4;
        ++count;
    }
    return count;
}

}  // extern "C"
