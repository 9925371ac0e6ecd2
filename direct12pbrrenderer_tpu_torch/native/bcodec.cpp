// Block-compression codecs: BC1 encode/decode, BC6H(UF16) decode + mode-11
// encode. Native counterpart of resource/bc.py (same algorithms, same
// outputs) — the hot path of the asset pipeline, where the reference uses
// DirectXTex + a D3D11 device (Engine/Source/Resource/TextureCompression.cpp).
//
// Exposed through a plain C ABI consumed via ctypes (resource/native_codec.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

namespace {

inline int blocks(int dim) { return dim < 4 ? 1 : (dim + 3) / 4; }

inline float half_to_float(uint16_t h) {
    uint32_t sign = (uint32_t)(h >> 15) << 31;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {
            // subnormal
            int e = -1;
            do { ++e; mant <<= 1; } while (!(mant & 0x400));
            bits = sign | ((127 - 15 - e) << 23) | ((mant & 0x3FF) << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (mant << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

// ---------------------------------------------------------------------------
// BC1
// ---------------------------------------------------------------------------

inline void rgb565_to_888(uint16_t c, int out[3]) {
    int r = (c >> 11) & 0x1F, g = (c >> 5) & 0x3F, b = c & 0x1F;
    out[0] = (r << 3) | (r >> 2);
    out[1] = (g << 2) | (g >> 4);
    out[2] = (b << 3) | (b >> 2);
}

} // namespace

extern "C" {

// data: ceil(w/4)*ceil(h/4)*8 bytes; out: w*h*4 uint8 RGBA
void bc1_decode(const uint8_t* data, int width, int height, uint8_t* out) {
    int bw = blocks(width), bh = blocks(height);
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            const uint8_t* blk = data + (by * bw + bx) * 8;
            uint16_t c0 = blk[0] | (blk[1] << 8);
            uint16_t c1 = blk[2] | (blk[3] << 8);
            int p[4][4];
            rgb565_to_888(c0, p[0]);
            rgb565_to_888(c1, p[1]);
            bool opaque = c0 > c1;
            for (int ch = 0; ch < 3; ++ch) {
                if (opaque) {
                    p[2][ch] = (2 * p[0][ch] + p[1][ch]) / 3;
                    p[3][ch] = (p[0][ch] + 2 * p[1][ch]) / 3;
                } else {
                    p[2][ch] = (p[0][ch] + p[1][ch]) / 2;
                    p[3][ch] = 0;
                }
            }
            p[0][3] = p[1][3] = p[2][3] = 255;
            p[3][3] = opaque ? 255 : 0;
            for (int ty = 0; ty < 4; ++ty) {
                int y = by * 4 + ty;
                if (y >= height) break;
                uint8_t row = blk[4 + ty];
                for (int tx = 0; tx < 4; ++tx) {
                    int x = bx * 4 + tx;
                    if (x >= width) break;
                    int sel = (row >> (tx * 2)) & 0x3;
                    uint8_t* px = out + (y * width + x) * 4;
                    px[0] = (uint8_t)p[sel][0];
                    px[1] = (uint8_t)p[sel][1];
                    px[2] = (uint8_t)p[sel][2];
                    px[3] = (uint8_t)(sel == 3 && !opaque ? 0 : 255);
                }
            }
        }
    }
}

// rgba: w*h*4 uint8; out: ceil(w/4)*ceil(h/4)*8 bytes.
// Principal-axis endpoints + 2-bit quantization (same scheme as bc.py).
void bc1_encode(const uint8_t* rgba, int width, int height, uint8_t* out) {
    int bw = blocks(width), bh = blocks(height);
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            float texels[16][3];
            for (int ty = 0; ty < 4; ++ty) {
                for (int tx = 0; tx < 4; ++tx) {
                    int y = std::min(by * 4 + ty, height - 1);
                    int x = std::min(bx * 4 + tx, width - 1);
                    const uint8_t* px = rgba + (y * width + x) * 4;
                    for (int c = 0; c < 3; ++c) texels[ty * 4 + tx][c] = px[c];
                }
            }
            float cmin[3] = {255, 255, 255}, cmax[3] = {0, 0, 0};
            for (auto& t : texels)
                for (int c = 0; c < 3; ++c) {
                    cmin[c] = std::min(cmin[c], t[c]);
                    cmax[c] = std::max(cmax[c], t[c]);
                }
            float axis[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1], cmax[2] - cmin[2]};
            float len = std::sqrt(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2]);
            if (len > 1e-6f)
                for (float& a : axis) a /= len;
            int lo_i = 0, hi_i = 0;
            float lo_p = 1e30f, hi_p = -1e30f;
            for (int i = 0; i < 16; ++i) {
                float proj = 0;
                for (int c = 0; c < 3; ++c) proj += (texels[i][c] - cmin[c]) * axis[c];
                if (proj < lo_p) { lo_p = proj; lo_i = i; }
                if (proj > hi_p) { hi_p = proj; hi_i = i; }
            }
            auto to565 = [](const float* c) -> uint16_t {
                int r = (int)std::lround(c[0] / 255.0f * 31);
                int g = (int)std::lround(c[1] / 255.0f * 63);
                int b = (int)std::lround(c[2] / 255.0f * 31);
                return (uint16_t)((r << 11) | (g << 5) | b);
            };
            uint16_t c0 = to565(texels[hi_i]);
            uint16_t c1 = to565(texels[lo_i]);
            if (c0 < c1) std::swap(c0, c1);
            int pal[4][3];
            rgb565_to_888(c0, pal[0]);
            rgb565_to_888(c1, pal[1]);
            for (int c = 0; c < 3; ++c) {
                pal[2][c] = (2 * pal[0][c] + pal[1][c]) / 3;
                pal[3][c] = (pal[0][c] + 2 * pal[1][c]) / 3;
            }
            uint8_t* blk = out + (by * bw + bx) * 8;
            blk[0] = c0 & 0xFF; blk[1] = c0 >> 8;
            blk[2] = c1 & 0xFF; blk[3] = c1 >> 8;
            for (int ty = 0; ty < 4; ++ty) {
                uint8_t row = 0;
                for (int tx = 0; tx < 4; ++tx) {
                    int best = 0;
                    float bd = 1e30f;
                    for (int s = 0; s < 4; ++s) {
                        float d = 0;
                        for (int c = 0; c < 3; ++c) {
                            float dd = texels[ty * 4 + tx][c] - pal[s][c];
                            d += dd * dd;
                        }
                        if (d < bd) { bd = d; best = s; }
                    }
                    if (c0 == c1) best = 0;
                    row |= (uint8_t)(best << (tx * 2));
                }
                blk[4 + ty] = row;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// BC6H UF16 — all 14 modes decoded (same field tables as resource/bc.py,
// validated bit-exact against Mesa's BPTC decoder). Encoder: mode 11
// (0x03 bits): 10-bit endpoints, 4-bit indices, single region.
// ---------------------------------------------------------------------------

namespace bc6h {

struct BitReader {
    const uint8_t* d;
    int pos = 0;
    int read(int n) {
        int v = 0;
        for (int i = 0; i < n; ++i, ++pos)
            v |= ((d[pos >> 3] >> (pos & 7)) & 1) << i;
        return v;
    }
    int read_rev(int n) {
        int v = 0;
        for (int i = 0; i < n; ++i, ++pos)
            v = (v << 1) | ((d[pos >> 3] >> (pos & 7)) & 1);
        return v;
    }
};

const int W3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int W4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

// P2 partition table + anchors (same as bc.py)
const uint8_t P2[32][16] = {
    {0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1},{0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1},
    {0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1},{0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1},
    {0,0,0,0,0,0,0,1,0,0,0,1,0,0,1,1},{0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1},
    {0,0,0,1,0,0,1,1,0,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,1,0,0,1,1,0,1,1,1},
    {0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1},{0,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1},
    {0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,0,0,0,0,1,0,1,1,1},
    {0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1},
    {0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1},
    {0,0,0,0,1,0,0,0,1,1,1,0,1,1,1,1},{0,1,1,1,0,0,0,1,0,0,0,0,0,0,0,0},
    {0,0,0,0,0,0,0,0,1,0,0,0,1,1,1,0},{0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0},
    {0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0},{0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0},
    {0,0,0,0,0,0,0,0,1,0,0,0,1,1,0,0},{0,1,1,1,0,0,1,1,0,0,1,1,0,0,0,1},
    {0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0},{0,0,0,0,1,0,0,0,1,0,0,0,1,1,0,0},
    {0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0},{0,0,1,1,0,1,1,0,0,1,1,0,1,1,0,0},
    {0,0,0,1,0,1,1,1,1,1,1,0,1,0,0,0},{0,0,0,0,1,1,1,1,1,1,1,1,0,0,0,0},
    {0,1,1,1,0,0,0,1,1,0,0,0,1,1,1,0},{0,0,1,1,1,0,0,1,1,0,0,1,1,1,0,0},
};
const int P2_ANCHOR[32] = {
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15, 2, 8, 2, 2, 8, 8,15, 2, 8, 2, 2, 8, 8, 2, 2,
};

// BC6H endpoint bit layouts, generated from resource/bc.py::_BC6H_LAYOUTS
// (validated bit-exact against Mesa's BPTC decoder; op = e<<6 | c<<4 | bit)
static const uint8_t kF00[] = {0x94, 0xA4, 0xE4, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x40, 0x41, 0x42, 0x43, 0x44, 0xD4, 0x90, 0x91, 0x92, 0x93, 0x50, 0x51, 0x52, 0x53, 0x54, 0xE0, 0xD0, 0xD1, 0xD2, 0xD3, 0x60, 0x61, 0x62, 0x63, 0x64, 0xE1, 0xA0, 0xA1, 0xA2, 0xA3, 0x80, 0x81, 0x82, 0x83, 0x84, 0xE2, 0xC0, 0xC1, 0xC2, 0xC3, 0xC4, 0xE3};
static const uint8_t kF01[] = {0x95, 0xD4, 0xD5, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0xE0, 0xE1, 0xA4, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0xA5, 0xE2, 0x94, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0xE3, 0xE5, 0xE4, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x90, 0x91, 0x92, 0x93, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0xD0, 0xD1, 0xD2, 0xD3, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0xA0, 0xA1, 0xA2, 0xA3, 0x80, 0x81, 0x82, 0x83, 0x84, 0x85, 0xC0, 0xC1, 0xC2, 0xC3, 0xC4, 0xC5};
static const uint8_t kF02[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x40, 0x41, 0x42, 0x43, 0x44, 0x0A, 0x90, 0x91, 0x92, 0x93, 0x50, 0x51, 0x52, 0x53, 0x1A, 0xE0, 0xD0, 0xD1, 0xD2, 0xD3, 0x60, 0x61, 0x62, 0x63, 0x2A, 0xE1, 0xA0, 0xA1, 0xA2, 0xA3, 0x80, 0x81, 0x82, 0x83, 0x84, 0xE2, 0xC0, 0xC1, 0xC2, 0xC3, 0xC4, 0xE3};
static const uint8_t kF03[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69};
static const uint8_t kF06[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x40, 0x41, 0x42, 0x43, 0x0A, 0xD4, 0x90, 0x91, 0x92, 0x93, 0x50, 0x51, 0x52, 0x53, 0x54, 0x1A, 0xD0, 0xD1, 0xD2, 0xD3, 0x60, 0x61, 0x62, 0x63, 0x2A, 0xE1, 0xA0, 0xA1, 0xA2, 0xA3, 0x80, 0x81, 0x82, 0x83, 0xE0, 0xE2, 0xC0, 0xC1, 0xC2, 0xC3, 0x94, 0xE3};
static const uint8_t kF07[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x0A, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x1A, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x2A};
static const uint8_t kF0A[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x40, 0x41, 0x42, 0x43, 0x0A, 0xA4, 0x90, 0x91, 0x92, 0x93, 0x50, 0x51, 0x52, 0x53, 0x1A, 0xE0, 0xD0, 0xD1, 0xD2, 0xD3, 0x60, 0x61, 0x62, 0x63, 0x64, 0x2A, 0xA0, 0xA1, 0xA2, 0xA3, 0x80, 0x81, 0x82, 0x83, 0xE1, 0xE2, 0xC0, 0xC1, 0xC2, 0xC3, 0xE4, 0xE3};
static const uint8_t kF0B[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x46, 0x47, 0x0B, 0x0A, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0x56, 0x57, 0x1B, 0x1A, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x66, 0x67, 0x2B, 0x2A};
static const uint8_t kF0E[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0xA4, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x94, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0xE4, 0x40, 0x41, 0x42, 0x43, 0x44, 0xD4, 0x90, 0x91, 0x92, 0x93, 0x50, 0x51, 0x52, 0x53, 0x54, 0xE0, 0xD0, 0xD1, 0xD2, 0xD3, 0x60, 0x61, 0x62, 0x63, 0x64, 0xE1, 0xA0, 0xA1, 0xA2, 0xA3, 0x80, 0x81, 0x82, 0x83, 0x84, 0xE2, 0xC0, 0xC1, 0xC2, 0xC3, 0xC4, 0xE3};
static const uint8_t kF0F[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0x28, 0x29, 0x40, 0x41, 0x42, 0x43, 0x0F, 0x0E, 0x0D, 0x0C, 0x0B, 0x0A, 0x50, 0x51, 0x52, 0x53, 0x1F, 0x1E, 0x1D, 0x1C, 0x1B, 0x1A, 0x60, 0x61, 0x62, 0x63, 0x2F, 0x2E, 0x2D, 0x2C, 0x2B, 0x2A};
static const uint8_t kF12[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0xD4, 0xA4, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0xE2, 0x94, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0xE3, 0xE4, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x90, 0x91, 0x92, 0x93, 0x50, 0x51, 0x52, 0x53, 0x54, 0xE0, 0xD0, 0xD1, 0xD2, 0xD3, 0x60, 0x61, 0x62, 0x63, 0x64, 0xE1, 0xA0, 0xA1, 0xA2, 0xA3, 0x80, 0x81, 0x82, 0x83, 0x84, 0x85, 0xC0, 0xC1, 0xC2, 0xC3, 0xC4, 0xC5};
static const uint8_t kF16[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0xE0, 0xA4, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0x95, 0x94, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0xD5, 0xE4, 0x40, 0x41, 0x42, 0x43, 0x44, 0xD4, 0x90, 0x91, 0x92, 0x93, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0xD0, 0xD1, 0xD2, 0xD3, 0x60, 0x61, 0x62, 0x63, 0x64, 0xE1, 0xA0, 0xA1, 0xA2, 0xA3, 0x80, 0x81, 0x82, 0x83, 0x84, 0xE2, 0xC0, 0xC1, 0xC2, 0xC3, 0xC4, 0xE3};
static const uint8_t kF1A[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0xE1, 0xA4, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17, 0xA5, 0x94, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0x26, 0x27, 0xE5, 0xE4, 0x40, 0x41, 0x42, 0x43, 0x44, 0xD4, 0x90, 0x91, 0x92, 0x93, 0x50, 0x51, 0x52, 0x53, 0x54, 0xE0, 0xD0, 0xD1, 0xD2, 0xD3, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0xA0, 0xA1, 0xA2, 0xA3, 0x80, 0x81, 0x82, 0x83, 0x84, 0xE2, 0xC0, 0xC1, 0xC2, 0xC3, 0xC4, 0xE3};
static const uint8_t kF1E[] = {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0xD4, 0xE0, 0xE1, 0xA4, 0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x95, 0xA5, 0xE2, 0x94, 0x20, 0x21, 0x22, 0x23, 0x24, 0x25, 0xD5, 0xE3, 0xE5, 0xE4, 0x40, 0x41, 0x42, 0x43, 0x44, 0x45, 0x90, 0x91, 0x92, 0x93, 0x50, 0x51, 0x52, 0x53, 0x54, 0x55, 0xD0, 0xD1, 0xD2, 0xD3, 0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0xA0, 0xA1, 0xA2, 0xA3, 0x80, 0x81, 0x82, 0x83, 0x84, 0x85, 0xC0, 0xC1, 0xC2, 0xC3, 0xC4, 0xC5};
struct FieldProg { uint8_t mode; const uint8_t* ops; uint8_t n; };
static const FieldProg kBC6HProgs[] = {
    {0x00, kF00, 75},
    {0x01, kF01, 75},
    {0x02, kF02, 72},
    {0x03, kF03, 60},
    {0x06, kF06, 72},
    {0x07, kF07, 60},
    {0x0A, kF0A, 72},
    {0x0B, kF0B, 60},
    {0x0E, kF0E, 72},
    {0x0F, kF0F, 60},
    {0x12, kF12, 72},
    {0x16, kF16, 72},
    {0x1A, kF1A, 72},
    {0x1E, kF1E, 72},
};

inline int unquantize(int x, int prec) {
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xFFFF;
    return (int)((((int64_t)x << 16) + 0x8000) >> prec);
}

inline uint16_t finalize(int x) { return (uint16_t)((x * 31) >> 6); }

// out16: 16 texels x 3 channels of f16 bits
void decode_block(const uint8_t* blk, uint16_t out16[16][3]) {
    BitReader br{blk};
    int m = br.read(2);
    if (m >= 2) m = (br.read(3) << 2) | m;

    int prec = 0, dr = 0, dg = 0, db = 0, regions = 1;
    bool transformed = true;
    switch (m) {
        case 0x00: prec = 10; dr = dg = db = 5; regions = 2; break;
        case 0x01: prec = 7; dr = dg = db = 6; regions = 2; break;
        case 0x02: prec = 11; dr = 5; dg = 4; db = 4; regions = 2; break;
        case 0x06: prec = 11; dr = 4; dg = 5; db = 4; regions = 2; break;
        case 0x0A: prec = 11; dr = 4; dg = 4; db = 5; regions = 2; break;
        case 0x0E: prec = 9; dr = dg = db = 5; regions = 2; break;
        case 0x12: prec = 8; dr = 6; dg = 5; db = 5; regions = 2; break;
        case 0x16: prec = 8; dr = 5; dg = 6; db = 5; regions = 2; break;
        case 0x1A: prec = 8; dr = 5; dg = 5; db = 6; regions = 2; break;
        case 0x1E: prec = 6; dr = dg = db = 6; transformed = false; regions = 2; break;
        case 0x03: prec = 10; dr = dg = db = 10; transformed = false; break;
        case 0x07: prec = 11; dr = dg = db = 9; break;
        case 0x0B: prec = 12; dr = dg = db = 8; break;
        case 0x0F: prec = 16; dr = dg = db = 4; break;
        default:  // reserved modes decode to black per spec
            std::memset(out16, 0, sizeof(uint16_t) * 48);
            return;
    }

    int ep[4][3] = {};
    const FieldProg* prog = nullptr;
    for (const FieldProg& fp : kBC6HProgs)
        if (fp.mode == m) { prog = &fp; break; }
    for (int i = 0; i < prog->n; ++i) {
        uint8_t op = prog->ops[i];
        ep[op >> 6][(op >> 4) & 3] |= br.read(1) << (op & 15);
    }

    int partition = (regions == 2) ? br.read(5) : 0;
    int mask = (1 << prec) - 1;
    if (transformed) {
        int deltas[3] = {dr, dg, db};
        for (int e = 1; e < regions * 2; ++e)
            for (int c = 0; c < 3; ++c) {
                int d = ep[e][c];
                if (d >= (1 << (deltas[c] - 1))) d -= 1 << deltas[c];
                ep[e][c] = (ep[0][c] + d) & mask;
            }
    }

    const int* weights = regions == 2 ? W3 : W4;
    int ibits = regions == 2 ? 3 : 4;
    int uq[4][3];
    for (int e = 0; e < regions * 2; ++e)
        for (int c = 0; c < 3; ++c) uq[e][c] = unquantize(ep[e][c], prec);

    const uint8_t* part_row = P2[partition];
    int anchor2 = regions == 2 ? P2_ANCHOR[partition] : -1;

    for (int t = 0; t < 16; ++t) {
        int subset = regions == 2 ? part_row[t] : 0;
        int nb = (t == 0 || t == anchor2) ? ibits - 1 : ibits;
        int w = weights[br.read(nb)];
        for (int c = 0; c < 3; ++c) {
            int a = uq[subset * 2][c], b = uq[subset * 2 + 1][c];
            out16[t][c] = finalize((a * (64 - w) + b * w + 32) >> 6);
        }
    }
}

} // namespace bc6h

// data: nblocks*16 bytes; out: w*h*4 f16 bits (RGBA, A = 1.0h = 0x3C00)
void bc6h_decode(const uint8_t* data, int width, int height, uint16_t* out) {
    int bw = blocks(width), bh = blocks(height);
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            uint16_t texels[16][3];
            bc6h::decode_block(data + (by * bw + bx) * 16, texels);
            for (int ty = 0; ty < 4; ++ty) {
                int y = by * 4 + ty;
                if (y >= height) break;
                for (int tx = 0; tx < 4; ++tx) {
                    int x = bx * 4 + tx;
                    if (x >= width) break;
                    uint16_t* px = out + (y * width + x) * 4;
                    px[0] = texels[ty * 4 + tx][0];
                    px[1] = texels[ty * 4 + tx][1];
                    px[2] = texels[ty * 4 + tx][2];
                    px[3] = 0x3C00;
                }
            }
        }
    }
}

// rgba_f16: w*h*4 f16 bits (non-negative halfs); out: nblocks*16 bytes
void bc6h_encode(const uint16_t* rgba_f16, int width, int height, uint8_t* out) {
    int bw = blocks(width), bh = blocks(height);
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            uint16_t texels[16][3];
            for (int ty = 0; ty < 4; ++ty)
                for (int tx = 0; tx < 4; ++tx) {
                    int y = std::min(by * 4 + ty, height - 1);
                    int x = std::min(bx * 4 + tx, width - 1);
                    const uint16_t* px = rgba_f16 + (y * width + x) * 4;
                    for (int c = 0; c < 3; ++c) {
                        uint16_t v = px[c];
                        texels[ty * 4 + tx][c] = (v & 0x8000) ? 0 : v;  // UF16
                    }
                }
            int e0[3], e1[3];
            for (int c = 0; c < 3; ++c) {
                int mn = 0xFFFF, mx = 0;
                for (auto& t : texels) {
                    mn = std::min<int>(mn, t[c]);
                    mx = std::max<int>(mx, t[c]);
                }
                // invert the decode chain: final = (unquantize(e)*31)>>6,
                // unquantize(e) ~= e*64 + 32 -> e ~= bits/31 - 0.5
                e0[c] = std::clamp((int)std::lround(mn / 31.0 - 0.5), 0, 1023);
                e1[c] = std::clamp((int)std::lround(mx / 31.0 - 0.5), 0, 1023);
            }
            // palette in f16-bit space
            uint16_t pal[16][3];
            for (int w = 0; w < 16; ++w)
                for (int c = 0; c < 3; ++c) {
                    int u0 = bc6h::unquantize(e0[c], 10);
                    int u1 = bc6h::unquantize(e1[c], 10);
                    pal[w][c] = bc6h::finalize(
                        (u0 * (64 - bc6h::W4[w]) + u1 * bc6h::W4[w] + 32) >> 6);
                }
            int idx[16];
            for (int t = 0; t < 16; ++t) {
                float best = 1e30f;
                int bi = 0;
                for (int w = 0; w < 16; ++w) {
                    float d = 0;
                    for (int c = 0; c < 3; ++c) {
                        // decoded-value distance (matches the numpy encoder)
                        float dd = half_to_float(texels[t][c]) - half_to_float(pal[w][c]);
                        d += dd * dd;
                    }
                    if (d < best) { best = d; bi = w; }
                }
                idx[t] = bi;
            }
            idx[0] = std::min(idx[0], 7);  // anchor has 3 index bits

            uint8_t* blk = out + (by * bw + bx) * 16;
            std::memset(blk, 0, 16);
            int pos = 0;
            auto put = [&](int v, int n) {
                for (int i = 0; i < n; ++i, ++pos)
                    if ((v >> i) & 1) blk[pos >> 3] |= 1 << (pos & 7);
            };
            put(0x03, 5);  // mode 11
            for (int c = 0; c < 3; ++c) put(e0[c], 10);
            for (int c = 0; c < 3; ++c) put(e1[c], 10);
            put(idx[0], 3);
            for (int t = 1; t < 16; ++t) put(idx[t], 4);
        }
    }
}

} // extern "C"
