// Native image writer — the C++ L7 layer.
//
// The reference writes ASCII P3 with `fprintf("%d %d %d ")` after an int
// truncation (cpu/printer.c:3-18). Python string formatting of a megapixel
// image is the slow part of writeout; this does the same byte-exact
// formatting with a hand-rolled itoa into one buffer + single write.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>  // PNG IDAT deflate + CRC32 (system zlib, like the
                   // reference's libpng dependency at gpu/CMakeLists.txt)

extern "C" {

// image: (h*w*3) floats in [0,255]; truncated toward zero like the C cast.
// Returns 0 on success, -1 on IO error.
int32_t rgt_write_ppm(const char* path, const float* image, int64_t w,
                      int64_t h) {
  std::string out;
  out.reserve((size_t)(w * h * 12 + 32));
  char head[64];
  std::snprintf(head, sizeof(head), "P3\n%lld %lld\n255\n", (long long)w,
                (long long)h);
  out += head;
  char buf[16];
  for (int64_t i = 0; i < w * h * 3; ++i) {
    int v = (int)image[i];  // C float->int truncates toward zero
    char* p = buf;
    if (v < 0) {
      *p++ = '-';
      v = -v;
    }
    if (v >= 100) {
      *p++ = (char)('0' + v / 100);
      *p++ = (char)('0' + (v / 10) % 10);
      *p++ = (char)('0' + v % 10);
    } else if (v >= 10) {
      *p++ = (char)('0' + v / 10);
      *p++ = (char)('0' + v % 10);
    } else {
      *p++ = (char)('0' + v);
    }
    *p++ = ' ';
    out.append(buf, (size_t)(p - buf));
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t n = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return n == out.size() ? 0 : -1;
}

// PNG writer — the gpu/rt.cpp:14-52 analog (RGBA8 via libpng there; plain
// zlib here: IHDR + one zlib-compressed IDAT of filter-0 scanlines + IEND).
// image: (h*w*4) RGBA bytes. Byte-identical to the Python writer in
// utils/image.py when both use the same zlib level (9): same library, same
// stream. Returns 0 on success, -1 on IO/deflate error.

static void png_u32be(std::string& s, uint32_t v) {
  char b[4] = {(char)(v >> 24), (char)(v >> 16), (char)(v >> 8), (char)v};
  s.append(b, 4);
}

static void png_chunk(std::string& out, const char* tag, const std::string& payload) {
  png_u32be(out, (uint32_t)payload.size());
  std::string body(tag, 4);
  body += payload;
  out += body;
  png_u32be(out, (uint32_t)crc32(0L, (const Bytef*)body.data(), (uInt)body.size()));
}

int32_t rgt_write_png(const char* path, const uint8_t* image, int64_t w,
                      int64_t h) {
  // filter-0 scanlines
  std::string raw;
  raw.reserve((size_t)(h * (w * 4 + 1)));
  for (int64_t r = 0; r < h; ++r) {
    raw.push_back('\0');
    raw.append((const char*)(image + r * w * 4), (size_t)(w * 4));
  }
  uLongf zcap = compressBound((uLong)raw.size());
  std::vector<Bytef> z(zcap);
  if (compress2(z.data(), &zcap, (const Bytef*)raw.data(), (uLong)raw.size(),
                9) != Z_OK)
    return -1;

  std::string ihdr;
  png_u32be(ihdr, (uint32_t)w);
  png_u32be(ihdr, (uint32_t)h);
  const char tail[5] = {8 /*depth*/, 6 /*RGBA*/, 0, 0, 0};
  ihdr.append(tail, 5);

  std::string out("\x89PNG\r\n\x1a\n", 8);
  png_chunk(out, "IHDR", ihdr);
  png_chunk(out, "IDAT", std::string((const char*)z.data(), (size_t)zcap));
  png_chunk(out, "IEND", std::string());

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t n = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return n == out.size() ? 0 : -1;
}

}  // extern "C"
