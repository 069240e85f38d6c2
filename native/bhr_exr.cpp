// bhr_exr: full-coverage EXR decode/encode via the system OpenEXR library.
//
// The reference loads its star map with the Rust `exr` crate, which handles
// every EXR compression scheme including PIZ — the scheme the actual NASA
// starmap_2020_4k.exr asset ships with (reference: src/lib.rs:270-308,
// Cargo.toml `exr`). This build's pure-Python reader (io/skybox.py)
// covers NONE/ZIPS/ZIP scanline files dependency-free; this native module
// fills in the rest (PIZ, PXR24, B44, DWA, tiled, deep-to-flat) by linking
// the battle-tested OpenEXR implementation — the same "use the reference
// library" position the Rust build takes.
//
// Exposed C ABI (consumed via ctypes from bhr_tpu/io/native.py):
//   int  bhr_exr_available(void);                  // 1 if compiled with OpenEXR
//   int  bhr_exr_size(path, int* w, int* h);       // 0 on success
//   int  bhr_exr_read(path, float* out_rgba);      // out is (h, w, 4) fp32
//   int  bhr_exr_write(path, const float* rgba, int w, int h,
//                      int compression, int as_half);
//   const char* bhr_exr_error(void);               // last error message
//
// `compression` uses the OpenEXR enum values (0=NONE, 2=ZIPS, 3=ZIP, 4=PIZ).

#include <cstring>
#include <thread>
#include <string>

#if defined(__has_include) && !defined(BHR_NO_OPENEXR)
#if __has_include(<OpenEXR/ImfInputFile.h>)
#define BHR_HAS_OPENEXR 1
#include <OpenEXR/ImfChannelList.h>
#include <OpenEXR/ImfFrameBuffer.h>
#include <OpenEXR/ImfHeader.h>
#include <OpenEXR/ImfInputFile.h>
#include <OpenEXR/ImfOutputFile.h>
#include <OpenEXR/ImfStandardAttributes.h>
#include <Imath/half.h>
#endif
#endif

namespace {
std::string& exr_error() {
  static thread_local std::string err;
  return err;
}
}  // namespace

extern "C" const char* bhr_exr_error(void) { return exr_error().c_str(); }

#ifdef BHR_HAS_OPENEXR

using namespace Imf;
using namespace Imath;

namespace {
// Decode/encode chunks in parallel (PIZ huffman is the bottleneck on 4K
// assets); idempotent, called from every entry point.
void ensure_threads() {
  static const bool done = [] {
    unsigned n = std::thread::hardware_concurrency();
    setGlobalThreadCount(n > 1 ? static_cast<int>(n) : 1);
    return true;
  }();
  (void)done;
}
}  // namespace

extern "C" int bhr_exr_available(void) { return 1; }

extern "C" int bhr_exr_size(const char* path, int* w, int* h) {
  try {
    ensure_threads();
    InputFile f(path);
    Box2i dw = f.header().dataWindow();
    *w = dw.max.x - dw.min.x + 1;
    *h = dw.max.y - dw.min.y + 1;
    return 0;
  } catch (const std::exception& e) {
    exr_error() = e.what();
    return 1;
  }
}

extern "C" int bhr_exr_read(const char* path, float* out) {
  try {
    ensure_threads();
    InputFile f(path);
    Box2i dw = f.header().dataWindow();
    const long long w = dw.max.x - dw.min.x + 1;
    const long long h = dw.max.y - dw.min.y + 1;

    // defaults for absent channels: RGB = 0 (or Y for grayscale), A = 1
    for (long long i = 0; i < w * h; ++i) {
      out[i * 4 + 0] = 0.0f;
      out[i * 4 + 1] = 0.0f;
      out[i * 4 + 2] = 0.0f;
      out[i * 4 + 3] = 1.0f;
    }

    const ChannelList& cl = f.header().channels();
    const bool has_rgb =
        cl.findChannel("R") || cl.findChannel("G") || cl.findChannel("B");
    const bool has_y = cl.findChannel("Y") != nullptr;

    FrameBuffer fb;
    // base pointer so that (x, y) = dataWindow.min maps to out[0]
    char* base = reinterpret_cast<char*>(out) -
                 (static_cast<long long>(dw.min.x) +
                  static_cast<long long>(dw.min.y) * w) *
                     4 * sizeof(float);
    const size_t xs = 4 * sizeof(float);
    const size_t ys = xs * static_cast<size_t>(w);
    const char* names[4] = {"R", "G", "B", "A"};
    const bool gray = !has_rgb && has_y;
    for (int c = 0; c < 4; ++c) {
      const char* ch = names[c];
      if (!cl.findChannel(ch)) {
        if (c == 0 && gray)
          ch = "Y";  // grayscale: decode luminance into R, replicate below
        else
          continue;  // keep the prefilled default
      }
      // NOTE: FrameBuffer is keyed by channel name — inserting "Y" three
      // times would keep only the last slice, so replicate post-read
      fb.insert(ch, Slice(FLOAT, base + c * sizeof(float), xs, ys));
    }
    f.setFrameBuffer(fb);
    f.readPixels(dw.min.y, dw.max.y);
    if (gray) {
      for (long long i = 0; i < w * h; ++i) {
        out[i * 4 + 1] = out[i * 4 + 0];
        out[i * 4 + 2] = out[i * 4 + 0];
      }
    }
    return 0;
  } catch (const std::exception& e) {
    exr_error() = e.what();
    return 1;
  }
}

extern "C" int bhr_exr_write(const char* path, const float* rgba, int w,
                             int h, int compression, int as_half) {
  try {
    ensure_threads();
    Header hdr(w, h);
    hdr.compression() = static_cast<Compression>(compression);
    const PixelType pt = as_half ? HALF : FLOAT;
    const char* names[4] = {"R", "G", "B", "A"};
    for (int c = 0; c < 4; ++c) hdr.channels().insert(names[c], Channel(pt));

    FrameBuffer fb;
    std::string staging;  // keeps half conversion alive through writePixels
    if (as_half) {
      staging.resize(static_cast<size_t>(w) * h * 4 * sizeof(half));
      half* hp = reinterpret_cast<half*>(staging.data());
      for (long long i = 0; i < static_cast<long long>(w) * h * 4; ++i)
        hp[i] = half(rgba[i]);
      const size_t xs = 4 * sizeof(half);
      for (int c = 0; c < 4; ++c)
        fb.insert(names[c], Slice(HALF,
                                  staging.data() + c * sizeof(half), xs,
                                  xs * static_cast<size_t>(w)));
    } else {
      const size_t xs = 4 * sizeof(float);
      char* base = const_cast<char*>(reinterpret_cast<const char*>(rgba));
      for (int c = 0; c < 4; ++c)
        fb.insert(names[c],
                  Slice(FLOAT, base + c * sizeof(float), xs,
                        xs * static_cast<size_t>(w)));
    }
    OutputFile out(path, hdr);
    out.setFrameBuffer(fb);
    out.writePixels(h);
    return 0;
  } catch (const std::exception& e) {
    exr_error() = e.what();
    return 1;
  }
}

#else  // !BHR_HAS_OPENEXR — stubs so the .so still builds and loads

extern "C" int bhr_exr_available(void) { return 0; }

extern "C" int bhr_exr_size(const char*, int*, int*) {
  exr_error() = "built without OpenEXR";
  return 1;
}

extern "C" int bhr_exr_read(const char*, float*) {
  exr_error() = "built without OpenEXR";
  return 1;
}

extern "C" int bhr_exr_write(const char*, const float*, int, int, int, int) {
  exr_error() = "built without OpenEXR";
  return 1;
}

#endif
