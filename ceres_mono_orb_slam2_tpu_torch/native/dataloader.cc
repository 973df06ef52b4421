// Native image decoding + threaded prefetching data loader.
//
// TPU-native runtime equivalent of the reference's data path: main.cc:85-96
// decodes each frame with cv::imread (native OpenCV) on the tracking thread;
// here a C++ worker thread decodes AHEAD of the tracker so PNG inflate +
// grayscale conversion overlaps the device round-trips of the previous
// frame. Minimal in-house PNG (zlib) + PGM decoders — no OpenCV/libpng in
// the image; zlib is.
//
// Grayscale conversion matches PIL's convert("L") exactly for 8-bit RGB(A):
//   L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16   (ITU-R 601-2 luma)
// so the native and Python fallback paths produce identical tensors.
// 16-bit samples take the high byte — the reference's cv::imread 16->8
// conversion — and the PIL fallback applies the same >>8 for 16-bit modes.
//
// C ABI for ctypes (no pybind11 in this image).

#include <pthread.h>
#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

struct Image {
  int w = 0, h = 0;
  float* px = nullptr;  // h*w grayscale
  int status = -1;      // 0 ok
};

uint8_t* read_file(const char* path, long* out_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(len > 0 ? len : 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  long got = static_cast<long>(std::fread(buf, 1, len, f));
  std::fclose(f);
  if (got != len) {
    std::free(buf);
    return nullptr;
  }
  *out_len = len;
  return buf;
}

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8/16-bit non-interlaced gray/RGB/gray+a/RGBA PNG to float32
// grayscale. Returns 0 ok, <0 on unsupported/corrupt input.
int decode_png(const uint8_t* buf, long len, Image* im) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 + 25 || std::memcmp(buf, magic, 8) != 0) return -1;
  long pos = 8;
  int w = 0, h = 0, depth = 0, ctype = 0, interlace = 0;
  uint8_t* idat = nullptr;
  size_t idat_len = 0, idat_cap = 0;
  while (pos + 8 <= len) {
    uint32_t clen = be32(buf + pos);
    const uint8_t* tag = buf + pos + 4;
    const uint8_t* data = buf + pos + 8;
    if (pos + 8 + clen + 4 > static_cast<uint32_t>(len)) break;
    if (std::memcmp(tag, "IHDR", 4) == 0 && clen >= 13) {
      w = be32(data);
      h = be32(data + 4);
      depth = data[8];
      ctype = data[9];
      interlace = data[12];
    } else if (std::memcmp(tag, "IDAT", 4) == 0) {
      if (idat_len + clen > idat_cap) {
        idat_cap = (idat_len + clen) * 2;
        idat = static_cast<uint8_t*>(std::realloc(idat, idat_cap));
        if (!idat) return -2;
      }
      std::memcpy(idat + idat_len, data, clen);
      idat_len += clen;
    } else if (std::memcmp(tag, "IEND", 4) == 0) {
      break;
    }
    pos += 8 + clen + 4;
  }
  int channels;
  switch (ctype) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // RGB
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // RGBA
    default: std::free(idat); return -3;  // palette/unknown unsupported
  }
  if (w <= 0 || h <= 0 || interlace != 0 || (depth != 8 && depth != 16) ||
      !idat) {
    std::free(idat);
    return -3;
  }
  int bpp = channels * depth / 8;          // bytes per pixel
  long stride = 1 + long(w) * bpp;         // filter byte + scanline
  long raw_len = stride * h;
  uint8_t* raw = static_cast<uint8_t*>(std::malloc(raw_len));
  if (!raw) {
    std::free(idat);
    return -2;
  }
  uLongf dst_len = raw_len;
  int zret = uncompress(raw, &dst_len, idat, idat_len);
  std::free(idat);
  if (zret != Z_OK || dst_len != static_cast<uLongf>(raw_len)) {
    std::free(raw);
    return -4;
  }
  // Defilter in place (output scanlines packed at w*bpp, reusing raw).
  uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    uint8_t* line = raw + y * stride;
    int filter = line[0];
    uint8_t* cur = line + 1;
    for (long i = 0; i < long(w) * bpp; ++i) {
      int a = i >= bpp ? cur[i - bpp] : 0;
      int b = prev ? prev[i] : 0;
      int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int x = cur[i];
      switch (filter) {
        case 0: break;
        case 1: x += a; break;
        case 2: x += b; break;
        case 3: x += (a + b) >> 1; break;
        case 4: x += paeth(a, b, c); break;
        default:
          std::free(raw);
          return -5;
      }
      cur[i] = static_cast<uint8_t>(x);
    }
    prev = cur;
  }
  float* px = static_cast<float*>(std::malloc(sizeof(float) * w * h));
  if (!px) {
    std::free(raw);
    return -2;
  }
  int step = depth / 8;  // take high byte of 16-bit samples
  for (int y = 0; y < h; ++y) {
    const uint8_t* cur = raw + y * stride + 1;
    float* out = px + long(y) * w;
    for (int x = 0; x < w; ++x) {
      const uint8_t* s = cur + long(x) * bpp;
      uint32_t l;
      if (channels >= 3) {
        uint32_t r = s[0], g = s[step], b = s[2 * step];
        l = (r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16;  // PIL L24
      } else {
        l = s[0];
      }
      out[x] = static_cast<float>(l);
    }
  }
  std::free(raw);
  im->w = w;
  im->h = h;
  im->px = px;
  im->status = 0;
  return 0;
}

// Binary PGM (P5), 8- or 16-bit.
int decode_pgm(const uint8_t* buf, long len, Image* im) {
  if (len < 10 || buf[0] != 'P' || buf[1] != '5') return -1;
  long pos = 2;
  long vals[3];
  for (int i = 0; i < 3; ++i) {
    // skip whitespace + comments
    while (pos < len) {
      if (buf[pos] == '#') {
        while (pos < len && buf[pos] != '\n') ++pos;
      } else if (buf[pos] == ' ' || buf[pos] == '\n' || buf[pos] == '\r' ||
                 buf[pos] == '\t') {
        ++pos;
      } else {
        break;
      }
    }
    long v = 0;
    bool any = false;
    while (pos < len && buf[pos] >= '0' && buf[pos] <= '9') {
      v = v * 10 + (buf[pos++] - '0');
      any = true;
    }
    if (!any) return -1;
    vals[i] = v;
  }
  ++pos;  // single whitespace after maxval
  int w = static_cast<int>(vals[0]), h = static_cast<int>(vals[1]);
  int step = vals[2] > 255 ? 2 : 1;
  if (w <= 0 || h <= 0 || pos + long(w) * h * step > len) return -1;
  float* px = static_cast<float*>(std::malloc(sizeof(float) * w * h));
  if (!px) return -2;
  for (long i = 0; i < long(w) * h; ++i)
    px[i] = static_cast<float>(buf[pos + i * step]);
  im->w = w;
  im->h = h;
  im->px = px;
  im->status = 0;
  return 0;
}

int decode_any(const uint8_t* buf, long len, Image* im) {
  if (len >= 8 && buf[0] == 137 && buf[1] == 'P') return decode_png(buf, len, im);
  if (len >= 2 && buf[0] == 'P' && buf[1] == '5') return decode_pgm(buf, len, im);
  return -1;
}

// ---------------- prefetching loader ----------------

struct Loader {
  char** paths = nullptr;
  long n = 0;
  int capacity = 0;
  Image* slots = nullptr;  // ring buffer, slot i holds frame (i mod capacity)
  bool* ready = nullptr;
  long next_consume = 0;
  bool stop = false;
  pthread_t worker;
  pthread_mutex_t mu;
  pthread_cond_t cv_ready;   // signaled when a slot becomes ready
  pthread_cond_t cv_space;   // signaled when a slot is consumed
};

void* loader_main(void* arg) {
  Loader* L = static_cast<Loader*>(arg);
  for (long i = 0; i < L->n; ++i) {
    // wait until slot i is within the window [next_consume, +capacity)
    pthread_mutex_lock(&L->mu);
    while (!L->stop && i >= L->next_consume + L->capacity)
      pthread_cond_wait(&L->cv_space, &L->mu);
    bool stop = L->stop;
    pthread_mutex_unlock(&L->mu);
    if (stop) return nullptr;

    Image im;
    long len = 0;
    uint8_t* buf = read_file(L->paths[i], &len);
    if (buf) {
      decode_any(buf, len, &im);
      std::free(buf);
    }
    pthread_mutex_lock(&L->mu);
    L->slots[i % L->capacity] = im;
    L->ready[i % L->capacity] = true;
    pthread_cond_signal(&L->cv_ready);
    pthread_mutex_unlock(&L->mu);
  }
  return nullptr;
}

}  // namespace

extern "C" {

// One-shot decode of a file into a caller buffer of max_pixels floats.
// Returns 0 and fills w/h, or <0 (unsupported → caller falls back).
int img_decode_file(const char* path, float* out, int* w, int* h,
                    long max_pixels) {
  long len = 0;
  uint8_t* buf = read_file(path, &len);
  if (!buf) return -10;
  Image im;
  int ret = decode_any(buf, len, &im);
  std::free(buf);
  if (ret != 0) return ret;
  if (long(im.w) * im.h > max_pixels) {
    std::free(im.px);
    return -6;
  }
  std::memcpy(out, im.px, sizeof(float) * im.w * im.h);
  std::free(im.px);
  *w = im.w;
  *h = im.h;
  return 0;
}

// Probe dimensions from the header only (PNG IHDR / PGM header): reads just
// the first 4 KB, validates the container magic, and bounds the dims — a
// corrupt file must return nonzero so the caller falls back, never garbage
// w/h that the Python side would allocate from.
int img_probe_file(const char* path, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -10;
  uint8_t head[4096];
  long len = static_cast<long>(std::fread(head, 1, sizeof(head), f));
  std::fclose(f);
  int pw = 0, ph = 0;
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len >= 24 && std::memcmp(head, magic, 8) == 0 &&
      std::memcmp(head + 12, "IHDR", 4) == 0) {
    pw = static_cast<int>(be32(head + 16));
    ph = static_cast<int>(be32(head + 20));
  } else if (len > 2 && head[0] == 'P' && head[1] == '5') {
    // parse "P5 <w> <h>" tokens (comments allowed) without touching pixels
    long pos = 2;
    long vals[2] = {0, 0};
    for (int i = 0; i < 2; ++i) {
      while (pos < len) {
        if (head[pos] == '#') {
          while (pos < len && head[pos] != '\n') ++pos;
        } else if (head[pos] == ' ' || head[pos] == '\n' ||
                   head[pos] == '\r' || head[pos] == '\t') {
          ++pos;
        } else {
          break;
        }
      }
      bool any = false;
      while (pos < len && head[pos] >= '0' && head[pos] <= '9') {
        vals[i] = vals[i] * 10 + (head[pos++] - '0');
        any = true;
      }
      if (!any) return -1;  // header beyond 4 KB or malformed → fallback
    }
    pw = static_cast<int>(vals[0]);
    ph = static_cast<int>(vals[1]);
  } else {
    return -1;
  }
  if (pw <= 0 || ph <= 0 || pw > 65535 || ph > 65535 ||
      long(pw) * ph > (1L << 28))
    return -1;
  *w = pw;
  *h = ph;
  return 0;
}

void* loader_create(const char** paths, long n, int capacity) {
  Loader* L = new Loader();
  L->n = n;
  L->capacity = capacity > 0 ? capacity : 4;
  L->paths = static_cast<char**>(std::malloc(sizeof(char*) * n));
  for (long i = 0; i < n; ++i) L->paths[i] = strdup(paths[i]);
  L->slots = new Image[L->capacity]();
  L->ready = new bool[L->capacity]();
  pthread_mutex_init(&L->mu, nullptr);
  pthread_cond_init(&L->cv_ready, nullptr);
  pthread_cond_init(&L->cv_space, nullptr);
  pthread_create(&L->worker, nullptr, loader_main, L);
  return L;
}

// Blocking: copy the next frame into out (max_pixels floats). Returns 0 ok,
// 1 = end of sequence, <0 = decode error for this frame (sequence continues).
int loader_next(void* handle, float* out, int* w, int* h, long max_pixels) {
  Loader* L = static_cast<Loader*>(handle);
  if (L->next_consume >= L->n) return 1;
  long i = L->next_consume;
  pthread_mutex_lock(&L->mu);
  while (!L->ready[i % L->capacity]) pthread_cond_wait(&L->cv_ready, &L->mu);
  Image im = L->slots[i % L->capacity];
  L->ready[i % L->capacity] = false;
  L->next_consume = i + 1;
  pthread_cond_signal(&L->cv_space);
  pthread_mutex_unlock(&L->mu);
  if (im.status != 0) return im.status == -1 ? -1 : im.status;
  int ret = 0;
  if (long(im.w) * im.h > max_pixels) {
    ret = -6;
  } else {
    std::memcpy(out, im.px, sizeof(float) * im.w * im.h);
    *w = im.w;
    *h = im.h;
  }
  std::free(im.px);
  return ret;
}

void loader_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  pthread_mutex_lock(&L->mu);
  L->stop = true;
  pthread_cond_broadcast(&L->cv_space);
  pthread_mutex_unlock(&L->mu);
  pthread_join(L->worker, nullptr);
  for (int i = 0; i < L->capacity; ++i)
    if (L->ready[i]) std::free(L->slots[i].px);
  delete[] L->slots;
  delete[] L->ready;
  for (long i = 0; i < L->n; ++i) std::free(L->paths[i]);
  std::free(L->paths);
  pthread_mutex_destroy(&L->mu);
  pthread_cond_destroy(&L->cv_ready);
  pthread_cond_destroy(&L->cv_space);
  delete L;
}

}  // extern "C"
