// Native batch image loader for the SIFT/SLAM framework.
//
// The reference implementation is pure JavaScript with no native
// components (SURVEY.md §2); this framework's compute path is JAX/XLA on
// the accelerator, and the runtime around it is native where that pays. Host-side
// image decode + grayscale conversion is the frame-ingest bottleneck for
// sequence processing (PIL decodes one image per GIL at a time), so this
// loader decodes PNG/PGM/PPM/BMP and converts RGB→gray with the EXACT
// reference weights ((r*0.299 + g*0.587 + b*0.114)/255,
// reference/src/image-utils.js:107-114) across a pthread pool. PNG is
// the format that matters in practice — KITTI odometry and TUM-RGBD
// sequences ship 8-bit gray/RGB (+16-bit depth) PNGs — decoded here
// with a from-scratch chunk parser + zlib inflate + per-scanline
// unfiltering (no libpng dependency).
//
// C ABI (ctypes-friendly); all functions return 0 on success, negative
// error codes otherwise. Build: see native/build.sh (g++ -O3 -shared).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <pthread.h>
#include <zlib.h>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;      // 1 or 3
  int maxval = 255;      // PNM maxval (<= 255); 16-bit PNG: 65535
  int bytes_per_sample = 1;  // 2 for 16-bit PNG (big-endian samples)
  unsigned char* data = nullptr;  // row-major, interleaved
};

int read_file(const char* path, unsigned char** out, long* size) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  *size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  *out = static_cast<unsigned char*>(std::malloc(*size));
  if (!*out) { std::fclose(f); return -2; }
  if (std::fread(*out, 1, *size, f) != static_cast<size_t>(*size)) {
    std::free(*out);
    std::fclose(f);
    return -3;
  }
  std::fclose(f);
  return 0;
}

// Skip PNM whitespace + '#' comments.
long pnm_token(const unsigned char* b, long size, long pos, long* value) {
  while (pos < size) {
    if (b[pos] == '#') {
      while (pos < size && b[pos] != '\n') pos++;
    } else if (b[pos] == ' ' || b[pos] == '\t' || b[pos] == '\n' ||
               b[pos] == '\r') {
      pos++;
    } else {
      break;
    }
  }
  long v = 0;
  bool any = false;
  while (pos < size && b[pos] >= '0' && b[pos] <= '9') {
    v = v * 10 + (b[pos] - '0');
    pos++;
    any = true;
  }
  if (!any) return -1;
  *value = v;
  return pos;
}

int decode_pnm(const unsigned char* buf, long size, Image* img) {
  if (size < 2 || buf[0] != 'P') return -10;
  int kind = buf[1] - '0';
  if (kind != 5 && kind != 6) return -11;  // binary PGM / PPM only
  long w, h, maxv;
  long pos = 2;
  pos = pnm_token(buf, size, pos, &w);
  if (pos < 0) return -12;
  pos = pnm_token(buf, size, pos, &h);
  if (pos < 0) return -12;
  pos = pnm_token(buf, size, pos, &maxv);
  if (pos < 0 || maxv < 1 || maxv > 255) return -13;
  pos++;  // single whitespace after maxval
  img->maxval = static_cast<int>(maxv);
  int ch = (kind == 5) ? 1 : 3;
  long need = w * h * ch;
  if (size - pos < need) return -14;
  img->width = static_cast<int>(w);
  img->height = static_cast<int>(h);
  img->channels = ch;
  img->data = static_cast<unsigned char*>(std::malloc(need));
  if (!img->data) return -2;
  std::memcpy(img->data, buf + pos, need);
  return 0;
}

uint32_t rd32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

int decode_bmp(const unsigned char* buf, long size, Image* img) {
  if (size < 54 || buf[0] != 'B' || buf[1] != 'M') return -20;
  uint32_t off = rd32(buf + 10);
  int32_t w = static_cast<int32_t>(rd32(buf + 18));
  int32_t h = static_cast<int32_t>(rd32(buf + 22));
  uint16_t bpp = buf[28] | (buf[29] << 8);
  uint32_t comp = rd32(buf + 30);
  if (comp != 0 || (bpp != 24 && bpp != 32)) return -21;  // uncompressed only
  bool flip = h > 0;
  int ah = h > 0 ? h : -h;
  int bytes = bpp / 8;
  long stride = ((w * bytes + 3) / 4) * 4;
  if (static_cast<long>(off) + stride * ah > size) return -22;
  img->width = w;
  img->height = ah;
  img->channels = 3;
  img->data = static_cast<unsigned char*>(std::malloc(3L * w * ah));
  if (!img->data) return -2;
  for (int y = 0; y < ah; y++) {
    const unsigned char* row = buf + off + stride * (flip ? (ah - 1 - y) : y);
    unsigned char* dst = img->data + 3L * w * y;
    for (int x = 0; x < w; x++) {
      dst[3 * x + 0] = row[bytes * x + 2];  // BGR → RGB
      dst[3 * x + 1] = row[bytes * x + 1];
      dst[3 * x + 2] = row[bytes * x + 0];
    }
  }
  return 0;
}

// ---- PNG ------------------------------------------------------------
//
// Minimal but complete decoder for the PNG subset real datasets use:
// non-interlaced, bit depth 8 (all color types incl. palette) and 16
// (gray / RGB — TUM depth maps are 16-bit gray). All five scanline
// filters. CRCs are not verified (decode robustness, not integrity, is
// the job here); zlib verifies the IDAT adler32.

uint32_t rd32be(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

int decode_png(const unsigned char* buf, long size, Image* img) {
  static const unsigned char kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 8 + 25 || std::memcmp(buf, kSig, 8) != 0) return -50;

  long pos = 8;
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  unsigned char palette[256][3];
  int palette_size = 0;
  unsigned char* idat = nullptr;
  long idat_size = 0, idat_cap = 0;
  bool seen_ihdr = false, seen_iend = false;

  while (pos + 8 <= size && !seen_iend) {
    uint32_t len = rd32be(buf + pos);
    const unsigned char* type = buf + pos + 4;
    const unsigned char* payload = buf + pos + 8;
    if (pos + 12 + static_cast<long>(len) > size) { std::free(idat); return -51; }
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) { std::free(idat); return -51; }
      w = rd32be(payload);
      h = rd32be(payload + 4);
      depth = payload[8];
      color = payload[9];
      interlace = payload[12];
      seen_ihdr = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      palette_size = static_cast<int>(len / 3);
      if (palette_size > 256) palette_size = 256;
      std::memcpy(palette, payload, static_cast<size_t>(palette_size) * 3);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (idat_size + len > idat_cap) {
        idat_cap = (idat_size + len) * 2;
        unsigned char* grown =
            static_cast<unsigned char*>(std::realloc(idat, idat_cap));
        if (!grown) { std::free(idat); return -2; }
        idat = grown;
      }
      std::memcpy(idat + idat_size, payload, len);
      idat_size += len;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      seen_iend = true;
    }
    pos += 12 + len;  // len + type + payload + crc
  }
  if (!seen_ihdr || idat == nullptr || w == 0 || h == 0) {
    std::free(idat);
    return -52;
  }
  if (interlace != 0) { std::free(idat); return -53; }  // Adam7 unsupported
  int samples;  // samples per pixel before palette expansion
  switch (color) {
    case 0: samples = 1; break;  // gray
    case 2: samples = 3; break;  // RGB
    case 3: samples = 1; break;  // palette index
    case 4: samples = 2; break;  // gray + alpha
    case 6: samples = 4; break;  // RGBA
    default: std::free(idat); return -54;
  }
  if (depth != 8 && !(depth == 16 && (color == 0 || color == 2))) {
    std::free(idat);
    return -55;
  }
  if (color == 3 && palette_size == 0) { std::free(idat); return -56; }

  int bytes_per_sample = depth / 8;
  long bpp = static_cast<long>(samples) * bytes_per_sample;  // filter delta
  long row_bytes = bpp * w;
  unsigned long raw_size =
      static_cast<unsigned long>((row_bytes + 1) * h);
  unsigned char* raw = static_cast<unsigned char*>(std::malloc(raw_size));
  if (!raw) { std::free(idat); return -2; }
  unsigned long out_len = raw_size;
  int zrc = uncompress(raw, &out_len, idat, idat_size);
  std::free(idat);
  if (zrc != Z_OK || out_len != raw_size) { std::free(raw); return -57; }

  // Unfilter in place (scanline layout: filter byte + row).
  unsigned char* prev = nullptr;
  for (uint32_t y = 0; y < h; y++) {
    unsigned char* line = raw + y * (row_bytes + 1);
    int filter = line[0];
    unsigned char* cur = line + 1;
    switch (filter) {
      case 0:
        break;
      case 1:  // Sub
        for (long i = bpp; i < row_bytes; i++) cur[i] += cur[i - bpp];
        break;
      case 2:  // Up
        if (prev)
          for (long i = 0; i < row_bytes; i++) cur[i] += prev[i];
        break;
      case 3:  // Average
        for (long i = 0; i < row_bytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          cur[i] += static_cast<unsigned char>((a + b) / 2);
        }
        break;
      case 4:  // Paeth
        for (long i = 0; i < row_bytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] += static_cast<unsigned char>(paeth(a, b, c));
        }
        break;
      default:
        std::free(raw);
        return -58;
    }
    prev = cur;
  }

  // Assemble the output image: gray or RGB, dropping alpha, expanding
  // palette, keeping 16-bit big-endian samples when present.
  int out_ch = (color == 2 || color == 3 || color == 6) ? 3 : 1;
  long n_px = static_cast<long>(w) * h;
  img->width = static_cast<int>(w);
  img->height = static_cast<int>(h);
  img->channels = out_ch;
  img->bytes_per_sample = bytes_per_sample;
  img->maxval = depth == 16 ? 65535 : 255;
  img->data = static_cast<unsigned char*>(
      std::malloc(n_px * out_ch * bytes_per_sample));
  if (!img->data) { std::free(raw); return -2; }
  for (uint32_t y = 0; y < h; y++) {
    const unsigned char* src = raw + y * (row_bytes + 1) + 1;
    unsigned char* dst =
        img->data + static_cast<long>(y) * w * out_ch * bytes_per_sample;
    if (color == 3) {
      for (uint32_t x = 0; x < w; x++) {
        int idx = src[x];
        if (idx >= palette_size) idx = 0;
        dst[3 * x + 0] = palette[idx][0];
        dst[3 * x + 1] = palette[idx][1];
        dst[3 * x + 2] = palette[idx][2];
      }
    } else if (color == 4) {  // gray+alpha → gray
      for (uint32_t x = 0; x < w; x++) dst[x] = src[2 * x];
    } else if (color == 6) {  // RGBA → RGB
      for (uint32_t x = 0; x < w; x++) {
        dst[3 * x + 0] = src[4 * x + 0];
        dst[3 * x + 1] = src[4 * x + 1];
        dst[3 * x + 2] = src[4 * x + 2];
      }
    } else {  // gray8 / gray16 / RGB8 / RGB16: straight copy
      std::memcpy(dst, src, row_bytes);
    }
  }
  std::free(raw);
  return 0;
}

int decode_any(const unsigned char* buf, long size, Image* img) {
  if (size >= 8 && buf[0] == 137 && buf[1] == 'P' && buf[2] == 'N' &&
      buf[3] == 'G')
    return decode_png(buf, size, img);
  if (size >= 2 && buf[0] == 'P') return decode_pnm(buf, size, img);
  if (size >= 2 && buf[0] == 'B' && buf[1] == 'M')
    return decode_bmp(buf, size, img);
  return -30;
}

void to_gray(const Image& img, float* out) {
  long n = static_cast<long>(img.width) * img.height;
  const double maxv = static_cast<double>(img.maxval);
  if (img.bytes_per_sample == 2) {  // 16-bit PNG, big-endian samples
    if (img.channels == 1) {
      for (long i = 0; i < n; i++) {
        const unsigned char* p = img.data + 2 * i;
        out[i] = static_cast<float>(((p[0] << 8) | p[1]) / maxv);
      }
    } else {
      for (long i = 0; i < n; i++) {
        const unsigned char* p = img.data + 6 * i;
        double r = (p[0] << 8) | p[1];
        double g = (p[2] << 8) | p[3];
        double b = (p[4] << 8) | p[5];
        out[i] = static_cast<float>(
            ((r * 0.299) + (g * 0.587) + (b * 0.114)) / maxv);
      }
    }
    return;
  }
  if (img.channels == 1) {
    for (long i = 0; i < n; i++)
      out[i] = static_cast<float>(img.data[i] / maxv);
  } else {
    for (long i = 0; i < n; i++) {
      const unsigned char* p = img.data + 3 * i;
      // Exact reference expression (image-utils.js:107-114), scaled by
      // the file's actual maxval (PNM permits any value <= 255).
      out[i] = static_cast<float>(
          ((p[0] * 0.299) + (p[1] * 0.587) + (p[2] * 0.114)) / maxv);
    }
  }
}

struct Job {
  const char* const* paths;
  float* out;       // (n, h, w)
  int* statuses;    // (n,)
  int n, width, height;
  pthread_mutex_t lock;
  int next;
};

void* worker(void* arg) {
  Job* job = static_cast<Job*>(arg);
  for (;;) {
    pthread_mutex_lock(&job->lock);
    int i = job->next++;
    pthread_mutex_unlock(&job->lock);
    if (i >= job->n) break;

    unsigned char* buf = nullptr;
    long size = 0;
    int rc = read_file(job->paths[i], &buf, &size);
    Image img;
    if (rc == 0) {
      rc = decode_any(buf, size, &img);
      std::free(buf);
    }
    if (rc == 0 && (img.width != job->width || img.height != job->height)) {
      rc = -40;  // size mismatch with the batch
    }
    if (rc == 0) {
      to_gray(img, job->out + static_cast<long>(i) * job->width * job->height);
    }
    std::free(img.data);
    job->statuses[i] = rc;
  }
  return nullptr;
}

// ---------------------------------------------------------------------------
// Streaming prefetcher: an ordered ring of decoded frames filled by a
// pthread pool ahead of the consumer. The online SLAM session
// (models/streaming.py) ingests one frame at a time; without a
// prefetcher the disk decode serializes with the device work. Workers
// claim frame indices in order and may fill ring slot (i % depth) once
// the consumer has emitted frame i - depth; the consumer blocks on the
// ring slot of the next in-order frame.
struct Stream {
  char** paths = nullptr;  // owned copies
  int n = 0, width = 0, height = 0, depth = 0, nthreads = 0;
  float* ring = nullptr;   // depth * h * w
  int* slot_status = nullptr;  // decode rc per slot (valid when ready)
  bool* slot_ready = nullptr;
  pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
  pthread_cond_t cv_prod = PTHREAD_COND_INITIALIZER;
  pthread_cond_t cv_cons = PTHREAD_COND_INITIALIZER;
  int next_fill = 0;  // next frame index a worker will claim
  int next_emit = 0;  // next frame index the consumer will take
  bool closed = false;
  pthread_t tids[64];
};

void* stream_worker(void* arg) {
  Stream* s = static_cast<Stream*>(arg);
  for (;;) {
    pthread_mutex_lock(&s->mu);
    if (s->closed || s->next_fill >= s->n) {
      pthread_mutex_unlock(&s->mu);
      break;
    }
    int mine = s->next_fill++;
    // Wait until the slot's previous occupant (mine - depth) was taken.
    while (!s->closed && mine - s->next_emit >= s->depth)
      pthread_cond_wait(&s->cv_prod, &s->mu);
    bool closed = s->closed;
    pthread_mutex_unlock(&s->mu);
    if (closed) break;

    unsigned char* buf = nullptr;
    long size = 0;
    int rc = read_file(s->paths[mine], &buf, &size);
    Image img;
    if (rc == 0) {
      rc = decode_any(buf, size, &img);
      std::free(buf);
    }
    if (rc == 0 && (img.width != s->width || img.height != s->height))
      rc = -40;
    int slot = mine % s->depth;
    if (rc == 0)
      to_gray(img,
              s->ring + static_cast<long>(slot) * s->width * s->height);
    std::free(img.data);

    pthread_mutex_lock(&s->mu);
    s->slot_status[slot] = rc;
    s->slot_ready[slot] = true;
    pthread_cond_broadcast(&s->cv_cons);
    pthread_mutex_unlock(&s->mu);
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Open a prefetching stream over n same-sized images. `depth` frames
// are decoded ahead across `threads` pthreads. Returns an opaque
// handle (NULL on allocation failure).
void* sift_io_stream_open(const char* const* paths, int n, int width,
                          int height, int threads, int depth) {
  if (n <= 0 || depth < 1) return nullptr;
  Stream* s = new (std::nothrow) Stream();
  if (!s) return nullptr;
  if (depth > n) depth = n;
  if (threads < 1) threads = 1;
  if (threads > depth) threads = depth;
  if (threads > 64) threads = 64;
  s->n = n;
  s->width = width;
  s->height = height;
  s->depth = depth;
  s->nthreads = threads;
  s->paths = static_cast<char**>(std::malloc(sizeof(char*) * n));
  for (int i = 0; i < n; i++) s->paths[i] = strdup(paths[i]);
  s->ring = static_cast<float*>(
      std::malloc(sizeof(float) * static_cast<long>(depth) * width * height));
  s->slot_status = static_cast<int*>(std::calloc(depth, sizeof(int)));
  s->slot_ready = static_cast<bool*>(std::calloc(depth, sizeof(bool)));
  if (!s->paths || !s->ring || !s->slot_status || !s->slot_ready) {
    delete s;
    return nullptr;
  }
  for (int t = 0; t < threads; t++)
    pthread_create(&s->tids[t], nullptr, stream_worker, s);
  return s;
}

// Block until the next in-order frame is decoded; copy it into `out`
// (h*w floats). Returns the frame index, -1 past the end, or the
// negative decode error code for that frame (the stream then advances).
int sift_io_stream_next(void* handle, float* out) {
  Stream* s = static_cast<Stream*>(handle);
  pthread_mutex_lock(&s->mu);
  if (s->next_emit >= s->n) {
    pthread_mutex_unlock(&s->mu);
    return -1;
  }
  int idx = s->next_emit;
  int slot = idx % s->depth;
  while (!s->slot_ready[slot]) pthread_cond_wait(&s->cv_cons, &s->mu);
  int rc = s->slot_status[slot];
  if (rc == 0)
    std::memcpy(out,
                s->ring + static_cast<long>(slot) * s->width * s->height,
                sizeof(float) * static_cast<long>(s->width) * s->height);
  s->slot_ready[slot] = false;
  s->next_emit++;
  pthread_cond_broadcast(&s->cv_prod);
  pthread_mutex_unlock(&s->mu);
  return rc == 0 ? idx : rc;
}

// Stop workers and free the stream.
void sift_io_stream_close(void* handle) {
  Stream* s = static_cast<Stream*>(handle);
  pthread_mutex_lock(&s->mu);
  s->closed = true;
  pthread_cond_broadcast(&s->cv_prod);
  pthread_cond_broadcast(&s->cv_cons);
  pthread_mutex_unlock(&s->mu);
  for (int t = 0; t < s->nthreads; t++) pthread_join(s->tids[t], nullptr);
  for (int i = 0; i < s->n; i++) std::free(s->paths[i]);
  std::free(s->paths);
  std::free(s->ring);
  std::free(s->slot_status);
  std::free(s->slot_ready);
  delete s;
}

// Probe an image's dimensions. Returns 0 and fills (w, h) on success.
int sift_io_probe(const char* path, int* width, int* height) {
  unsigned char* buf = nullptr;
  long size = 0;
  int rc = read_file(path, &buf, &size);
  if (rc != 0) return rc;
  Image img;
  rc = decode_any(buf, size, &img);
  std::free(buf);
  if (rc != 0) return rc;
  *width = img.width;
  *height = img.height;
  std::free(img.data);
  return 0;
}

// Load n same-sized images as float32 grayscale in [0,1] into out
// (n*h*w floats), decoding across `threads` pthreads. statuses[i] gets
// the per-image result code. Returns 0 iff every image succeeded.
int sift_io_load_batch_gray(const char* const* paths, int n, int width,
                            int height, int threads, float* out,
                            int* statuses) {
  if (n <= 0) return 0;
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  Job job{paths, out, statuses, n, width, height,
          PTHREAD_MUTEX_INITIALIZER, 0};
  pthread_t tids[64];
  if (threads > 64) threads = 64;
  for (int t = 0; t < threads; t++)
    pthread_create(&tids[t], nullptr, worker, &job);
  for (int t = 0; t < threads; t++) pthread_join(tids[t], nullptr);
  int rc = 0;
  for (int i = 0; i < n; i++)
    if (statuses[i] != 0) rc = statuses[i];
  return rc;
}

}  // extern "C"
