// The port's JPEG codec on the host: libjpeg decode to uint8 RGB and
// encode from it, threaded over a batch of files.
//
// The decode is the JAX package's `decode_jpeg` (out_color_space =
// JCS_RGB, so grey and YCbCr files both come out as three channels, with
// libjpeg's default DCT and upsampling). Crop and resize are not done
// here: the port's `data/transforms.py` takes the decoded uint8 batch.
// The encode is libjpeg's compressor with `jpeg_set_defaults` and
// `jpeg_set_quality(q)`: 4:2:0 chroma, no optimised Huffman tables, as
// PIL's `save(path, quality=q)` writes.
//
// C interface (ctypes, `ctvae_torch/native/__init__.py`); the nvJPEG
// build (`nvjpeg.cpp`) exports the same functions:
//   ctvae_jpeg_codec        -> "libjpeg <JPEG_LIB_VERSION> ..."
//   ctvae_jpeg_error        -> the last failure's message
//   ctvae_jpeg_size         path -> height, width (header only)
//   ctvae_decode_jpeg_batch paths -> uint8 [n, h, w, 3] (each file h x w)
//   ctvae_encode_jpeg_batch uint8 [n, h, w, 3] -> files at quality q
// A batch call returns the number of files that failed and sets status[i]
// to nonzero for each of them (1: open / read, 2: header or size, 3:
// decode or encode, 4: write).

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

// the last failure's message, from whichever thread of a batch failed
std::mutex g_error_mu;
std::string g_error;

void set_error(const std::string& msg) {
  std::lock_guard<std::mutex> lock(g_error_mu);
  g_error = msg;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  char msg[JMSG_LENGTH_MAX];
  (*cinfo->err->format_message)(cinfo, msg);
  set_error(msg);
  longjmp(err->jb, 1);
}

void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  n_threads = std::max(1, std::min(n_threads, n));
  if (n_threads == 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t)
    pool.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  for (auto& th : pool) th.join();
}

// Decodes `path` into `out` (h x w x 3, RGB) when its size is (h, w);
// with out == nullptr reads the header alone and sets *h, *w. Returns 0 or
// the status code of the failure.
int decode_jpeg(const char* path, uint8_t* out, int* h, int* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return 1;
  }
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  volatile int stage = 2;   // read after the longjmp
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return stage;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  if (out == nullptr) {
    *h = static_cast<int>(cinfo.image_height);
    *w = static_cast<int>(cinfo.image_width);
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 0;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != *h ||
      static_cast<int>(cinfo.output_width) != *w ||
      cinfo.output_components != 3) {
    set_error(std::string(path) + " is " +
              std::to_string(cinfo.output_height) + " x " +
              std::to_string(cinfo.output_width) + " x " +
              std::to_string(cinfo.output_components) + ", not " +
              std::to_string(*h) + " x " + std::to_string(*w) + " x 3");
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  stage = 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

int encode_jpeg(const uint8_t* rgb, int h, int w, const char* path,
                int quality) {
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) {
    set_error("cannot write " + tmp);
    return 4;
  }
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(f);
    std::remove(tmp.c_str());
    return 3;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(
        rgb + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  if (std::fclose(f) != 0 || std::rename(tmp.c_str(), path) != 0) {
    set_error(std::string("cannot write ") + path);
    return 4;
  }
  return 0;
}

#define CTVAE_STR2(x) #x
#define CTVAE_STR(x) CTVAE_STR2(x)

}  // namespace

extern "C" {

const char* ctvae_jpeg_codec() {
#ifdef LIBJPEG_TURBO_VERSION
  return "libjpeg " CTVAE_STR(JPEG_LIB_VERSION) " (libjpeg-turbo "
         CTVAE_STR(LIBJPEG_TURBO_VERSION) ")";
#else
  return "libjpeg " CTVAE_STR(JPEG_LIB_VERSION);
#endif
}

const char* ctvae_jpeg_error() { return g_error.c_str(); }

int ctvae_jpeg_size(const char* path, int* h, int* w) {
  return decode_jpeg(path, nullptr, h, w);
}

int ctvae_decode_jpeg_batch(const char** paths, int n, uint8_t* out, int h,
                            int w, int n_threads, int* status) {
  std::atomic<int> failures(0);
  size_t stride = static_cast<size_t>(h) * w * 3;
  parallel_for(n, n_threads, [&](int i) {
    int hh = h, ww = w;
    status[i] = decode_jpeg(paths[i], out + i * stride, &hh, &ww);
    if (status[i]) failures.fetch_add(1);
  });
  return failures.load();
}

int ctvae_encode_jpeg_batch(const uint8_t* images, int n, int h, int w,
                            const char** paths, int quality, int n_threads,
                            int* status) {
  std::atomic<int> failures(0);
  size_t stride = static_cast<size_t>(h) * w * 3;
  parallel_for(n, n_threads, [&](int i) {
    status[i] = encode_jpeg(images + i * stride, h, w, paths[i], quality);
    if (status[i]) failures.fetch_add(1);
  });
  return failures.load();
}

}  // extern "C"
