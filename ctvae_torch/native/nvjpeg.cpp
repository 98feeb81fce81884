// The port's JPEG codec on a CUDA card: nvJPEG decode to uint8 RGB and
// encode from it.
//
// The same C interface as `jpeg.cpp` (see there), for machines whose
// toolkit has nvJPEG and whose host has no libjpeg. Files are read and
// written on host threads; the decode and the encode run on the card
// through nvJPEG on a stream of their own (non-blocking, so they do not
// wait for the work torch has queued on its stream), and the pixels come
// back to the host: a batch call returns uint8 [n, h, w, 3] in host
// memory, as the libjpeg build does.
//
// Decode: `nvjpegDecodeBatched` to NVJPEG_OUTPUT_RGBI (grey files come out
// as three equal channels) on the default backend. nvJPEG's inverse DCT
// and chroma upsampling are not libjpeg's, so its pixels differ from
// libjpeg's by a few levels (`tests/torch_jpeg_reference.npz` holds
// libjpeg's). If a batch fails, each file is decoded alone to name the
// ones at fault, and the batch fails.
// Encode: `nvjpegEncodeImage` from NVJPEG_INPUT_RGBI at quality q, 4:2:0
// chroma, no optimised Huffman tables (libjpeg's defaults).
//
// One call at a time: the codec's state, stream and device buffer are
// shared by every caller of the process.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <cuda_runtime.h>
#include <library_types.h>
#include <nvjpeg.h>

namespace {

std::mutex g_call_mu;    // one codec call at a time
std::mutex g_error_mu;
std::string g_error;

void set_error(const std::string& msg) {
  std::lock_guard<std::mutex> lock(g_error_mu);
  g_error = msg;
}

bool nvj_ok(nvjpegStatus_t s, const char* what) {
  if (s == NVJPEG_STATUS_SUCCESS) return true;
  set_error(std::string(what) + ": nvJPEG status " + std::to_string(s));
  return false;
}

bool cuda_ok(cudaError_t e, const char* what) {
  if (e == cudaSuccess) return true;
  set_error(std::string(what) + ": " + cudaGetErrorString(e));
  return false;
}

struct Codec {
  bool ready = false;
  cudaStream_t stream = nullptr;
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t batched = nullptr;   // state of nvjpegDecodeBatched
  nvjpegJpegState_t single = nullptr;    // state of nvjpegDecode
  int batch = 0;             // the batch size `batched` is set up for
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  int quality = -1;
  unsigned char* dev = nullptr;          // pixels of one batch
  size_t dev_bytes = 0;
};

Codec g;

bool init() {
  if (g.ready) return true;
  if (!cuda_ok(cudaStreamCreateWithFlags(&g.stream, cudaStreamNonBlocking),
               "cudaStreamCreateWithFlags") ||
      !nvj_ok(nvjpegCreateSimple(&g.handle), "nvjpegCreateSimple") ||
      !nvj_ok(nvjpegJpegStateCreate(g.handle, &g.batched),
              "nvjpegJpegStateCreate") ||
      !nvj_ok(nvjpegJpegStateCreate(g.handle, &g.single),
              "nvjpegJpegStateCreate") ||
      !nvj_ok(nvjpegEncoderStateCreate(g.handle, &g.enc, g.stream),
              "nvjpegEncoderStateCreate") ||
      !nvj_ok(nvjpegEncoderParamsCreate(g.handle, &g.params, g.stream),
              "nvjpegEncoderParamsCreate") ||
      !nvj_ok(nvjpegEncoderParamsSetSamplingFactors(g.params, NVJPEG_CSS_420,
                                                    g.stream),
              "nvjpegEncoderParamsSetSamplingFactors") ||
      !nvj_ok(nvjpegEncoderParamsSetOptimizedHuffman(g.params, 0, g.stream),
              "nvjpegEncoderParamsSetOptimizedHuffman"))
    return false;
  g.ready = true;
  return true;
}

bool reserve(size_t bytes) {
  if (bytes <= g.dev_bytes) return true;
  if (g.dev != nullptr && !cuda_ok(cudaFree(g.dev), "cudaFree")) return false;
  g.dev = nullptr;
  g.dev_bytes = 0;
  if (!cuda_ok(cudaMalloc(&g.dev, bytes), "cudaMalloc")) return false;
  g.dev_bytes = bytes;
  return true;
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

bool read_file(const char* path, std::vector<unsigned char>* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  data->resize(size > 0 ? static_cast<size_t>(size) : 0);
  bool ok = size > 0 && std::fread(data->data(), 1, data->size(), f) ==
                            data->size();
  std::fclose(f);
  if (!ok) set_error(std::string("cannot read ") + path);
  return ok;
}

// 0, or 2 when `data` is no JPEG nvJPEG reads
int image_size(const std::vector<unsigned char>& data, const char* path,
               int* h, int* w) {
  int comps = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  if (nvjpegGetImageInfo(g.handle, data.data(), data.size(), &comps,
                         &subsampling, widths, heights) !=
      NVJPEG_STATUS_SUCCESS) {
    set_error(std::string(path) + ": not a JPEG nvJPEG reads");
    return 2;
  }
  *h = heights[0];
  *w = widths[0];
  return 0;
}

nvjpegImage_t rgbi(unsigned char* pixels, int w) {
  nvjpegImage_t img;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    img.channel[c] = nullptr;
    img.pitch[c] = 0;
  }
  img.channel[0] = pixels;
  img.pitch[0] = static_cast<size_t>(w) * 3;
  return img;
}

}  // namespace

extern "C" {

const char* ctvae_jpeg_codec() {
  static std::string name;
  std::lock_guard<std::mutex> lock(g_call_mu);
  if (name.empty()) {
    int major = 0, minor = 0, patch = 0;
    nvjpegGetProperty(MAJOR_VERSION, &major);
    nvjpegGetProperty(MINOR_VERSION, &minor);
    nvjpegGetProperty(PATCH_LEVEL, &patch);
    name = "nvJPEG " + std::to_string(major) + "." + std::to_string(minor) +
           "." + std::to_string(patch) + " (default backend)";
  }
  return name.c_str();
}

const char* ctvae_jpeg_error() { return g_error.c_str(); }

int ctvae_jpeg_size(const char* path, int* h, int* w) {
  std::lock_guard<std::mutex> lock(g_call_mu);
  if (!init()) return 3;
  std::vector<unsigned char> data;
  if (!read_file(path, &data)) return 1;
  return image_size(data, path, h, w);
}

int ctvae_decode_jpeg_batch(const char** paths, int n, uint8_t* out, int h,
                            int w, int n_threads, int* status) {
  std::lock_guard<std::mutex> lock(g_call_mu);
  auto fail_all = [&](int code) {
    for (int i = 0; i < n; ++i) status[i] = code;
    return n;
  };
  if (n <= 0) return 0;
  if (!init()) return fail_all(3);
  std::vector<std::vector<unsigned char>> data(n);
  std::atomic<int> failures(0);
  parallel_for(n, n_threads, [&](int i) {
    status[i] = read_file(paths[i], &data[i]) ? 0 : 1;
    if (status[i]) failures.fetch_add(1);
  });
  for (int i = 0; i < n; ++i) {
    if (status[i]) continue;
    int hh = 0, ww = 0;
    status[i] = image_size(data[i], paths[i], &hh, &ww);
    if (!status[i] && (hh != h || ww != w)) {
      set_error(std::string(paths[i]) + " is " + std::to_string(hh) + " x " +
                std::to_string(ww) + ", not " + std::to_string(h) + " x " +
                std::to_string(w));
      status[i] = 2;
    }
    if (status[i]) failures.fetch_add(1);
  }
  if (failures.load()) return failures.load();

  size_t stride = static_cast<size_t>(h) * w * 3;
  if (!reserve(stride * n)) return fail_all(3);
  std::vector<nvjpegImage_t> images(n);
  std::vector<const unsigned char*> ptrs(n);
  std::vector<size_t> lengths(n);
  for (int i = 0; i < n; ++i) {
    images[i] = rgbi(g.dev + i * stride, w);
    ptrs[i] = data[i].data();
    lengths[i] = data[i].size();
  }
  bool ok = true;
  if (g.batch != n) {
    ok = nvj_ok(nvjpegDecodeBatchedInitialize(g.handle, g.batched, n, 1,
                                              NVJPEG_OUTPUT_RGBI),
                "nvjpegDecodeBatchedInitialize");
    g.batch = ok ? n : 0;
  }
  ok = ok && nvj_ok(nvjpegDecodeBatched(g.handle, g.batched, ptrs.data(),
                                        lengths.data(), images.data(),
                                        g.stream),
                    "nvjpegDecodeBatched");
  if (!ok) {
    // name the files at fault: each decoded alone (pixels discarded)
    g.batch = 0;
    std::string batch_error = g_error;
    for (int i = 0; i < n; ++i) {
      if (!nvj_ok(nvjpegDecode(g.handle, g.single, ptrs[i], lengths[i],
                               NVJPEG_OUTPUT_RGBI, &images[i], g.stream),
                  paths[i])) {
        status[i] = 3;
        failures.fetch_add(1);
      }
    }
    cudaStreamSynchronize(g.stream);
    if (failures.load()) return failures.load();
    set_error(batch_error);
    return fail_all(3);
  }
  if (!cuda_ok(cudaMemcpyAsync(out, g.dev, stride * n,
                               cudaMemcpyDeviceToHost, g.stream),
               "cudaMemcpyAsync") ||
      !cuda_ok(cudaStreamSynchronize(g.stream), "nvjpegDecodeBatched"))
    return fail_all(3);
  return 0;
}

int ctvae_encode_jpeg_batch(const uint8_t* images, int n, int h, int w,
                            const char** paths, int quality, int n_threads,
                            int* status) {
  std::lock_guard<std::mutex> lock(g_call_mu);
  auto fail_all = [&](int code) {
    for (int i = 0; i < n; ++i) status[i] = code;
    return n;
  };
  if (n <= 0) return 0;
  if (!init()) return fail_all(3);
  if (g.quality != quality) {
    if (!nvj_ok(nvjpegEncoderParamsSetQuality(g.params, quality, g.stream),
                "nvjpegEncoderParamsSetQuality"))
      return fail_all(3);
    g.quality = quality;
  }
  size_t stride = static_cast<size_t>(h) * w * 3;
  if (!reserve(stride * n) ||
      !cuda_ok(cudaMemcpyAsync(g.dev, images, stride * n,
                               cudaMemcpyHostToDevice, g.stream),
               "cudaMemcpyAsync"))
    return fail_all(3);
  std::vector<std::vector<unsigned char>> bits(n);
  std::atomic<int> failures(0);
  for (int i = 0; i < n; ++i) {
    nvjpegImage_t src = rgbi(g.dev + i * stride, w);
    size_t length = 0;
    bool ok =
        nvj_ok(nvjpegEncodeImage(g.handle, g.enc, g.params, &src,
                                 NVJPEG_INPUT_RGBI, w, h, g.stream),
               "nvjpegEncodeImage") &&
        nvj_ok(nvjpegEncodeRetrieveBitstream(g.handle, g.enc, nullptr,
                                             &length, g.stream),
               "nvjpegEncodeRetrieveBitstream") &&
        cuda_ok(cudaStreamSynchronize(g.stream), "nvjpegEncodeImage");
    if (ok) {
      bits[i].resize(length);
      ok = nvj_ok(nvjpegEncodeRetrieveBitstream(g.handle, g.enc,
                                                bits[i].data(), &length,
                                                g.stream),
                  "nvjpegEncodeRetrieveBitstream") &&
           cuda_ok(cudaStreamSynchronize(g.stream),
                   "nvjpegEncodeRetrieveBitstream");
      bits[i].resize(length);
    }
    status[i] = ok ? 0 : 3;
    if (!ok) failures.fetch_add(1);
  }
  parallel_for(n, n_threads, [&](int i) {
    if (status[i]) return;
    std::string tmp = std::string(paths[i]) + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    bool ok = f != nullptr &&
              std::fwrite(bits[i].data(), 1, bits[i].size(), f) ==
                  bits[i].size();
    if (f != nullptr) ok = std::fclose(f) == 0 && ok;
    ok = ok && std::rename(tmp.c_str(), paths[i]) == 0;
    if (!ok) {
      std::remove(tmp.c_str());
      set_error(std::string("cannot write ") + paths[i]);
      status[i] = 4;
      failures.fetch_add(1);
    }
  });
  return failures.load();
}

}  // extern "C"
