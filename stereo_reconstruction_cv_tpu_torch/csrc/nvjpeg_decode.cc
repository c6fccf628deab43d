// JPEG decode with nvJPEG (CUDA toolkit) for the data loader.
//
// The reference decodes its frames on the host with libjpeg
// (native/jpeg_loader.cc, stereo_reconstruction_cv_tpu/native.py:119). Where
// libjpeg's headers are absent, the port decodes with nvJPEG instead: the
// Huffman stage on the host, the inverse DCT on the card. The contract is
// the reference's: JPEG bytes in, uint8 pixels out into a caller's host
// buffer, gray = the luma plane (libjpeg's JCS_GRAYSCALE, nvJPEG's
// NVJPEG_OUTPUT_Y) or interleaved RGB. The pixels go back to the host so that
// the loader's host-to-device copy is the same whatever the decoder.
//
// A Decoder holds nvJPEG's handle and decode state, a stream and a device
// buffer that grows to the largest frame; one thread uses it at a time (the
// caller keeps a pool of them). Every entry point returns 0 on success, else
// kind * 1000 + code: kind 1 = the data (nvJPEG found the bytes bad or
// unsupported), 2 = another nvJPEG status, 3 = a CUDA error.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* pixels = nullptr;
  size_t capacity = 0;
};

int nvjpeg_code(nvjpegStatus_t st) {
  if (st == NVJPEG_STATUS_SUCCESS) return 0;
  const bool data = st == NVJPEG_STATUS_BAD_JPEG || st == NVJPEG_STATUS_JPEG_NOT_SUPPORTED ||
                    st == NVJPEG_STATUS_INCOMPLETE_BITSTREAM ||
                    st == NVJPEG_STATUS_INVALID_PARAMETER;
  return (data ? 1000 : 2000) + static_cast<int>(st);
}

int cuda_code(cudaError_t e) { return e == cudaSuccess ? 0 : 3000 + static_cast<int>(e); }

void release(Decoder* d) {
  if (d->pixels) cudaFree(d->pixels);
  if (d->stream) cudaStreamDestroy(d->stream);
  if (d->state) nvjpegJpegStateDestroy(d->state);
  if (d->handle) nvjpegDestroy(d->handle);
  delete d;
}

int image_info(Decoder* d, const unsigned char* data, size_t size, int* h, int* w,
               int* channels) {
  int nc = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  const int rc = nvjpeg_code(nvjpegGetImageInfo(d->handle, data, size, &nc, &sub, widths,
                                                heights));
  if (rc) return rc;
  *h = heights[0];
  *w = widths[0];
  *channels = nc;
  return 0;
}

}  // namespace

extern "C" {

// A new Decoder on the current CUDA device, written to *out.
int srcv_nvjpeg_create(void** out) {
  Decoder* d = new Decoder();
  int rc = nvjpeg_code(nvjpegCreateSimple(&d->handle));
  if (!rc) rc = nvjpeg_code(nvjpegJpegStateCreate(d->handle, &d->state));
  if (!rc) rc = cuda_code(cudaStreamCreateWithFlags(&d->stream, cudaStreamNonBlocking));
  if (rc) {
    release(d);
    return rc;
  }
  *out = d;
  return 0;
}

int srcv_nvjpeg_destroy(void* decoder) {
  release(static_cast<Decoder*>(decoder));
  return 0;
}

// Header only: (h, w, components).
int srcv_nvjpeg_info(void* decoder, const uint8_t* data, size_t size, int* h, int* w,
                     int* channels) {
  return image_info(static_cast<Decoder*>(decoder), data, size, h, w, channels);
}

// Decode into `out`, a host buffer of h * w (gray) or h * w * 3 bytes.
// Returns once the pixels are in `out`.
int srcv_nvjpeg_decode(void* decoder, const uint8_t* data, size_t size, uint8_t* out,
                       int gray) {
  Decoder* d = static_cast<Decoder*>(decoder);
  int h = 0, w = 0, nc = 0;
  int rc = image_info(d, data, size, &h, &w, &nc);
  if (rc) return rc;
  const size_t pitch = static_cast<size_t>(w) * (gray ? 1 : 3);
  const size_t bytes = pitch * static_cast<size_t>(h);
  if (bytes > d->capacity) {
    if (d->pixels) cudaFree(d->pixels);
    d->pixels = nullptr;
    d->capacity = 0;
    rc = cuda_code(cudaMalloc(&d->pixels, bytes));
    if (rc) return rc;
    d->capacity = bytes;
  }
  nvjpegImage_t image = {};
  image.channel[0] = d->pixels;
  image.pitch[0] = pitch;
  rc = nvjpeg_code(nvjpegDecode(d->handle, d->state, data, size,
                                gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &image, d->stream));
  if (rc) return rc;
  rc = cuda_code(cudaMemcpyAsync(out, d->pixels, bytes, cudaMemcpyDeviceToHost, d->stream));
  if (rc) return rc;
  return cuda_code(cudaStreamSynchronize(d->stream));
}

}  // extern "C"
