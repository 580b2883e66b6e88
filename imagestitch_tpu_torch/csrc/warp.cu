// Rotation warp of N images into N shared-frame canvases in one launch:
// per canvas pixel the backward map (cylindrical, spherical or plane, the
// kind as data), the K·R⁻¹ projection with z > 0, the ROI-rectangle test,
// the in-image test on each image's true size, and a bilinear sample of C
// channels with clamped taps; invalid pixels are written as zero.
//
// Replaces the TPU kernel imagestitch_tpu/ops/pallas_warp.py:
// pallas_warp_batched (body _warp_kernel). It follows the JAX package's
// XLA path (warp/warper.py), not the TPU kernel's slab schedule: no slab or
// shift-window clipping, so pixels the TPU kernel invalidates when their
// footprint overflows its slab (pallas_warp.py:197-200) stay valid here.
//
// Bound on an H100 (3.35 TB/s): at the main-path shapes (N=2,
// 1080x1920x3 into 1458x4032) it must read the ~50 MB of sources once and
// write ~141 MB of canvases plus ~12 MB of masks — about 60 µs of memory
// traffic. Its operations (two sincos, a divide and ~40 flops per pixel)
// stay below that, so the bound is the bytes.
//
// Design, simple first: one thread per canvas pixel of one image, blocks
// of 32x8 pixels. A block whose tile lies wholly outside the image's ROI
// writes zeros and returns before any trigonometry (u depends only on the
// column and v only on the row, so testing the tile's corners is exact).
// Sources are read directly through the L1/L2 caches; the bilinear
// footprints of neighbouring threads overlap, so most taps hit in cache.
// sinf/cosf and the divides are the accurate ones (no fast math): at
// u/scale ~ 1 rad and a focal of ~2000 px an intrinsic's error moves taps
// by whole pixels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr float PI_F = 3.14159265358979323846f;

// per-image parameters, float: k_rinv (9, row-major), scale, u0, v0, u1,
// v1, kind (0 cylindrical, 1 spherical, 2 plane), unused
constexpr int NF = 16;
// per-image parameters, int: corner x, corner y, true height, true width
constexpr int NI = 4;

__global__ void __launch_bounds__(BX * BY)
warp_kernel(const float* __restrict__ src, float* __restrict__ out,
            uint8_t* __restrict__ valid, const float* __restrict__ fpar,
            const int* __restrict__ ipar, int H, int W, int C, int Hc,
            int Wc) {
  const int n = blockIdx.z;
  const float* fp = fpar + n * NF;
  const int* ip = ipar + n * NI;
  const float cx = static_cast<float>(ip[0]);
  const float cy = static_cast<float>(ip[1]);
  const int h = ip[2], w = ip[3];
  const float u0 = fp[10], v0 = fp[11], u1 = fp[12], v1 = fp[13];

  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const bool inside = x < Wc && y < Hc;
  const size_t pix = (static_cast<size_t>(n) * Hc + y) * Wc + x;

  // whole-tile ROI test on the tile's corners
  const float tu_lo = static_cast<float>(blockIdx.x * BX) + cx;
  const float tv_lo = static_cast<float>(blockIdx.y * BY) + cy;
  const bool live = (tu_lo + (BX - 1) >= u0 - 1.0f) && (tu_lo <= u1 + 1.0f)
                    && (tv_lo + (BY - 1) >= v0 - 1.0f)
                    && (tv_lo <= v1 + 1.0f);
  if (!live) {
    if (inside) {
      for (int c = 0; c < C; ++c) out[pix * C + c] = 0.0f;
      valid[pix] = 0;
    }
    return;
  }
  if (!inside) return;

  const float u = static_cast<float>(x) + cx;
  const float v = static_cast<float>(y) + cy;
  const float scale = fp[9];
  const int kind = static_cast<int>(fp[14]);
  const float us = u / scale;
  const float vs = v / scale;
  float X, Y, Z;
  if (kind == 0) {
    X = sinf(us);
    Y = vs;
    Z = cosf(us);
  } else if (kind == 1) {
    const float sv = sinf(PI_F - vs);
    X = sv * sinf(us);
    Y = cosf(PI_F - vs);
    Z = sv * cosf(us);
  } else {
    X = us;
    Y = vs;
    Z = 1.0f;
  }
  const float px = fp[0] * X + fp[1] * Y + fp[2] * Z;
  const float py = fp[3] * X + fp[4] * Y + fp[5] * Z;
  const float pz = fp[6] * X + fp[7] * Y + fp[8] * Z;
  const bool ray_ok = pz > 0.0f;
  const float pzs = fabsf(pz) < 1e-12f ? 1e-12f : pz;
  const float xs = px / pzs;
  const float ys = py / pzs;

  const bool in_roi = u >= u0 - 1.0f && u <= u1 + 1.0f && v >= v0 - 1.0f
                      && v <= v1 + 1.0f;
  const bool in_img = xs >= 0.0f && xs <= static_cast<float>(w - 1)
                      && ys >= 0.0f && ys <= static_cast<float>(h - 1);
  const bool ok = ray_ok && in_roi && in_img;
  float* o = out + pix * C;
  valid[pix] = ok ? 1 : 0;
  if (!ok) {
    for (int c = 0; c < C; ++c) o[c] = 0.0f;
    return;
  }

  const float fx0 = floorf(xs), fy0 = floorf(ys);
  const float fx = xs - fx0, fy = ys - fy0;
  const int xa = min(max(static_cast<int>(fx0), 0), w - 1);
  const int xb = min(max(static_cast<int>(fx0) + 1, 0), w - 1);
  const int ya = min(max(static_cast<int>(fy0), 0), h - 1);
  const int yb = min(max(static_cast<int>(fy0) + 1, 0), h - 1);
  const float* img = src + static_cast<size_t>(n) * H * W * C;
  const float* ra = img + static_cast<size_t>(ya) * W * C;
  const float* rb = img + static_cast<size_t>(yb) * W * C;
  for (int c = 0; c < C; ++c) {
    const float ia = __ldg(ra + xa * C + c), ib = __ldg(ra + xb * C + c);
    const float ic = __ldg(rb + xa * C + c), id = __ldg(rb + xb * C + c);
    const float top = ia + (ib - ia) * fx;
    const float bot = ic + (id - ic) * fx;
    o[c] = top + (bot - top) * fy;
  }
}

}  // namespace

// src: (N, H, W, C) float32; out: (N, Hc, Wc, C) float32; valid: (N, Hc,
// Wc) bool (one byte each); fpar: (N, 16) float32 and ipar: (N, 4) int32
// per-image parameters as laid out above — all contiguous on the device.
extern "C" int imagestitch_warp(const float* src, float* out, uint8_t* valid,
                                const float* fpar, const int* ipar, int N,
                                int H, int W, int C, int Hc, int Wc,
                                cudaStream_t stream) {
  const dim3 block(BX, BY);
  const dim3 grid((Wc + BX - 1) / BX, (Hc + BY - 1) / BY, N);
  warp_kernel<<<grid, block, 0, stream>>>(src, out, valid, fpar, ipar, H, W,
                                          C, Hc, Wc);
  return static_cast<int>(cudaGetLastError());
}
