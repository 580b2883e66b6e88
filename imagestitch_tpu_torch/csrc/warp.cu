// Rotation warp of N images into N shared-frame canvases in one launch:
// per canvas pixel the backward map (cylindrical, spherical or plane), the
// K·R⁻¹ projection with z > 0, the ROI-rectangle test, the in-image test on
// each image's true size, and a bilinear sample of C channels with clamped
// taps; invalid pixels are written as zero.
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
// traffic, so the bound is the bytes: the kernel's work is to keep the
// stores wide and the arithmetic off the critical path.
//
// Design:
// - One block of 32x8 threads per 128x16 canvas tile of one image. u
//   depends only on the column and v only on the row, so the block first
//   computes u/scale and its sinf/cosf once per tile column, and v/scale
//   (spherical: sinf/cosf of π − v/scale) once per tile row, into shared
//   memory; each pixel then only projects, divides and samples. The
//   expressions and their order are the plain version's, and the build
//   has no fast math and no fused multiply-add, so every pixel sees the
//   plain version's float32 values.
// - Warp w owns the tile rows w and w+8. Its lanes take adjacent
//   pixels (32 apart across four passes), so the bilinear taps of a warp
//   instruction fall on a few cache lines; the C values and the mask byte
//   of each pixel go to the warp's row buffer in shared memory, and the
//   warp then writes the row segment with 16-byte stores (the C·128
//   floats as float4, the 128 mask bytes as uint4), narrower only at an
//   unaligned head or a ragged tail.
// - A tile wholly outside the image's ROI (testing the tile's corners is
//   exact, as u and v are separable) writes its zeros with the same wide
//   stores and no arithmetic.
// - Sources are read directly through L1 (__ldg): neighbouring pixels'
//   footprints overlap, so most taps hit in cache. Staging the source in
//   shared memory was not needed: with L2 flushed the kernel is within
//   1.3% of its warm time.
// - Tile height 16: measured at the main-path shapes (PERF.md), 8 and 16
//   rows tie and 24, 32 and 64 rows are 8%, 6% and 19% slower, as fewer,
//   larger tiles balance the costly live tiles against the zero-only ones
//   worse. An occupancy hint beyond the 4 blocks per SM that 60 registers
//   allow spills and loses 12-18%. The outputs' write alone (two fills)
//   takes about 60% of the time.
// - The per-image parameters are read through pointers to the caller's
//   device tensors (the corners through their strides, so an expanded
//   view needs no copy; the surface scale is one for all images or one
//   per image, so a batch of stitches with their own scales warps in one
//   launch); true sizes travel by value. The launch is the
//   only device work of a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;              // tile columns
constexpr int TH = 16;               // tile rows
constexpr int BX = 32;               // lanes: adjacent columns
constexpr int BY = 8;                // warps: one row of the tile each
constexpr int MAX_SIZES = 64;        // images whose true sizes go by value
constexpr int MAX_C = 8;             // channels the row buffers hold
constexpr float PI_F = 3.14159265358979323846f;
static_assert(TW + TH <= BX * BY, "one thread per tile column and row");

struct Args {
  const float* src;        // (N, H, W, C)
  float* out;              // (N, Hc, Wc, C)
  uint8_t* valid;          // (N, Hc, Wc)
  const float* k_rinv;     // (N, 3, 3) row-major
  const float* scale_ptr;  // scale_ptr[n * scale_stride], or scale_val
  float scale_val;         // when scale_ptr is null
  int scale_stride;        // 0: one scale for all images; 1: one each
  const int* corners;      // corners[n * cs0 + k * cs1]: canvas origin (x, y)
  int cs0, cs1;
  const float* roi;        // (N, 4) u0, v0, u1, v1
  int H, W, C, Hc, Wc;
  int has_sizes;
};

struct Sizes {
  int hw[2 * MAX_SIZES];   // per image true (h, w)
};

// One warp writes n floats from shared `s` (zeros when s is null) to
// global `g`: scalar head up to a 16-byte boundary, float4 body, tail.
__device__ __forceinline__ void warp_store_f32(float* g, const float* s,
                                               int n, int lane) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
  const int head = min((4 - mis) & 3, n);
  if (lane < head) g[lane] = s ? s[lane] : 0.0f;
  const int body = (n - head) >> 2;
  float4* g4 = reinterpret_cast<float4*>(g + head);
  for (int i = lane; i < body; i += BX) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (s) {
      if (head == 0) {
        v = reinterpret_cast<const float4*>(s)[i];
      } else {
        const float* q = s + head + 4 * i;
        v = make_float4(q[0], q[1], q[2], q[3]);
      }
    }
    g4[i] = v;
  }
  const int done = head + 4 * body;
  if (lane < n - done) g[done + lane] = s ? s[done + lane] : 0.0f;
}

// The same for n mask bytes, uint4 body.
__device__ __forceinline__ void warp_store_u8(uint8_t* g, const uint8_t* s,
                                              int n, int lane) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  const int head = min((16 - mis) & 15, n);
  if (lane < head) g[lane] = s ? s[lane] : 0;
  const int body = (n - head) >> 4;
  uint4* g16 = reinterpret_cast<uint4*>(g + head);
  for (int i = lane; i < body; i += BX) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (s && head == 0) {
      v = reinterpret_cast<const uint4*>(s)[i];
    } else if (s) {
      const uint8_t* q = s + head + 16 * i;
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = static_cast<uint32_t>(q[4 * k])
               | (static_cast<uint32_t>(q[4 * k + 1]) << 8)
               | (static_cast<uint32_t>(q[4 * k + 2]) << 16)
               | (static_cast<uint32_t>(q[4 * k + 3]) << 24);
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    g16[i] = v;
  }
  const int done = head + 16 * body;
  if (lane < n - done) g[done + lane] = s ? s[done + lane] : 0;
}

template <int KIND>   // 0 cylindrical, 1 spherical, 2 plane
__global__ void __launch_bounds__(BX * BY)
warp_kernel(const Args a, const Sizes sz) {
  extern __shared__ float4 dyn[];            // BY rows of TW x C floats
  __shared__ __align__(16) uint8_t s_mask[BY][TW];
  __shared__ float s_ca[TW], s_cb[TW];       // per column
  __shared__ float s_ra[TH], s_rb[TH];       // per row

  const int n = blockIdx.z;
  const int lane = threadIdx.x, wy = threadIdx.y;
  const int tid = wy * BX + lane;
  const int C = a.C, Hc = a.Hc, Wc = a.Wc;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tw = min(TW, Wc - x0);
  const int th = min(TH, Hc - y0);
  float* out_n = a.out + static_cast<size_t>(n) * Hc * Wc * C;
  uint8_t* val_n = a.valid + static_cast<size_t>(n) * Hc * Wc;

  const float cx = static_cast<float>(__ldg(a.corners + n * a.cs0));
  const float cy = static_cast<float>(__ldg(a.corners + n * a.cs0 + a.cs1));
  const float u0 = __ldg(a.roi + 4 * n), v0 = __ldg(a.roi + 4 * n + 1);
  const float u1 = __ldg(a.roi + 4 * n + 2), v1 = __ldg(a.roi + 4 * n + 3);

  // whole-tile ROI test on the tile's corners
  const float tu_lo = static_cast<float>(x0) + cx;
  const float tv_lo = static_cast<float>(y0) + cy;
  const bool live = (tu_lo + (TW - 1) >= u0 - 1.0f) && (tu_lo <= u1 + 1.0f)
                    && (tv_lo + (TH - 1) >= v0 - 1.0f)
                    && (tv_lo <= v1 + 1.0f);
  if (!live) {
    for (int r = wy; r < th; r += BY) {
      const size_t row = static_cast<size_t>(y0 + r) * Wc + x0;
      warp_store_f32(out_n + row * C, nullptr, tw * C, lane);
      warp_store_u8(val_n + row, nullptr, tw, lane);
    }
    return;
  }

  const float scale = a.scale_ptr ? __ldg(a.scale_ptr + n * a.scale_stride)
                                  : a.scale_val;
  if (tid < TW) {
    const float us = (static_cast<float>(x0 + tid) + cx) / scale;
    if (KIND == 2) {
      s_ca[tid] = us;
    } else {
      s_ca[tid] = sinf(us);
      s_cb[tid] = cosf(us);
    }
  } else if (tid < TW + TH) {
    const int r = tid - TW;
    const float vs = (static_cast<float>(y0 + r) + cy) / scale;
    if (KIND == 1) {
      s_ra[r] = sinf(PI_F - vs);
      s_rb[r] = cosf(PI_F - vs);
    } else {
      s_ra[r] = vs;
    }
  }
  __syncthreads();

  const float* M = a.k_rinv + 9 * n;
  const float m0 = __ldg(M), m1 = __ldg(M + 1), m2 = __ldg(M + 2);
  const float m3 = __ldg(M + 3), m4 = __ldg(M + 4), m5 = __ldg(M + 5);
  const float m6 = __ldg(M + 6), m7 = __ldg(M + 7), m8 = __ldg(M + 8);
  const int h = a.has_sizes ? sz.hw[2 * n] : a.H;
  const int w = a.has_sizes ? sz.hw[2 * n + 1] : a.W;
  const float* img = a.src + static_cast<size_t>(n) * a.H * a.W * C;
  float* rowbuf = reinterpret_cast<float*>(dyn) + wy * TW * C;
  uint8_t* maskbuf = s_mask[wy];

  for (int r = wy; r < th; r += BY) {
    const float v = static_cast<float>(y0 + r) + cy;
    const bool v_in = v >= v0 - 1.0f && v <= v1 + 1.0f;
    const float ra = s_ra[r];
    const float rb = KIND == 1 ? s_rb[r] : 0.0f;
    for (int col = lane; col < tw; col += BX) {
      const float u = static_cast<float>(x0 + col) + cx;
      float X, Y, Z;
      if (KIND == 0) {
        X = s_ca[col];
        Y = ra;
        Z = s_cb[col];
      } else if (KIND == 1) {
        X = ra * s_ca[col];
        Y = rb;
        Z = ra * s_cb[col];
      } else {
        X = s_ca[col];
        Y = ra;
        Z = 1.0f;
      }
      const float px = m0 * X + m1 * Y + m2 * Z;
      const float py = m3 * X + m4 * Y + m5 * Z;
      const float pz = m6 * X + m7 * Y + m8 * Z;
      const float pzs = fabsf(pz) < 1e-12f ? 1e-12f : pz;
      const float xs = px / pzs;
      const float ys = py / pzs;
      const bool ok = pz > 0.0f && v_in && u >= u0 - 1.0f
                      && u <= u1 + 1.0f && xs >= 0.0f
                      && xs <= static_cast<float>(w - 1) && ys >= 0.0f
                      && ys <= static_cast<float>(h - 1);
      float* o = rowbuf + col * C;
      maskbuf[col] = ok ? 1 : 0;
      if (!ok) {
        for (int c = 0; c < C; ++c) o[c] = 0.0f;
        continue;
      }
      const float fx0 = floorf(xs), fy0 = floorf(ys);
      const float fx = xs - fx0, fy = ys - fy0;
      const int xa = min(max(static_cast<int>(fx0), 0), w - 1);
      const int xb = min(max(static_cast<int>(fx0) + 1, 0), w - 1);
      const int ya = min(max(static_cast<int>(fy0), 0), h - 1);
      const int yb = min(max(static_cast<int>(fy0) + 1, 0), h - 1);
      const float* pa = img + static_cast<size_t>(ya) * a.W * C;
      const float* pb = img + static_cast<size_t>(yb) * a.W * C;
      for (int c = 0; c < C; ++c) {
        const float ia = __ldg(pa + xa * C + c), ib = __ldg(pa + xb * C + c);
        const float ic = __ldg(pb + xa * C + c), id = __ldg(pb + xb * C + c);
        const float top = ia + (ib - ia) * fx;
        const float bot = ic + (id - ic) * fx;
        o[c] = top + (bot - top) * fy;
      }
    }
    __syncwarp();
    const size_t row = static_cast<size_t>(y0 + r) * Wc + x0;
    warp_store_f32(out_n + row * C, rowbuf, tw * C, lane);
    warp_store_u8(val_n + row, maskbuf, tw, lane);
    __syncwarp();
  }
}

}  // namespace

// src: (N, H, W, C) float32; out: (N, Hc, Wc, C) float32; valid: (N, Hc,
// Wc) bool (one byte each), all contiguous on the device. k_rinvs (N, 3, 3)
// and roi_uvs (N, 4) float32 contiguous on the device; corners int32 on
// the device at strides (cs0, cs1) elements; scale: image n's surface
// scale is scale_ptr[n * scale_stride] on the device (stride 0: one scale
// for all images, 1: one per image), or scale_val when scale_ptr is null.
// sizes_hw: host array of N (h, w) pairs (N <= 64), or null for (H, W).
// kind: 0 cylindrical, 1 spherical, 2 plane. C <= 8 (the row buffers
// then fit in the 48 KB of shared memory a block gets without opting in).
extern "C" int imagestitch_warp(const float* src, float* out, uint8_t* valid,
                                const float* k_rinvs, const float* scale_ptr,
                                float scale_val, int scale_stride,
                                const int* corners, int cs0, int cs1,
                                const float* roi_uvs, const int* sizes_hw,
                                int N, int H, int W, int C, int Hc, int Wc,
                                int kind, cudaStream_t stream) {
  if (C < 1 || C > MAX_C || kind < 0 || kind > 2
      || scale_stride < 0 || scale_stride > 1
      || (sizes_hw && (N < 1 || N > MAX_SIZES)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{src, out, valid, k_rinvs, scale_ptr, scale_val, scale_stride,
               corners, cs0, cs1, roi_uvs, H, W, C, Hc, Wc,
               sizes_hw ? 1 : 0};
  Sizes sz{};
  if (sizes_hw)
    for (int i = 0; i < 2 * N; ++i) sz.hw[i] = sizes_hw[i];
  const dim3 block(BX, BY);
  const dim3 grid((Wc + TW - 1) / TW, (Hc + TH - 1) / TH, N);
  const size_t smem = static_cast<size_t>(BY) * TW * C * sizeof(float);
  if (kind == 0)
    warp_kernel<0><<<grid, block, smem, stream>>>(a, sz);
  else if (kind == 1)
    warp_kernel<1><<<grid, block, smem, stream>>>(a, sz);
  else
    warp_kernel<2><<<grid, block, smem, stream>>>(a, sz);
  return static_cast<int>(cudaGetLastError());
}
