// Detector maps of one ORB pyramid level, for a batch of images, in one
// pass: FAST-9/16 score + 3x3 non-max suppression, the Harris response and
// the 7x7 Gaussian blur the descriptors sample from.
//
// Replaces the TPU kernel imagestitch_tpu/ops/pallas_detect.py:detect_maps
// (body _detect_kernel). Its 64-row band schedule, lane-roll shifts and
// zero-padded halo are not carried over. The borders follow the plain
// version (features/fast.py + ops/image.py) exactly, over the whole map:
//   - FAST differences and Harris gradients wrap around the image;
//   - NMS treats out-of-image neighbours as -inf;
//   - the Harris box sums treat them as 0;
//   - the blur reflects them (reflect-101).
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32 off the tensor cores):
// per pixel it must read 4 bytes and write 12, and it does about 470
// float32 operations (16 circle differences, 16 nine-long arc min/max
// windows, the NMS, 3 gradient products with 7x7 box sums, the separable
// blur) — about 30 operations per byte, above the card's ~20 flop/byte
// balance point, so the bound is the operations, not the bytes.
//
// Every product and sum rounds on its own (built with --fmad=false), in
// the plain version's order, so the card can hold the two to tight
// tolerances: FAST/NMS bit for bit.
//
// Design: a block stages a 32x16 output tile plus a 4-pixel halo (FAST
// radius 3 + NMS 1; Harris gradient 1 + box 3; blur 3) in shared memory
// once, computes every intermediate (scores with their NMS ring, the three
// gradient products, vertical box and blur passes) in shared memory and
// writes the three maps once. Device memory sees each input pixel read
// about 1.5 times (halo) and each output written once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;            // output tile width
constexpr int TH = 16;            // output tile height
constexpr int HALO = 4;
constexpr int SW = TW + 2 * HALO;
constexpr int SH = TH + 2 * HALO;
constexpr int PW = TW + 6;        // Harris product / blur column span
constexpr int PH = TH + 6;
constexpr float NEG_SCORE = -3.4e38f;

struct Taps { float k[7]; };

__constant__ int CIRCLE_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int CIRCLE_DY[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ int wrap_index(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

// FAST-9/16 score at shared-memory position (cy, cx).
__device__ float fast_score(const float (*s_img)[SW], int cy, int cx,
                            float t) {
  const float c = s_img[cy][cx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    d[k] = s_img[cy + CIRCLE_DY[k]][cx + CIRCLE_DX[k]] - c;
  float best = NEG_SCORE;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float mn = d[k], mx = d[k];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      const float v = d[(k + j) & 15];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    const float sb = mn > t ? mn : NEG_SCORE;
    const float sd = mx < -t ? -mx : NEG_SCORE;
    best = fmaxf(best, fmaxf(sb, sd));
  }
  return fmaxf(best, 0.0f);
}

__global__ void __launch_bounds__(256)
detect_maps_kernel(const float* __restrict__ img, float* __restrict__ nms,
                   float* __restrict__ harris, float* __restrict__ blur,
                   int H, int W, float t, int r, float k_harris, float s4,
                   Taps taps) {
  __shared__ float s_img[SH][SW];          // rows y0-4.., cols x0-4.., wrapped
  __shared__ float s_score[TH + 2][TW + 2];  // rows y0-1.., -inf outside
  __shared__ float s_p[3][PH][PW];         // Ix², Iy², IxIy; rows y0-3.., 0 outside
  __shared__ float s_v[4][TH][PW];         // vertical box sums + vertical blur

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const float* im = img + static_cast<size_t>(b) * H * W;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;

  for (int i = tid; i < SH * SW; i += nt) {
    const int ly = i / SW, lx = i % SW;
    const int gy = wrap_index(y0 - HALO + ly, H);
    const int gx = wrap_index(x0 - HALO + lx, W);
    s_img[ly][lx] = im[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  // FAST scores on the tile and its 1-pixel NMS ring
  for (int i = tid; i < (TH + 2) * (TW + 2); i += nt) {
    const int ly = i / (TW + 2), lx = i % (TW + 2);
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    float sc = -INFINITY;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      sc = fast_score(s_img, ly + 3, lx + 3, t);
    s_score[ly][lx] = sc;
  }
  // Harris gradient products on the tile and its 3-pixel box ring
  for (int i = tid; i < PH * PW; i += nt) {
    const int ly = i / PW, lx = i % PW;
    const int gy = y0 - 3 + ly, gx = x0 - 3 + lx;
    float a = 0.f, bb = 0.f, c = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int sy = ly + 1, sx = lx + 1;
      const float ix = s_img[sy][sx + 1] - s_img[sy][sx - 1];
      const float iy = s_img[sy + 1][sx] - s_img[sy - 1][sx];
      a = ix * ix;
      bb = iy * iy;
      c = ix * iy;
    }
    s_p[0][ly][lx] = a;
    s_p[1][ly][lx] = bb;
    s_p[2][ly][lx] = c;
  }
  // vertical blur pass (reflect-101 rows) over the tile's column span
  for (int i = tid; i < TH * PW; i += nt) {
    const int ly = i / PW, lx = i % PW;
    const int gy = y0 + ly;
    if (gy >= H) continue;
    const int sx = lx + 1;                 // s_img column of x0-3+lx
    float rows[7];
#pragma unroll
    for (int k = 0; k < 7; ++k)
      rows[k] = s_img[reflect101(gy + k - 3, H) - (y0 - HALO)][sx];
    float acc = taps.k[0] * rows[0];
#pragma unroll
    for (int k = 1; k < 7; ++k) acc = acc + taps.k[k] * rows[k];
    s_v[3][ly][lx] = acc;
  }
  __syncthreads();

  // vertical Harris box sums, top row first
  for (int i = tid; i < TH * PW; i += nt) {
    const int ly = i / PW, lx = i % PW;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float s = s_p[m][ly + 3 - r][lx];
      for (int dy = -r + 1; dy <= r; ++dy) s += s_p[m][ly + 3 + dy][lx];
      s_v[m][ly][lx] = s;
    }
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += nt) {
    const int ly = i / TW, lx = i % TW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const size_t o = static_cast<size_t>(b) * H * W
                     + static_cast<size_t>(gy) * W + gx;

    const float sc = s_score[ly + 1][lx + 1];
    float mx = sc;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, s_score[ly + dy][lx + dx]);
    nms[o] = (sc >= mx && sc > 0.f) ? sc : 0.f;

    float h[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float s = s_v[m][ly][lx + 3 - r];
      for (int dx = -r + 1; dx <= r; ++dx) s += s_v[m][ly][lx + 3 + dx];
      h[m] = s;
    }
    const float apb = h[0] + h[1];
    harris[o] = (h[0] * h[1] - h[2] * h[2] - k_harris * apb * apb) * s4;

    float cols[7];
#pragma unroll
    for (int k = 0; k < 7; ++k)
      cols[k] = s_v[3][ly][reflect101(gx + k - 3, W) - (x0 - 3)];
    float g = taps.k[0] * cols[0];
#pragma unroll
    for (int k = 1; k < 7; ++k) g = g + taps.k[k] * cols[k];
    blur[o] = g;
  }
}

}  // namespace

// img, nms, harris, blur: (B, H, W) float32 contiguous on the device.
// block_size: Harris box width, odd, at most 7. taps: 7 host floats.
extern "C" int imagestitch_detect_maps(const float* img, float* nms,
                                       float* harris, float* blur, int B,
                                       int H, int W, float threshold,
                                       int block_size, float k_harris,
                                       float s4, const float* taps,
                                       cudaStream_t stream) {
  Taps tp;
  for (int k = 0; k < 7; ++k) tp.k[k] = taps[k];
  const dim3 block(32, 8);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  detect_maps_kernel<<<grid, block, 0, stream>>>(
      img, nms, harris, blur, H, W, threshold, block_size / 2, k_harris, s4,
      tp);
  return static_cast<int>(cudaGetLastError());
}
