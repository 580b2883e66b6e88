// Detector maps of every ORB pyramid level of a batch of images in one
// launch: FAST-9/16 score + 3x3 non-max suppression, the Harris response
// and the 7x7 Gaussian blur the descriptors sample from.
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
// per pixel it must read 4 bytes and write 12, 0.045 ms for the 9.42 Mpx
// of one 1080p stitch's two five-level pyramids. Its float32 operations
// are fewer: at most 204 a pixel (FAST 118: 16 differences, the arcs'
// min and max 96, the threshold 6; NMS 11; Harris 49; blur 26), and the
// compass test below skips FAST's 118 on most pixels. So the bytes bound
// it. What sets its pace is the instruction issue: shared-memory loads,
// index arithmetic and min/max at half the float32 rate.
//
// Design, against what held the first port back (one launch per level,
// small levels that left SMs idle, 384 FAST operations a pixel, a `%` per
// staged pixel):
//   - One launch per call for up to 8 levels: a table passed by value
//     gives each level's input, the offset of its (3, B, H, W) maps in
//     one output allocation, its size and its first tile; each block
//     finds its level. The big levels' tiles come first, the small ones
//     fill the tail.
//   - A block stages a TW x TH output tile with a 4-pixel halo once
//     (wrap indices computed once per staged row and column), then:
//     FAST scores on the tile and its NMS ring; per tile column, threads
//     walk RPT rows down with the Harris products and the blur taps in
//     registers and write the vertical box sums and the vertical blur;
//     each output pixel then takes its NMS, horizontal box sums and
//     horizontal blur from shared memory and writes the three maps once.
//   - FAST: a pixel whose four compass points hold no neighbouring pair
//     past the threshold is no corner (few pass on the main path's
//     images: chip_smoke.py reports the share). For the others,
//     neighbouring arcs share eight ring pixels, whose min and max come
//     from a doubling tree, and the threshold is applied once, to the
//     best arc: the same bits as testing every arc.
//   - Reflect-101 rows and columns for the blur are looked up in tables
//     made once per tile; no `%` or `/` by a non-constant per pixel.
//   - 64x32 tiles of 256 threads: chosen by measurement against 32 and
//     128 wide, 16 and 64 high (PERF.md, section 6).
//
// Every product and sum rounds on its own (built with --fmad=false), in
// the plain version's order (box sums rows then columns, taps in
// sequence, no running sums), so FAST/NMS and the Harris and blur maps
// equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 64;             // output tile width
constexpr int TH = 32;             // output tile height
constexpr int NT = 256;            // threads per block
constexpr int RPT = 8;             // rows a thread walks in the vertical passes
constexpr int HALO = 4;            // FAST 3 + NMS 1; gradient 1 + box 3; blur 3
constexpr int SW = TW + 2 * HALO;  // staged input
constexpr int SH = TH + 2 * HALO;
constexpr int FW = TW + 2;         // FAST scores and their NMS ring
constexpr int FH = TH + 2;
constexpr int VW = TW + 6;         // vertical sums: Harris box / blur columns
constexpr int VH = TH + 6;         // blur source rows of the tile
constexpr int MAX_LEVELS = 8;
constexpr float NEG_SCORE = -3.4e38f;
static_assert(TH % RPT == 0, "row chunks must tile the output rows");

constexpr int SMEM_FLOATS = SH * SW + FH * FW + 4 * TH * VW;
constexpr int SMEM_INTS = SH + SW + VH + VW;
constexpr size_t SMEM_BYTES = 4 * (SMEM_FLOATS + SMEM_INTS);

struct Taps { float k[7]; };

struct Level {
  const float* img;   // (B, H, W)
  long long out;      // offset of this level's (3, B, H, W) maps in `out`
  int H, W, tiles_x, tile0;
};

struct Levels { Level l[MAX_LEVELS]; int n; };

__device__ __forceinline__ int wrap_index(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

__device__ __forceinline__ int clampi(int i, int lo, int hi) {
  return i < lo ? lo : (i > hi ? hi : i);
}

// A 9-arc of the 16-ring holds two neighbouring compass points (ring
// pixels 0, 4, 8, 12). Where no two neighbouring ones are both brighter
// than t, or both darker than -t, the pixel is no corner: its score is 0,
// as the full test would give.
__device__ __forceinline__ bool maybe_corner(const float* p, float t) {
  const float c = p[0];
  const float n = p[-3 * SW] - c, e = p[3] - c, s = p[3 * SW] - c,
              w = p[-3] - c;
  const bool bn = n > t, be = e > t, bs = s > t, bw = w > t;
  const bool dn = n < -t, de = e < -t, ds = s < -t, dw = w < -t;
  return (bn && be) || (be && bs) || (bs && bw) || (bw && bn) ||
         (dn && de) || (de && ds) || (ds && dw) || (dw && dn);
}

// FAST-9/16 score at p (a staged pixel with 3 pixels around it): the
// largest threshold at which 9 contiguous ring pixels are all brighter
// (or all darker) than the centre, 0 where it is no corner. Arcs k and
// k+1 share the eight pixels k+1 .. k+8, so the better of the two is
// min(those eight, max(pixel k, pixel k+9)) (max(min(a, m), min(m, b)) =
// min(m, max(a, b)), exact); the eights come from a doubling tree over
// the odd ring positions.
__device__ __forceinline__ float fast_score(const float* p, float t) {
  const int off[16] = {-3 * SW,     -3 * SW + 1, -2 * SW + 2, -SW + 3,
                       3,           SW + 3,      2 * SW + 2,  3 * SW + 1,
                       3 * SW,      3 * SW - 1,  2 * SW - 2,  SW - 3,
                       -3,          -SW - 3,     -2 * SW - 2, -3 * SW - 1};
  if (!maybe_corner(p, t)) return 0.0f;
  const float c = p[0];
  float d[16], lo[8], hi[8], lo2[8], hi2[8];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = p[off[k]] - c;
#pragma unroll
  for (int i = 0; i < 8; ++i) {           // pixels 2i+1 .. 2i+2
    lo[i] = fminf(d[2 * i + 1], d[(2 * i + 2) & 15]);
    hi[i] = fmaxf(d[2 * i + 1], d[(2 * i + 2) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {           // pixels 2i+1 .. 2i+4
    lo2[i] = fminf(lo[i], lo[(i + 1) & 7]);
    hi2[i] = fmaxf(hi[i], hi[(i + 1) & 7]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {           // pixels 2i+1 .. 2i+8
    lo[i] = fminf(lo2[i], lo2[(i + 2) & 7]);
    hi[i] = fmaxf(hi2[i], hi2[(i + 2) & 7]);
  }
  // arcs 2i and 2i+1: the max of their mins, the min of their maxes
  float bright = NEG_SCORE, dark = -NEG_SCORE;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = d[2 * i], b = d[(2 * i + 9) & 15];
    bright = fmaxf(bright, fminf(lo[i], fmaxf(a, b)));
    dark = fminf(dark, fmaxf(hi[i], fminf(a, b)));
  }
  const float sb = bright > t ? bright : NEG_SCORE;
  const float sd = dark < -t ? -dark : NEG_SCORE;
  return fmaxf(fmaxf(sb, sd), 0.0f);
}

// R: Harris box radius (block_size / 2).
template <int R>
__global__ void __launch_bounds__(NT)
detect_maps_kernel(Levels L, float* __restrict__ out, float t,
                   float k_harris, float s4, Taps taps) {
  extern __shared__ float smem[];
  float* s_img = smem;                       // SH x SW, wrapped
  float* s_score = s_img + SH * SW;          // FH x FW, -inf outside
  float* s_v = s_score + FH * FW;            // 4 x TH x VW
  int* s_roff = reinterpret_cast<int*>(s_v + 4 * TH * VW);  // SH row offsets
  int* s_col = s_roff + SH;                  // SW columns
  int* s_brow = s_col + SW;                  // VH staged rows, reflected
  int* s_bcol = s_brow + VH;                 // VW staged columns, reflected

  Level lv = L.l[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (i < L.n && static_cast<int>(blockIdx.x) >= L.l[i].tile0) lv = L.l[i];
  const int H = lv.H, W = lv.W;
  const int tile = blockIdx.x - lv.tile0;
  const int ty = tile / lv.tiles_x;
  const int x0 = (tile - ty * lv.tiles_x) * TW;
  const int y0 = ty * TH;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* im = lv.img + blockIdx.y * plane;
  float* const maps = out + lv.out + blockIdx.y * plane;  // nms of image b
  const size_t mstride = gridDim.y * plane;  // to its harris, then blur
  const int tid = threadIdx.x;

  // index tables, once per tile row and column
  for (int i = tid; i < SH; i += NT)
    s_roff[i] = wrap_index(y0 - HALO + i, H) * W;
  for (int i = tid; i < SW; i += NT) s_col[i] = wrap_index(x0 - HALO + i, W);
  for (int i = tid; i < VH; i += NT)
    s_brow[i] = clampi(reflect101(y0 - 3 + i, H) - (y0 - HALO), 0, SH - 1);
  for (int i = tid; i < VW; i += NT)
    s_bcol[i] = clampi(reflect101(x0 - 3 + i, W) - (x0 - HALO), 0, SW - 1);
  __syncthreads();

  for (int i = tid; i < SH * SW; i += NT) {
    const int ly = i / SW, lx = i - ly * SW;
    s_img[i] = im[s_roff[ly] + s_col[lx]];
  }
  __syncthreads();

  // FAST scores on the tile and its 1-pixel NMS ring
  for (int i = tid; i < FH * FW; i += NT) {
    const int ly = i / FW, lx = i - ly * FW;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    float sc = -INFINITY;
    if (static_cast<unsigned>(gy) < static_cast<unsigned>(H) &&
        static_cast<unsigned>(gx) < static_cast<unsigned>(W))
      sc = fast_score(s_img + (ly + 3) * SW + lx + 3, t);
    s_score[i] = sc;
  }

  // vertical passes: each thread walks RPT output rows of one column of
  // the Harris / blur span (tile columns -3 .. TW+2); the tasks go from
  // the last thread down, which took the fewest FAST scores
  for (int task = NT - 1 - tid; task < VW * (TH / RPT); task += NT) {
    const int chunk = task / VW, j = task - chunk * VW;
    const int r0 = chunk * RPT;
    const bool col_in =
        static_cast<unsigned>(x0 - 3 + j) < static_cast<unsigned>(W);
    float pa[RPT + 2 * R], pb[RPT + 2 * R], pc[RPT + 2 * R];
#pragma unroll
    for (int i = 0; i < RPT + 2 * R; ++i) {
      const int ly = r0 - R + i;
      const float* q = s_img + (ly + HALO) * SW + j + 1;
      const float ix = q[1] - q[-1];
      const float iy = q[SW] - q[-SW];
      const bool in = col_in && static_cast<unsigned>(y0 + ly) <
                                    static_cast<unsigned>(H);
      pa[i] = in ? ix * ix : 0.f;
      pb[i] = in ? iy * iy : 0.f;
      pc[i] = in ? ix * iy : 0.f;
    }
    float* v0 = s_v + r0 * VW + j;
#pragma unroll
    for (int o = 0; o < RPT; ++o) {       // box sums, top row first
      float a = pa[o], b = pb[o], c = pc[o];
#pragma unroll
      for (int k = 1; k <= 2 * R; ++k) {
        a = a + pa[o + k];
        b = b + pb[o + k];
        c = c + pc[o + k];
      }
      v0[o * VW] = a;
      v0[TH * VW + o * VW] = b;
      v0[2 * TH * VW + o * VW] = c;
    }
    const int bx = s_bcol[j];
    float v[RPT + 6];
#pragma unroll
    for (int i = 0; i < RPT + 6; ++i) v[i] = s_img[s_brow[r0 + i] * SW + bx];
#pragma unroll
    for (int o = 0; o < RPT; ++o) {       // blur taps in sequence
      float acc = taps.k[0] * v[o];
#pragma unroll
      for (int k = 1; k < 7; ++k) acc = acc + taps.k[k] * v[o + k];
      v0[3 * TH * VW + o * VW] = acc;
    }
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += NT) {
    const int ly = i / TW, lx = i - ly * TW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    const size_t o = static_cast<size_t>(gy) * W + gx;

    const float* sp = s_score + ly * FW + lx;
    const float sc = sp[FW + 1];
    float mx = sc;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) mx = fmaxf(mx, sp[dy * FW + dx]);
    maps[o] = (sc >= mx && sc > 0.f) ? sc : 0.f;

    const float* vp = s_v + ly * VW + lx + 3;
    float h[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {         // box sums, left column first
      const float* q = vp + m * TH * VW;
      float s = q[-R];
#pragma unroll
      for (int dx = -R + 1; dx <= R; ++dx) s = s + q[dx];
      h[m] = s;
    }
    const float apb = h[0] + h[1];
    maps[mstride + o] =
        (h[0] * h[1] - h[2] * h[2] - k_harris * apb * apb) * s4;

    const float* bp = s_v + 3 * TH * VW + ly * VW + lx;
    float g = taps.k[0] * bp[0];
#pragma unroll
    for (int k = 1; k < 7; ++k) g = g + taps.k[k] * bp[k];
    maps[2 * mstride + o] = g;
  }
}

template <int R>
cudaError_t launch(const Levels& L, int tiles, int B, float* out, float t,
                   float k_harris, float s4, const Taps& taps,
                   cudaStream_t stream) {
  if (SMEM_BYTES > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        detect_maps_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return e;
  }
  detect_maps_kernel<R><<<dim3(tiles, B), NT, SMEM_BYTES, stream>>>(
      L, out, t, k_harris, s4, taps);
  return cudaGetLastError();
}

}  // namespace

// imgs[l]: level l's (B, Hs[l], Ws[l]) float32 contiguous input on the
// device, n levels (1..8). out: one float32 allocation holding each
// level's (3, B, H, W) maps (nms, harris, blur) in turn. block_size: Harris
// box width, odd, at most 7. taps: 7 host floats. One launch.
extern "C" int imagestitch_detect_maps_levels(
    const float* const* imgs, const int* Hs, const int* Ws, int n, int B,
    float* out, float threshold, int block_size, float k_harris, float s4,
    const float* taps, cudaStream_t stream) {
  if (n < 1 || n > MAX_LEVELS || B < 1 || B > 65535 || block_size < 1 ||
      block_size > 7 || block_size % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels L = {};
  L.n = n;
  long long off = 0;
  int tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (Hs[i] < 4 || Ws[i] < 4) return static_cast<int>(cudaErrorInvalidValue);
    const int tx = (Ws[i] + TW - 1) / TW, ty = (Hs[i] + TH - 1) / TH;
    L.l[i] = {imgs[i], off, Hs[i], Ws[i], tx, tiles};
    off += 3LL * B * Hs[i] * Ws[i];
    tiles += tx * ty;
  }
  Taps tp;
  for (int k = 0; k < 7; ++k) tp.k[k] = taps[k];
  cudaError_t e;
  switch (block_size / 2) {
    case 0: e = launch<0>(L, tiles, B, out, threshold, k_harris, s4, tp,
                          stream); break;
    case 1: e = launch<1>(L, tiles, B, out, threshold, k_harris, s4, tp,
                          stream); break;
    case 2: e = launch<2>(L, tiles, B, out, threshold, k_harris, s4, tp,
                          stream); break;
    default: e = launch<3>(L, tiles, B, out, threshold, k_harris, s4, tp,
                           stream); break;
  }
  return static_cast<int>(e);
}
