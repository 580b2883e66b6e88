// SIFT octave maps of one (H, W) float32 image in one launch: the S+3
// chained Gaussian levels, then the DoG layers, the 26-neighbour extremum
// scores of the interior layers (contrast and Hessian edge tests, 8 px
// border mask), the edge-clamped central-difference gradients of levels
// 1..S+1 and level S.
//
// Replaces the TPU kernel imagestitch_tpu/ops/pallas_sift.py:
// sift_octave_maps (body _sift_kernel). Its 64-row bands, lane-roll shifts,
// reflect-padded base and 2·halo size gate are not carried over: the
// semantics are those of the XLA path (features/sift.py _octave_maps with
// use_pallas=False) at every size, with reflect-101 borders at every blur
// and edge-clamped gradients.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32 off the tensor cores):
// per octave pixel it must read 4 bytes and write 17 planes of 4 bytes
// (dog S+2, score S, gx and gy S+1 each, gS; S = 3), 72 bytes, and the
// blurs over the image alone take 268 float32 operations a pixel (the
// first octave's): the bytes bound it, 0.118 ms for one 1080p stitch's 8
// calls (397 MB). What sets its pace is instruction issue in the blur
// passes: with the halos a 64x64 tile's blurs are 575 operations an
// output pixel, one instruction each under --fmad=false, and the passes
// issue at about a quarter of the card's float32 rate (PERF.md, section
// 6: about 0.6 ms per stitch).
//
// Design, against what held the first port back (two launches per blur,
// 46 launches per image, every level written to device memory and read
// back, 54 global loads a pixel to rebuild the DoG neighbourhood):
//   - One launch per call. A block owns a TW x TH output tile and computes
//     the whole octave for it in shared memory: the base is read once over
//     the tile plus a halo (cp.async, every load in flight at once), and
//     each output plane is written once.
//   - Halos. Level l is needed over the tile plus halo[l]: 1 for the last
//     level (the 3x3 DoG neighbourhood and the central differences), and
//     each blur before adds its radius. With S = 3, sigma0 = 1.6 the taps
//     are 7 (the first octave's pre-blur), 9, 11, 13, 15, 15, so the
//     levels' halos are 30, 26, 21, 15, 8, 1 and the base's 33 on the
//     first octave, 30 on the others. The table comes from the host
//     (ops/cuda_sift.py octave_halos), by value, with the taps; a tile
//     variant's frame holds halos up to HB.
//   - Borders by image coordinates. A level's region is the tile plus its
//     halo clipped to the image. Before each blur, the frame positions
//     outside the image that its passes read get the level's value at the
//     reflect-101 position (the base load reads them so): every pass then
//     sums taps 0..n-1 in sequence over the same values as the plain
//     version, never a reflect-padded copy blurred twice.
//   - Two frame planes of a compile-time odd pitch: the level (A) and the
//     vertical pass (V). The vertical pass walks SEG rows down a column
//     with the window in registers; the horizontal pass takes SEG
//     adjacent outputs of a row per thread, neighbouring threads on
//     neighbouring rows (odd pitch: no bank conflicts), and writes the new
//     level over the old one in place, taking DoG = new - old on the way
//     for the tile and its 1-px ring (a ring of three DoG layers in shared
//     memory). A thread's SEG sums advance tap by tap side by side.
//   - The extremum test of layer s runs as soon as layer s+1 exists, each
//     thread walking SROWS rows down a column with the 3x3x3
//     neighbourhood in registers; most pixels fail the contrast test and
//     skip the 26 comparisons (the same bits: the score is 0 there).
//   - Tiles: 64x64 with 512 threads (189 KB of shared memory, one block an
//     SM) where an octave has at least as many tiles as the card has SMs,
//     else 32x32 with 256 threads (92 KB, two blocks an SM): the 1080p
//     path's two small octaves would otherwise be one partial wave. The
//     host picks (ops/cuda_sift.py tile_variant).
//
// Every product and sum rounds on its own (built with --fmad=false), in
// the plain version's order (ops/cuda_sift.py, ops/image.py
// sep_filter_planes), so the card holds the two to equality.

#include <cuda_runtime.h>

// CUDA launches of sift_octave_kernel since the library was loaded, read
// by the wrapper (ops/cuda_sift.py cuda_launches)
extern "C" {
long long imagestitch_sift_octave_launches = 0;
}

namespace {

constexpr int MAX_TAPS = 15;
constexpr int MAX_BLURS = 9;   // the pre-blur and S+2 <= 8 chained blurs
constexpr int BORDER = 8;
constexpr int SEG = 8;         // outputs a thread takes in a blur pass
constexpr int SROWS = 8;       // rows a thread walks in the extremum test
constexpr int MAX_SMEM = 232448;

struct Plan {
  float taps[MAX_BLURS][MAX_TAPS];
  int n[MAX_BLURS];            // taps of blur b
  int halo[MAX_BLURS + 1];     // stage b's halo (stage 0: the base)
  int nblur, first, S, tiles_x;
  float ct_half, edge_r, r1sq;
};

struct Outs { float *dog, *score, *gx, *gy, *gs; };

// A 4-byte copy from device memory into shared memory that does not hold
// a register (cp.async): every load of a tile's base is in flight at once.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

// The next task of a pass whose tasks are (slow, fast) pairs with `nfast`
// fast indices, NT tasks apart: no division per task.
template <int NT>
__device__ __forceinline__ void next_task(int& slow, int& fast, int nfast) {
  fast += NT;
  while (fast >= nfast) {
    fast -= nfast;
    ++slow;
  }
}

// out[o] = sum_k t[k] v[o + k], each sum over k in sequence, the SEG sums
// side by side (tap by tap) so that they hide each other's latency.
template <int N>
__device__ __forceinline__ void taps_sum(const float (&t)[N],
                                         const float (&v)[SEG + N - 1],
                                         float (&out)[SEG]) {
#pragma unroll
  for (int o = 0; o < SEG; ++o) out[o] = t[0] * v[o];
#pragma unroll
  for (int k = 1; k < N; ++k)
#pragma unroll
    for (int o = 0; o < SEG; ++o) out[o] = out[o] + t[k] * v[o + k];
}

// Vertical pass of an N-tap blur: V over the frame's rows [r0, r0 + nr)
// and columns [c0, c0 + nc) from A's rows r0 - R .. r0 + nr + R - 1 (P:
// the frame pitch). A thread takes SEG rows of one column, neighbouring
// threads neighbouring columns; the last segment of a column is moved up
// to end at its last row and stores only the rows it owns.
template <int NT, int N, int P>
__device__ __forceinline__ void vertical(const float* __restrict__ A,
                                         float* __restrict__ V,
                                         const float* taps, int r0, int nr,
                                         int c0, int nc) {
  constexpr int R = (N - 1) / 2;
  float t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = taps[k];
  const int nseg = (nr + SEG - 1) / SEG;
  int seg = 0, c = static_cast<int>(threadIdx.x) - NT;
  next_task<NT>(seg, c, nc);
  for (; seg < nseg; next_task<NT>(seg, c, nc)) {
    const int own = seg * SEG;
    const int s = min(own, max(nr - SEG, 0));
    const float* src = A + (r0 + s - R) * P + c0 + c;
    float v[SEG + N - 1], acc[SEG];
#pragma unroll
    for (int i = 0; i < SEG + N - 1; ++i) v[i] = src[i * P];
    taps_sum<N>(t, v, acc);
    float* dst = V + (r0 + s) * P + c0 + c;
    if (s == own && own + SEG <= nr) {
#pragma unroll
      for (int o = 0; o < SEG; ++o) dst[o * P] = acc[o];
    } else {
#pragma unroll
      for (int o = 0; o < SEG; ++o)
        if (s + o >= own && s + o < nr) dst[o * P] = acc[o];
    }
  }
}

// Horizontal pass of an N-tap blur: A over the frame's rows [r0, r0 + nr)
// and columns [c0, c0 + nc) from V's columns c0 - R .., in place. A
// thread takes SEG columns of one row, neighbouring threads neighbouring
// rows (P odd: no bank conflicts). With `dog`, the new level minus the
// old one goes there for the frame positions of the tile and its 1-px
// ring (origin core0, pitch TW + 3).
template <int NT, int N, int TW, int TH, int P>
__device__ __forceinline__ void horizontal(float* __restrict__ A,
                                           const float* __restrict__ V,
                                           const float* taps, int r0,
                                           int nr, int c0, int nc,
                                           float* __restrict__ dog,
                                           int core0) {
  constexpr int R = (N - 1) / 2;
  constexpr int RP = TW + 3;
  float t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = taps[k];
  const int nseg = (nc + SEG - 1) / SEG;
  int seg = 0, row = static_cast<int>(threadIdx.x) - NT;
  next_task<NT>(seg, row, nr);
  for (; seg < nseg; next_task<NT>(seg, row, nr)) {
    const int own = seg * SEG;
    const int s = min(own, max(nc - SEG, 0));
    const int off = (r0 + row) * P + c0 + s;
    float v[SEG + N - 1], acc[SEG];
#pragma unroll
    for (int i = 0; i < SEG + N - 1; ++i) v[i] = V[off - R + i];
    taps_sum<N>(t, v, acc);
    float* dst = A + off;
    const int cy = r0 + row - core0;
    const int cx = c0 + s - core0;
    if (dog != nullptr &&
        static_cast<unsigned>(cy) < static_cast<unsigned>(TH + 2)) {
      // a row of the tile or its ring: the old level first, all at once
      float old[SEG];
#pragma unroll
      for (int o = 0; o < SEG; ++o) old[o] = dst[o];
#pragma unroll
      for (int o = 0; o < SEG; ++o) {
        const bool mine = s + o >= own && s + o < nc;
        if (mine &&
            static_cast<unsigned>(cx + o) < static_cast<unsigned>(TW + 2))
          dog[cy * RP + cx + o] = acc[o] - old[o];
        if (mine) dst[o] = acc[o];
      }
    } else if (s == own && own + SEG <= nc) {
#pragma unroll
      for (int o = 0; o < SEG; ++o) dst[o] = acc[o];
    } else {
#pragma unroll
      for (int o = 0; o < SEG; ++o)
        if (s + o >= own && s + o < nc) dst[o] = acc[o];
    }
  }
}

template <int NT, int TW, int TH, int P>
__device__ __forceinline__ void blur(int n, bool vert, float* A, float* V,
                                     const float* taps, int r0, int nr,
                                     int c0, int nc, float* dog, int core0) {
  switch (n) {
#define SIFT_BLUR(N)                                                       \
  case N:                                                                  \
    if (vert)                                                              \
      vertical<NT, N, P>(A, V, taps, r0, nr, c0, nc);                      \
    else                                                                   \
      horizontal<NT, N, TW, TH, P>(A, V, taps, r0, nr, c0, nc, dog,        \
                                   core0);                                 \
    break;
    SIFT_BLUR(3) SIFT_BLUR(5) SIFT_BLUR(7) SIFT_BLUR(9) SIFT_BLUR(11)
    SIFT_BLUR(13) SIFT_BLUR(15)
#undef SIFT_BLUR
  }
}

// The 26-neighbour extremum score of the centre of w[layer][dy][dx]
// (layers s-1, s, s+1): |D| at a strict extremum passing the contrast and
// Hessian edge tests, else 0. The same tests in the same order as the
// plain version; a pixel failing the contrast test scores 0 either way.
__device__ __forceinline__ float extremum(const float (&w)[3][3][3],
                                          float ct_half, float edge_r,
                                          float r1sq) {
  const float c = w[1][1][1];
  const float ac = fabsf(c);
  if (!(ac >= ct_half)) return 0.f;
  bool is_max = true, is_min = true;
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (l == 1 && dy == 1 && dx == 1) continue;
        const float nb = w[l][dy][dx];
        is_max = is_max && (c > nb);
        is_min = is_min && (c < nb);
      }
  const float s = (is_max || is_min) ? ac : 0.f;
  const float dxx = (w[1][1][2] + w[1][1][0]) - 2.0f * c;
  const float dyy = (w[1][2][1] + w[1][0][1]) - 2.0f * c;
  const float dxy =
      0.25f * (((w[1][2][2] + w[1][0][0]) - w[1][2][0]) - w[1][0][2]);
  const float tr = dxx + dyy;
  const float det = dxx * dyy - dxy * dxy;
  const bool edge_ok = (det > 0.f) && (tr * tr * edge_r < r1sq * det);
  return edge_ok ? s : 0.f;
}

// The frame of a TW x TH tile with halo room HB: FH rows of an odd pitch
// P; the level plane A, the vertical-pass plane V and three DoG layers of
// the tile and its 1-px ring (pitch TW + 3, odd).
template <int TW, int TH, int HB>
struct Frame {
  static constexpr int P = (TW + 2 * HB) | 1;
  static constexpr int FH = TH + 2 * HB;
  static constexpr int RP = TW + 3;
  static constexpr int RSZ = (TH + 2) * RP;
  static constexpr int FLOATS = 2 * FH * P + 3 * RSZ;
  static constexpr size_t BYTES = 4 * static_cast<size_t>(FLOATS);
  static constexpr int BLOCKS = 2 * BYTES <= MAX_SMEM ? 2 : 1;  // per SM
  static_assert(BYTES <= MAX_SMEM, "the frame exceeds shared memory");
};

template <int TW, int TH, int NT, int HB>
__global__ void __launch_bounds__(NT, Frame<TW, TH, HB>::BLOCKS)
sift_octave_kernel(const float* __restrict__ base, Outs out, int H, int W,
                   const __grid_constant__ Plan p) {
  using F = Frame<TW, TH, HB>;
  constexpr int P = F::P, RP = F::RP, RSZ = F::RSZ;
  constexpr int NW = NT / 32;
  static_assert(TH % SROWS == 0, "the extremum rows must tile the tile");
  extern __shared__ float smem[];
  float* const A = smem;                 // the level
  float* const V = A + F::FH * P;        // the vertical pass
  float* const ring = V + F::FH * P;     // DoG layers d % 3, tile + 1 px
  const int ty = blockIdx.x / p.tiles_x;
  const int y0 = ty * TH;
  const int x0 = (blockIdx.x - ty * p.tiles_x) * TW;
  // the frame: image (y, x) at A[(y - fy0) * P + (x - fx0)]
  const int fy0 = y0 - HB, fx0 = x0 - HB;
  constexpr int core0 = HB - 1;          // frame row / column of the ring
  const size_t hw = static_cast<size_t>(H) * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // blur b's output region (image coordinates, clipped) and radius
  auto region = [&](int b, int& oy0, int& oy1, int& ox0, int& ox1) {
    const int h = p.halo[b + 1];
    oy0 = max(0, y0 - h);
    oy1 = min(H, y0 + TH + h);
    ox0 = max(0, x0 - h);
    ox1 = min(W, x0 + TW + h);
    return (p.n[b] - 1) / 2;
  };

  // the base over blur 0's input rectangle, reflected by image coordinates
  {
    int oy0, oy1, ox0, ox1;
    const int r = region(0, oy0, oy1, ox0, ox1);
    const int xa = ox0 - r, xb = ox1 + r;
    const bool inside = xa >= 0 && xb <= W;
    for (int y = oy0 - r + warp; y < oy1 + r; y += NW) {
      const float* src = base + static_cast<size_t>(reflect101(y, H)) * W;
      float* dst = A + (y - fy0) * P - fx0;
      if (inside) {
        for (int x = xa + lane; x < xb; x += 32) copy_async(dst + x, src + x);
      } else {
        for (int x = xa + lane; x < xb; x += 32)
          copy_async(dst + x, src + reflect101(x, W));
      }
    }
  }
  wait_copies();
  __syncthreads();

  for (int b = 0; b < p.nblur; ++b) {
    const int l = b + 1 - p.first;       // the level blur b makes
    const float* taps = p.taps[b];
    int oy0, oy1, ox0, ox1;
    const int r = region(b, oy0, oy1, ox0, ox1);
    blur<NT, TW, TH, P>(p.n[b], true, A, V, taps, oy0 - fy0, oy1 - oy0,
                        ox0 - r - fx0, ox1 - ox0 + 2 * r, nullptr, core0);
    __syncthreads();
    float* const dnew = l >= 1 ? ring + ((l - 1) % 3) * RSZ : nullptr;
    blur<NT, TW, TH, P>(p.n[b], false, A, V, taps, oy0 - fy0, oy1 - oy0,
                        ox0 - fx0, ox1 - ox0, dnew, core0);
    __syncthreads();

    if (l >= 1) {                        // dog l-1, gx / gy l-1, gS
      float* const dog = out.dog + (l - 1) * hw;
      float* const gx = out.gx + (l - 1) * hw;
      float* const gy = out.gy + (l - 1) * hw;
      const bool grads = l <= p.S + 1, gs = l == p.S;
      static_assert(TH * TW % NT == 0, "threads must tile the tile");
#pragma unroll
      for (int k = 0; k < TH * TW / NT; ++k) {
        const int i = threadIdx.x + k * NT;
        const int ly = i / TW, lx = i % TW;
        const int y = y0 + ly, x = x0 + lx;
        if (y >= H || x >= W) continue;
        const int o = y * W + x;
        dog[o] = dnew[(ly + 1) * RP + lx + 1];
        const float* row = A + (y - fy0) * P - fx0;
        if (grads) {
          const float* up = A + (max(y - 1, 0) - fy0) * P - fx0;
          const float* dn = A + (min(y + 1, H - 1) - fy0) * P - fx0;
          gx[o] = 0.5f * (row[min(x + 1, W - 1)] - row[max(x - 1, 0)]);
          gy[o] = 0.5f * (dn[x] - up[x]);
        }
        if (gs) out.gs[o] = row[x];
      }
    }

    const int sl = l - 2;                // layers sl-1, sl, sl+1 are done
    if (sl >= 1 && sl <= p.S) {
      const float* d0 = ring + ((sl - 1) % 3) * RSZ;
      const float* d1 = ring + (sl % 3) * RSZ;
      const float* d2 = ring + ((sl + 1) % 3) * RSZ;
      float* const sc = out.score + (sl - 1) * hw;
      for (int task = threadIdx.x; task < TW * (TH / SROWS); task += NT) {
        const int ly0 = (task / TW) * SROWS, lx = task % TW;
        const int x = x0 + lx;
        if (x >= W) continue;
        const bool x_in = x >= BORDER && x < W - BORDER;
        // w[layer][dy][dx]: image (y + dy - 1, x + dx - 1), ring row y-y0+dy
        float w[3][3][3];
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int q = (ly0 + dy) * RP + lx + dx;
            w[0][dy + 1][dx] = d0[q];
            w[1][dy + 1][dx] = d1[q];
            w[2][dy + 1][dx] = d2[q];
          }
#pragma unroll
        for (int j = 0; j < SROWS; ++j) {
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              w[0][dy][dx] = w[0][dy + 1][dx];
              w[1][dy][dx] = w[1][dy + 1][dx];
              w[2][dy][dx] = w[2][dy + 1][dx];
            }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int q = (ly0 + j + 2) * RP + lx + dx;
            w[0][2][dx] = d0[q];
            w[1][2][dx] = d1[q];
            w[2][2][dx] = d2[q];
          }
          const int y = y0 + ly0 + j;
          if (y < H)
            sc[y * W + x] = (x_in && y >= BORDER && y < H - BORDER)
                                ? extremum(w, p.ct_half, p.edge_r, p.r1sq)
                                : 0.f;
        }
      }
    }

    if (b + 1 < p.nblur) {
      // the next blur's input positions outside the image get the
      // level's value at their reflect-101 position
      int oy0n, oy1n, ox0n, ox1n;
      const int rn = region(b + 1, oy0n, oy1n, ox0n, ox1n);
      const int ya = oy0n - rn, yb = oy1n + rn;
      const int xa = ox0n - rn, xb = ox1n + rn;
      if (ya < 0 || yb > H || xa < 0 || xb > W) {
        for (int y = ya + warp; y < yb; y += NW) {
          const int sy = reflect101(y, H);
          const float* src = A + (sy - fy0) * P - fx0;
          float* dst = A + (y - fy0) * P - fx0;
          if (sy != y) {
            for (int x = xa + lane; x < xb; x += 32)
              dst[x] = src[reflect101(x, W)];
          } else {
            for (int x = xa + lane; x < 0; x += 32) dst[x] = src[-x];
            for (int x = W + lane; x < xb; x += 32)
              dst[x] = src[2 * (W - 1) - x];
          }
        }
        __syncthreads();
      }
    }
  }
}

// One launch of tile variant <TW, TH, NT, HB>; HB must hold the base halo.
template <int TW, int TH, int NT, int HB>
cudaError_t launch(const float* base, const Outs& out, int H, int W,
                   Plan& p, cudaStream_t stream) {
  if (p.halo[0] > HB) return cudaErrorInvalidValue;
  constexpr size_t smem = Frame<TW, TH, HB>::BYTES;
  p.tiles_x = (W + TW - 1) / TW;
  const int tiles = p.tiles_x * ((H + TH - 1) / TH);
  cudaError_t e = cudaFuncSetAttribute(
      sift_octave_kernel<TW, TH, NT, HB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  sift_octave_kernel<TW, TH, NT, HB><<<tiles, NT, smem, stream>>>(
      base, out, H, W, p);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++imagestitch_sift_octave_launches;
  return e;
}

}  // namespace

// base: (H, W); dog (S+2, H, W), score (S, H, W), gx and gy (S+1, H, W),
// gs (H, W); all float32 contiguous on the device, fewer than 2^31
// elements each. taps: every blur's host taps in order (the pre-blur
// first when `first`), lens: their lengths (S+2+first, each odd, 3..15),
// halos: the halo of each stage (S+3+first: the base, then each blur's
// output). variant: the tile shape, an index into ops/cuda_sift.py TILES.
// 1 <= S <= 6, min(H, W) > 7. One launch.
extern "C" int imagestitch_sift_octave(const float* base, float* dog,
                                       float* score, float* gx, float* gy,
                                       float* gs, int H, int W, int S,
                                       int first, const float* taps,
                                       const int* lens, const int* halos,
                                       float ct_half, float edge_r,
                                       float r1sq, int variant,
                                       cudaStream_t stream) {
  if (S < 1 || S > 6 || H <= MAX_TAPS / 2 || W <= MAX_TAPS / 2 ||
      (first != 0 && first != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p = {};
  p.nblur = S + 2 + first;
  p.first = first;
  p.S = S;
  p.ct_half = ct_half;
  p.edge_r = edge_r;
  p.r1sq = r1sq;
  if (halos[p.nblur] < 1) return static_cast<int>(cudaErrorInvalidValue);
  p.halo[p.nblur] = halos[p.nblur];
  int off = 0;
  for (int b = 0; b < p.nblur; ++b) {
    const int n = lens[b];
    if (n < 3 || n > MAX_TAPS || n % 2 == 0 ||
        halos[b] < halos[b + 1] + (n - 1) / 2)
      return static_cast<int>(cudaErrorInvalidValue);
    p.n[b] = n;
    p.halo[b] = halos[b];
    for (int k = 0; k < n; ++k) p.taps[b][k] = taps[off + k];
    off += n;
  }
  const Outs out = {dog, score, gx, gy, gs};
  cudaError_t e = cudaErrorInvalidValue;
  switch (variant) {
    case 0: e = launch<64, 64, 512, 33>(base, out, H, W, p, stream); break;
    case 1: e = launch<32, 32, 256, 33>(base, out, H, W, p, stream); break;
    case 2: e = launch<32, 32, 256, 60>(base, out, H, W, p, stream); break;
    default: break;
  }
  return static_cast<int>(e);
}
