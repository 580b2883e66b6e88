// SIFT octave maps of one (H, W) float32 image: the S+3 chained Gaussian
// levels, then the DoG layers, the 26-neighbour extremum scores of the
// interior layers (contrast and Hessian edge tests, 8 px border mask),
// the edge-clamped central-difference gradients of levels 1..S+1 and
// level S.
//
// Replaces the TPU kernel imagestitch_tpu/ops/pallas_sift.py:
// sift_octave_maps (body _sift_kernel). Its 64-row bands, lane-roll shifts
// and 2·halo size gate are not carried over: the semantics are those of
// the XLA path (features/sift.py _octave_maps with use_pallas=False) at
// every size, with reflect-101 borders at every blur and edge-clamped
// gradients.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s float32 off the tensor cores):
// per octave pixel it must read 4 bytes and write 17 planes of 4 bytes
// (dog S+2, score S, gx and gy S+1 each, gS; S = 3), 72 bytes, and it does
// about 500 float32 operations (the separable blurs take half, the 26
// comparisons per interior layer most of the rest): about 7 operations
// per byte, below the card's ~20 flop/byte balance, so the bound is the
// bytes.
//
// Every product and sum rounds on its own (built with --fmad=false), in
// the plain version's order (ops/cuda_sift.py), so the card holds the two
// to equality.
//
// Design (simple first version): each blur is two passes, vertical then
// horizontal, one thread per pixel, through one scratch plane; the levels
// live in a (S+3, H, W) scratch in device memory. One last pass, one
// thread per pixel, reads the 3x3 neighbourhood of every level and writes
// all five outputs once; the DoG values of the 3x3x3 neighbourhood are
// recomputed from the levels, the same subtraction the dog output holds.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_TAPS = 15;
constexpr int BORDER = 8;

struct Taps { float k[MAX_TAPS]; int n; };

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

// vertical pass: out[y][x] = sum_k taps[k] * in[reflect(y - r + k)][x]
__global__ void __launch_bounds__(256)
blur_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
                 int H, int W, Taps t) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int r = (t.n - 1) / 2;
  float acc = t.k[0] * in[static_cast<size_t>(reflect101(y - r, H)) * W + x];
  for (int k = 1; k < t.n; ++k)
    acc = acc + t.k[k] * in[static_cast<size_t>(reflect101(y - r + k, H)) * W
                            + x];
  out[static_cast<size_t>(y) * W + x] = acc;
}

// horizontal pass: out[y][x] = sum_k taps[k] * in[y][reflect(x - r + k)]
__global__ void __launch_bounds__(256)
blur_cols_kernel(const float* __restrict__ in, float* __restrict__ out,
                 int H, int W, Taps t) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int r = (t.n - 1) / 2;
  const float* row = in + static_cast<size_t>(y) * W;
  float acc = t.k[0] * row[reflect101(x - r, W)];
  for (int k = 1; k < t.n; ++k)
    acc = acc + t.k[k] * row[reflect101(x - r + k, W)];
  out[static_cast<size_t>(y) * W + x] = acc;
}

// level l: the octave base (level 0 of a later octave) or the scratch
__device__ __forceinline__ const float* level(const float* l0,
                                              const float* lev, int l,
                                              size_t hw) {
  return l == 0 ? l0 : lev + static_cast<size_t>(l) * hw;
}

template <int S>
__global__ void __launch_bounds__(256)
octave_maps_kernel(const float* __restrict__ l0,
                   const float* __restrict__ lev, float* __restrict__ dog,
                   float* __restrict__ score, float* __restrict__ gx,
                   float* __restrict__ gy, float* __restrict__ gs, int H,
                   int W, float ct_half, float edge_r, float r1sq) {
  constexpr int NL = S + 3;      // levels
  constexpr int ND = S + 2;      // DoG layers
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t hw = static_cast<size_t>(H) * W;
  const size_t o = static_cast<size_t>(y) * W + x;

  float v[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) v[l] = level(l0, lev, l, hw)[o];
#pragma unroll
  for (int l = 0; l < ND; ++l) dog[l * hw + o] = v[l + 1] - v[l];
  gs[o] = v[S];

  // edge-clamped central differences of levels 1..S+1
  const size_t oxp = static_cast<size_t>(y) * W + min(x + 1, W - 1);
  const size_t oxm = static_cast<size_t>(y) * W + max(x - 1, 0);
  const size_t oyp = static_cast<size_t>(min(y + 1, H - 1)) * W + x;
  const size_t oym = static_cast<size_t>(max(y - 1, 0)) * W + x;
#pragma unroll
  for (int l = 1; l <= S + 1; ++l) {
    const float* p = level(l0, lev, l, hw);
    gx[(l - 1) * hw + o] = 0.5f * (p[oxp] - p[oxm]);
    gy[(l - 1) * hw + o] = 0.5f * (p[oyp] - p[oym]);
  }

  if (y < BORDER || y >= H - BORDER || x < BORDER || x >= W - BORDER) {
#pragma unroll
    for (int l = 0; l < S; ++l) score[l * hw + o] = 0.f;
    return;
  }

  // the 3x3 DoG neighbourhood of every layer, d[l][dy][dx]
  float d[ND][3][3];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const size_t q = static_cast<size_t>(y + dy - 1) * W + (x + dx - 1);
      float prev = level(l0, lev, 0, hw)[q];
#pragma unroll
      for (int l = 0; l < ND; ++l) {
        const float next = level(l0, lev, l + 1, hw)[q];
        d[l][dy][dx] = next - prev;
        prev = next;
      }
    }

#pragma unroll
  for (int l = 1; l <= S; ++l) {
    const float c = d[l][1][1];
    bool is_max = true, is_min = true;
#pragma unroll
    for (int dl = -1; dl <= 1; ++dl)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          if (dl == 0 && dy == 1 && dx == 1) continue;
          const float nb = d[l + dl][dy][dx];
          is_max = is_max && (c > nb);
          is_min = is_min && (c < nb);
        }
    const float ac = fabsf(c);
    float s = (is_max || is_min) ? ac : 0.f;
    s = ac >= ct_half ? s : 0.f;
    const float dxx = (d[l][1][2] + d[l][1][0]) - 2.0f * c;
    const float dyy = (d[l][2][1] + d[l][0][1]) - 2.0f * c;
    const float dxy =
        0.25f * (((d[l][2][2] + d[l][0][0]) - d[l][2][0]) - d[l][0][2]);
    const float tr = dxx + dyy;
    const float det = dxx * dyy - dxy * dxy;
    const bool edge_ok = (det > 0.f) && (tr * tr * edge_r < r1sq * det);
    score[(l - 1) * hw + o] = edge_ok ? s : 0.f;
  }
}

template <int S>
cudaError_t launch_maps(dim3 grid, dim3 block, cudaStream_t stream,
                        const float* l0, const float* lev, float* dog,
                        float* score, float* gx, float* gy, float* gs,
                        int H, int W, float ct_half, float edge_r,
                        float r1sq) {
  octave_maps_kernel<S><<<grid, block, 0, stream>>>(
      l0, lev, dog, score, gx, gy, gs, H, W, ct_half, edge_r, r1sq);
  return cudaGetLastError();
}

}  // namespace

// base: (H, W); scratch: (S+4, H, W) (levels 0..S+2, then one pass plane);
// dog (S+2, H, W), score (S, H, W), gx and gy (S+1, H, W), gs (H, W); all
// float32 contiguous on the device. taps: the host taps of every blur in
// order (the pre-blur first when `first`), lens[0] the pre-blur's length
// (0 when none), lens[1..S+2] the chained blurs'. 1 <= S <= 6,
// min(H, W) > 7.
extern "C" int imagestitch_sift_octave(const float* base, float* scratch,
                                       float* dog, float* score, float* gx,
                                       float* gy, float* gs, int H, int W,
                                       int S, int first, const float* taps,
                                       const int* lens, float ct_half,
                                       float edge_r, float r1sq,
                                       cudaStream_t stream) {
  if (S < 1 || S > 6 || H <= MAX_TAPS / 2 || W <= MAX_TAPS / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = first ? 0 : 1; i < S + 3; ++i)
    if (lens[i] < 1 || lens[i] > MAX_TAPS || lens[i] % 2 == 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const size_t hw = static_cast<size_t>(H) * W;
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8);
  float* tmp = scratch + static_cast<size_t>(S + 3) * hw;

  auto blur = [&](const float* in, float* out, const float* k,
                  int n) -> cudaError_t {
    Taps t;
    t.n = n;
    for (int i = 0; i < MAX_TAPS; ++i) t.k[i] = i < n ? k[i] : 0.f;
    blur_rows_kernel<<<grid, block, 0, stream>>>(in, tmp, H, W, t);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    blur_cols_kernel<<<grid, block, 0, stream>>>(tmp, out, H, W, t);
    return cudaGetLastError();
  };

  const float* l0 = base;
  int off = 0;
  if (first) {
    cudaError_t e = blur(base, scratch, taps, lens[0]);
    if (e != cudaSuccess) return static_cast<int>(e);
    l0 = scratch;
    off = lens[0];
  }
  const float* prev = l0;
  for (int s = 1; s <= S + 2; ++s) {
    float* out = scratch + static_cast<size_t>(s) * hw;
    cudaError_t e = blur(prev, out, taps + off, lens[s]);
    if (e != cudaSuccess) return static_cast<int>(e);
    off += lens[s];
    prev = out;
  }

  cudaError_t e = cudaErrorInvalidValue;
  switch (S) {
#define SIFT_CASE(n)                                                       \
  case n:                                                                  \
    e = launch_maps<n>(grid, block, stream, l0, scratch, dog, score, gx,   \
                       gy, gs, H, W, ct_half, edge_r, r1sq);               \
    break;
    SIFT_CASE(1) SIFT_CASE(2) SIFT_CASE(3) SIFT_CASE(4) SIFT_CASE(5)
    SIFT_CASE(6)
#undef SIFT_CASE
  }
  return static_cast<int>(e);
}
