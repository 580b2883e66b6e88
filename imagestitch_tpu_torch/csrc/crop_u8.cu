// The readback's crop in one launch: one pass over the (H, W, 3) float32
// panorama and its (H, W) bool mask writes the panorama as uint8 and the
// valid pixels' bounding box; the host then copies only the box's rows of
// the uint8 buffer (pipeline.py _to_uint8, ops/cuda_crop.py).
//
// Replaces no Pallas kernel. It replaces host NumPy: the whole float32
// canvas and mask read back, np.nonzero over the mask, the min and max of
// its indices, np.clip and astype(np.uint8) over the crop.
//
// Bound on an H100: bytes. 12 B of canvas and 1 B of mask read and 3 B
// written a pixel, a few operations each: 16 B a pixel, 94 MB (0.028 ms)
// for the 1458 x 4032 canvas. The design reads each input once:
// - Four pixels a thread and step, in a grid-stride loop over
//   min(groups, 8 blocks an SM) blocks of 256 threads: an interleaved
//   canvas is three 16-byte loads (48 B, four pixels), a planar one (the
//   multi-band blend's, channel planes of H W floats) one 16-byte load a
//   plane; the mask one 4-byte load; the output three 4-byte stores.
//   Neighbouring threads read neighbouring addresses. A canvas or mask
//   not aligned for that, and the last group of fewer than four pixels,
//   go pixel by pixel.
// - The value: np.clip(p, 0, 255).astype(np.uint8) as NumPy computes it
//   on x86, clamp and then truncate toward zero; fmaxf(NaN, 0) is 0, so
//   NaN gives 0 as the host cast does; +inf 255, -inf 0.
// - The bounding box as four maxima, of -y, -x, y and x over the valid
//   pixels: each thread over its pixels, then the warp (__reduce_max_sync),
//   then the block's warps, then one atomicMax per maximum and block. The
//   caller sets the four ints to 0x80808080 (a memset of 16 bytes on the
//   same stream, before the launch), below any of them, so a mask with no
//   valid pixel leaves y1 negative.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 8;
constexpr int NONE = static_cast<int>(0x80808080u);   // the memset's int

// np.clip(p, 0, 255).astype(np.uint8): NaN -> 0 (fmaxf returns the number)
__device__ __forceinline__ uint32_t to_u8(float p) {
  return static_cast<uint32_t>(fminf(fmaxf(p, 0.f), 255.f));
}

struct Box {
  int ny0 = NONE, nx0 = NONE, y1 = NONE, x1 = NONE;

  __device__ __forceinline__ void add(int y, int x) {
    ny0 = max(ny0, -y);
    nx0 = max(nx0, -x);
    y1 = max(y1, y);
    x1 = max(x1, x);
  }
};

// One pixel p (row y, column x): its three bytes, and the box if valid.
__device__ __forceinline__ void one_pixel(const float* __restrict__ canvas,
                                          const uint8_t* __restrict__ mask,
                                          uint8_t* __restrict__ out,
                                          long long p, long long px_stride,
                                          long long ch_stride, int W,
                                          Box& box) {
  for (int c = 0; c < 3; ++c)
    out[3 * p + c] = static_cast<uint8_t>(
        to_u8(canvas[p * px_stride + c * ch_stride]));
  if (mask[p]) box.add(static_cast<int>(p / W), static_cast<int>(p % W));
}

template <bool PLANAR>
__global__ void __launch_bounds__(THREADS)
crop_u8_kernel(const float* __restrict__ canvas,
               const uint8_t* __restrict__ mask, int H, int W,
               bool vector, uint8_t* __restrict__ out, int* bbox) {
  const long long n = static_cast<long long>(H) * W;
  const long long groups = (n + 3) / 4;
  const long long full = vector ? n / 4 : 0;   // groups taken 16 B at a time
  const long long px_stride = PLANAR ? 1 : 3;
  const long long ch_stride = PLANAR ? n : 1;
  Box box;
  for (long long g = blockIdx.x * (long long)THREADS + threadIdx.x;
       g < groups; g += (long long)gridDim.x * THREADS) {
    if (g >= full) {
      for (long long p = 4 * g; p < n && p < 4 * g + 4; ++p)
        one_pixel(canvas, mask, out, p, px_stride, ch_stride, W, box);
      continue;
    }
    float v[12];   // pixel k's channel c at v[3 k + c]
    if (PLANAR) {
      for (int c = 0; c < 3; ++c) {
        const float4 q = __ldcs(reinterpret_cast<const float4*>(
            canvas + c * n) + g);
        v[c] = q.x;
        v[3 + c] = q.y;
        v[6 + c] = q.z;
        v[9 + c] = q.w;
      }
    } else {
      const float4* src = reinterpret_cast<const float4*>(canvas) + 3 * g;
      for (int j = 0; j < 3; ++j) {
        const float4 q = __ldcs(src + j);
        v[4 * j] = q.x;
        v[4 * j + 1] = q.y;
        v[4 * j + 2] = q.z;
        v[4 * j + 3] = q.w;
      }
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(out) + 3 * g;
    for (int j = 0; j < 3; ++j)
      dst[j] = to_u8(v[4 * j]) | to_u8(v[4 * j + 1]) << 8 |
               to_u8(v[4 * j + 2]) << 16 | to_u8(v[4 * j + 3]) << 24;
    const uint32_t m = reinterpret_cast<const uint32_t*>(mask)[g];
    if (m) {
      const long long p = 4 * g;
      int y = static_cast<int>(p / W), x = static_cast<int>(p % W);
      for (int k = 0; k < 4; ++k) {
        if ((m >> (8 * k)) & 0xffu) box.add(y, x);
        if (++x == W) {
          x = 0;
          ++y;
        }
      }
    }
  }

  __shared__ int red[4][WARPS];
  int vals[4] = {box.ny0, box.nx0, box.y1, box.x1};
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int i = 0; i < 4; ++i) {
    vals[i] = __reduce_max_sync(0xffffffffu, vals[i]);
    if (lane == 0) red[i][warp] = vals[i];
  }
  __syncthreads();
  if (threadIdx.x >= 4) return;
  int best = red[threadIdx.x][0];
  for (int w = 1; w < WARPS; ++w) best = max(best, red[threadIdx.x][w]);
  if (best != NONE) atomicMax(bbox + threadIdx.x, best);
}

}  // namespace

// The uint8 panorama and its mask's bounding box. `canvas`: H W pixels of
// 3 float32, interleaved ((H, W, 3) contiguous) or, with `planar`, three
// contiguous planes of H W floats; `mask`: (H, W) bytes, nonzero valid;
// `out`: (H, W, 3) uint8; `bbox`: 4 ints, set here to 0x80808080 and then
// to the maxima of -y, -x, y and x over the valid pixels (y1 = bbox[2]
// stays negative when none is valid). Everything on `stream`, no sync.
// Returns a CUDA error code; 0 on a launch.
extern "C" int imagestitch_crop_u8(const float* canvas, const uint8_t* mask,
                                   int H, int W, int planar, uint8_t* out,
                                   int* bbox, cudaStream_t stream) {
  if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaMemsetAsync(bbox, 0x80, 16, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(H) * W;
  const long long groups = (n + 3) / 4;
  const bool vector = reinterpret_cast<uintptr_t>(canvas) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 4 == 0 &&
                      (!planar || n % 4 == 0);
  const long long want = (groups + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(
      want < (long long)sms * BLOCKS_PER_SM ? want
                                            : (long long)sms * BLOCKS_PER_SM);
  if (planar)
    crop_u8_kernel<true><<<blocks, THREADS, 0, stream>>>(
        canvas, mask, H, W, vector, out, bbox);
  else
    crop_u8_kernel<false><<<blocks, THREADS, 0, stream>>>(
        canvas, mask, H, W, vector, out, bbox);
  return static_cast<int>(cudaGetLastError());
}

// Rows y0 .. y0 + h - 1, columns x0 .. x0 + w - 1 of an (H, W, 3) uint8
// device buffer of row pitch 3 W, copied to `host` (page-locked) as a
// contiguous (h, w, 3) array, in one strided copy on `stream`, no sync.
// Returns a CUDA error code.
extern "C" int imagestitch_crop_copy(const uint8_t* quantized, int H, int W,
                                     int y0, int x0, int h, int w,
                                     uint8_t* host, cudaStream_t stream) {
  if (h < 1 || w < 1 || y0 < 0 || x0 < 0 || y0 + h > H || x0 + w > W)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t pitch = 3 * static_cast<size_t>(W);
  return static_cast<int>(cudaMemcpy2DAsync(
      host, 3 * static_cast<size_t>(w),
      quantized + y0 * pitch + 3 * static_cast<size_t>(x0), pitch,
      3 * static_cast<size_t>(w), h, cudaMemcpyDeviceToHost, stream));
}
