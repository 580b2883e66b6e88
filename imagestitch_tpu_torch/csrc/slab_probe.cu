// Slab-load probe: for each of `steps` steps and NCH = 8 chunks, copy a
// (C, h, 384) window of a float32 source into shared memory at the
// chunk's pseudo-random (8, 128)-aligned origin, then read the window's
// first (8, 128) block of channel 0; the step's output is those blocks
// summed in chunk order (acc = 0; acc += block[ch], ch = 0..7, float32).
// The result is the last step's sum.
//
// Replaces the TPU kernel tools/exp_dma_layouts.py: build (bodies
// _kern_planar and _kern_tiled), a microbenchmark of how the cost of
// staging slab windows on chip depends on the source layout:
//   planar (C, H, W):           one copy per (channel, row), C*h runs of
//                               384 floats (1,536 B);
//   tiled  (C, W/128, H, 128):  one copy per (channel, 128-column tile),
//                               C*3 runs of h*128 floats (8-24 KB).
// Each run is one asynchronous bulk copy (cp.async.bulk) into shared
// memory, completed on an mbarrier: Hopper's counterpart of
// pltpu.make_async_copy. A 2-D TMA box cannot be 384 wide (a box side is
// at most 256), and the layout question is about contiguous runs, so the
// copies stay one per run. Every run starts at a multiple of 128 floats
// and is a multiple of 16 bytes long, as bulk copies require.
//
// Bound on an H100 (3.35 TB/s): the slab bytes, steps * 8 * C * h * 384 * 4
// (276 / 414 / 552 / 828 MB for h = 16 / 24 / 32 / 48 at 468 steps), if
// each slab came from device memory. The 24.9 MB source fits in the 50 MB
// L2, so back-to-back calls are served from L2 and may beat that figure.
//
// Design, simple first: one block per step (the TPU's grid step), its
// eight slabs in turn through a ring of `nbuf` slab buffers, as many as
// fit in the block's 227 KB of shared memory (3 / 2 / 1 / 1 for
// h = 16 / 24 / 32 / 48). Warp 0 issues a slab's copies, lane 0 first
// arming the buffer's mbarrier with the slab's byte count; all threads
// wait on it, read their 4 floats of the block and add them in chunk
// order. The buffer is refilled with the slab nbuf chunks later once every
// thread has read it. At h >= 32 one slab fills the SM, so the card's
// parallelism is its 132 SMs, each with one slab in flight. Blocks run in
// no order; only the last step's block stores, and the others hand their
// sums to an empty asm statement, so no read is dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NCH = 8;
constexpr int SLAB_W = 384;
constexpr int TILE_W = 128;
constexpr int TILES = SLAB_W / TILE_W;
constexpr int THREADS = 256;          // 256 x float4 = one (8, 128) block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The origin rule of tools/exp_dma_layouts.py:_origins, in uint32.
__device__ __forceinline__ void origin(int step, int ch, int ny, int nx,
                                       int* sy, int* sx) {
  const uint32_t r = static_cast<uint32_t>(step) * 2654435761u
                     + static_cast<uint32_t>(ch) * 40503u;
  *sy = static_cast<int>((r >> 8) % static_cast<uint32_t>(ny)) * 8;
  *sx = static_cast<int>((r >> 19) % static_cast<uint32_t>(nx)) * TILE_W;
}

// Warp 0: arm the buffer's barrier with the slab's bytes, then copy the
// slab of chunk `ch` of `step` as its contiguous runs, 32 lanes in turn.
// Planar runs land as (C, h, 384); tiled runs as (C, 3, h, 128).
__device__ void issue_slab(const float* __restrict__ src, float* buf,
                           uint64_t* bar, int step, int ch, int C, int H,
                           int W, int h, int tiled, int ny, int nx) {
  const int lane = threadIdx.x & 31;
  int sy, sx;
  origin(step, ch, ny, nx, &sy, &sx);
  if (lane == 0) {
    bar_arrive_expect(bar, static_cast<uint32_t>(C * h * SLAB_W * 4));
  }
  __syncwarp();
  if (tiled) {
    // src (C, W/128, H, 128): run (c, t) is rows sy..sy+h of tile sx/128+t
    const int nt = W / TILE_W;
    for (int run = lane; run < C * TILES; run += 32) {
      const int c = run / TILES, t = run % TILES;
      const float* g = src + ((static_cast<size_t>(c) * nt + sx / TILE_W + t)
                              * H + sy) * TILE_W;
      bulk_copy(buf + static_cast<size_t>(run) * h * TILE_W, g,
                static_cast<uint32_t>(h * TILE_W * 4), bar);
    }
  } else {
    // src (C, H, W): run (c, r) is 384 floats of row sy + r of channel c
    for (int run = lane; run < C * h; run += 32) {
      const int c = run / h, r = run % h;
      const float* g = src + (static_cast<size_t>(c) * H + sy + r) * W + sx;
      bulk_copy(buf + static_cast<size_t>(run) * SLAB_W, g,
                static_cast<uint32_t>(SLAB_W * 4), bar);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
slab_probe_kernel(const float* __restrict__ src, float* __restrict__ out,
                  int C, int H, int W, int h, int tiled, int ny, int nx,
                  int steps, int nbuf) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[NCH];
  float* slabs = reinterpret_cast<float*>(smem);
  const size_t slab_floats = static_cast<size_t>(C) * h * SLAB_W;
  const int step = blockIdx.x;
  const bool producer = threadIdx.x < 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < nbuf; ++b) bar_init(&bars[b], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    for (int ch = 0; ch < nbuf && ch < NCH; ++ch) {
      issue_slab(src, slabs + ch * slab_floats, &bars[ch], step, ch, C, H, W,
                 h, tiled, ny, nx);
    }
  }

  // this thread's 4 floats of the (8, 128) block of channel 0
  const int row = (threadIdx.x * 4) / TILE_W;
  const int col = (threadIdx.x * 4) % TILE_W;
  const int off = row * (tiled ? TILE_W : SLAB_W) + col;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int ch = 0; ch < NCH; ++ch) {
    const int b = ch % nbuf;
    float* buf = slabs + b * slab_floats;
    bar_wait(&bars[b], static_cast<uint32_t>((ch / nbuf) & 1));
    const float4 v = *reinterpret_cast<const float4*>(buf + off);
    acc.x = acc.x + v.x;
    acc.y = acc.y + v.y;
    acc.z = acc.z + v.z;
    acc.w = acc.w + v.w;
    const int next = ch + nbuf;
    if (next < NCH) {
      __syncthreads();                 // every thread has read buffer b
      if (producer) {
        // order the reads above before the async proxy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_slab(src, buf, &bars[b], step, next, C, H, W, h, tiled, ny,
                   nx);
      }
    }
  }
  asm volatile("" :: "f"(acc.x), "f"(acc.y), "f"(acc.z), "f"(acc.w));
  if (step == steps - 1) {
    reinterpret_cast<float4*>(out)[threadIdx.x] = acc;
  }
}

// Ring depth: as many slab buffers as fit, beside the barriers, in the
// card's opt-in shared memory per block (232,448 bytes on an H100).
cudaError_t ring_depth(int C, int h, int* nbuf) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long slab_bytes = static_cast<long>(C) * h * SLAB_W * 4;
  const long n = (optin - static_cast<long>(NCH * sizeof(uint64_t)))
                 / slab_bytes;
  *nbuf = static_cast<int>(n > NCH ? NCH : n);
  return *nbuf < 1 ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

// src: planar (C, H, W) or tiled (C, W/128, H, 128) float32, contiguous,
// 16-byte aligned; out: (8, 128) float32. H and W are the planar height
// and width (for tiled, W = 128 x the tile count). ny, nx: the origin
// rule's row and column window counts. Returns a CUDA error code.
extern "C" int imagestitch_slab_probe(const float* src, float* out, int C,
                                      int H, int W, int h, int tiled,
                                      int ny, int nx, int steps,
                                      cudaStream_t stream) {
  int nbuf = 0;
  cudaError_t err = ring_depth(C, h, &nbuf);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dyn = static_cast<size_t>(nbuf) * C * h * SLAB_W * 4;
  err = cudaFuncSetAttribute(slab_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_probe_kernel<<<steps, THREADS, dyn, stream>>>(
      src, out, C, H, W, h, tiled, ny, nx, steps, nbuf);
  return static_cast<int>(cudaGetLastError());
}
