// Slab-load probe: for each of `steps` steps and NCH = 8 chunks, copy a
// (C, h, 384) window of a float32 source into shared memory at the
// chunk's pseudo-random (8, 128)-aligned origin, then read the window's
// first (8, 128) block of channel 0; the step's output is those blocks
// summed in chunk order (acc = 0; acc += block[ch], ch = 0..7, float32).
// The result is the last step's sum.
//
// Replaces the TPU kernel tools/exp_dma_layouts.py: build (bodies
// _kern_planar and _kern_tiled), a microbenchmark of how the cost of
// staging slab windows on chip depends on the source layout, planar
// (C, H, W) or 128-column tiled (C, W/128, H, 128).
//
// Copies: one TMA tensor-map copy (cp.async.bulk.tensor.4d) per slab,
// for both layouts, completed on an mbarrier: Hopper's counterpart of
// pltpu.make_async_copy. A 2-D box cannot be 384 wide (a box side is at
// most 256 elements), but a 4-D map splits the row into 3 tiles of 128:
//   planar: dims {128, W/128, H, C}, box {128, 3, h, C}, coordinates
//           {0, sx/128, sy, 0}; the slab lands as (C, h, 3, 128), the
//           memory order of (C, h, 384);
//   tiled:  dims {128, H, W/128, C}, box {128, h, 3, C}, coordinates
//           {0, sy, sx/128, 0}; the slab lands as (C, 3, h, 128).
// The host encodes the map per call (ops/slab_probe.py tensor_map_spec
// gives its dims, strides and box) with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint, and passes it by value. So
// both layouts cost one descriptor per slab: the layout question becomes
// whether the layout still costs anything once one copy moves the slab.
// One cp.async.bulk per contiguous run would take C*h copies of 1,536 B
// for a planar slab against C*3 of 8-24 KB tiled, and on an H100 those
// planar copies took 33-40% longer.
//
// What bounds it on an H100: the bound counts the source bytes the slabs
// cover, read once (23 MB, 0.0069 ms at 3.35 TB/s). The slabs themselves
// are 276-828 MB (h = 16-48 at 468 steps), all served from L2, since the
// 24.9 MB source stays resident in the 50 MB L2. So the probe is held to
// the card's L2-to-SM rate, which l2_ceiling_kernel below measures on the
// same source and bytes: one block per SM keeping 1-D bulk copies in
// flight into shared memory, the probe's path without its map and reads
// (7.4 TB/s at h = 48 on an H100 SXM at 700 W, chip_smoke.py's
// dma_layouts phase). Half the covered-byte bound would need 60 TB/s.
//
// Design: one persistent block per SM (blocks = min(SMs, steps), chosen by
// the wrapper). Block b copies a contiguous range of the 8 * steps slabs
// in (step, chunk) order, q = units / blocks of them and one more for the
// first units % blocks blocks (ops/slab_probe.py block_ranges), so the
// last block's range ends with the last step's 8 slabs whole, and no SM
// waits out a half-empty last wave (468 one-step blocks would run as 3.55
// waves on 132 SMs). The slabs go through a ring of `nbuf` buffers, as many as fit in
// the block's 227 KB (3 / 2 / 1 / 1 for h = 16 / 24 / 32 / 48), kept
// running across step boundaries: thread 0 issues slab i + nbuf as soon as
// every thread has read slab i. The sum resets at chunk 0 of each step;
// only the last block stores.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NCH = 8;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;          // 256 x float4 = one (8, 128) block
constexpr int MAX_BUF = NCH;
constexpr int SMEM_ALIGN = 128;       // TMA destinations
// a barrier that waits longer than this many polls traps: a copy that
// never completes ends the launch with an error instead of hanging
constexpr uint32_t MAX_POLLS = 1u << 26;

// The launch's constants, by value.
struct Probe {
  int ydim;            // the map dim of the row origin (the tile's: 3 - ydim)
  int ny, nx;          // the origin rule's window counts
  int steps, nbuf;
  int pitch;           // floats between two rows of a landed slab
  uint32_t slab_bytes; // what one copy lands
};

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
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == MAX_POLLS) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(float* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// The origin rule of tools/exp_dma_layouts.py:_origins, in uint32: the
// row origin sy and the tile sx / 128.
__device__ __forceinline__ void origin(int step, int ch, int ny, int nx,
                                       int* sy, int* tx) {
  const uint32_t r = static_cast<uint32_t>(step) * 2654435761u
                     + static_cast<uint32_t>(ch) * 40503u;
  *sy = static_cast<int>((r >> 8) % static_cast<uint32_t>(ny)) * 8;
  *tx = static_cast<int>((r >> 19) % static_cast<uint32_t>(nx));
}

// Thread 0: arm the buffer's barrier with the slab's bytes, then copy slab
// `unit` (step unit / NCH, chunk unit % NCH) with one copy.
__device__ void issue_slab(const CUtensorMap* map, float* buf, uint64_t* bar,
                           int unit, const Probe& p) {
  int sy, tx;
  origin(unit / NCH, unit % NCH, p.ny, p.nx, &sy, &tx);
  bar_arrive_expect(bar, p.slab_bytes);
  tma_load_4d(buf, map, bar, 0, p.ydim == 1 ? sy : tx,
              p.ydim == 2 ? sy : tx, 0);
}

__global__ void __launch_bounds__(THREADS)
slab_probe_kernel(__grid_constant__ const CUtensorMap map,
                  float* __restrict__ out, const Probe p) {
  extern __shared__ unsigned char smem_raw[];
  // the ring starts at the first 128-byte boundary; the barriers follow it
  const uint32_t pad = (SMEM_ALIGN - smem_addr(smem_raw) % SMEM_ALIGN)
                       % SMEM_ALIGN;
  float* slabs = reinterpret_cast<float*>(smem_raw + pad);
  const size_t slab_floats = p.slab_bytes / 4;
  uint64_t* bars = reinterpret_cast<uint64_t*>(slabs + p.nbuf * slab_floats);

  const int units = NCH * p.steps;
  const int b = blockIdx.x;
  const int q = units / gridDim.x, rem = units % gridDim.x;
  const int first = b * q + min(b, rem);
  const int count = q + (b < rem ? 1 : 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.nbuf; ++i) bar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&map)) : "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < p.nbuf && k < count; ++k) {
      issue_slab(&map, slabs + k * slab_floats, &bars[k], first + k, p);
    }
  }

  // this thread's 4 floats of the (8, 128) block of channel 0
  const int row = (threadIdx.x * 4) / TILE_W;
  const int col = (threadIdx.x * 4) % TILE_W;
  const int off = row * p.pitch + col;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = 0; k < count; ++k) {
    const int i = k % p.nbuf;
    float* buf = slabs + i * slab_floats;
    bar_wait(&bars[i], static_cast<uint32_t>((k / p.nbuf) & 1));
    if ((first + k) % NCH == 0) acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 v = *reinterpret_cast<const float4*>(buf + off);
    acc.x = acc.x + v.x;
    acc.y = acc.y + v.y;
    acc.z = acc.z + v.z;
    acc.w = acc.w + v.w;
    if (k + p.nbuf < count) {
      __syncthreads();                 // every thread has read buffer i
      if (threadIdx.x == 0) {
        // order the reads above before the async proxy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue_slab(&map, buf, &bars[i], first + k + p.nbuf, p);
      }
    }
  }
  asm volatile("" :: "f"(acc.x), "f"(acc.y), "f"(acc.z), "f"(acc.w));
  if (b == gridDim.x - 1) {
    reinterpret_cast<float4*>(out)[threadIdx.x] = acc;
  }
}

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// -lcuda.
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr) {
      return cudaErrorSymbolNotFound;
    }
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// Ring depth: as many slab buffers as fit, beside the alignment pad and
// the barriers, in the card's opt-in shared memory per block (232,448
// bytes on an H100).
cudaError_t ring_depth(long slab_bytes, int* nbuf) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const long n = (optin - SMEM_ALIGN
                  - static_cast<long>(MAX_BUF * sizeof(uint64_t)))
                 / slab_bytes;
  *nbuf = static_cast<int>(n > MAX_BUF ? MAX_BUF : n);
  return *nbuf < 1 ? cudaErrorInvalidValue : cudaSuccess;
}

// The L2 readings: one block per SM, each walking the source from its own
// origin and wrapping at its end; a block's value goes to out[block].
//
// l2_ceiling_kernel: the probe's own path without its tensor map and its
// reads. `total` copies of BULK_CHUNK bytes are split over the blocks as
// the probe splits its slabs (q = total / blocks each, one more for the
// first total % blocks), and thread 0 keeps BULK_BUF of them in flight
// into a shared-memory ring, 224 KB, as much as fits in a block's 227 KB
// (the probe's own ring holds 216 KB at h = 16, 24 and 48). This is the
// ceiling the probe is held to.
constexpr int BULK_CHUNK = 32 << 10;
constexpr int BULK_BUF = 7;
constexpr size_t BULK_SMEM = SMEM_ALIGN
                             + BULK_BUF * (BULK_CHUNK + sizeof(uint64_t));

__device__ __forceinline__ void bulk_copy(unsigned char* dst,
                                          const float* src, uint64_t* bar) {
  bar_arrive_expect(bar, BULK_CHUNK);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(BULK_CHUNK), "r"(smem_addr(bar))
      : "memory");
}

__global__ void __launch_bounds__(32)
l2_ceiling_kernel(const float* __restrict__ src, long long n_chunks,
                  long long total, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (SMEM_ALIGN - smem_addr(smem_raw) % SMEM_ALIGN)
                       % SMEM_ALIGN;
  unsigned char* ring = smem_raw + pad;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + BULK_BUF * BULK_CHUNK);
  if (threadIdx.x != 0) return;
  for (int b = 0; b < BULK_BUF; ++b) bar_init(&bars[b], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const long long count = total / gridDim.x
                          + (blockIdx.x < total % gridDim.x ? 1 : 0);
  constexpr size_t floats = BULK_CHUNK / 4;
  long long c = blockIdx.x * (n_chunks / gridDim.x) % n_chunks;
  for (int k = 0; k < BULK_BUF && k < count; ++k) {
    bulk_copy(ring + k * BULK_CHUNK, src + c * floats, &bars[k]);
    if (++c == n_chunks) c = 0;
  }
  for (long long k = 0; k < count; ++k) {
    const int b = static_cast<int>(k % BULK_BUF);
    bar_wait(&bars[b], static_cast<uint32_t>((k / BULK_BUF) & 1));
    if (k + BULK_BUF < count) {
      bulk_copy(ring + b * BULK_CHUNK, src + c * floats, &bars[b]);
      if (++c == n_chunks) c = 0;
    }
  }
  out[blockIdx.x] = count > 0 ? reinterpret_cast<const float*>(ring)[0]
                              : 0.0f;
}

// l2_loads_kernel: LOAD_THREADS threads, each with LOAD_UNROLL 16-byte
// loads in flight that skip L1. Not a ceiling: at h = 16-24 the probe's
// copies outrun it.
constexpr int LOAD_THREADS = 1024;
constexpr int LOAD_UNROLL = 4;

__global__ void __launch_bounds__(LOAD_THREADS)
l2_loads_kernel(const float4* __restrict__ src, long long n, int iters,
                float* __restrict__ out) {
  __shared__ float warp_sums[LOAD_THREADS / 32];
  long long i = (static_cast<long long>(blockIdx.x) * (n / gridDim.x)
                 + threadIdx.x) % n;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int it = 0; it < iters; ++it) {
    float4 v[LOAD_UNROLL];
#pragma unroll
    for (int u = 0; u < LOAD_UNROLL; ++u) {
      asm volatile("ld.global.nc.L1::no_allocate.v4.f32 "
                   "{%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[u].x), "=f"(v[u].y), "=f"(v[u].z), "=f"(v[u].w)
                   : "l"(src + i));
      i += LOAD_THREADS;
      if (i >= n) i -= n;
    }
#pragma unroll
    for (int u = 0; u < LOAD_UNROLL; ++u) {
      acc.x += v[u].x;
      acc.y += v[u].y;
      acc.z += v[u].z;
      acc.w += v[u].w;
    }
  }
  float s = (acc.x + acc.y) + (acc.z + acc.w);
  for (int d = 16; d > 0; d /= 2) s += __shfl_down_sync(0xffffffffu, s, d);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < LOAD_THREADS / 32; ++w) s += warp_sums[w];
    out[blockIdx.x] = s;
  }
}

}  // namespace

// src: the float32 source, 16-byte aligned; out: (8, 128) float32. The map
// (ops/slab_probe.py tensor_map_spec): dims[4] and box[4] innermost first,
// the box holding every channel, strides[3] in bytes of dims 1-3; ydim,
// xdim: the map dims that take a slab's row origin and tile (1 and 2,
// either way round). ny, nx: the
// origin rule's window counts. blocks: the persistent grid, at most
// steps. Returns a CUDA error code, or minus the CUresult of a failed
// cuTensorMapEncodeTiled.
extern "C" int imagestitch_slab_probe(const float* src, float* out,
                                      const uint64_t* dims,
                                      const uint64_t* strides,
                                      const uint32_t* box, int ydim, int xdim,
                                      int ny, int nx, int steps, int blocks,
                                      cudaStream_t stream) {
  if (!((ydim == 1 && xdim == 2) || (ydim == 2 && xdim == 1))
      || blocks < 1 || blocks > steps || box[3] != dims[3]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EncodeTiled encode = nullptr;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(src),
      reinterpret_cast<const cuuint64_t*>(dims),
      reinterpret_cast<const cuuint64_t*>(strides),
      reinterpret_cast<const cuuint32_t*>(box), ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);

  Probe p;
  p.ydim = ydim;
  p.ny = ny;
  p.nx = nx;
  p.steps = steps;
  p.slab_bytes = box[0] * box[1] * box[2] * box[3] * 4;
  p.pitch = static_cast<int>(ydim == 1 ? box[0] : box[0] * box[1]);
  err = ring_depth(p.slab_bytes, &p.nbuf);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dyn = SMEM_ALIGN + static_cast<size_t>(p.nbuf) * p.slab_bytes
                     + MAX_BUF * sizeof(uint64_t);
  err = cudaFuncSetAttribute(slab_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  slab_probe_kernel<<<blocks, THREADS, dyn, stream>>>(map, out, p);
  return static_cast<int>(cudaGetLastError());
}

// The L2 ceiling (l2_ceiling_kernel), copying `nbytes` rounded up to
// whole 32 KB chunks, and the 16-byte-load reading (l2_loads_kernel),
// reading `nbytes` rounded up to whole rounds of 16 loads a thread. src:
// n_floats float32, 16-byte aligned, at least one chunk and one round
// (a multiple of 4 floats); out: `blocks` float32; *read: the bytes read.
// Return a CUDA error code.
extern "C" int imagestitch_l2_ceiling(const float* src, long long n_floats,
                                      long long nbytes, int blocks,
                                      float* out, long long* read,
                                      cudaStream_t stream) {
  const long long n_chunks = n_floats * 4 / BULK_CHUNK;
  if (n_chunks < 1 || nbytes < 1 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = (nbytes + BULK_CHUNK - 1) / BULK_CHUNK;
  cudaError_t err = cudaFuncSetAttribute(
      l2_ceiling_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(BULK_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  l2_ceiling_kernel<<<blocks, 32, BULK_SMEM, stream>>>(src, n_chunks, total,
                                                       out);
  *read = total * BULK_CHUNK;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int imagestitch_l2_loads(const float* src, long long n_floats,
                                    long long nbytes, int blocks, float* out,
                                    long long* read, cudaStream_t stream) {
  if (n_floats % 4 || n_floats < 4LL * LOAD_THREADS * LOAD_UNROLL
      || nbytes < 1 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_round = static_cast<long long>(blocks) * LOAD_THREADS
                              * LOAD_UNROLL * 16;
  const long long iters = (nbytes + per_round - 1) / per_round;
  l2_loads_kernel<<<blocks, LOAD_THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(src), n_floats / 4,
      static_cast<int>(iters), out);
  *read = iters * per_round;
  return static_cast<int>(cudaGetLastError());
}
