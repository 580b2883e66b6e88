// The DP seam in one launch: the forward recurrence of seam/dp.py's
// dp_seam_path over every cost row, the argmin of the last row and the
// backtrack, in one thread block; the seam's columns stay on the device.
//
// Replaces no Pallas kernel. It replaces the JAX package's chunked
// lax.scan (imagestitch_tpu/seam/dp.py dp_seam_path), which the port had
// turned into a host loop of about 23 small launches per cost row and one
// readback of the int8 choices for a NumPy backtrack.
//
// Bound on an H100: latency. A (365, 544) cost is 0.8 MB read once and
// 0.2 MB of choices written once, and a few operations per cell; but each
// row needs the whole previous row, so the rows are a chain of barriers,
// and the backtrack is a chain of dependent loads. The design keeps the
// chain inside one block of one launch, with no host in the loop.
//
// Design:
// - One block per seam; threads = min(1024, W rounded up to 32), thread t
//   owning columns t, t + threads, ..., so every global access is
//   coalesced and every shared access conflict-free. Rows of any width:
//   a thread's first column (every column up to 1024, which holds every
//   cell's window) has its next cost loaded into a register while the
//   current row is computed; its further columns load theirs in the row.
//   One instantiation for every width: holding further columns in
//   registers as well (templates of 2 to 16 a thread) made the cells'
//   rows slower by a third or more, for at most 17% on rows wider than
//   2048 columns.
// - The running row m double-buffered (2 W floats): a row reads one
//   buffer and writes the other, so one barrier per row. The buffers are
//   in shared memory when they fit in the block's opt-in maximum, and in
//   a global scratch buffer of the caller's otherwise (rows wider than
//   about 29000 columns on an H100).
// - The row's barrier is __syncthreads_or over "some cost of the next row
//   < BIG", which is the plain path's row_has: a row with no overlap
//   enters as zeros.
// - Each transition is the plain loop's arithmetic in float32, in its
//   order: left = m[c-1] (BIG at c = 0), right = m[c+1] (BIG at W-1); the
//   first minimum among (left, straight, right) as the choice 0/1/2;
//   best = min(min(left, m), right) with NaN propagating as in
//   torch.minimum; m' = min(rest + best, BIG) as torch.clamp (NaN stays).
//   The choices go to a (T, W) int8 scratch buffer in global memory.
// - T, the transitions, is the caller's: H - 1 padded with free (zero)
//   rows, so the backtrack starts from the plain loop's padded bottom.
// - The argmin of the last row: each thread over its columns, then warp
//   shuffles, then the warps' winners; NaN first and the lowest index on
//   ties, as torch.argmin.
// - The backtrack: thread 0 walks the choices up from the argmin; a move
//   off the grid keeps the position. It writes the (H,) int64 columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e9f;
constexpr int MAX_THREADS = 1024;
constexpr int WARPS = MAX_THREADS / 32;

// torch.minimum: NaN when either is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// Whether (a, ia) comes before (b, ib) in torch.argmin's order: NaN
// first, then the smaller value, then the smaller index; ib < 0 is none.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (ia < 0) return false;
  if (ib < 0) return true;
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && (!bn || ia < ib);
  return a < b || (a == b && ia < ib);
}

// The cost at (row, c), 0 past the last row or the last column.
__device__ __forceinline__ float cost_at(const float* __restrict__ cost,
                                         int row, int c, int H, int W) {
  return row < H && c < W ? cost[(size_t)row * W + c] : 0.f;
}

// Whether some cost of row `row` at this thread's columns past its first
// is < BIG (rows of more than blockDim.x columns only).
__device__ __forceinline__ int tail_has(const float* __restrict__ cost,
                                        int row, int H, int W) {
  int any = 0;
  if (row < H)
    for (int c = threadIdx.x + blockDim.x; c < W; c += blockDim.x)
      any |= cost[(size_t)row * W + c] < BIG;
  return any;
}

// One transition at column c: the choice into ch[c], the new m into out.
__device__ __forceinline__ void step(const float* m, float* out, int8_t* ch,
                                     int c, int W, float rest) {
  const float s = m[c];
  const float left = c > 0 ? m[c - 1] : BIG;
  const float right = c < W - 1 ? m[c + 1] : BIG;
  // first minimum among (left, straight, right)
  const bool take_l = left <= s && left <= right;
  const bool take_s = !take_l && s <= right;
  ch[c] = take_l ? 0 : (take_s ? 1 : 2);
  const float best = min_nan(min_nan(left, s), right);
  const float sum = rest + best;
  out[c] = sum > BIG ? BIG : sum;
}

__global__ void __launch_bounds__(MAX_THREADS)
dp_seam_kernel(const float* __restrict__ cost, int H, int W, int T,
               float* m_global, int8_t* choices,
               long long* __restrict__ cols) {
  extern __shared__ float smem[];   // the warps' argmins, then m if it fits
  float* red_v = smem;
  int* red_i = reinterpret_cast<int*>(smem + WARPS);
  float* mbuf = m_global ? m_global : smem + 2 * WARPS;
  const int nt = blockDim.x;
  const int c0 = threadIdx.x;   // this thread's first column

  float v = cost_at(cost, 0, c0, H, W);
  const int has0 = __syncthreads_or((c0 < W && v < BIG) |
                                    tail_has(cost, 0, H, W));
  if (c0 < W) mbuf[c0] = has0 ? v : 0.f;
  for (int c = c0 + nt; c < W; c += nt) mbuf[c] = has0 ? cost[c] : 0.f;
  // the barrier publishes row 0 and says whether row 1 has overlap
  v = cost_at(cost, 1, c0, H, W);
  int has = __syncthreads_or((1 < H && c0 < W && v < BIG) |
                             tail_has(cost, 1, H, W));
  for (int r = 0; r < T; ++r) {
    const float* m = mbuf + (r & 1) * W;
    float* out = mbuf + ((r + 1) & 1) * W;
    const float rest = has ? v : 0.f;
    v = cost_at(cost, r + 2, c0, H, W);   // in flight through the row
    int next_has = tail_has(cost, r + 2, H, W);
    int8_t* ch = choices + (size_t)r * W;
    if (c0 < W) step(m, out, ch, c0, W, rest);
    const float* next = cost + (size_t)(r + 1) * W;
    for (int c = c0 + nt; c < W; c += nt)
      step(m, out, ch, c, W, has ? next[c] : 0.f);
    // v is read only here, after the row's transitions
    next_has |= r + 2 < H && c0 < W && v < BIG;
    has = __syncthreads_or(next_has);
  }

  // argmin of the last row
  const float* m = mbuf + (T & 1) * W;
  float bv = 0.f;
  int bi = -1;
  for (int c = threadIdx.x; c < W; c += nt) {
    if (before(m[c], c, bv, bi)) {
      bv = m[c];
      bi = c;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    if (before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();   // also makes every thread's choices visible
  if (threadIdx.x != 0) return;
  for (int w = 1; w < nt / 32; ++w) {
    if (before(red_v[w], red_i[w], bv, bi)) {
      bv = red_v[w];
      bi = red_i[w];
    }
  }

  // the backtrack; a move off the grid keeps the position
  int col = bi;
  for (int r = T - 1; r >= 0; --r) {
    if (r + 1 < H) cols[r + 1] = col;
    const int o = choices[(size_t)r * W + col];
    const int nxt = o == 0 ? col - 1 : (o == 2 ? col + 1 : col);
    if (nxt >= 0 && nxt < W) col = nxt;
  }
  cols[0] = col;
}

}  // namespace

// The seam of an (H, W) float32 cost, row-major and contiguous: `cols`
// (H,) int64. T >= H - 1 is the number of transitions, the rows past
// H - 1 free; `choices` is (T, W) int8 scratch and `m_scratch` 2 W
// floats of scratch, used when m's two rows do not fit in shared memory.
// Returns a CUDA error code; 0 on a launch.
extern "C" int imagestitch_dp_seam(const float* cost, int H, int W, int T,
                                   float* m_scratch, int8_t* choices,
                                   long long* cols, cudaStream_t stream) {
  if (H < 1 || W < 1 || T < H - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t red = 2 * WARPS * sizeof(float);
  const size_t rows = 2 * (size_t)W * sizeof(float);
  const bool shared_m = red + rows <= (size_t)optin;
  const size_t bytes = red + (shared_m ? rows : 0);
  err = cudaFuncSetAttribute(dp_seam_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = W < MAX_THREADS ? (W + 31) / 32 * 32 : MAX_THREADS;
  dp_seam_kernel<<<1, threads, bytes, stream>>>(
      cost, H, W, T, shared_m ? nullptr : m_scratch, choices, cols);
  return static_cast<int>(cudaGetLastError());
}
