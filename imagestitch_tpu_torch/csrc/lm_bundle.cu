// Levenberg–Marquardt bundle adjustment in one launch: the whole
// minimisation of geometry/bundle._lm_minimize (the ray adjuster's or the
// reprojection adjuster's residuals) runs in one thread block, and the
// host reads the result back once.
//
// Replaces no Pallas kernel. It replaces the JAX package's jitted
// lax.while_loop (imagestitch_tpu/geometry/bundle.py:62 _lm_minimize),
// which the port had turned into a host loop of jacfwd steps, each a few
// hundred small dispatches and one read of the stopping test.
//
// Bound on an H100: neither bytes nor operations. At most 2560
// correspondences (the chain's 5 pairs of 512 matches) are read 2 times
// per iteration for at most 25 iterations, all from L2, and the
// arithmetic is some thousands of operations per correspondence. The
// bound is latency: per iteration, one block reduction per pair, an n x n
// LU (n = 4 or 7 parameters per camera) and one reduction of the trial
// error, each a chain of barriers. The design answers that by keeping
// every iteration in one block in one launch, with no host in the loop.
//
// Design:
// - The same arithmetic, schedule and stopping rule as the plain loop, in
//   float32: λ from 1e-3, λ·0.5 on an accepted step and λ·4 on a rejected
//   one, clamped to [1e-10, 1e10]; D = diag(max(diag(A), 1e-8)); a
//   non-finite step becomes 0; the loop stops when an accepted step
//   improves the error by < 1e-6 relative, when λ > 1e8 or after `iters`.
// - The Jacobian by forward-mode dual numbers in registers: a residual is
//   evaluated on Dual<2K> values carrying the tangents of the two cameras
//   it touches, with the plain residual's operations in its order
//   (rodrigues_to_R's small-angle branch, the normalised rays, the
//   sqrt|f_i·f_j| scale, the point mask), so the residuals are the plain
//   ones and the rows jacfwd's up to rounding (a tangent multiplies by
//   one reciprocal where jacfwd divides). The two residuals are two
//   functors (Ray, Reproj) over one templated LM loop. Each camera's
//   parameters, rotation and its tangents are computed once per pass
//   into shared memory.
// - The normal equations pair by pair in a fixed order: each thread sums
//   the upper triangle of its correspondences' 2K x 2K block of JᵀJ and
//   their Jᵀr, a warp reduces them with shuffles and the warps' sums are
//   added in warp order into A (n x n in shared memory). No float
//   atomics: the same inputs give the same bits on every run.
// - A rejected step leaves x, and so A and Jᵀr, as they were: the next
//   iteration reuses them instead of recomputing the same values.
// - The solve: LU with partial pivoting (first largest pivot, as LAPACK's
//   isamax) of [A + λD | Jᵀr] in shared memory, then back substitution;
//   a zero pivot gives a non-finite step, which the rule above rejects.
// - The trial error: one more pass of residuals without tangents, summed
//   per thread and reduced once; the decision is taken by every thread
//   from the same shared values, so the loop's exit is uniform.
// - Outputs: x (n floats), the error and the iterations run, in one
//   int32 buffer the wrapper reads back with one copy. A pair index
//   outside [0, N) makes the kernel write -1 iterations and x0.

#include <cuda_runtime.h>
#include <stdint.h>

#define LM_HD __host__ __device__ __forceinline__

namespace lm {

// A value and its D tangents (D = 0: the value alone).
template <int D>
struct Dual {
  float v;
  float d[D > 0 ? D : 1];
};

template <int D>
LM_HD Dual<D> constant(float v) {
  Dual<D> r;
  r.v = v;
  for (int k = 0; k < D; ++k) r.d[k] = 0.f;
  return r;
}

// The parameter whose tangent is k (no tangent when k >= D).
template <int D>
LM_HD Dual<D> variable(float v, int k) {
  Dual<D> r = constant<D>(v);
  for (int i = 0; i < D; ++i) r.d[i] = i == k ? 1.f : 0.f;
  return r;
}

template <int D>
LM_HD Dual<D> add(const Dual<D>& a, const Dual<D>& b) {
  Dual<D> r;
  r.v = a.v + b.v;
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

template <int D>
LM_HD Dual<D> sub(const Dual<D>& a, const Dual<D>& b) {
  Dual<D> r;
  r.v = a.v - b.v;
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

template <int D>
LM_HD Dual<D> neg(const Dual<D>& a) {
  Dual<D> r;
  r.v = -a.v;
  for (int k = 0; k < D; ++k) r.d[k] = -a.d[k];
  return r;
}

template <int D>
LM_HD Dual<D> mul(const Dual<D>& a, const Dual<D>& b) {
  Dual<D> r;
  r.v = a.v * b.v;
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

template <int D>
LM_HD Dual<D> mul(const Dual<D>& a, float c) {
  Dual<D> r;
  r.v = a.v * c;
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] * c;
  return r;
}

// The value divides as the plain residual does; the tangents multiply by
// one reciprocal (a division each would be most of a residual's work).
template <int D>
LM_HD Dual<D> div(const Dual<D>& a, const Dual<D>& b) {
  Dual<D> r;
  r.v = a.v / b.v;
  const float inv = 1.f / b.v;
  for (int k = 0; k < D; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
  return r;
}

template <int D>
LM_HD Dual<D> sqrt(const Dual<D>& a) {
  Dual<D> r;
  r.v = sqrtf(a.v);
  const float half_inv = 1.f / (2.f * r.v);
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] * half_inv;
  return r;
}

template <int D>
LM_HD Dual<D> abs(const Dual<D>& a) {
  Dual<D> r;
  r.v = fabsf(a.v);
  const float s = a.v > 0.f ? 1.f : (a.v < 0.f ? -1.f : 0.f);
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] * s;
  return r;
}

template <int D>
LM_HD Dual<D> sin(const Dual<D>& a) {
  Dual<D> r;
  r.v = sinf(a.v);
  const float c = cosf(a.v);
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] * c;
  return r;
}

template <int D>
LM_HD Dual<D> cos(const Dual<D>& a) {
  Dual<D> r;
  r.v = cosf(a.v);
  const float s = -sinf(a.v);
  for (int k = 0; k < D; ++k) r.d[k] = a.d[k] * s;
  return r;
}

// a's tangents placed at [off, off + D) of 2D tangents.
template <int D>
LM_HD Dual<2 * D> lift(const Dual<D>& a, int off) {
  Dual<2 * D> r = constant<2 * D>(a.v);
  for (int k = 0; k < D; ++k) r.d[off + k] = a.d[k];
  return r;
}

// rodrigues_to_R of a Rodrigues vector r, row-major R.
template <int D>
LM_HD void rodrigues(const Dual<D> r[3], Dual<D> R[9]) {
  const Dual<D> theta2 =
      add(add(mul(r[0], r[0]), mul(r[1], r[1])), mul(r[2], r[2]));
  const Dual<D> one = constant<D>(1.f), zero = constant<D>(0.f);
  if (theta2.v < 1e-12f) {           // first order: I + [r]x
    R[0] = one;      R[1] = neg(r[2]); R[2] = r[1];
    R[3] = r[2];     R[4] = one;       R[5] = neg(r[0]);
    R[6] = neg(r[1]); R[7] = r[0];     R[8] = one;
    return;
  }
  const Dual<D> theta = sqrt(add(theta2, constant<D>(1e-24f)));
  Dual<D> K[9];
  K[0] = zero;                  K[1] = div(neg(r[2]), theta);
  K[2] = div(r[1], theta);      K[3] = div(r[2], theta);
  K[4] = zero;                  K[5] = div(neg(r[0]), theta);
  K[6] = div(neg(r[1]), theta); K[7] = div(r[0], theta);
  K[8] = zero;
  const Dual<D> s = sin(theta);
  const Dual<D> omc = sub(one, cos(theta));
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) {
      const Dual<D> kk = add(add(mul(K[3 * a], K[b]),
                                 mul(K[3 * a + 1], K[3 + b])),
                             mul(K[3 * a + 2], K[6 + b]));
      const Dual<D> eye = a == b ? one : zero;
      R[3 * a + b] = add(add(eye, mul(s, K[3 * a + b])), mul(omc, kk));
    }
  }
}

// bundle_adjust_ray: parameters (focal, r3) per camera; per
// correspondence the three components of sqrt|f_i·f_j|·(ray_i − ray_j)·m.
struct Ray {
  static constexpr int K = 4;
  static constexpr int ROWS = 3;

  template <int D>
  struct Cam {
    Dual<D> f;
    Dual<D> R[9];
    float ppx, ppy;
  };

  template <int D>
  LM_HD static void camera(const float* p, float ppx, float ppy,
                           Cam<D>& c) {
    c.f = variable<D>(p[0], 0);
    const Dual<D> r[3] = {variable<D>(p[1], 1), variable<D>(p[2], 2),
                          variable<D>(p[3], 3)};
    rodrigues(r, c.R);
    c.ppx = ppx;
    c.ppy = ppy;
  }

  // _rays: the unit ray of pixel (px, py).
  template <int D>
  LM_HD static void ray(const Cam<D>& c, float px, float py, Dual<D> out[3]) {
    const Dual<D> x = div(constant<D>(px - c.ppx), c.f);
    const Dual<D> y = div(constant<D>(py - c.ppy), c.f);
    for (int k = 0; k < 3; ++k)
      out[k] = add(add(mul(x, c.R[3 * k]), mul(y, c.R[3 * k + 1])),
                   c.R[3 * k + 2]);
    const Dual<D> n = sqrt(add(add(mul(out[0], out[0]), mul(out[1], out[1])),
                               mul(out[2], out[2])));
    for (int k = 0; k < 3; ++k) out[k] = div(out[k], n);
  }

  template <int D>
  LM_HD static void residual(const Cam<D>& ci, const Cam<D>& cj, float sx,
                             float sy, float qx, float qy, float m,
                             Dual<2 * D> r[ROWS]) {
    Dual<D> a[3], b[3];
    ray(ci, sx, sy, a);
    ray(cj, qx, qy, b);
    const Dual<2 * D> scale = sqrt(abs(mul(lift(ci.f, 0), lift(cj.f, D))));
    for (int k = 0; k < 3; ++k)
      r[k] = mul(mul(sub(lift(a[k], 0), lift(b[k], D)), scale), m);
  }
};

// bundle_adjust_reproj: parameters (focal, ppx, ppy, aspect, r3) per
// camera; per correspondence the pixel error of the rotation-only
// transfer proj(K_j·R_jᵀ·R_i·K_i⁻¹·[p, 1]) − q, times m.
struct Reproj {
  static constexpr int K = 7;
  static constexpr int ROWS = 2;

  template <int D>
  struct Cam {
    Dual<D> f, px, py, a;
    Dual<D> R[9];
  };

  template <int D>
  LM_HD static void camera(const float* p, float, float, Cam<D>& c) {
    c.f = variable<D>(p[0], 0);
    c.px = variable<D>(p[1], 1);
    c.py = variable<D>(p[2], 2);
    c.a = variable<D>(p[3], 3);
    const Dual<D> r[3] = {variable<D>(p[4], 4), variable<D>(p[5], 5),
                          variable<D>(p[6], 6)};
    rodrigues(r, c.R);
  }

  template <int D>
  LM_HD static void residual(const Cam<D>& ci, const Cam<D>& cj, float sx,
                             float sy, float qx, float qy, float m,
                             Dual<2 * D> r[ROWS]) {
    const Dual<D> xx = div(sub(constant<D>(sx), ci.px), ci.f);
    const Dual<D> yy = div(sub(constant<D>(sy), ci.py), mul(ci.f, ci.a));
    Dual<2 * D> v[3], w[3];
    for (int k = 0; k < 3; ++k)     // d @ R_iᵀ
      v[k] = lift(add(add(mul(xx, ci.R[3 * k]), mul(yy, ci.R[3 * k + 1])),
                      ci.R[3 * k + 2]), 0);
    for (int k = 0; k < 3; ++k)     // (d @ R_iᵀ) @ R_j
      w[k] = add(add(mul(v[0], lift(cj.R[k], D)),
                     mul(v[1], lift(cj.R[3 + k], D))),
                 mul(v[2], lift(cj.R[6 + k], D)));
    const Dual<2 * D> z =
        fabsf(w[2].v) < 1e-8f ? constant<2 * D>(1e-8f) : w[2];
    const Dual<2 * D> fj = lift(cj.f, D);
    const Dual<2 * D> u = add(div(mul(fj, w[0]), z), lift(cj.px, D));
    const Dual<2 * D> vv =
        add(div(mul(mul(fj, lift(cj.a, D)), w[1]), z), lift(cj.py, D));
    r[0] = mul(sub(u, constant<2 * D>(qx)), m);
    r[1] = mul(sub(vv, constant<2 * D>(qy)), m);
  }
};

}  // namespace lm

namespace {

using lm::Dual;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_N = 128;          // parameters: A and its factor in shared

struct Args {
  const float* x0;            // (n,) initial parameters, K per camera
  const float* src;           // (P, T, 2) points in pair_from's view
  const float* dst;           // (P, T, 2) points in pair_to's view
  const uint8_t* pt_valid;    // (P, T) bool
  const uint8_t* pair_valid;  // (P,) bool
  const long long* pair_from; // (P,)
  const long long* pair_to;   // (P,)
  const float* ppx;           // (N,) the ray residual's principal points
  const float* ppy;
  int* out;                   // (n + 2,): x's bits, the error's, iterations
  int N, P, T, iters;
};

template <class F>
__host__ __device__ constexpr int normal_values() {  // JᵀJ's upper, Jᵀr
  return (2 * F::K) * (2 * F::K + 1) / 2 + 2 * F::K;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of v (lane sums, then the warps' in order), in every
// thread.
__device__ float block_sum(float v, float* red) {
  __shared__ float total;
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = red[0];
    for (int w = 1; w < WARPS; ++w) s += red[w];
    total = s;
  }
  __syncthreads();
  return total;
}

template <class F, int D>
__device__ void cameras(const Args& a, const float* x,
                        typename F::template Cam<D>* cams) {
  for (int c = threadIdx.x; c < a.N; c += THREADS)
    F::template camera<D>(x + c * F::K, a.ppx ? a.ppx[c] : 0.f,
                          a.ppy ? a.ppy[c] : 0.f, cams[c]);
}

__device__ __forceinline__ float point_mask(const Args& a, int p, int t) {
  return a.pair_valid[p] && a.pt_valid[(size_t)p * a.T + t] ? 1.f : 0.f;
}

// Σ r(x)², in every thread.
template <class F>
__device__ float error_of(const Args& a, const float* x,
                          typename F::template Cam<0>* cams, float* red) {
  cameras<F, 0>(a, x, cams);
  __syncthreads();
  float e = 0.f;
  for (int p = 0; p < a.P; ++p) {
    const int i = (int)a.pair_from[p], j = (int)a.pair_to[p];
    for (int t = threadIdx.x; t < a.T; t += THREADS) {
      const size_t q = ((size_t)p * a.T + t) * 2;
      Dual<0> r[F::ROWS];
      F::template residual<0>(cams[i], cams[j], a.src[q], a.src[q + 1],
                              a.dst[q], a.dst[q + 1], point_mask(a, p, t), r);
      for (int k = 0; k < F::ROWS; ++k) e += r[k].v * r[k].v;
    }
  }
  return block_sum(e, red);
}

// A = JᵀJ (n x n) and g = Jᵀr at x, pair by pair.
template <class F>
__device__ void normal_equations(const Args& a, const float* x, float* A,
                                 float* g, int n,
                                 typename F::template Cam<F::K>* cams,
                                 float* red) {
  constexpr int K = F::K, S = 2 * K, NT = S * (S + 1) / 2;
  constexpr int NV = normal_values<F>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cameras<F, K>(a, x, cams);
  for (int e = threadIdx.x; e < n * n; e += THREADS) A[e] = 0.f;
  for (int e = threadIdx.x; e < n; e += THREADS) g[e] = 0.f;
  __syncthreads();
  for (int p = 0; p < a.P; ++p) {
    const int i = (int)a.pair_from[p], j = (int)a.pair_to[p];
    float acc[NV];                  // indices fixed at compile time: registers
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = 0.f;
    for (int t = threadIdx.x; t < a.T; t += THREADS) {
      const size_t q = ((size_t)p * a.T + t) * 2;
      Dual<S> r[F::ROWS];
      F::template residual<K>(cams[i], cams[j], a.src[q], a.src[q + 1],
                              a.dst[q], a.dst[q + 1], point_mask(a, p, t), r);
#pragma unroll
      for (int k = 0; k < F::ROWS; ++k) {
        if (i == j) {       // one camera on both sides: its two tangents add
          for (int c = 0; c < K; ++c) {
            r[k].d[c] += r[k].d[K + c];
            r[k].d[K + c] = 0.f;
          }
        }
        int v = 0;
#pragma unroll
        for (int c = 0; c < S; ++c)
#pragma unroll
          for (int d = c; d < S; ++d) acc[v++] += r[k].d[c] * r[k].d[d];
#pragma unroll
        for (int c = 0; c < S; ++c) acc[NT + c] += r[k].d[c] * r[k].v;
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float s = warp_sum(acc[v]);
      if (lane == 0) red[warp * NV + v] = s;
    }
    __syncthreads();
    for (int v = threadIdx.x; v < NV; v += THREADS) {
      float s = red[v];
      for (int w = 1; w < WARPS; ++w) s += red[w * NV + v];
      int c = v < NT ? 0 : v - NT, d = c, rem = v;
      if (v < NT) {
        while (rem >= S - c) { rem -= S - c; ++c; }
        d = c + rem;
      }
      if (i == j && (c >= K || d >= K)) continue;
      const int gc = c < K ? i * K + c : j * K + c - K;
      const int gd = d < K ? i * K + d : j * K + d - K;
      if (v < NT) {
        A[gc * n + gd] += s;
        if (c != d) A[gd * n + gc] += s;
      } else {
        g[gc] += s;
      }
    }
    __syncthreads();
  }
}

// dx = M⁻¹ b for M = [M | b] (n x (n + 1), row-major): LU with partial
// pivoting, the right-hand side carried through the elimination, then
// back substitution. Overwrites M.
__device__ void solve(float* M, int n, float* dx) {
  __shared__ int pivot_row;
  const int ld = n + 1, lane = threadIdx.x & 31;
  for (int k = 0; k < n; ++k) {
    if (threadIdx.x < 32) {         // the first largest |M[i][k]|, i >= k
      float best = -1.f;
      int at = n;
      for (int i = k + lane; i < n; i += 32) {
        const float v = fabsf(M[i * ld + k]);
        if (v > best) { best = v; at = i; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oa = __shfl_down_sync(0xffffffffu, at, off);
        if (ob > best || (ob == best && oa < at)) { best = ob; at = oa; }
      }
      if (lane == 0) pivot_row = at < n ? at : k;
    }
    __syncthreads();
    const int p = pivot_row;
    if (p != k) {
      for (int c = k + threadIdx.x; c < ld; c += THREADS) {
        const float t = M[k * ld + c];
        M[k * ld + c] = M[p * ld + c];
        M[p * ld + c] = t;
      }
      __syncthreads();
    }
    const float piv = M[k * ld + k];
    const int cols = n - k;         // columns k+1 .. n (the right-hand side)
    for (int e = threadIdx.x; e < (n - k - 1) * cols; e += THREADS) {
      const int i = k + 1 + e / cols, c = k + 1 + e % cols;
      const float l = M[i * ld + k] / piv;
      M[i * ld + c] -= l * M[k * ld + c];
    }
    __syncthreads();
  }
  for (int k = n - 1; k >= 0; --k) {
    const float xk = M[k * ld + n] / M[k * ld + k];
    for (int i = threadIdx.x; i < k; i += THREADS)
      M[i * ld + n] -= M[i * ld + k] * xk;
    if (threadIdx.x == 0) dx[k] = xk;
    __syncthreads();
  }
}

template <class F>
constexpr size_t cam_bytes() {
  return sizeof(typename F::template Cam<F::K>);
}

template <class F>
__global__ void __launch_bounds__(THREADS) lm_kernel(Args a) {
  using CamJ = typename F::template Cam<F::K>;
  using Cam0 = typename F::template Cam<0>;
  constexpr int NV = normal_values<F>();
  extern __shared__ float smem[];
  const int n = F::K * a.N;
  float* A = smem;                  // n x n
  float* M = A + n * n;             // n x (n + 1)
  float* g = M + n * (n + 1);
  float* x = g + n;
  float* xt = x + n;
  float* dx = xt + n;
  float* red = dx + n;              // WARPS x NV
  CamJ* cams = reinterpret_cast<CamJ*>(red + WARPS * NV);
  Cam0* cams0 = reinterpret_cast<Cam0*>(cams);

  int bad = 0;
  for (int p = threadIdx.x; p < a.P; p += THREADS)
    bad |= a.pair_from[p] < 0 || a.pair_from[p] >= a.N ||
           a.pair_to[p] < 0 || a.pair_to[p] >= a.N;
  for (int i = threadIdx.x; i < n; i += THREADS) x[i] = a.x0[i];
  if (__syncthreads_or(bad)) {
    for (int i = threadIdx.x; i < n; i += THREADS)
      a.out[i] = __float_as_int(x[i]);
    if (threadIdx.x == 0) {
      a.out[n] = 0;
      a.out[n + 1] = -1;
    }
    return;
  }

  float err = error_of<F>(a, x, cams0, red);
  float lam = 1e-3f;
  bool fresh = false;               // A and g hold the normal equations at x
  int it = 0;
  while (it < a.iters) {
    ++it;
    if (!fresh) {
      normal_equations<F>(a, x, A, g, n, cams, red);
      fresh = true;
    }
    for (int e = threadIdx.x; e < n * (n + 1); e += THREADS) {
      const int r = e / (n + 1), c = e % (n + 1);
      if (c == n) {
        M[e] = g[r];
      } else if (r == c) {
        const float ar = A[r * n + c];
        M[e] = ar + lam * (ar < 1e-8f ? 1e-8f : ar);
      } else {
        M[e] = A[r * n + c];
      }
    }
    __syncthreads();
    solve(M, n, dx);
    int nonfinite = 0;
    for (int i = threadIdx.x; i < n; i += THREADS)
      nonfinite |= !isfinite(dx[i]);
    nonfinite = __syncthreads_or(nonfinite);
    for (int i = threadIdx.x; i < n; i += THREADS)
      xt[i] = x[i] - (nonfinite ? 0.f : dx[i]);
    __syncthreads();
    const float e_try = error_of<F>(a, xt, cams0, red);
    const bool accept = e_try < err;
    const bool done =
        (accept && err - e_try < 1e-6f * (err + 1e-20f)) || lam > 1e8f;
    if (accept) {
      for (int i = threadIdx.x; i < n; i += THREADS) x[i] = xt[i];
      err = e_try;
      fresh = false;
    }
    lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.f, 1e-10f), 1e10f);
    __syncthreads();
    if (done) break;
  }
  for (int i = threadIdx.x; i < n; i += THREADS)
    a.out[i] = __float_as_int(x[i]);
  if (threadIdx.x == 0) {
    a.out[n] = __float_as_int(err);
    a.out[n + 1] = it;
  }
}

template <class F>
int launch(const Args& a, cudaStream_t stream) {
  const int n = F::K * a.N;
  const size_t bytes =
      sizeof(float) * ((size_t)n * n + (size_t)n * (n + 1) + 4 * n +
                       WARPS * normal_values<F>()) +
      a.N * cam_bytes<F>();
  cudaError_t err = cudaFuncSetAttribute(
      lm_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  lm_kernel<F><<<1, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind 0: the ray residual (4 parameters per camera), 1: the reprojection
// residual (7). Returns a CUDA error code; 0 on a launch.
extern "C" int imagestitch_lm_bundle(int kind, const float* x0,
                                     const float* src, const float* dst,
                                     const uint8_t* pt_valid,
                                     const uint8_t* pair_valid,
                                     const long long* pair_from,
                                     const long long* pair_to,
                                     const float* ppx, const float* ppy,
                                     int N, int P, int T, int iters, int* out,
                                     cudaStream_t stream) {
  const int K = kind == 0 ? lm::Ray::K : lm::Reproj::K;
  if ((kind != 0 && kind != 1) || N < 1 || K * N > MAX_N || P < 0 || T < 0 ||
      iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = {x0, src, dst, pt_valid, pair_valid, pair_from, pair_to,
                  ppx, ppy, out, N, P, T, iters};
  return kind == 0 ? launch<lm::Ray>(a, stream) : launch<lm::Reproj>(a, stream);
}
